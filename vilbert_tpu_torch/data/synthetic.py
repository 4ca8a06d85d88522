"""Synthetic fixtures: annotations + stores for every task family.

The port's own copy of ``vilbert_tpu/data/synthetic.py``: the port imports
nothing of the JAX package, and ``tests/test_torch_host.py`` holds the
copy to the original.

Used by tests, the demo, and benchmarks when the real LMDB/VFR artifacts are
absent (the reference has no equivalent — its correctness was only checkable
with the full datasets downloaded; SURVEY.md §4).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from vilbert_tpu_torch.data.feature_store import InMemoryFeatureStore
from vilbert_tpu_torch.data.tasks import Annotation


def synthetic_store(num_images=16, num_boxes=8, feature_dim=16, seed=0):
    return InMemoryFeatureStore.synthetic(
        num_images=num_images, num_boxes=num_boxes, feature_dim=feature_dim,
        target_dim=None, seed=seed,
    )


def vqa_annotations(num=32, num_images=16, num_labels=13, seed=0) -> List[Annotation]:
    rng = np.random.RandomState(seed)
    out = []
    for i in range(num):
        k = int(rng.randint(num_images))
        lab = rng.choice(num_labels, size=2, replace=False)
        out.append(
            Annotation(
                question_id=i, image_id=str(k),
                text=f"what is object {k} doing in image {i}",
                labels=lab.tolist(), scores=[1.0, 0.3],
            )
        )
    return out


def classification_annotations(num=32, num_images=16, num_classes=3, seed=0):
    rng = np.random.RandomState(seed)
    return [
        Annotation(
            question_id=i, image_id=str(int(rng.randint(num_images))),
            text=f"a statement number {i} about the scene",
            label=int(rng.randint(num_classes)),
        )
        for i in range(num)
    ]


def expand_annotations(num=16, num_images=16, num_options=4, seed=0):
    rng = np.random.RandomState(seed)
    return [
        Annotation(
            question_id=i, image_id=str(int(rng.randint(num_images))),
            text=f"why is thing {i} happening",
            options=[f"because of reason {j} item {i}" for j in range(num_options)],
            label=int(rng.randint(num_options)),
        )
        for i in range(num)
    ]


def retrieval_annotations(num=24, num_images=16, seed=0):
    rng = np.random.RandomState(seed)
    return [
        Annotation(
            question_id=i, image_id=str(i % num_images),
            text=f"a caption describing image {i % num_images} variant {i}",
        )
        for i in range(num)
    ]


def grounding_annotations(store, num=24, seed=0):
    rng = np.random.RandomState(seed)
    keys = store.keys()
    out = []
    for i in range(num):
        k = keys[int(rng.randint(len(keys)))]
        rf = store.get(k)
        box = rf.boxes[int(rng.randint(rf.boxes.shape[0]))]
        out.append(
            Annotation(
                question_id=i, image_id=k,
                text=f"the thing near position {i}", ref_box=box.copy(),
            )
        )
    return out


def pointing_annotations(store, num=16, num_mc=4, max_region_num=108, seed=0):
    from vilbert_tpu_torch.train.multitask import MC_REGION_OFFSET

    rng = np.random.RandomState(seed)
    keys = store.keys()
    out = []
    n_option_rows = max_region_num - MC_REGION_OFFSET
    for i in range(num):
        k = keys[int(rng.randint(len(keys)))]
        rf = store.get(k)
        mc = rng.choice(n_option_rows, size=num_mc, replace=False).astype(np.int64)
        box = rf.boxes[int(rng.randint(rf.boxes.shape[0]))]
        out.append(
            Annotation(
                question_id=i, image_id=k,
                text=f"which region is item {i}", ref_box=box.copy(),
                mc_idx=mc, label=int(rng.randint(num_mc)),
            )
        )
    return out


def nlvr2_annotations(num=16, num_images=16, seed=0):
    rng = np.random.RandomState(seed)
    return [
        Annotation(
            question_id=i,
            image_id=str(int(rng.randint(num_images))),
            image_id_b=str(int(rng.randint(num_images))),
            text=f"both images contain the object {i}",
            label=int(rng.randint(2)),
        )
        for i in range(num)
    ]
