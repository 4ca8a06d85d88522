"""Wire TaskConfigs to datasets/loaders (reference LoadDatasets /
LoadDatasetEval, task_utils.py:394-615).

The port's own copy of ``vilbert_tpu/data/loading.py``: the port imports
nothing of the JAX package, and ``tests/test_torch_host.py`` holds the
copy to the original.

Feature stores are deduplicated across tasks by path (reference :400-419);
annotations are parsed by task name through
vilbert_tpu_torch.data.annotations;
per-task batch sizes are divided by grad-accum and host shards (:433-437).
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional, Tuple

from vilbert_tpu_torch.core.config import TaskConfig
from vilbert_tpu_torch.data import annotations as ann
from vilbert_tpu_torch.data.feature_store import FeatureStore, open_feature_store
from vilbert_tpu_torch.data.tasks import DATASET_REGISTRY, DataLoader, TaskDataset
from vilbert_tpu_torch.data.tokenization import Tokenizer

logger = logging.getLogger(__name__)

#: task head widths (reference hardcodes 3129/1533, vilbert.py:1610-1615)
NUM_LABELS = {"VQA": 3129, "GenomeQA": 3129, "GQA": 1533}


#: tasks whose TRAIN split drops test-pool images when the cache npy exists
#: (reference clean_datasets, visual_entailment_dataset.py:47-52,
#: retreival_dataset.py:35-43)
_CLEAN_POOLS = {
    "VisualEntailment": "flickr",
    "RetrievalCOCO": "coco",
    "RetrievalFlickr30k": "flickr",
    "FlickrGrounding": "flickr",
    "Foil": "coco",
}


def _load_annotations(task: TaskConfig, split: str, clean_datasets: bool = True):
    anns = _load_annotations_raw(task, split)
    if (
        clean_datasets
        and split.startswith("train")
        and task.name in _CLEAN_POOLS
    ):
        remove = ann.load_clean_ids(task.dataroot, _CLEAN_POOLS[task.name])
        if remove:
            before = len(anns)
            anns = ann.filter_clean(anns, remove)
            logger.info("clean_datasets %s: %d -> %d annotations",
                        task.name, before, len(anns))
    return anns


def _load_annotations_raw(task: TaskConfig, split: str):
    name = task.name
    root = task.dataroot
    if name in ("VQA", "GenomeQA"):
        return ann.load_vqa(root, split)
    if name == "GQA":
        return ann.load_gqa(root, split)
    if name == "NLVR2":
        return ann.load_nlvr2(root, split)
    if name == "VisualEntailment":
        return ann.load_snli_ve(root, split)
    if name in ("RetrievalCOCO", "RetrievalFlickr30k"):
        path = (task.train_annotations_jsonpath if split.startswith("train")
                else task.val_annotations_jsonpath)
        return ann.load_retrieval(path, name)
    if name in ("refcoco", "refcoco+", "refcocog"):
        return ann.load_refer(root, name, split)
    if name == "VisualDialog":
        path = (task.train_annotations_jsonpath if split.startswith("train")
                else task.val_annotations_jsonpath)
        return ann.load_visdial(path)
    if name in ("VCR_Q-A", "VCR_QA-R"):
        path = (task.train_annotations_jsonpath if split.startswith("train")
                else task.val_annotations_jsonpath)
        return ann.load_vcr(path, mode="QA" if name == "VCR_Q-A" else "QAR")
    if name == "Visual7w":
        return ann.load_visual7w_pointing(root, split)
    if name == "GuessWhat":
        path = os.path.join(root, f"guesswhat.{split}.jsonl")
        return ann.load_guesswhat(path)
    if name == "Foil":
        path = (task.train_annotations_jsonpath if split.startswith("train")
                else task.val_annotations_jsonpath)
        return ann.load_foil(path)
    if name == "GuessWhatPointing":
        return ann.load_guesswhat_pointing(root, split)
    if name == "FlickrGrounding":
        return ann.load_flickr_grounding(root, split)
    raise NotImplementedError(
        f"no annotation loader wired for task {name}; construct the dataset "
        f"directly via DATASET_REGISTRY"
    )


def load_datasets(
    tasks: Dict[str, TaskConfig],
    tokenizer: Tokenizer,
    *,
    grad_accum: int = 1,
    shard_id: int = 0,
    num_shards: int = 1,
    seed: int = 0,
    with_val: bool = True,
    store_cache: Optional[Dict[str, FeatureStore]] = None,
    clean_train_sets: bool = True,
) -> Tuple[Dict[str, DataLoader], Dict[str, DataLoader]]:
    """Build train (and val) loaders for every task.

    ``clean_train_sets`` drops test-set image ids from the train
    annotations (the reference's --clean_train_sets, default true,
    train_tasks.py:199-204).

    Returns (train_loaders, val_loaders) keyed like ``tasks``.
    """
    stores: Dict[str, FeatureStore] = store_cache if store_cache is not None else {}

    def get_store(path: str) -> Optional[FeatureStore]:
        if not path:
            return None
        if path not in stores:
            logger.info("opening feature store %s", path)
            stores[path] = open_feature_store(path)
        return stores[path]

    train_loaders: Dict[str, DataLoader] = {}
    val_loaders: Dict[str, DataLoader] = {}
    for key, task in tasks.items():
        store = get_store(task.features_path)
        store_gt = get_store(task.features_path_gt)
        cls = DATASET_REGISTRY[task.name]
        common = dict(
            store=store,
            tokenizer=tokenizer,
            max_seq_length=task.max_seq_length,
            max_region_num=task.max_region_num,
            num_labels=task.num_labels or NUM_LABELS.get(task.name, 0),
            store_gt=store_gt,
        )
        extra = {}
        if task.name == "GuessWhatPointing":
            # reference pads the per-game object list to 204 options
            # (guesswhat_pointing_dataset.py:252-253)
            extra["num_options"] = 204
        if task.name.startswith("Retrieval"):
            # precomputed 100-NN hard negatives (reference
            # retreival_dataset.py:97-107; built by
            # scripts/generate_hard_negatives.py)
            pool_path = os.path.join(task.dataroot, "hard_negative.pkl")
            if os.path.exists(pool_path):
                import pickle

                with open(pool_path, "rb") as f:
                    extra["hard_negative_pool"] = pickle.load(f)
        train_ds = cls(
            _load_annotations(task, task.train_split,
                              clean_datasets=clean_train_sets),
            split="train", **common, **extra,
        )
        batch = max(task.batch_size // (grad_accum * num_shards), 1)
        train_loaders[key] = DataLoader(
            train_ds, batch, shuffle=True, seed=seed,
            shard_id=shard_id, num_shards=num_shards,
        )
        if with_val:
            extra_val = {k: v for k, v in extra.items() if k == "num_options"}
            val_ds = cls(
                _load_annotations(task, task.val_split), split="val",
                **common, **extra_val,
            )
            val_loaders[key] = DataLoader(
                val_ds, task.eval_batch_size or batch, shuffle=False,
                drop_last=False,
            )
    return train_loaders, val_loaders
