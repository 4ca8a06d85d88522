"""Box geometry utilities (vectorized numpy).

The port's own copy of ``vilbert_tpu/data/boxes.py``: the port imports
nothing of the JAX package, and ``tests/test_torch_host.py`` holds the
copy to the original.

Replicates the reference's IoU (vilbert/datasets/concept_cap_dataset.py:39-76)
and the 5-dim normalized location encoding
[x1/w, y1/h, x2/w, y2/h, area/(w*h)] used throughout the datasets
(e.g. concept_cap_dataset.py:443-454, _image_features_reader.py:103-121).
"""

from __future__ import annotations

import numpy as np


def iou(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """Pairwise IoU of [N,4] and [K,4] xyxy boxes -> [N,K] float32.

    Uses the reference's +1 pixel-area convention ((x2-x1+1)*(y2-y1+1)).
    """
    a = boxes_a.astype(np.float64)
    b = boxes_b.astype(np.float64)
    area_a = (a[:, 2] - a[:, 0] + 1) * (a[:, 3] - a[:, 1] + 1)
    area_b = (b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1)

    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:4], b[None, :, 2:4])
    wh = np.clip(rb - lt + 1, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None, :] - inter
    return (inter / np.maximum(union, 1e-10)).astype(np.float32)


def normalize_locations(
    boxes: np.ndarray, image_w: float, image_h: float
) -> np.ndarray:
    """[N,4] xyxy pixel boxes -> [N,5] normalized location encoding."""
    out = np.zeros((boxes.shape[0], 5), np.float32)
    out[:, 0] = boxes[:, 0] / image_w
    out[:, 1] = boxes[:, 1] / image_h
    out[:, 2] = boxes[:, 2] / image_w
    out[:, 3] = boxes[:, 3] / image_h
    out[:, 4] = (
        (boxes[:, 3] - boxes[:, 1]) * (boxes[:, 2] - boxes[:, 0])
    ) / (image_w * image_h)
    return out
