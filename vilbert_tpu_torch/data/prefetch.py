"""Host batches to the card.

Counterpart of ``vilbert_tpu/data/prefetch.py`` (which imports jax at the
top, so it is mirrored here): ``compress_for_transfer`` shrinks the
host->device copy under bf16 compute, and ``to_device`` copies a batch
through pinned host memory with ``non_blocking=True`` (the reference's
``pin_memory`` + ``cuda(non_blocking=True)``), so the copy overlaps the work
already queued on the card.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Iterator

import numpy as np
import torch


def to_tensors(batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """numpy batch -> CPU tensors (sharing memory where numpy allows)."""
    return {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}


def compress_for_transfer(
    batch: Dict[str, torch.Tensor], compute_dtype: str, raw_feature_targets: bool = False
) -> Dict[str, torch.Tensor]:
    """Under bf16 compute: fp32 image features -> bf16 (bit-identical to the
    cast the first Linear makes anyway) and fp32 soft targets -> fp16 (11
    mantissa bits for a distribution); raw feature targets
    (``raw_feature_targets``, visual targets 1 and 2) go to bf16, whose
    range holds detector features. A no-op under fp32 compute."""
    if compute_dtype != "bfloat16":
        return batch
    out = dict(batch)
    for key in ("image_feat", "features"):
        if key in out and out[key].dtype == torch.float32:
            out[key] = out[key].to(torch.bfloat16)
    if "image_target" in out and out["image_target"].dtype == torch.float32:
        out["image_target"] = out["image_target"].to(
            torch.bfloat16 if raw_feature_targets else torch.float16)
    return out


def to_device(batch: Dict[str, torch.Tensor], device) -> Dict[str, torch.Tensor]:
    """Copy every tensor to ``device``; to a CUDA device through pinned
    memory, without waiting for the copy."""
    device = torch.device(device)
    if device.type != "cuda":
        return {k: v.to(device) for k, v in batch.items()}
    return {k: v.pin_memory().to(device, non_blocking=True) for k, v in batch.items()}


def repeat_iterator(make_iter: Callable[[], Iterable[Any]]) -> Iterator[Any]:
    """Endless stream over re-creatable epochs; raises on an epoch without a
    batch, which would otherwise loop forever."""
    while True:
        empty = True
        for item in make_iter():
            empty = False
            yield item
        if empty:
            raise ValueError("the loader yielded no batch: is the batch larger than the dataset?")
