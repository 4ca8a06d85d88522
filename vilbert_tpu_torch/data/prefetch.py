"""Host batches to the card.

Counterpart of ``vilbert_tpu/data/prefetch.py`` (which imports jax at the
top, so it is mirrored here): ``compress_for_transfer`` shrinks the
host->device copy under bf16 compute, ``to_device`` copies a batch through
pinned host memory with ``non_blocking=True`` (the reference's
``pin_memory`` + ``cuda(non_blocking=True)``), so the copy overlaps the work
already queued on the card, and ``device_prefetch`` builds and stages
batches ``size`` ahead of the step on a thread of its own.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Iterable, Iterator, Optional

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


class _Staged:
    """A batch on its way to the card: the device tensors, the pinned host
    tensors they were copied from (held until the step has the batch) and
    the event that marks the end of the copies on the side stream."""

    __slots__ = ("batch", "pinned", "event")

    def __init__(self, batch, pinned=None, event=None):
        self.batch, self.pinned, self.event = batch, pinned, event


def _stage(batch: Dict[str, torch.Tensor], device: torch.device,
           stream: Optional["torch.cuda.Stream"]) -> _Staged:
    """Copy a CPU batch to ``device``: on a CUDA device, pinned and copied on
    ``stream`` (the producer's side stream), with an event recorded after
    the copies; elsewhere ``to_device``."""
    if stream is None:
        return _Staged(to_device(batch, device))
    pinned = {k: v.pin_memory() for k, v in batch.items()}
    with torch.cuda.stream(stream):
        out = {k: v.to(device, non_blocking=True) for k, v in pinned.items()}
        event = torch.cuda.Event()
        event.record(stream)
    return _Staged(out, pinned, event)


def _receive(item: _Staged, device: torch.device) -> Dict[str, torch.Tensor]:
    """The batch of a staged item, usable on the current stream: the
    current stream waits for the copies, and each tensor is marked as used
    by it, so that the caching allocator does not hand its memory to the
    side stream's next copy while the step still reads it."""
    if item.event is not None:
        current = torch.cuda.current_stream(device)
        current.wait_event(item.event)
        for v in item.batch.values():
            v.record_stream(current)
    return item.batch


def device_prefetch(
    iterator: Iterable[Any],
    *,
    size: int = 2,
    device,
    transform: Optional[Callable[[Any], Dict[str, torch.Tensor]]] = None,
    placer: Optional[Callable[[Any], Any]] = None,
) -> Iterator[Any]:
    """Yield batches already on ``device``, built and copied ``size`` ahead.

    ``vilbert_tpu.data.prefetch.device_prefetch`` for torch: a daemon thread
    takes the host batches from ``iterator``, applies ``transform`` (host
    side: numpy to CPU tensors, the transfer compression, microbatch
    stacking) and places each batch with ``placer``, or else copies it to
    ``device``: on a CUDA device through pinned memory on a side stream of
    its own, the step's stream then waiting on the copy's event. At most
    ``size`` placed batches wait in the queue. An exception in the loader
    or the transform is raised again here, at the batch it stopped; the
    stream ends where ``iterator`` ends. ``size=0`` builds and copies each
    batch on the caller's thread when it is asked for, with the same
    transform and placement. Closing the generator (or dropping it) stops
    the thread.
    """
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())

    def place(batch, stream=None):
        if transform is not None:
            batch = transform(batch)
        if placer is not None:
            return _Staged(placer(batch))
        return _stage(batch, device, stream)

    if size <= 0:
        for batch in iterator:
            yield _receive(place(batch), device)
        return

    q: "queue.Queue[Any]" = queue.Queue(maxsize=size)
    sentinel = object()
    stop = threading.Event()
    err: list = []

    def offer(item) -> bool:
        """Queue ``item``; False once the consumer has gone."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            stream = None
            if device.type == "cuda":
                torch.cuda.set_device(device)
                stream = torch.cuda.Stream(device)
            for batch in iterator:
                if not offer(place(batch, stream)):
                    return
        except Exception as e:  # raised again at the consumer
            err.append(e)
        finally:
            offer(sentinel)

    thread = threading.Thread(target=producer, daemon=True, name="device_prefetch")
    thread.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if err:
                    raise err[0]
                return
            yield _receive(item, device)
    finally:
        stop.set()
        while thread.is_alive():  # unblock a producer waiting on a full queue
            try:
                q.get(timeout=0.1)
            except queue.Empty:
                pass


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
