"""Data parallelism across processes over ``torch.distributed``.

Counterpart of ``vilbert_tpu/parallel/distributed.py``. The JAX package
joins its processes with ``jax.distributed.initialize``, lets each load its
shard of every batch and assembles the global batch, on which XLA inserts
the gradient ``psum``. Here every process runs the same program on its own
shard, and the collectives are explicit:

- ``initialize_distributed`` joins the process group (NCCL for CUDA
  devices, gloo on the CPU) and returns this rank's device;
- ``process_shard`` gives the loaders their (shard_id, num_shards);
- ``all_mean_`` averages gradients (and the step's metrics) in place, one
  flat ``all_reduce`` per dtype, each in its own dtype;
- ``global_sum`` (a data-dependent count, summed over the ranks),
  ``all_gather`` (a data tensor, concatenated in rank order),
  ``sum_host`` (a small host vector summed over the ranks, the JAX
  trainer's ``process_allgather(...).sum(0)``) and ``broadcast_``.

A failed initialization raises: nothing carries on as a single process.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def _local_index(process_id: int, local_device_ids: Optional[str]) -> int:
    """The CUDA device index of this process: the first of
    ``local_device_ids``, else ``LOCAL_RANK`` (set by ``torchrun``), else
    the process id modulo the devices of this host."""
    if local_device_ids:
        return int(str(local_device_ids).split(",")[0])
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return process_id % max(torch.cuda.device_count(), 1)


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[str] = None,
    *,
    device="cuda",
    backend: Optional[str] = None,
) -> torch.device:
    """Join the process group (reference ``init_process_group``,
    train_tasks.py:269-278) and return this rank's device.

    ``coordinator_address`` ("host:port") is rank 0's rendezvous,
    ``num_processes`` the world size, ``process_id`` this rank. Without a
    coordinator, a ``torchrun`` launch is read from the environment
    (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``, ``MASTER_PORT``). With
    neither, and no ``num_processes``, it does nothing and returns
    ``device``, as the JAX function does for one process. The backend is
    NCCL on a CUDA device and gloo on the CPU unless ``backend`` names one
    (gloo also carries CUDA tensors, e.g. two ranks on one card). A CUDA
    rank takes ``cuda:<local index>`` (``_local_index``) and makes it the
    current device."""
    device = torch.device(device)
    from_env = not coordinator_address and "WORLD_SIZE" in os.environ
    if not coordinator_address and not num_processes and not from_env:
        if process_id:
            raise ValueError("--process_id needs --coordinator and --num_processes")
        return device
    if from_env:
        world = int(os.environ["WORLD_SIZE"]) if not num_processes else int(num_processes)
        rank = int(os.environ["RANK"]) if process_id is None else int(process_id)
        init_method = "env://"
    else:
        if not coordinator_address:
            raise ValueError("--num_processes needs --coordinator (host:port of rank 0)")
        world = int(num_processes or 1)
        if process_id is None and world > 1:
            raise ValueError("a multi-process run needs each process's --process_id")
        rank = int(process_id or 0)
        init_method = f"tcp://{coordinator_address}"
    if not 0 <= rank < world:
        raise ValueError(f"process id {rank} outside a world of {world}")
    if device.type == "cuda":
        device = torch.device("cuda", _local_index(rank, local_device_ids))
        torch.cuda.set_device(device)
    if is_initialized():
        if dist.get_world_size() != world or dist.get_rank() != rank:
            raise RuntimeError(
                f"a process group of rank {dist.get_rank()}/{dist.get_world_size()} is up; "
                f"asked for {rank}/{world}")
        return device
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
    logger.info("process group up: rank %d of %d, %s, %s", rank, world, backend, device)
    return device


def shutdown_distributed() -> None:
    """Leave the process group, if this process is in one."""
    if is_initialized():
        dist.destroy_process_group()


def process_shard() -> Tuple[int, int]:
    """(shard_id, num_shards) for the host-side loaders: (rank, world)."""
    if is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def barrier() -> None:
    if is_initialized():
        dist.barrier()


def _by_dtype(tensors: Sequence[torch.Tensor]) -> Dict[torch.dtype, List[torch.Tensor]]:
    groups: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    return groups


def _flat_collective(tensors: Sequence[torch.Tensor], op) -> None:
    """``op(flat)`` on one flat buffer per dtype, copied back in place."""
    for group in _by_dtype(tensors).values():
        flat = torch.cat([t.reshape(-1) for t in group])
        op(flat)
        torch._foreach_copy_(group, [v.view_as(t) for t, v in
                                     zip(group, flat.split([t.numel() for t in group]))])


@torch.no_grad()
def all_mean_(tensors: Sequence[torch.Tensor]) -> None:
    """Average ``tensors`` over the ranks in place: one ``all_reduce`` (sum)
    of a flat buffer per dtype, in that dtype (bf16 gradients are summed in
    bf16, as the JAX ``psum`` under ``--bf16_grads``), then a division by
    the world size. Every rank ends with the same bits."""
    if not is_initialized() or not tensors:
        return
    world = dist.get_world_size()

    def op(flat):
        dist.all_reduce(flat)
        if world != 1:
            flat.div_(world)

    _flat_collective(tensors, op)


@torch.no_grad()
def global_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks (a new tensor; ``t`` itself without a
    process group): the global count a loss divides by."""
    if not is_initialized():
        return t
    out = t.detach().clone()
    dist.all_reduce(out)
    return out


@torch.no_grad()
def all_gather(t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes), concatenated along dim 0 in rank
    order: the global batch of a data tensor. No gradient flows through."""
    if not is_initialized():
        return t
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t.detach().contiguous())
    return torch.cat(parts)


def _host_device() -> torch.device:
    """Where a host value goes to ride a collective: the current CUDA
    device under NCCL, the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def sum_host(values: Sequence[float]) -> np.ndarray:
    """A small host vector summed over the ranks, in float64 (the JAX
    trainer's ``process_allgather(...).sum(axis=0)``,
    ``vilbert_tpu/train/multitask.py:636-645``)."""
    v = np.asarray(values, np.float64)
    if not is_initialized():
        return v
    t = torch.tensor(v, dtype=torch.float64, device=_host_device())
    dist.all_reduce(t)
    return t.cpu().numpy()


@torch.no_grad()
def broadcast_(tensors: Sequence[torch.Tensor], src: int = 0) -> None:
    """Overwrite ``tensors`` in place with rank ``src``'s, one flat
    ``broadcast`` per dtype."""
    if not is_initialized() or not tensors:
        return
    _flat_collective(tensors, lambda flat: dist.broadcast(flat, src))
