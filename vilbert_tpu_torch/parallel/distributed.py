"""Data parallelism and the model axis across processes over ``torch.distributed``.

Counterpart of ``vilbert_tpu/parallel/distributed.py``. The JAX package
joins its processes with ``jax.distributed.initialize``, lets each load its
shard of every batch and assembles the global batch, on which XLA inserts
the collectives its shardings need. Here every process runs the same
program on its own shard, and the collectives are explicit:

- ``initialize_distributed`` joins the process group (NCCL for CUDA
  devices, gloo on the CPU) and returns this rank's device;
- ``process_shard`` gives the loaders their (shard_id, num_shards): a
  mesh's data coordinate, else (rank, world);
- ``all_mean_`` averages gradients (and the step's metrics) in place, one
  flat ``all_reduce`` per dtype, each in its own dtype;
- ``global_sum`` (a data-dependent count, summed over the ranks),
  ``all_gather`` (a data tensor, concatenated in rank order),
  ``gather_rows`` (the same with a gradient: the ``in_batch_pairs``
  images), ``all_gather_into_`` (parameter slices into the full
  parameters), ``sum_host`` (a small host vector summed over the ranks,
  the JAX trainer's ``process_allgather(...).sum(0)``) and ``broadcast_``.

Each takes a ``group`` (a mesh axis's subgroup; None: every rank) and uses
only ``all_reduce``, ``broadcast`` and ``all_gather``, which gloo also
carries on CUDA tensors (ranks that share one card). A failed
initialization raises: nothing carries on as a single process.
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


def process_shard(mesh=None) -> Tuple[int, int]:
    """(shard_id, num_shards) for the host-side loaders: ``mesh``'s data
    coordinate (the ranks of a data row read the same shard), else (rank,
    world) of the process group."""
    if mesh is not None:
        return mesh.data_rank, mesh.data_size
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
def all_mean_(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Average ``tensors`` over the ranks of ``group`` in place: one
    ``all_reduce`` (sum) of a flat buffer per dtype, in that dtype (bf16
    gradients are summed in bf16, as the JAX ``psum`` under
    ``--bf16_grads``), then a division by the group's size. Every rank ends
    with the same bits."""
    if not is_initialized() or not tensors:
        return
    world = dist.get_world_size(group)

    def op(flat):
        dist.all_reduce(flat, group=group)
        if world != 1:
            flat.div_(world)

    _flat_collective(tensors, op)


@torch.no_grad()
def global_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t`` summed over the ranks of ``group`` (a new tensor; ``t`` itself
    without a process group): the global count a loss divides by."""
    if not is_initialized():
        return t
    out = t.detach().clone()
    dist.all_reduce(out, group=group)
    return out


def _gather(t: torch.Tensor, group) -> torch.Tensor:
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.detach().contiguous(), group=group)
    return torch.cat(parts)


@torch.no_grad()
def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) of ``group``, concatenated along
    dim 0 in rank order: the global batch of a data tensor. No gradient
    flows through (``gather_rows`` for one that does)."""
    if not is_initialized():
        return t
    return _gather(t, group)


class _GatherRows(torch.autograd.Function):
    """``all_gather`` over ``group`` whose backward all-reduces (sums) the
    gradient of the gathered tensor and keeps this rank's rows."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group, ctx.rows = group, t.shape[0]
        return _gather(t, group)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        i = dist.get_rank(ctx.group)
        return grad[i * ctx.rows:(i + 1) * ctx.rows], None


def gather_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """``all_gather`` with a gradient. Every rank's loss may read every
    rank's rows, so the gradient of this rank's rows is the sum of every
    rank's gradient for them: the backward all-reduces the gathered
    gradient and keeps its own rows. Under the step's convention (the
    global loss is the mean of the ranks' losses, and ``all_mean_``
    averages the gradients), that sum is what makes the averaged gradient
    the global loss's."""
    if not is_initialized() or dist.get_world_size(group) == 1:
        return t
    return _GatherRows.apply(t, group)


@torch.no_grad()
def all_gather_into_(parts: Sequence[torch.Tensor], fulls: Sequence[torch.Tensor],
                     dims: Sequence[int], group=None) -> None:
    """Rank i of ``group`` holds slice i of every tensor of ``fulls``
    along its dim of ``dims`` (equal slices, ``parts`` being this rank's
    values of its own); write every rank's slices into ``fulls``: one
    ``all_gather`` of a flat buffer per dtype."""
    if not parts:
        return
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, p in enumerate(parts):
        by_dtype.setdefault(p.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([parts[i].reshape(-1) for i in idx])
        out = [torch.empty_like(flat) for _ in range(world)]
        dist.all_gather(out, flat, group=group)
        for r, buf in enumerate(out):
            if r == rank:
                continue
            for i, v in zip(idx, buf.split([parts[i].numel() for i in idx])):
                n = parts[i].shape[dims[i]]
                fulls[i].narrow(dims[i], r * n, n).copy_(v.view_as(parts[i]))


def _host_device(group=None) -> torch.device:
    """Where a host value goes to ride a collective: the current CUDA
    device under NCCL, the CPU under gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def sum_host(values: Sequence[float], group=None) -> np.ndarray:
    """A small host vector summed over the ranks of ``group``, in float64
    (the JAX trainer's ``process_allgather(...).sum(axis=0)``,
    ``vilbert_tpu/train/multitask.py:636-645``)."""
    v = np.asarray(values, np.float64)
    if not is_initialized():
        return v
    t = torch.tensor(v, dtype=torch.float64, device=_host_device(group))
    dist.all_reduce(t, group=group)
    return t.cpu().numpy()


@torch.no_grad()
def broadcast_(tensors: Sequence[torch.Tensor], src: int = 0) -> None:
    """Overwrite ``tensors`` in place with rank ``src``'s, one flat
    ``broadcast`` per dtype over every rank."""
    if not is_initialized() or not tensors:
        return
    _flat_collective(tensors, lambda flat: dist.broadcast(flat, src))
