"""The mesh of a run: a data axis and an optional model axis over the
process group.

Counterpart of ``vilbert_tpu/parallel/mesh.py`` (``make_mesh``,
``batch_sharding``, ``replicate_pytree``, ``param_sharding_rules``). A
``Mesh`` places this process at (``data_rank``, ``model_rank``) of a
``data_size`` x ``model_size`` grid of ranks: rank r sits at
(r // model_size, r % model_size), the row-major layout of JAX's
``np.array(devices).reshape(shape)``.

- The data axis shards the batch. The loaders read the data coordinate
  (``distributed.process_shard(mesh)``): each data row's batch is rows
  ``data_rank * B_local ...`` of the global batch, and the ranks of one
  data row see the same rows. The train step averages the gradients over
  ``data_group`` (the ranks of this model column), the losses divide by
  the data group's counts, and the dropout masks are those of the data
  row's rows of the global batch.
- The model axis shards the optimizer's update. ``param_sharding_rules``
  picks, as the JAX function does, the largest dim of every parameter of at
  least ``min_size_to_shard`` elements that divides by ``model_size``; the
  train step (``parallel/train_step.py``, ``shard_rules=``) lets each rank
  of a data row update its slice of each such parameter, with moments for
  that slice alone, and all-gathers the slices over ``model_group``.
  Without rules the state is replicated over the model axis, as the JAX
  trainers replicate it.

``replicate`` broadcasts rank 0's parameters and optimizer state so that
every rank starts identical. Rank 0 (``is_primary``) writes logs and
checkpoints.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from vilbert_tpu_torch.core.importer import _needs_transpose
from vilbert_tpu_torch.parallel import distributed

AXES = ("data", "model")


def _tensor_leaves(tree: Any) -> List[torch.Tensor]:
    """The tensors of a nested dict / list state, in a fixed order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, Mapping):
        return [t for k in sorted(tree) for t in _tensor_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensor_leaves(v)]
    return []


@dataclass(frozen=True)
class Mesh:
    """This process's place in a ``data_size`` x ``model_size`` grid of
    ranks, on ``device``. ``distributed`` is whether a process group
    carries the collectives (a mesh of one without one runs none).
    ``data_group`` holds the ranks of this model column (every data row at
    this ``model_rank``; None: the whole group), ``model_group`` those of
    this data row (None without a model axis)."""

    data_rank: int = 0
    data_size: int = 1
    model_rank: int = 0
    model_size: int = 1
    device: torch.device = torch.device("cpu")
    distributed: bool = False
    data_group: Any = None
    model_group: Any = None

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data_size, "model": self.model_size}

    @property
    def is_primary(self) -> bool:
        """Rank 0, which writes checkpoints, final weights and logs."""
        return self.data_rank == 0 and self.model_rank == 0

    def replicate(self, model: nn.Module, optimizer=None) -> None:
        """Rank 0's parameters, buffers and optimizer state on every rank."""
        if not self.distributed:
            return
        tensors = list(model.state_dict().values())
        if optimizer is not None:
            tensors += _tensor_leaves(optimizer.state_dict())
        distributed.broadcast_(tensors, src=0)

    def barrier(self) -> None:
        if self.distributed:
            distributed.barrier()


def _resolve_shape(shape: Sequence[int], world: int) -> List[int]:
    """``shape`` with its one -1 entry taking the ranks left."""
    shape = list(shape)
    if shape.count(-1) > 1:
        raise ValueError(f"mesh shape {shape}: at most one -1")
    if -1 in shape:
        known = math.prod(s for s in shape if s != -1)
        shape[shape.index(-1)] = world // known
    if math.prod(shape) != world:
        raise ValueError(f"mesh shape {shape} does not hold the {world} ranks of the group")
    return shape


def make_mesh(shape: Sequence[int] = (-1,), axes: Sequence[str] = ("data",),
              device: Optional[Any] = None) -> Mesh:
    """The mesh of this process over its process group (one rank without
    one): ``axes`` ("data",) or ("data", "model") of ``shape``, a -1 entry
    taking the ranks left, as ``vilbert_tpu.parallel.mesh.make_mesh``
    reshapes its devices. Every rank of the group must call it, in the same
    order as any other group it creates: it creates the subgroups of both
    axes (``dist.new_group``, which every rank joins).

    ``device`` defaults to the current CUDA device and raises without one:
    a CPU mesh is asked for by name."""
    axes, shape = tuple(axes), tuple(shape)
    if axes not in (AXES[:1], AXES):
        raise ValueError(f"mesh axes {axes}: ('data',) or ('data', 'model')")
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} for axes {axes}")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass device='cpu' for a CPU mesh")
        device = torch.device("cuda", torch.cuda.current_device())
    rank, world = distributed.process_shard()
    data_size, model_size = (_resolve_shape(shape, world) + [1])[:2]
    groups: Dict[str, Any] = {"data_group": None, "model_group": None}
    if distributed.is_initialized() and model_size > 1:
        # every rank creates every group, rows (model groups) then columns
        for d in range(data_size):
            g = dist.new_group([d * model_size + m for m in range(model_size)])
            if d == rank // model_size:
                groups["model_group"] = g
        for m in range(model_size):
            g = dist.new_group([d * model_size + m for d in range(data_size)])
            if m == rank % model_size:
                groups["data_group"] = g
    return Mesh(rank // model_size, data_size, rank % model_size, model_size,
                torch.device(device), distributed.is_initialized(), **groups)


def param_sharding_rules(model: nn.Module, mesh: Mesh, *,
                         min_size_to_shard: int = 2 ** 20) -> Dict[str, Optional[int]]:
    """{parameter name: the dim sharded over the model axis, or None for a
    replicated one}: ``vilbert_tpu.parallel.mesh.param_sharding_rules``'s
    rule on each parameter's flax shape (the largest dim, the first of a
    tie, of a parameter of at least ``min_size_to_shard`` elements, where
    it divides by the model size), mapped back to the port's tensor: a
    ``Linear`` weight is the transpose of its flax kernel, so it shards the
    same logical axis, a square one included. A tied parameter is named
    once. With a model axis of one, everything is replicated, as in JAX."""
    family = getattr(model, "family", "vilbert")
    rules: Dict[str, Optional[int]] = {}
    for name, p in model.named_parameters():
        rules[name] = None
        transposed = _needs_transpose(name, family)
        shape = tuple(reversed(p.shape)) if transposed else tuple(p.shape)
        if mesh.model_size == 1 or not shape or p.numel() < min_size_to_shard:
            continue
        dim = max(range(len(shape)), key=lambda i: (shape[i], -i))
        if shape[dim] % mesh.model_size == 0:
            rules[name] = len(shape) - 1 - dim if transposed else dim
    return rules
