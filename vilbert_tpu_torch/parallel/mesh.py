"""The data axis of a data-parallel run.

Counterpart of the data-axis half of ``vilbert_tpu/parallel/mesh.py``
(``make_mesh``, ``batch_sharding``, ``replicate_pytree``): a ``DataMesh``
is this process's rank, the world size and its device. The batch axis is
sharded by the loaders (``process_shard``), each rank's batch being rows
``rank * B_local ...`` of the global batch; ``replicate`` broadcasts rank
0's parameters and optimizer state so that every rank starts identical;
the train step averages the gradients over the ranks
(``parallel/train_step.py``). The "model" axis (``param_sharding_rules``,
FSDP) is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Mapping, Optional

import torch

from vilbert_tpu_torch.parallel import distributed


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
class DataMesh:
    """Rank ``rank`` of ``world_size`` data-parallel processes, on
    ``device``. ``distributed`` is whether a process group carries the
    collectives (a mesh of one without one runs none)."""

    rank: int = 0
    world_size: int = 1
    device: torch.device = torch.device("cpu")
    distributed: bool = False

    @property
    def is_primary(self) -> bool:
        """Rank 0, which writes checkpoints, final weights and logs."""
        return self.rank == 0

    def replicate(self, model: torch.nn.Module, optimizer=None) -> None:
        """Rank 0's parameters, buffers and optimizer state on every rank."""
        if not self.distributed:
            return
        tensors = list(model.state_dict().values())
        if optimizer is not None:
            tensors += _tensor_leaves(optimizer.state_dict())
        distributed.broadcast_(tensors, src=0)

    def check_config(self, cfg) -> None:
        """Refuse what the data axis cannot split yet."""
        if self.world_size > 1 and getattr(cfg, "in_batch_pairs", False):
            raise NotImplementedError(
                "in_batch_pairs pairs every text with every image of the global batch; "
                "across processes it is not ported (ROADMAP A12b)")

    def barrier(self) -> None:
        if self.distributed:
            distributed.barrier()


def make_mesh(device: Optional[Any] = None) -> DataMesh:
    """The data mesh of this process: its rank and world in the process
    group (one rank without one) on ``device`` (default: the current CUDA
    device if there is one, else the CPU)."""
    rank, world = distributed.process_shard()
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if torch.cuda.is_available() else torch.device("cpu"))
    return DataMesh(rank, world, torch.device(device), distributed.is_initialized())
