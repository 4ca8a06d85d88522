"""The training step: forward, backward, gradient accumulation, update.

Counterpart of ``vilbert_tpu/parallel/train_step.py::make_train_step`` on one
device: the gradients of ``grad_accum`` microbatches are averaged (the
batch carries a leading [grad_accum, micro_batch, ...] axis), multiplied
by ``loss_scale``, their global norm is the ``grad_norm`` metric (taken
after ``loss_scale``, as there), and the optimizer applies one update in
place. Metrics stay on the device; the caller reads them when it logs.

With ``external_lr`` the step takes the host's learning rate as its third
argument (the multi-task trainer's per-iteration schedule), and
``update_mask`` limits the update to one task's parameters. A parameter
without a gradient (outside the loss's graph, or behind a ``detach``)
takes a zero gradient, as in JAX, where it participates; where it does
not, it gets no update at all.

With a ``mesh`` (``parallel.mesh.Mesh``) in a process group, each data
row differentiates its own shard of the batch and the summed gradients of
its microbatches are averaged over the data axis (``mesh.data_group``) in
the step, with the loss and the metrics, in one ``all_reduce`` a dtype
(``parallel.distributed.all_mean_``), before the ``grad_accum`` divide,
``loss_scale``, the norm and the update: every rank applies the same
update and logs the global values. The ranks of one data row (the model
axis) see the same batch, so their gradients are equal already, and
without ``shard_rules`` each applies the whole update: the state is
replicated over the model axis, as the JAX trainers replicate it. With
``shard_rules`` (``parallel.mesh.param_sharding_rules``) the optimizer
holds this rank's slice of every sharded parameter, with moments for it
alone (``ReferenceAdamW.shard_``), and updates it from the full averaged
gradients (``grad_norm`` and clipping read them all); the slices are then
all-gathered over ``mesh.model_group`` into the full parameters. Not DDP: the multi-task step leaves the
other tasks' heads without a gradient and the bf16 branch takes
``autograd.grad``, neither of which DDP's hooks cover. A loss whose
normalizer depends on the data (a count of masked positions) must divide
by the global count (``train.losses``) for the average to be the loss of
the global batch.

``grad_dtype="bfloat16"`` differentiates with respect to bf16 copies of
every fp32 parameter (``torch.func.functional_call`` over bf16 leaves), as
the JAX step casts its parameters before ``value_and_grad``: the forward
runs on the rounded weights (LayerNorm scales and biases included, which
K4 then takes as bf16) and the gradients come out in bf16. One microbatch
keeps them bf16; with ``grad_accum > 1`` they are summed into fp32 zeros,
as the JAX ``scan`` does, and stay fp32. The optimizer's fp32 parameters
are the ones updated.

Under a profiler the step records its spans (``core.tracing``):
``train.step`` (``rows``: ``batch_rows``) over ``step.forward`` and
``step.backward`` for each microbatch and ``step.optimizer`` (the norm,
the update and the model axis's gather); the three phases with their
stream time.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, NamedTuple, Optional, Tuple

import torch
from torch import nn

from vilbert_tpu_torch.core.tracing import span
from vilbert_tpu_torch.parallel.distributed import all_gather_into_, all_mean_
from vilbert_tpu_torch.train.optim import global_norm

#: loss_fn(model, batch) -> (scalar loss, metrics dict)
LossFn = Callable[[nn.Module, Dict[str, torch.Tensor]],
                  Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


class TrainState(NamedTuple):
    step: int
    model: nn.Module
    optimizer: Any  # ReferenceAdamW or ReferenceRAdam


def train_state_dict(state: TrainState) -> Dict[str, Any]:
    """What a full-state checkpoint holds: the step, the parameters under
    the model's ``state_dict`` names and the optimizer's state (live
    tensors; ``core.checkpoint`` saves them)."""
    return {"step": state.step, "params": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict()}


def load_train_state(state: TrainState, saved: Mapping[str, Any]) -> TrainState:
    """Copy a ``train_state_dict`` (of the same names and dtypes) into the
    model and the optimizer in place; returns the state at the saved step."""
    state.model.load_state_dict(saved["params"])
    state.optimizer.load_state_dict(saved["optimizer"])
    return state._replace(step=int(saved["step"]))


class _Loss(nn.Module):
    """``loss_fn(model, batch)`` as a module over the model's parameters, for
    ``functional_call`` (which swaps them for the bf16 leaves)."""

    def __init__(self, model: nn.Module, loss_fn: LossFn):
        super().__init__()
        self.model = model
        self.loss_fn = loss_fn

    def forward(self, batch):
        return self.loss_fn(self.model, batch)


def bf16_grads(model: nn.Module, loss_fn: LossFn, batch, names) -> Tuple[Any, Any, Dict]:
    """(loss, metrics, {name: gradient}) of ``loss_fn`` with respect to bf16
    copies of the model's fp32 parameters; a parameter outside the graph
    gets bf16 zeros."""
    with span("step.forward", device=True):
        leaves = {n: (p.detach().to(torch.bfloat16) if p.dtype == torch.float32 else p.detach())
                  .requires_grad_() for n, p in model.named_parameters()}
        loss, metrics = torch.func.functional_call(
            _Loss(model, loss_fn), {f"model.{n}": t for n, t in leaves.items()}, (batch,),
            tie_weights=False)
    wanted = [leaves[n] for n in names]
    with span("step.backward", device=True):
        grads = torch.autograd.grad(loss, wanted, allow_unused=True)
    return loss, metrics, {n: g if g is not None else torch.zeros_like(t)
                           for n, t, g in zip(names, wanted, grads)}


def batch_rows(batch: Mapping[str, Any], grad_accum: int = 1) -> int:
    """Rows of a step's batch, a loader's rows (a retrieval row with its
    options counts once): its first entry's leading axis, or with
    ``grad_accum > 1`` the micro-batch axis after it times ``grad_accum``."""
    shape = next(iter(batch.values())).shape
    return shape[0] if grad_accum == 1 else grad_accum * shape[1]


def make_train_step(
    loss_fn: LossFn,
    optimizer,
    *,
    grad_accum: int = 1,
    loss_scale: float = 1.0,
    external_lr: bool = False,
    grad_dtype: Optional[str] = None,
    update_mask: Optional[Mapping[str, bool]] = None,
    mesh=None,
    shard_rules: Optional[Mapping[str, Optional[int]]] = None,
) -> Callable[..., Dict[str, torch.Tensor]]:
    """step(model, batch[, lr]) -> metrics (``loss``, ``grad_norm`` and the
    loss function's own), updating the optimizer's parameters in place;
    ``lr`` is required with ``external_lr`` and refused without it.
    ``mesh``: average gradients and metrics over its data axis; with
    ``shard_rules`` ({name: dim or None}), shard the update over its model
    axis, which shards ``optimizer`` in place (module docstring)."""
    if grad_dtype not in (None, "", "float32", "bfloat16"):
        raise ValueError(f"grad_dtype {grad_dtype!r}")
    bf16 = grad_dtype == "bfloat16"
    params = dict(optimizer.params)  # the full parameters, before any sharding
    mask = optimizer.update_mask if update_mask is None else update_mask
    shards = {}
    if shard_rules and mesh is not None and mesh.model_size > 1:
        shards = {n: d for n, d in shard_rules.items() if d is not None}
        optimizer.shard_(shards, mesh.model_rank, mesh.model_size)

    def step_fn(model: nn.Module, batch: Dict[str, Any],
                lr: Optional[float] = None) -> Dict[str, torch.Tensor]:
        if external_lr and lr is None:
            raise ValueError("an external_lr step takes the learning rate: step(model, batch, lr)")
        if lr is not None and not external_lr:
            raise ValueError("this step has its own schedule and takes no lr")
        with span("train.step") as traced:
            if traced:
                traced.set(rows=batch_rows(batch, grad_accum))
            return _step(model, batch, lr)

    def _step(model, batch, lr):
        micro = [batch] if grad_accum == 1 else [
            {k: v[i] for k, v in batch.items()} for i in range(grad_accum)]
        if bf16:
            # every parameter gets a gradient (zeros outside the graph), as
            # the JAX step differentiates the whole tree
            grads, loss, metrics = None, 0.0, {}
            for mb in micro:
                loss_i, metrics_i, g_i = bf16_grads(model, loss_fn, mb, list(params))
                if grad_accum == 1:
                    grads = g_i
                else:  # summed into fp32 zeros (the JAX scan's carry)
                    grads = grads or {n: torch.zeros_like(p, dtype=torch.float32)
                                      for n, p in params.items()}
                    torch._foreach_add_(list(grads.values()), list(g_i.values()))
                loss = loss + loss_i.detach()
                metrics = {k: metrics.get(k, 0.0) + v.detach() for k, v in metrics_i.items()}
        else:
            for p in params.values():
                p.grad = None
            loss, metrics = 0.0, {}
            for mb in micro:
                with span("step.forward", device=True):
                    loss_i, metrics_i = loss_fn(model, mb)
                with span("step.backward", device=True):
                    loss_i.backward()  # sums into .grad
                loss = loss + loss_i.detach()
                metrics = {k: metrics.get(k, 0.0) + v.detach() for k, v in metrics_i.items()}
            grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                     for n, p in params.items()
                     if p.grad is not None or mask is None or mask[n]}
        if mesh is not None and mesh.distributed:
            all_mean_(list(grads.values()) + [loss] + list(metrics.values()),
                      group=mesh.data_group)
        if grad_accum > 1:
            loss = loss / grad_accum
            metrics = {k: v / grad_accum for k, v in metrics.items()}
            torch._foreach_mul_(list(grads.values()), 1.0 / grad_accum)
        if loss_scale != 1.0:
            torch._foreach_mul_(list(grads.values()), loss_scale)
        out = {k: v.detach() for k, v in metrics.items()}
        out["loss"] = loss.detach()
        with span("step.optimizer", device=True):
            out["grad_norm"] = global_norm(list(grads.values()))
            optimizer.step(grads, lr=lr, mask=mask)
            if shards:
                names = [n for n in shards if n in grads]
                all_gather_into_([optimizer.params[n] for n in names],
                                 [params[n] for n in names], [shards[n] for n in names],
                                 group=mesh.model_group)
        return out

    return step_fn
