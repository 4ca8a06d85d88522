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

``grad_dtype="bfloat16"`` (bf16 gradients) raises (ROADMAP A5).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, NamedTuple, Optional, Tuple

import torch
from torch import nn

from vilbert_tpu_torch.train.optim import ReferenceAdamW, global_norm

#: loss_fn(model, batch) -> (scalar loss, metrics dict)
LossFn = Callable[[nn.Module, Dict[str, torch.Tensor]],
                  Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


class TrainState(NamedTuple):
    step: int
    model: nn.Module
    optimizer: ReferenceAdamW


def make_train_step(
    loss_fn: LossFn,
    optimizer: ReferenceAdamW,
    *,
    grad_accum: int = 1,
    loss_scale: float = 1.0,
    external_lr: bool = False,
    grad_dtype: Optional[str] = None,
    update_mask: Optional[Mapping[str, bool]] = None,
) -> Callable[..., Dict[str, torch.Tensor]]:
    """step(model, batch[, lr]) -> metrics (``loss``, ``grad_norm`` and the
    loss function's own), updating the optimizer's parameters in place;
    ``lr`` is required with ``external_lr`` and refused without it."""
    if grad_dtype:
        raise NotImplementedError("bf16 gradients are not ported yet (ROADMAP A5)")
    params = optimizer.params
    mask = optimizer.update_mask if update_mask is None else update_mask

    def step_fn(model: nn.Module, batch: Dict[str, Any],
                lr: Optional[float] = None) -> Dict[str, torch.Tensor]:
        if external_lr and lr is None:
            raise ValueError("an external_lr step takes the learning rate: step(model, batch, lr)")
        if lr is not None and not external_lr:
            raise ValueError("this step has its own schedule and takes no lr")
        for p in params.values():
            p.grad = None
        if grad_accum == 1:
            loss, metrics = loss_fn(model, batch)
            loss.backward()
        else:
            loss, metrics = 0.0, {}
            for i in range(grad_accum):
                loss_i, metrics_i = loss_fn(model, {k: v[i] for k, v in batch.items()})
                loss_i.backward()  # sums into .grad
                loss = loss + loss_i.detach()
                metrics = {k: metrics.get(k, 0.0) + v.detach() for k, v in metrics_i.items()}
            loss = loss / grad_accum
            metrics = {k: v / grad_accum for k, v in metrics.items()}
        scale = loss_scale / grad_accum
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in params.items()
                 if p.grad is not None or mask is None or mask[n]}
        if scale != 1.0:
            torch._foreach_mul_(list(grads.values()), scale)
        out = {k: v.detach() for k, v in metrics.items()}
        out["loss"] = loss.detach()
        out["grad_norm"] = global_norm(list(grads.values()))
        optimizer.step(grads, lr=lr, mask=mask)
        return out

    return step_fn
