"""The training step: forward, backward, gradient accumulation, update.

Counterpart of ``vilbert_tpu/parallel/train_step.py::make_train_step`` on one
device: the gradients of ``grad_accum`` microbatches are averaged (the
batch carries a leading [grad_accum, micro_batch, ...] axis), multiplied
by ``loss_scale``, their global norm is the ``grad_norm`` metric (taken
after ``loss_scale``, as there), and the optimizer applies one update in
place. Metrics stay on the device; the caller reads them when it logs.

``grad_dtype="bfloat16"`` (bf16 gradients) and ``external_lr`` come with the
multi-task slice and raise.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

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
) -> Callable[[nn.Module, Dict[str, torch.Tensor]], Dict[str, torch.Tensor]]:
    """step(model, batch) -> metrics (``loss``, ``grad_norm`` and the loss
    function's own), updating the optimizer's parameters in place."""
    if external_lr:
        raise NotImplementedError("external_lr comes with the multi-task trainer (ROADMAP A9)")
    if grad_dtype:
        raise NotImplementedError("bf16 gradients come with the multi-task slice (ROADMAP A5)")
    params = optimizer.params

    def step_fn(model: nn.Module, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
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
        grads = {n: (torch.zeros_like(p) if p.grad is None else p.grad) for n, p in params.items()}
        if scale != 1.0:
            torch._foreach_mul_(list(grads.values()), scale)
        out = {k: v.detach() for k, v in metrics.items()}
        out["loss"] = loss.detach()
        out["grad_norm"] = global_norm(list(grads.values()))
        optimizer.step(grads)
        return out

    return step_fn
