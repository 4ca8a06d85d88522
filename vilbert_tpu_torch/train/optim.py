"""The pretraining optimizer: AdamW with pytorch_transformers semantics.

Counterpart of ``vilbert_tpu/train/optim.py`` (which imports jax and optax,
so it is mirrored here, not imported): the warmup schedules,
``_decay_mask`` and ``label_params``, ``reference_adamw`` and
``build_optimizer``. Its update is

    p <- p - lr_t * ratio_p * (scale * m / (sqrt(v) + eps) + wd_p * p),
    scale = sqrt(1 - b2^t) / (1 - b1^t)   (correct_bias)

which is NOT ``torch.optim.AdamW``: eps is added before the bias
correction, weight decay joins the update, one step count is shared by all
parameters (ROADMAP C3), the schedule is read at ``count + step_offset``,
frozen parameters keep their moments, and the moments accumulate in fp32.

Names: the JAX rules match flax paths (``NO_DECAY_SUBSTRINGS``,
``TEXT_BERT_PREFIXES``), so every port parameter name goes through
``core.importer._to_flax_key`` first. The co-attention
``LayerNorm1``/``LayerNorm2`` weights do not contain "LayerNorm.weight"
and are decayed, as the reference decays them.

Schedules compute in float32 as the JAX schedules do inside the jitted
step, where XLA turns each division by a constant into a multiplication by
its float32 reciprocal: the learning rates match bit for bit.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from vilbert_tpu_torch.core.config import OptimizerConfig
from vilbert_tpu_torch.core.importer import _to_flax_key

#: see vilbert_tpu/train/optim.py:38-45
NO_DECAY_SUBSTRINGS = ("bias", "LayerNorm.weight")
HEAD_PREFIXES = (
    "vil_prediction", "vil_prediction_gqa", "vil_binary_prediction",
    "vil_logit_dense", "vil_tri_dense",
)
TEXT_BERT_PREFIXES = ("bert.embeddings.", "bert.encoder.layer_")

Schedule = Callable[[int], np.float32]


def warmup_linear_schedule(base_lr: float, total_steps: int,
                           warmup_proportion: float) -> Schedule:
    """pytorch_transformers ``WarmupLinearSchedule`` with a float warmup
    threshold: step/max(1, w) below w, then max(0, (T-step)/max(1, T-w))."""
    warmup = float(total_steps * warmup_proportion)
    f32 = np.float32

    inv_warmup = f32(1.0) / f32(max(warmup, 1.0))
    inv_decay = f32(1.0) / f32(max(total_steps - warmup, 1.0))

    def fn(step):
        step = f32(step)
        if step < f32(warmup):
            frac = step * inv_warmup
        else:
            frac = max((f32(total_steps) - step) * inv_decay, f32(0.0))
        return f32(base_lr) * frac

    return fn


def warmup_constant_schedule(base_lr: float, total_steps: int,
                             warmup_proportion: float) -> Schedule:
    """pytorch_transformers ``WarmupConstantSchedule``: ramp, then hold."""
    warmup = float(total_steps * warmup_proportion)
    f32 = np.float32

    inv_warmup = f32(1.0) / f32(max(warmup, 1.0))

    def fn(step):
        step = f32(step)
        frac = step * inv_warmup if step < f32(warmup) else f32(1.0)
        return f32(base_lr) * frac

    return fn


def make_schedule(cfg: OptimizerConfig, base_lr: float, total_steps: int) -> Schedule:
    if cfg.schedule == "warmup_linear":
        return warmup_linear_schedule(base_lr, total_steps, cfg.warmup_proportion)
    if cfg.schedule == "warmup_constant":
        return warmup_constant_schedule(base_lr, total_steps, cfg.warmup_proportion)
    if cfg.schedule == "constant":
        return lambda step: np.float32(base_lr)
    raise NotImplementedError(
        f"schedule {cfg.schedule!r} is not ported yet: the epoch-level schedules "
        f"come with the multi-task trainer (ROADMAP A9)")


def flax_path(name: str) -> str:
    """The flax param path of a port parameter name."""
    path = _to_flax_key(name)
    if path is None:
        raise ValueError(f"parameter {name!r} has no flax path")
    return path


def decay_mask(names: Iterable[str]) -> Dict[str, bool]:
    """``_decay_mask``: weight decay unless the flax path contains a
    NO_DECAY substring."""
    return {n: not any(s in flax_path(n) for s in NO_DECAY_SUBSTRINGS) for n in names}


def label_params(
    names: Iterable[str],
    *,
    freeze_prefix="",
    head_lr: Optional[float] = None,
    pretrained_lr_scale: float = 1.0,
    vision_scratch: bool = False,
) -> Dict[str, str]:
    """``label_params``: "frozen" | "head" | "pretrained_scaled" | "base" per
    parameter, by flax-path prefix."""
    if isinstance(freeze_prefix, str):
        prefixes = (freeze_prefix,) if freeze_prefix else ()
    else:
        prefixes = tuple(fp for fp in freeze_prefix if fp)

    def label(p: str) -> str:
        if prefixes and p.startswith(prefixes):
            return "frozen"
        if head_lr is not None and any(p.startswith(h) for h in HEAD_PREFIXES):
            return "head"
        if vision_scratch and not p.startswith(TEXT_BERT_PREFIXES):
            return "head"
        if pretrained_lr_scale != 1.0 and p.startswith("bert"):
            return "pretrained_scaled"
        return "base"

    return {n: label(flax_path(n)) for n in names}


class AdamState(NamedTuple):
    count: int                     # updates taken, shared by every parameter
    mu: Dict[str, torch.Tensor]    # fp32 first moments
    nu: Dict[str, torch.Tensor]    # fp32 second moments


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (``optax.global_norm``)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


class ReferenceAdamW:
    """``reference_adamw`` + optional ``clip_by_global_norm``, over a
    {name: parameter} mapping. ``step(grads)`` applies one update in place;
    the state (count, fp32 moments) is in ``state``."""

    def __init__(self, cfg: OptimizerConfig, params: Mapping[str, torch.Tensor], *,
                 ratios: Mapping[str, float], schedule: Schedule, step_offset: int = 0):
        if cfg.first_moment_dtype != "float32" or cfg.second_moment_dtype != "float32":
            raise NotImplementedError(
                "bf16 Adam moments come with the multi-task slice (ROADMAP A5)")
        self.cfg = cfg
        self.params = dict(params)
        self.schedule = schedule
        self.step_offset = step_offset
        decay = decay_mask(self.params)
        #: participating (not frozen) parameters grouped by (ratio, decayed)
        self.groups: Dict[Tuple[float, bool], List[str]] = {}
        for n in self.params:
            if ratios[n] != 0.0:
                self.groups.setdefault((ratios[n], decay[n]), []).append(n)
        self.state = AdamState(
            0,
            {n: torch.zeros_like(p, dtype=torch.float32) for n, p in self.params.items()},
            {n: torch.zeros_like(p, dtype=torch.float32) for n, p in self.params.items()},
        )

    def lr(self, count: int) -> np.float32:
        return self.schedule(count + self.step_offset)

    @torch.no_grad()
    def step(self, grads: Mapping[str, torch.Tensor]) -> None:
        cfg = self.cfg
        b1, b2, eps, wd = cfg.beta1, cfg.beta2, cfg.eps, cfg.weight_decay
        if cfg.grad_clip_norm:
            gs = list(grads.values())
            norm = global_norm(gs)
            coef = torch.where(norm < cfg.grad_clip_norm, torch.ones_like(norm),
                               cfg.grad_clip_norm / norm)
            grads = dict(zip(grads, torch._foreach_mul(gs, coef)))
        count, mu, nu = self.state
        lr_t = self.lr(count)
        count += 1
        if cfg.correct_bias:
            t = np.float32(count)
            scale = float(np.sqrt(np.float32(1.0) - np.float32(b2) ** t)
                          / (np.float32(1.0) - np.float32(b1) ** t))
        else:
            scale = 1.0
        for (ratio, decayed), names in self.groups.items():
            g = [grads[n].float() for n in names]
            m = [mu[n] for n in names]
            v = [nu[n] for n in names]
            p = [self.params[n] for n in names]
            torch._foreach_mul_(m, b1)
            torch._foreach_add_(m, torch._foreach_mul(g, 1.0 - b1))
            torch._foreach_mul_(v, b2)
            torch._foreach_add_(v, torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - b2))
            denom = torch._foreach_sqrt(v)
            torch._foreach_add_(denom, eps)
            u = torch._foreach_mul(m, scale)
            torch._foreach_div_(u, denom)
            if wd and decayed:
                torch._foreach_add_(u, torch._foreach_mul([x.float() for x in p], wd))
            torch._foreach_mul_(u, float(np.float32(-lr_t) * np.float32(ratio)))
            torch._foreach_add_(p, u)
        self.state = AdamState(count, mu, nu)


def build_optimizer(
    cfg: OptimizerConfig,
    params: Mapping[str, torch.Tensor],
    total_steps: int,
    *,
    freeze_prefix="",
    step_offset: int = 0,
) -> Tuple[ReferenceAdamW, Schedule]:
    """``build_optimizer`` for adamw with an internal schedule: returns the
    optimizer and its schedule function (for logging)."""
    if cfg.name != "adamw":
        raise NotImplementedError(f"optimizer {cfg.name!r} is not ported yet (ROADMAP A5)")
    if cfg.vision_scratch and cfg.head_lr is None:
        raise ValueError("vision_scratch trains the fresh vision weights at head_lr: set head_lr")
    labels = label_params(params, freeze_prefix=freeze_prefix, head_lr=cfg.head_lr,
                          pretrained_lr_scale=cfg.pretrained_lr_scale,
                          vision_scratch=cfg.vision_scratch)
    ratio_of = {
        "base": 1.0,
        "head": cfg.head_lr / cfg.learning_rate if cfg.head_lr is not None else 1.0,
        "pretrained_scaled": cfg.pretrained_lr_scale,
        "frozen": 0.0,
    }
    schedule = make_schedule(cfg, cfg.learning_rate, total_steps)
    ratios = {n: ratio_of[lb] for n, lb in labels.items()}
    opt = ReferenceAdamW(cfg, params, ratios=ratios, schedule=schedule,
                         step_offset=step_offset)
    return opt, schedule

