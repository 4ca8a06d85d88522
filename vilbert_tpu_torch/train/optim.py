"""The optimizer: AdamW with pytorch_transformers semantics, its schedules
and parameter groups.

Counterpart of ``vilbert_tpu/train/optim.py`` (which imports jax and optax,
so it is mirrored here, not imported): the warmup schedules, the
epoch-level ``HostLRScheduler`` of the multi-task trainer (a verbatim copy:
it is plain Python), ``_decay_mask`` and ``label_params``,
``task_update_mask``, ``reference_adamw`` and ``build_optimizer``. Its
update is

    p <- p - lr_t * ratio_p * (scale * m / (sqrt(v) + eps) + wd_p * p),
    scale = sqrt(1 - b2^t) / (1 - b1^t)   (correct_bias)

which is NOT ``torch.optim.AdamW``: eps is added before the bias
correction, weight decay joins the update, one step count is shared by all
parameters (ROADMAP C3), the schedule is read at ``count + step_offset``,
frozen parameters keep their moments, and the moments accumulate in fp32.

With ``external_lr`` the optimizer has no schedule: the per-group ratios
are relative to a unit base and ``step(grads, lr=...)`` takes the learning
rate from the host, once per round-robin iteration (the multi-task
trainer). A participation mask (``task_update_mask``) limits a step to the
parameters in a task's backward graph: the others get no moment update and
no weight decay, as torch skips parameters whose ``.grad`` is None. One
optimizer, and so one state, serves every task's mask.

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

from typing import Callable, Dict, Iterable, List, Mapping, NamedTuple, Optional, Tuple, Union

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


#: schedules that compose a per-iteration warmup with an epoch-level scheduler
#: (reference train_tasks.py:440-457); they carry host state and therefore
#: require the external-lr step (multi-task trainer).
EPOCH_SCHEDULES = ("mannul", "automatic", "cosine", "cosine_warm")

#: epochs at whose END the "mannul" scheduler multiplies the LR by 0.2
#: (reference lr_reduce_list = [5, 7]: the ×0.2**k factor applies from the
#: start of epoch 5 resp. 7, train_tasks.py:439,:604-605)
LR_REDUCE_EPOCHS = (5, 7)


class HostLRScheduler:
    """The reference train_tasks.py LR family, evaluated host-side.

    Reproduces the composition of two torch schedulers over one optimizer
    (train_tasks.py:431-457):

    - every iteration, WarmupConstantSchedule ramps 0→base over the warmup
      then holds (it stops stepping after warmup, train_tasks.py:552-556);
    - "mannul": LambdaLR ×0.2**|{5,7} ≤ epoch| stepped at epoch end
      (train_tasks.py:604-605) — the reference DEFAULT;
    - "automatic": ReduceLROnPlateau(mode=max, factor=0.2, patience=1,
      cooldown=1, threshold=0.001) stepped on the summed val scores at epoch
      end (train_tasks.py:595-597);
    - "cosine"/"cosine_warm": CosineAnnealing(T=total_steps) stepped once per
      iteration after warmup (train_tasks.py:571-573), closed form.

    Callable(step) → float LR; ``on_epoch_end(epoch, val_score_sum)`` applies
    the epoch-level transition. State is checkpointable via state_dict().
    """

    def __init__(self, kind: str, base_lr: float, total_steps: int,
                 warmup_proportion: float):
        assert kind in EPOCH_SCHEDULES, kind
        self.kind = kind
        self.base_lr = base_lr
        self.total_steps = max(total_steps, 1)
        # float threshold, exactly as the reference passes it
        # (warmpu_steps = args.warmup_proportion * num_train_optimization_steps,
        # train_tasks.py:430)
        self.warmup_steps = float(self.total_steps * warmup_proportion)
        self.decay_factor = 1.0
        # ReduceLROnPlateau state (torch defaults: threshold_mode="rel")
        self.plateau_best = -float("inf")
        self.plateau_bad = 0
        self.plateau_cooldown = 0

    def _warm(self, step: float) -> float:
        return min(step / max(self.warmup_steps, 1.0), 1.0)

    def _tail(self, step: float) -> float:
        import math

        if self.kind in ("mannul", "automatic"):
            return self.decay_factor
        # cosine family: the annealer steps once per iteration past warmup
        # with T_max/T_0 = total_steps (train_tasks.py:444-452,:571-573) — so
        # t lags ``step`` by the warmup and the curve never quite reaches 0
        t = max(step - self.warmup_steps, 0.0)
        T = float(self.total_steps)
        if self.kind == "cosine_warm":
            t = t % T
        return 0.5 * (1.0 + math.cos(math.pi * min(t / T, 1.0)))

    def __call__(self, step) -> float:
        step = float(step)
        if step == 0.0 and self.kind != "automatic":
            # Construction-order quirk, verified against torch: the epoch
            # scheduler (LambdaLR/CosineAnnealingLR) is constructed AFTER the
            # warmup scheduler (train_tasks.py:431-457) and _LRScheduler
            # construction re-applies lr = initial_lr * lambda(0), clobbering
            # the warmup's 0 — so the very FIRST update of training runs at
            # the full base LR, not at warm(0)=0. ReduceLROnPlateau
            # ("automatic") sets nothing at construction, so there the 0
            # survives.
            return self.base_lr * self._tail(0.0)
        return self.base_lr * self._warm(step) * self._tail(step)

    def mid_iteration(self, step) -> float:
        """LR seen by the non-first tasks of iteration ``step``: the warmup
        scheduler has already stepped mid-iteration after the first task's
        optimizer.step (train_tasks.py:548-556), while the epoch/cosine
        scheduler steps only at iteration/epoch end (:571-573,:595-605)."""
        step = float(step)
        return self.base_lr * self._warm(step + 1.0) * self._tail(step)

    def on_epoch_end(self, epoch: int, val_score_sum: Optional[float] = None):
        if self.kind == "mannul":
            nxt = epoch + 1
            self.decay_factor = 0.2 ** sum(1 for r in LR_REDUCE_EPOCHS if r <= nxt)
        elif self.kind == "automatic" and val_score_sum is not None:
            a = float(val_score_sum)
            if a > self.plateau_best * (1.0 + 0.001):
                self.plateau_best = a
                self.plateau_bad = 0
            else:
                self.plateau_bad += 1
            if self.plateau_cooldown > 0:
                self.plateau_cooldown -= 1
                self.plateau_bad = 0
            if self.plateau_bad > 1:  # patience=1
                self.decay_factor *= 0.2
                self.plateau_cooldown = 1  # cooldown=1
                self.plateau_bad = 0

    def state_dict(self) -> Dict[str, float]:
        return {k: getattr(self, k) for k in
                ("decay_factor", "plateau_best", "plateau_bad",
                 "plateau_cooldown")}

    def load_state_dict(self, d: Mapping[str, float]) -> None:
        for k, v in d.items():
            setattr(self, k, v)


def make_schedule(cfg: OptimizerConfig, base_lr: float,
                  total_steps: int) -> Union[Schedule, HostLRScheduler]:
    if cfg.schedule == "warmup_linear":
        return warmup_linear_schedule(base_lr, total_steps, cfg.warmup_proportion)
    if cfg.schedule == "warmup_constant":
        return warmup_constant_schedule(base_lr, total_steps, cfg.warmup_proportion)
    if cfg.schedule == "constant":
        return lambda step: np.float32(base_lr)
    if cfg.schedule in EPOCH_SCHEDULES:
        return HostLRScheduler(cfg.schedule, base_lr, total_steps, cfg.warmup_proportion)
    raise ValueError(cfg.schedule)


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


#: top-level head modules of ViLBERTForVLTasks (flax param keys). "cls" (the
#: pretraining heads) is computed in some forwards but consumed by no task
#: loss, so it participates in NO task's update.
ALL_HEAD_MODULES = (
    "vil_prediction", "vil_prediction_gqa", "vil_binary_prediction",
    "vil_logit_dense", "vil_tri_dense", "vision_logit_dense",
    "linguisic_logit_dense", "cls",
)

#: the head module each task type backpropagates through
HEAD_MODULE_FOR_TYPE = {
    "VL-classifier": "vil_prediction",
    "VL-classifier-GQA": "vil_prediction_gqa",
    "VL-logit": "vil_logit_dense",
    "V-logit": "vision_logit_dense",
    "V-logit-mc": "vision_logit_dense",
    "VL-binary-classifier": "vil_binary_prediction",
    "VL-tri-classifier": "vil_tri_dense",
}


def task_update_mask(names: Iterable[str], task_type: str) -> Dict[str, bool]:
    """Which parameters take part in a task's optimizer step: not the other
    tasks' heads, not ``cls``, and for the V-logit types not the poolers
    (their loss reads sequence_v only). The JAX ``task_update_mask``, by
    flax path."""
    used = HEAD_MODULE_FOR_TYPE[task_type]
    pooled_unused = task_type in ("V-logit", "V-logit-mc")

    def mask(p: str) -> bool:
        top = p.split(".", 1)[0]
        if top in ALL_HEAD_MODULES:
            return top == used
        if pooled_unused and p.startswith(("bert.t_pooler", "bert.v_pooler")):
            return False
        return True

    return {n: mask(flax_path(n)) for n in names}


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
    the state (count, fp32 moments) is in ``state``. ``schedule=None`` is
    the external-lr mode: ``step(grads, lr=...)``. ``update_mask`` is the
    default participation mask; ``step(..., mask=...)`` overrides it."""

    def __init__(self, cfg: OptimizerConfig, params: Mapping[str, torch.Tensor], *,
                 ratios: Mapping[str, float], schedule: Optional[Schedule],
                 step_offset: int = 0, update_mask: Optional[Mapping[str, bool]] = None):
        if cfg.first_moment_dtype != "float32" or cfg.second_moment_dtype != "float32":
            raise NotImplementedError(
                "bf16 Adam moments are not ported yet (ROADMAP A5)")
        self.cfg = cfg
        self.params = dict(params)
        self.schedule = schedule
        self.step_offset = step_offset
        self.update_mask = update_mask
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
    def step(self, grads: Mapping[str, torch.Tensor], *, lr: Optional[float] = None,
             mask: Optional[Mapping[str, bool]] = None) -> None:
        """One update from ``grads`` (every participating name; others may be
        left out). ``lr`` is the host learning rate in the external-lr mode
        and must be None otherwise."""
        if (lr is None) != (self.schedule is not None):
            raise ValueError("an external-lr optimizer takes step(grads, lr=...); "
                             "one with a schedule takes no lr")
        mask = self.update_mask if mask is None else mask
        cfg = self.cfg
        b1, b2, eps, wd = cfg.beta1, cfg.beta2, cfg.eps, cfg.weight_decay
        if cfg.grad_clip_norm:
            gs = list(grads.values())
            norm = global_norm(gs)
            coef = torch.where(norm < cfg.grad_clip_norm, torch.ones_like(norm),
                               cfg.grad_clip_norm / norm)
            grads = dict(zip(grads, torch._foreach_mul(gs, coef)))
        count, mu, nu = self.state
        lr_t = self.lr(count) if lr is None else np.float32(lr)
        count += 1
        if cfg.correct_bias:
            t = np.float32(count)
            scale = float(np.sqrt(np.float32(1.0) - np.float32(b2) ** t)
                          / (np.float32(1.0) - np.float32(b1) ** t))
        else:
            scale = 1.0
        for (ratio, decayed), names in self.groups.items():
            if mask is not None:
                names = [n for n in names if mask[n]]
                if not names:
                    continue
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
    external_lr: bool = False,
    update_mask: Optional[Mapping[str, bool]] = None,
) -> Tuple[ReferenceAdamW, Union[Schedule, HostLRScheduler]]:
    """``build_optimizer`` for adamw: returns the optimizer and its schedule
    (for logging, and with ``external_lr`` for the caller to drive: the
    optimizer then has no schedule and unit-base group ratios).
    ``update_mask`` is the optimizer's default participation mask."""
    if cfg.name != "adamw":
        raise NotImplementedError(f"optimizer {cfg.name!r} is not ported yet (ROADMAP A5)")
    if cfg.schedule in EPOCH_SCHEDULES and not external_lr:
        raise ValueError(
            f"schedule {cfg.schedule!r} carries host state (epoch-level LR transitions) "
            "and requires external_lr=True")
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
    opt = ReferenceAdamW(cfg, params, ratios=ratios,
                         schedule=None if external_lr else schedule,
                         step_offset=step_offset, update_mask=update_mask)
    return opt, schedule

