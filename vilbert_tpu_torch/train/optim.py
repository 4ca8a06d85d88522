"""The optimizer: AdamW with pytorch_transformers semantics, its schedules
and parameter groups.

Counterpart of ``vilbert_tpu/train/optim.py`` (which imports jax and optax,
so it is mirrored here, not imported): the warmup schedules, the
epoch-level ``HostLRScheduler`` of the multi-task trainer (a verbatim copy:
it is plain Python), ``_decay_mask`` and ``label_params``,
``task_update_mask``, ``reference_adamw`` (``ReferenceAdamW``), RAdam
(``ReferenceRAdam``) and ``build_optimizer``. The AdamW update is

    p <- p - lr_t * ratio_p * (scale * m / (sqrt(v) + eps) + wd_p * p),
    scale = sqrt(1 - b2^t) / (1 - b1^t)   (correct_bias)

which is NOT ``torch.optim.AdamW``: eps is added before the bias
correction, weight decay joins the update, one step count is shared by all
parameters (ROADMAP C3), the schedule is read at ``count + step_offset``,
frozen parameters keep their moments, and the moments accumulate in fp32:
the gradient is widened before ``(1 - b1) * g``, and with
``first_moment_dtype``/``second_moment_dtype`` "bfloat16" the moments are
stored in bf16, rounded once a step and only where a parameter takes part.

RAdam is ``optax.radam`` under ``optax.multi_transform``, as the JAX
``build_optimizer(name="radam")`` chains it: coupled weight decay
(``add_decayed_weights`` before the rectified moments, so the decay enters
them), one state and one step count per label ("base", "head",
"pretrained_scaled"; "frozen" is set to zero), and no participation mask:
a parameter outside a step's graph steps on a zero gradient.

With ``external_lr`` the optimizer has no schedule: the per-group ratios
are relative to a unit base and ``step(grads, lr=...)`` takes the learning
rate from the host, once per round-robin iteration (the multi-task
trainer). A participation mask (``task_update_mask``) limits a step to the
parameters in a task's backward graph: the others get no moment update and
no weight decay, as torch skips parameters whose ``.grad`` is None. One
optimizer, and so one state, serves every task's mask.

With ``shard_(shards, index, parts)`` (the model axis of
``parallel.mesh``) an optimizer holds and updates slice ``index`` of
``parts`` of each parameter named in ``shards``, along the dim given
there: its ``params`` are views of those slices, its moments have their
shapes, and ``step`` still takes the full gradients, clips them by their
global norm and then slices them. The update of an element is the
replicated one's, so the slices gathered are the replicated update bit for
bit. A sharded state has no ``state_dict`` (no checkpoint of it).

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

from typing import Any, Callable, Dict, Iterable, List, Mapping, NamedTuple, Optional, Tuple, Union

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


def flax_path(name: str, family: str = "vilbert") -> str:
    """The flax param path of a port parameter name of ``family``
    (``core.weights``)."""
    path = _to_flax_key(name, family)
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
    family: str = "vilbert",
) -> Dict[str, str]:
    """``label_params``: "frozen" | "head" | "pretrained_scaled" | "base" per
    parameter, by flax-path prefix (the paths of ``family``)."""
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

    return {n: label(flax_path(n, family)) for n in names}


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
    mu: Dict[str, torch.Tensor]    # first moments, in cfg.first_moment_dtype
    nu: Dict[str, torch.Tensor]    # second moments, in cfg.second_moment_dtype


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (``optax.global_norm``).
    fp32 for fp32 tensors; bf16 tensors, as optax reduces them, give a bf16
    norm: each tensor's sum of squares (accumulated in fp32) is rounded to
    bf16, and so is their total."""
    norms = torch.stack(torch._foreach_norm(tensors, dtype=torch.float32))
    if all(t.dtype == torch.bfloat16 for t in tensors):
        total = norms.square().to(torch.bfloat16).float().sum()
        return total.to(torch.bfloat16).sqrt()
    return torch.linalg.vector_norm(norms)


def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: Optional[float]
                        ) -> Dict[str, torch.Tensor]:
    """``optax.clip_by_global_norm``: every gradient t becomes t / norm *
    max_norm where the global norm reaches max_norm (no clip for None or 0),
    in the gradients' dtype; decided on the device."""
    if not max_norm:
        return dict(grads)
    gs = list(grads.values())
    norm = global_norm(gs)
    keep = norm < max_norm
    one = torch.ones_like(norm)
    out = torch._foreach_div(gs, torch.where(keep, one, norm))
    torch._foreach_mul_(out, torch.where(keep, one, torch.full_like(norm, max_norm)))
    return dict(zip(grads, out))


def _slice(t: torch.Tensor, dim: int, index: int, parts: int) -> torch.Tensor:
    """Slice ``index`` of ``parts`` equal slices of ``t`` along ``dim`` (a view)."""
    n = t.shape[dim] // parts
    return t.narrow(dim, index * n, n)


class _Sharding:
    """The model-axis slices an optimizer holds (module docstring)."""

    shards: Dict[str, Tuple[int, int, int]] = {}

    def _shard_params(self, shards: Mapping[str, int], index: int, parts: int) -> None:
        if self.shards:
            raise ValueError("the optimizer is sharded already")
        for n, dim in shards.items():
            if self.params[n].shape[dim] % parts:
                raise ValueError(f"{n}: dim {dim} of {tuple(self.params[n].shape)} does not "
                                 f"split into {parts}")
        self.shards = {n: (dim, index, parts) for n, dim in shards.items()}
        for n, spec in self.shards.items():
            self.params[n] = _slice(self.params[n], *spec)

    def _shard_moments(self, moments: Dict[str, torch.Tensor]) -> None:
        for n, spec in self.shards.items():
            if n in moments:
                moments[n] = _slice(moments[n], *spec).clone()

    def _sliced(self, grads: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The gradients of the slices this optimizer holds."""
        return {n: _slice(g, *self.shards[n]) if n in self.shards else g
                for n, g in grads.items()}

    def _refuse_sharded_state(self) -> None:
        if self.shards:
            raise ValueError(
                "a model-sharded optimizer state has no state_dict: checkpoints and "
                "replicate() take a replicated state (the JAX dry run checkpoints none either)")


class ReferenceAdamW(_Sharding):
    """``reference_adamw`` + optional ``clip_by_global_norm``, over a
    {name: parameter} mapping. ``step(grads)`` applies one update in place;
    the state (count, moments in their storage dtypes) is in ``state``.
    ``schedule=None`` is the external-lr mode: ``step(grads, lr=...)``.
    ``update_mask`` is the default participation mask; ``step(...,
    mask=...)`` overrides it."""

    def __init__(self, cfg: OptimizerConfig, params: Mapping[str, torch.Tensor], *,
                 ratios: Mapping[str, float], schedule: Optional[Schedule],
                 step_offset: int = 0, update_mask: Optional[Mapping[str, bool]] = None):
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
        mdt, vdt = (getattr(torch, d) for d in (cfg.first_moment_dtype, cfg.second_moment_dtype))
        self.state = AdamState(
            0,
            {n: torch.zeros_like(p, dtype=mdt) for n, p in self.params.items()},
            {n: torch.zeros_like(p, dtype=vdt) for n, p in self.params.items()},
        )

    def lr(self, count: int) -> np.float32:
        return self.schedule(count + self.step_offset)

    def shard_(self, shards: Mapping[str, int], index: int, parts: int) -> None:
        """Hold slice ``index`` of ``parts`` of each parameter of ``shards``
        ({name: dim}) and its moments alone (module docstring)."""
        self._shard_params(shards, index, parts)
        for moments in (self.state.mu, self.state.nu):
            self._shard_moments(moments)

    def state_dict(self) -> Dict[str, Any]:
        """{"count", "mu", "nu"}: the shared count and the moments (live
        tensors, in their storage dtypes)."""
        self._refuse_sharded_state()
        count, mu, nu = self.state
        return {"count": count, "mu": mu, "nu": nu}

    @torch.no_grad()
    def load_state_dict(self, state: Mapping[str, Any]) -> None:
        """Copy a ``state_dict`` of the same names and dtypes into the state."""
        for name in ("mu", "nu"):
            _copy_into(getattr(self.state, name), state[name], name)
        self.state = AdamState(int(state["count"]), self.state.mu, self.state.nu)

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
        grads = self._sliced(clip_by_global_norm(grads, cfg.grad_clip_norm))
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
            # fp32 moments are updated in place; bf16 ones through fp32
            # copies, rounded back below
            m = [mu[n].float() for n in names]
            v = [nu[n].float() for n in names]
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
            for store, acc in ((mu, m), (nu, v)):  # round to the storage dtype
                if acc[0].dtype != store[names[0]].dtype:
                    torch._foreach_copy_([store[n] for n in names], acc)
        self.state = AdamState(count, mu, nu)


def _copy_into(dst: Dict[str, torch.Tensor], src: Mapping[str, torch.Tensor], what: str) -> None:
    if set(dst) != set(src):
        raise ValueError(f"{what}: the state names differ: {sorted(set(dst) ^ set(src))[:5]}")
    for n, t in dst.items():
        if src[n].dtype != t.dtype or src[n].shape != t.shape:
            raise ValueError(f"{what}.{n}: {src[n].dtype} {tuple(src[n].shape)} into "
                             f"{t.dtype} {tuple(t.shape)}")
        t.copy_(src[n])


class RAdamGroupState(NamedTuple):
    count: int                     # updates of this label
    mu: Dict[str, torch.Tensor]    # fp32 first moments of the label's parameters
    nu: Dict[str, torch.Tensor]    # fp32 second moments


class ReferenceRAdam(_Sharding):
    """``build_optimizer(name="radam")`` over a {name: parameter} mapping:
    optional ``clip_by_global_norm``, then per label
    ``chain(add_decayed_weights(wd, decay mask), scale_by_radam,
    scale_by_learning_rate(group lr))``, with optax's arithmetic (rho_inf,
    the threshold 5.0, the un-rectified branch, eps_root 0, fp32 scalars).

    ``schedules`` maps each label to its schedule (the internal mode: the
    label's lr at ``count + step_offset``) or, with ``external_lr``, to its
    constant ratio to cfg.learning_rate, and ``step(grads, lr=...)`` then
    multiplies by the host's learning rate. The state is one
    ``RAdamGroupState`` a label, in ``state``."""

    def __init__(self, cfg: OptimizerConfig, params: Mapping[str, torch.Tensor], *,
                 labels: Mapping[str, str], schedules: Mapping[str, Any], external_lr: bool,
                 step_offset: int = 0):
        self.cfg = cfg
        self.params = dict(params)
        self.schedules = dict(schedules)
        self.external_lr = external_lr
        self.step_offset = step_offset
        self.update_mask = None  # every parameter of a label steps, on a zero gradient if unused
        self.decay = decay_mask(self.params)
        #: label -> its parameters' names, in parameter order
        self.labels: Dict[str, List[str]] = {}
        for n, lb in labels.items():
            if lb != "frozen":
                self.labels.setdefault(lb, []).append(n)
        self.state: Dict[str, RAdamGroupState] = {
            lb: RAdamGroupState(0, {n: torch.zeros_like(self.params[n]) for n in names},
                                {n: torch.zeros_like(self.params[n]) for n in names})
            for lb, names in self.labels.items()}

    def shard_(self, shards: Mapping[str, int], index: int, parts: int) -> None:
        """Hold slice ``index`` of ``parts`` of each parameter of ``shards``
        ({name: dim}) and its moments alone (module docstring)."""
        self._shard_params(shards, index, parts)
        for st in self.state.values():
            self._shard_moments(st.mu)
            self._shard_moments(st.nu)

    def state_dict(self) -> Dict[str, Any]:
        """{"groups": {label: {"count", "mu", "nu"}}} (live tensors)."""
        self._refuse_sharded_state()
        return {"groups": {lb: st._asdict() for lb, st in self.state.items()}}

    @torch.no_grad()
    def load_state_dict(self, state: Mapping[str, Any]) -> None:
        groups = state["groups"]
        if set(groups) != set(self.state):
            raise ValueError(f"radam labels {sorted(groups)} != {sorted(self.state)}")
        for lb, st in self.state.items():
            for name in ("mu", "nu"):
                _copy_into(getattr(st, name), groups[lb][name], f"{lb}.{name}")
            self.state[lb] = st._replace(count=int(groups[lb]["count"]))

    @torch.no_grad()
    def step(self, grads: Mapping[str, torch.Tensor], *, lr: Optional[float] = None,
             mask: Optional[Mapping[str, bool]] = None) -> None:
        """One update from ``grads`` (every parameter of a label); ``lr`` is
        the host learning rate with ``external_lr`` and None otherwise.
        ``mask`` must be None: optax's radam has no participation mask."""
        if (lr is None) == self.external_lr:
            raise ValueError("an external-lr optimizer takes step(grads, lr=...); "
                             "one with a schedule takes no lr")
        if mask is not None:
            raise ValueError("radam takes no update mask")
        cfg = self.cfg
        b1, b2, eps, wd = cfg.beta1, cfg.beta2, cfg.eps, cfg.weight_decay
        ro_inf = 2.0 / (1.0 - b2) - 1.0
        grads = self._sliced(clip_by_global_norm(grads, cfg.grad_clip_norm))
        for lb, names in self.labels.items():
            count, mu, nu = self.state[lb]
            p = [self.params[n] for n in names]
            g = [grads[n] for n in names]
            if wd:  # add_decayed_weights: g + wd * p on the decayed parameters
                g = [gi + wd * pi if self.decay[n] else gi for n, gi, pi in zip(names, g, p)]
            m = [mu[n] for n in names]
            v = [nu[n] for n in names]
            # update_moment: (1 - b) * g^order + b * moment
            torch._foreach_mul_(m, b1)
            torch._foreach_add_(m, torch._foreach_mul(g, 1.0 - b1))
            torch._foreach_mul_(v, b2)
            torch._foreach_add_(v, torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - b2))
            count += 1
            c = np.float32(count)
            b2t = np.float32(b2) ** c
            ro = np.float32(ro_inf) - np.float32(2 * count) * b2t / (np.float32(1.0) - b2t)
            m_hat = torch._foreach_div(m, float(np.float32(1.0) - np.float32(b1) ** c))
            if ro >= np.float32(5.0):
                r = np.sqrt((ro - np.float32(4.0)) * (ro - np.float32(2.0)) * np.float32(ro_inf)
                            / (np.float32((ro_inf - 4.0) * (ro_inf - 2.0)) * ro))
                v_hat = torch._foreach_div(v, float(np.float32(1.0) - b2t))
                u = torch._foreach_mul(m_hat, float(r))
                torch._foreach_div_(u, torch._foreach_add(torch._foreach_sqrt(v_hat), eps))
            else:
                u = m_hat
            if self.external_lr:  # scale(-ratio), then the host's lr
                torch._foreach_mul_(u, float(np.float32(-self.schedules[lb])))
                torch._foreach_mul_(u, float(np.float32(lr)))
            else:  # scale_by_schedule(-lr(count + step_offset)), before the increment
                torch._foreach_mul_(
                    u, float(-np.float32(self.schedules[lb](count - 1 + self.step_offset))))
            torch._foreach_add_(p, u)
            self.state[lb] = RAdamGroupState(count, mu, nu)


def build_optimizer(
    cfg: OptimizerConfig,
    params: Mapping[str, torch.Tensor],
    total_steps: int,
    *,
    freeze_prefix="",
    step_offset: int = 0,
    external_lr: bool = False,
    update_mask: Optional[Mapping[str, bool]] = None,
    family: str = "vilbert",
) -> Tuple[Union[ReferenceAdamW, ReferenceRAdam], Union[Schedule, HostLRScheduler]]:
    """``build_optimizer``: returns the optimizer (adamw or radam) and its
    schedule (for logging, and with ``external_lr`` for the caller to drive:
    the optimizer then has no schedule and unit-base group ratios).
    ``update_mask`` is adamw's default participation mask; ``family`` names
    the model family of the parameter names, whose flax paths the labels
    and ``freeze_prefix`` read."""
    if cfg.name not in ("adamw", "radam"):
        raise ValueError(cfg.name)
    if cfg.name == "radam" and update_mask is not None:
        raise ValueError("update_mask is only supported for adamw")
    if cfg.schedule in EPOCH_SCHEDULES and not external_lr:
        raise ValueError(
            f"schedule {cfg.schedule!r} carries host state (epoch-level LR transitions) "
            "and requires external_lr=True")
    if cfg.vision_scratch and cfg.head_lr is None:
        raise ValueError("vision_scratch trains the fresh vision weights at head_lr: set head_lr")
    labels = label_params(params, freeze_prefix=freeze_prefix, head_lr=cfg.head_lr,
                          pretrained_lr_scale=cfg.pretrained_lr_scale,
                          vision_scratch=cfg.vision_scratch, family=family)
    ratio_of = {
        "base": 1.0,
        "head": cfg.head_lr / cfg.learning_rate if cfg.head_lr is not None else 1.0,
        "pretrained_scaled": cfg.pretrained_lr_scale,
        "frozen": 0.0,
    }
    schedule = make_schedule(cfg, cfg.learning_rate, total_steps)
    if cfg.name == "radam":
        # each label its own schedule at its own lr (internal mode) or the
        # constant ratio lr / learning_rate (external mode), as group_lr
        group_lr = {"base": cfg.learning_rate,
                    "head": cfg.head_lr if cfg.head_lr is not None else cfg.learning_rate,
                    "pretrained_scaled": cfg.learning_rate * cfg.pretrained_lr_scale}
        schedules = {lb: lr / cfg.learning_rate if external_lr else
                     make_schedule(cfg, lr, total_steps) for lb, lr in group_lr.items()}
        opt = ReferenceRAdam(cfg, params, labels=labels, schedules=schedules,
                             external_lr=external_lr, step_offset=step_offset)
        return opt, schedule
    ratios = {n: ratio_of[lb] for n, lb in labels.items()}
    opt = ReferenceAdamW(cfg, params, ratios=ratios,
                         schedule=None if external_lr else schedule,
                         step_offset=step_offset, update_mask=update_mask)
    return opt, schedule

