"""Losses and the optimizer of the plain reference.

Pretraining (train_concap.py with BertForMultiModalPreTraining): masked-LM
cross-entropy over the labelled positions, the masked-region KL against the
detector's class distribution (visual target 0) over the masked regions,
the alignment cross-entropy; their sum. ``lm_gather`` K scores the first K
labelled positions of each row only.

AdamW is pytorch_transformers' (the reference's optimizer): moments in
float32, eps added to sqrt(v), the bias correction folded into the step
size, then decoupled weight decay on the updated parameter; no decay on
biases and ``LayerNorm.weight``.
"""

from __future__ import annotations

import math
from typing import Iterable, Mapping, Optional

import torch
import torch.nn.functional as F


def first_masked(labels: torch.Tensor, k: int):
    """(positions, labels) of the first k labelled positions of each row
    (then unlabelled ones, labelled -1)."""
    masked = labels != -1
    order = torch.sort((~masked).int(), dim=1, stable=True).indices[:, :k]
    return order, torch.where(masked.gather(1, order), labels.gather(1, order), -1)


def ce_ignore(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    valid = labels != -1
    nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]).float(),
                          torch.where(valid, labels, 0).reshape(-1).long(), reduction="none")
    return (nll * valid.reshape(-1)).sum() / valid.sum().clamp_min(1)


def region_kl(scores_v: torch.Tensor, image_label: torch.Tensor,
              image_target: torch.Tensor) -> torch.Tensor:
    """KL(target || softmax(score)) summed over classes, mean over masked
    regions; row 0 of the scores (the global feature) has no label."""
    logp = torch.log_softmax(scores_v[:, 1:].float(), dim=-1)
    t = image_target.float()
    kl = torch.where(t > 0, t * (torch.log(t.clamp_min(1e-30)) - logp), 0.0)
    masked = (image_label == 1).float()
    return (kl.sum(-1) * masked).sum() / masked.sum().clamp_min(1)


def pretrain_loss(model, batch: Mapping[str, torch.Tensor], lm_gather: int) -> torch.Tensor:
    lm_pos, lm_labels = None, batch["lm_label_ids"]
    if lm_gather:
        lm_pos, lm_labels = first_masked(lm_labels, lm_gather)
    scores_t, scores_v, nsp = model(
        batch["input_ids"], batch["image_feat"], batch["image_loc"], batch["segment_ids"],
        batch["input_mask"], batch["image_mask"], lm_positions=lm_pos)
    return (ce_ignore(scores_t, lm_labels)
            + region_kl(scores_v, batch["image_label"], batch["image_target"])
            + ce_ignore(nsp, batch["is_next"]))


def decayed(name: str) -> bool:
    """No decay on biases and LayerNorm scales: by name, and the LayerNorm
    inside a task head's classifier (``logit_fc.2``), as the JAX recipe
    the program follows reads it (the published rule, by torch name, decays
    that one)."""
    return not ("bias" in name or "LayerNorm.weight" in name
                or name.endswith("logit_fc.2.weight"))


class AdamW:
    """pytorch_transformers.AdamW over {name: parameter}. A step updates the
    names given (a task's participating parameters; a name without a
    gradient steps on zeros), each at ``lr`` times its ``ratios`` entry."""

    def __init__(self, params: Mapping[str, torch.Tensor], *, lr: float, betas=(0.9, 0.999),
                 eps: float = 1e-6, weight_decay: float = 0.0, correct_bias: bool = True):
        self.params = dict(params)
        self.lr, self.betas, self.eps = lr, betas, eps
        self.weight_decay, self.correct_bias = weight_decay, correct_bias
        self.m = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Mapping[str, torch.Tensor], lr: Optional[float] = None,
             names: Optional[Iterable[str]] = None,
             ratios: Optional[Mapping[str, float]] = None) -> None:
        b1, b2 = self.betas
        self.t += 1
        correction = 1.0
        if self.correct_bias:
            correction = math.sqrt(1.0 - b2 ** self.t) / (1.0 - b1 ** self.t)
        for n in (self.params if names is None else names):
            rate = (self.lr if lr is None else lr) * (ratios or {}).get(n, 1.0)
            p, m, v = self.params[n], self.m[n], self.v[n]
            g = grads[n].float() if grads.get(n) is not None else torch.zeros_like(p)
            m.mul_(b1).add_(g, alpha=1.0 - b1)
            v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            p.addcdiv_(m, v.sqrt().add_(self.eps), value=-rate * correction)
            if self.weight_decay and decayed(n):
                p.add_(p, alpha=-rate * self.weight_decay)
