"""Per-task losses and scores, unreduced (one value per sample).

Counterpart of ``vilbert_tpu/train/losses.py::task_loss_and_score_per_sample``
and ``compute_score_with_logits_per_sample`` (reference task_utils.py:325-374,
:618-623). Means of these vectors are the reference's batch loss and score;
the evaluator sums them over the valid rows of padded batches.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """-log softmax(logits)[label] via logsumexp + gather."""
    lse = torch.logsumexp(logits.float(), dim=-1)
    gathered = logits.gather(-1, labels.long()[..., None])[..., 0]
    return lse - gathered.float()


def _bce(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross-entropy with logits (stable form)."""
    t = target.float()
    return logits.clamp_min(0) - logits * t + torch.log1p(torch.exp(-logits.abs()))


def compute_score_with_logits_per_sample(
    logits: torch.Tensor, targets: torch.Tensor
) -> torch.Tensor:
    """Per-sample soft-target mass at the argmax."""
    pred = logits.float().argmax(-1)
    return targets.gather(-1, pred[..., None])[..., 0]


def task_loss_and_score_per_sample(
    task_type: str, logits: torch.Tensor, target: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """([B] loss, [B] score) for one task head type."""
    logits = logits.float()
    if task_type in ("VL-classifier", "VL-classifier-GQA"):
        # reduced loss = mean(bce) * C  =>  per-sample = mean_C(bce) * C
        loss = _bce(logits, target).mean(-1) * target.shape[1]
        return loss, compute_score_with_logits_per_sample(logits, target)
    if task_type in ("VL-logit", "VL-binary-classifier", "VL-tri-classifier"):
        score = (logits.argmax(-1) == target).float()
        return _nll(logits, target), score
    if task_type in ("V-logit", "V-logit-mc"):
        t = target.squeeze(-1) if target.dim() == 3 else target
        lg = logits.squeeze(-1) if logits.dim() == 3 else logits
        loss = _bce(lg, t).mean(-1) * t.shape[1]
        gathered = t.gather(1, lg.argmax(-1)[:, None])[:, 0]
        return loss, (gathered > 0.5).float()
    raise ValueError(f"unknown task type {task_type}")
