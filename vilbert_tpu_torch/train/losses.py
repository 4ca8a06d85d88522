"""Pretraining losses, and per-task losses and scores.

Counterpart of ``vilbert_tpu/train/losses.py``: the three pretraining losses
(``pretrain_losses``: masked-LM cross-entropy with ignore index -1, the
masked-region loss for visual targets 0 (KL against the detector's soft
classes), 1 (feature MSE) and 2 (NCE against sampled negatives, drawn from
an explicit ``torch.Generator``), the alignment cross-entropy), all reduced
in fp32; the per-task losses and scores of training, ``task_loss_and_score``
over ``bce_with_logits``, ``cross_entropy`` and ``compute_score_with_logits``
(reference task_utils.py:325-374, :618-623); and their unreduced forms for
evaluation, ``task_loss_and_score_per_sample`` /
``compute_score_with_logits_per_sample``, whose means are the reference's
batch loss and score.

Data parallelism (a ``mesh`` of more than one data row): the JAX loss is
that of the global batch. The pretraining losses divide by counts of the
data (masked positions, masked regions), which differ between data rows,
so each rank divides its sum by the count summed over the data axis, times
the data size: the data rows' average is then the global loss, and so are
its gradients. NCE scores each rank's rows against the targets gathered
from every data row, with the global batch's negatives. The task losses are means
over equal shards and need neither. With one rank the arithmetic is the
single process's, bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from vilbert_tpu_torch.parallel.distributed import all_gather, global_sum


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """-log softmax(logits)[label] via logsumexp + gather."""
    lse = torch.logsumexp(logits.float(), dim=-1)
    gathered = logits.gather(-1, labels.long()[..., None])[..., 0]
    return lse - gathered.float()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE with integer labels (no ignore index)."""
    return _nll(logits, labels).mean()


def _sharded(mesh) -> bool:
    return mesh is not None and mesh.data_size > 1


def masked_mean(total: torch.Tensor, count: torch.Tensor, mesh=None) -> torch.Tensor:
    """``total / max(count, 1)`` over the batch; over a mesh of several
    data rows, this rank's share of the global batch's mean: ``total``
    times the data size over the count summed over the data axis."""
    if not _sharded(mesh):
        return total / count.clamp_min(1)
    return total * mesh.data_size / global_sum(count, mesh.data_group).clamp_min(1)


def cross_entropy_ignore_index(
    logits: torch.Tensor, labels: torch.Tensor, ignore_index: int = -1, mesh=None
) -> torch.Tensor:
    """Mean CE over positions whose label != ignore_index (torch semantics);
    over a ``mesh``, the count is the global batch's (``masked_mean``)."""
    valid = labels != ignore_index
    nll = torch.where(valid, _nll(logits, torch.where(valid, labels, 0)), 0.0)
    return masked_mean(nll.sum(), valid.sum(), mesh)


def kl_div_soft_targets(log_pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """torch KLDivLoss(reduction="none") with 0 where the target is 0."""
    target = target.float()
    safe_log_t = torch.where(target > 0, torch.log(target.clamp_min(1e-30)), 0.0)
    return torch.where(target > 0, target * (safe_log_t - log_pred), 0.0)


class PretrainLosses(NamedTuple):
    masked_lm_loss: torch.Tensor
    masked_img_loss: torch.Tensor
    next_sentence_loss: torch.Tensor


def masked_image_loss(
    prediction_scores_v: torch.Tensor,  # [B, R, v_target_size] (incl. global row 0)
    image_label: torch.Tensor,          # [B, R-1]: 1 = masked region
    image_target: torch.Tensor,         # [B, R-1, v_target_size] or [B, R-1, feat]
    *,
    visual_target: int,
    gathered: bool = False,
    num_negative: int = 128,
    generator: Optional[torch.Generator] = None,
    mesh=None,
) -> torch.Tensor:
    """Masked-region loss over the masked rows; row 0 (the global feature)
    is skipped unless the model already gathered K rows (``gathered``).
    Visual target 2 (NCE) draws its negatives from ``generator``, a
    generator on the predictions' device, and takes no ``gathered``.
    ``mesh``: this rank's share of the global batch's loss (module
    docstring)."""
    if gathered and visual_target == 2:
        raise ValueError("img_gather is not supported with NCE (visual_target 2), as in "
                         "the JAX package: its negatives come from every region")
    pred = (prediction_scores_v if gathered else prediction_scores_v[:, 1:]).float()
    if image_label.shape[1] != pred.shape[1]:
        raise ValueError(
            f"image_label rows {image_label.shape[1]} do not align with the "
            f"prediction rows {pred.shape[1]}")
    masked = (image_label == 1).float()
    if visual_target == 1:  # feature regression, mean over masked elements
        err = (pred - image_target.float()).square()
        return masked_mean((err * masked[..., None]).sum(), masked.sum() * pred.shape[-1], mesh)
    if visual_target == 0:  # KL vs the soft class distribution, mean over masked rows
        kl = kl_div_soft_targets(torch.log_softmax(pred, dim=-1), image_target)
        return masked_mean((kl * masked[..., None]).sum(), masked.sum(), mesh)
    if visual_target == 2:
        if generator is None:
            raise ValueError("visual_target 2 (NCE) draws its negatives from a generator")
        nll = _nce_nll(pred, image_target, num_negative, generator, mesh)
        return masked_mean((nll * masked).sum(), masked.sum(), mesh)
    raise ValueError(f"unknown visual_target {visual_target}")


def nce_index(b: int, r: int, num_negative: int, generator: torch.Generator,
              device) -> torch.Tensor:
    """[B, R, 1 + N] flat indices (row * R + column) into the [B R] region
    rows of NCE's samples: the row's own first, then ``int(0.7 N)``
    negatives from across the batch (another row, any column) and
    ``int(0.3 N)`` from inside the row (another column), each uniform, drawn
    from ``generator`` as ``vilbert_tpu/train/losses.py`` draws them from
    its key (reference vilbert.py:1523-1575)."""
    n_across, n_inside = int(num_negative * 0.7), int(num_negative * 0.3)

    def draw(high: int, n: int) -> torch.Tensor:
        # uniform on [0, high), and 0 where the range is empty, as jax.random.randint
        return torch.randint(0, max(high, 1), (b, r, n), generator=generator, device=device)

    rows = torch.arange(b, device=device)[:, None, None]
    cols = torch.arange(r, device=device)[None, :, None]
    across_row = draw(b - 1, n_across)
    across_row = torch.where(across_row == rows, b - 1, across_row)  # row != self
    across = across_row * r + draw(r, n_across)
    inside_col = draw(r - 1, n_inside)
    inside = rows * r + torch.where(inside_col == cols, r - 1, inside_col)  # col != self
    return torch.cat([(rows * r + cols).expand(b, r, 1), across, inside], dim=2)


def _nce_nll(pred: torch.Tensor, image_target: torch.Tensor, num_negative: int,
             generator: torch.Generator, mesh=None) -> torch.Tensor:
    """[B, R] NCE loss of every region row: the predicted feature scored
    against its true feature and the negatives of ``nce_index``; the NLL of
    the true one under the log-softmax over the 1 + N scores. Over a
    ``mesh`` of several data rows, the targets are gathered from every
    data row and the index is the global batch's (the ranks' generators
    agree), of which this rank keeps its own rows.

    The scores are one fp32 product of every prediction with every target,
    [B R, B R], from which each row's 1 + N columns are gathered: the same
    function as gathering the [B, R, 1 + N, d] samples first, in a bounded
    memory (at B 256, 36 regions, d 2048: 340 MB where the samples take
    9.7 GB, and autograd would keep them)."""
    target = image_target.to(pred.dtype)
    b, r, d = target.shape
    if _sharded(mesh):
        target = all_gather(target, mesh.data_group)
        index = nce_index(target.shape[0], r, num_negative, generator, pred.device)
        index = index[mesh.data_rank * b:(mesh.data_rank + 1) * b]
    else:
        index = nce_index(b, r, num_negative, generator, pred.device)
    scores = pred.reshape(b * r, d) @ target.reshape(-1, d).T
    score = scores.gather(1, index.reshape(b * r, -1)).reshape(b, r, -1)
    return -torch.log_softmax(score, dim=-1)[..., 0]


def pretrain_losses(
    out,
    masked_lm_labels: torch.Tensor,
    image_label: torch.Tensor,
    image_target: torch.Tensor,
    next_sentence_label: torch.Tensor,
    *,
    visual_target: int,
    num_negative: int = 128,
    generator: Optional[torch.Generator] = None,
    img_gathered: bool = False,
    mesh=None,
) -> PretrainLosses:
    """The three pretraining losses; over a ``mesh``, this rank's shares of
    the global batch's (module docstring)."""
    return PretrainLosses(
        cross_entropy_ignore_index(out.prediction_scores_t, masked_lm_labels, -1, mesh),
        masked_image_loss(out.prediction_scores_v, image_label, image_target,
                          visual_target=visual_target, gathered=img_gathered,
                          num_negative=num_negative, generator=generator, mesh=mesh),
        cross_entropy_ignore_index(out.seq_relationship_score, next_sentence_label, -1, mesh),
    )


def _bce(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross-entropy with logits (stable form)."""
    t = target.float()
    return logits.clamp_min(0) - logits * t + torch.log1p(torch.exp(-logits.abs()))


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Elementwise binary CE with logits, mean reduction (torch
    ``BCEWithLogitsLoss(reduction="mean")``), in fp32."""
    return _bce(logits.float(), targets).mean()


def compute_score_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Sum of soft-target mass at the argmax prediction."""
    return compute_score_with_logits_per_sample(logits, targets).sum()


def _accuracy(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(-1) == target).float().mean()


def task_loss_and_score(
    task_type: str, logits: torch.Tensor, target: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean-style loss as the reference computes it, batch score) for one
    task head type; ``logits`` is the head output already reshaped to
    [batch(, options | regions), classes]."""
    if task_type in ("VL-classifier", "VL-classifier-GQA"):
        # the reference multiplies the mean BCE by the label width
        loss = bce_with_logits(logits, target) * target.shape[1]
        return loss, compute_score_with_logits(logits, target) / target.shape[0]
    if task_type in ("VL-logit", "VL-binary-classifier", "VL-tri-classifier"):
        return cross_entropy(logits, target), _accuracy(logits, target)
    if task_type in ("V-logit", "V-logit-mc"):
        # per-region BCE with a [B, R(, 1)] IoU-derived target
        loss = bce_with_logits(logits, target) * target.shape[1]
        t = target.squeeze(-1) if target.dim() == 3 else target
        gathered = t.gather(1, logits.squeeze(-1).float().argmax(-1)[:, None])
        return loss, (gathered > 0.5).float().sum() / logits.shape[0]
    raise ValueError(f"unknown task type {task_type}")


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
