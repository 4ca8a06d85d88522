"""Image-text retrieval ranking evaluation on PyTorch.

Counterpart of ``vilbert_tpu/eval/retrieval.py`` (reference
eval_retrieval.py): every caption is scored against a pool of images
(reference: 1,000 validation images in two chunks of 500), and the rank of
the true image gives R@1/5/10 and the median and mean rank.

Fine-tuned mode scores with the ``vil_logit`` head, zero-shot mode with
softmax(alignment logit)[:, 0] of the pretraining heads. With a model built
with ``fast_mode`` the caption goes in at batch 1: its text stream runs
once and is broadcast over the chunk inside the encoder at the first
co-attention layer.

Unlike the JAX package, which places the whole pool on the device first,
``evaluate_retrieval`` loops over the chunks outside and the captions
inside: one chunk is on the device at a time, and the score matrix is the
same. On a CUDA device the model runs the port's kernels (attention K1,
LayerNorm K4).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Sequence

import numpy as np
import torch


def ranking_metrics(score_matrix: np.ndarray, target_indices: np.ndarray) -> Dict[str, float]:
    """R@1/5/10 + median/mean rank from a [num_captions, pool] score matrix
    (reference eval_retrieval.py:315-351; rank is the position of the true
    image when scores are sorted descending)."""
    order = np.argsort(-score_matrix, axis=1)
    ranks = np.empty(score_matrix.shape[0], np.int64)
    for i in range(score_matrix.shape[0]):
        ranks[i] = int(np.where(order[i] == target_indices[i])[0][0])
    return {
        "r1": float(np.mean(ranks < 1)),
        "r5": float(np.mean(ranks < 5)),
        "r10": float(np.mean(ranks < 10)),
        "medr": float(np.median(ranks) + 1),
        "meanr": float(np.mean(ranks) + 1),
    }


def make_vil_logit_scorer(model) -> Callable:
    """score(question, features, spatials, input_mask, segment_ids,
    image_mask) -> [chunk] fp32 scores through the ``vil_logit`` head of a
    ``ViLBERTForVLTasks`` or ``BaseBertForVLTasks`` (fine-tuned mode), in
    eval mode, no gradients."""

    @torch.no_grad()
    def score(question, features, spatials, input_mask, segment_ids, image_mask):
        model.eval()
        out = model(question, features, spatials, segment_ids, input_mask, image_mask,
                    heads=("vil_logit",))
        return out.vil_logit[:, 0]

    return score


def make_alignment_scorer(model) -> Callable:
    """The same through softmax(seq_relationship)[:, 0] of a
    ``ViLBERTForPretraining`` or ``BaseBertForPretraining`` (zero-shot,
    reference eval_retrieval.py:281-296)."""

    @torch.no_grad()
    def score(question, features, spatials, input_mask, segment_ids, image_mask):
        model.eval()
        out = model(question, features, spatials, segment_ids, input_mask, image_mask)
        return torch.softmax(out.seq_relationship_score, dim=1)[:, 0]

    return score


def score_matrix(
    scorer: Callable,
    captions: Sequence[Dict[str, np.ndarray]],
    pool: Dict[str, np.ndarray],
    *,
    chunk: int = 500,
    fast_mode: bool = False,
    device="cuda",
) -> np.ndarray:
    """[len(captions), pool size] fp32 scores of every caption against every
    pool image: chunks outside, captions inside, one chunk on ``device`` at
    a time (``evaluate_retrieval`` says what the arguments hold)."""
    n_pool = pool["features"].shape[0]
    assert n_pool % chunk == 0, f"pool {n_pool} must be a multiple of chunk {chunk}"
    text_batch = 1 if fast_mode else chunk
    texts = [
        {k: torch.from_numpy(np.broadcast_to(c[k], (text_batch,) + np.shape(c[k])).copy())
         .to(device) for k in ("question", "input_mask", "segment_ids")}
        for c in captions
    ]
    scores = torch.empty(len(captions), n_pool, dtype=torch.float32, device=device)
    for c0 in range(0, n_pool, chunk):
        ch = {k: torch.from_numpy(np.ascontiguousarray(v[c0:c0 + chunk])).to(device)
              for k, v in pool.items()}
        for i, t in enumerate(texts):
            scores[i, c0:c0 + chunk] = scorer(t["question"], ch["features"], ch["spatials"],
                                              t["input_mask"], t["segment_ids"],
                                              ch["image_mask"])
        del ch
    return scores.cpu().numpy()


def evaluate_retrieval(
    scorer: Callable,
    caption_iter: Iterable[Dict[str, np.ndarray]],
    pool: Dict[str, np.ndarray],
    *,
    chunk: int = 500,
    fast_mode: bool = False,
    device="cuda",
) -> Dict[str, float]:
    """Score every caption against the whole image pool; ``ranking_metrics``.

    Args:
      scorer: (question, features, spatials, input_mask, segment_ids,
        image_mask) -> [chunk] scores. The caption goes in at batch 1 with
        ``fast_mode`` (the model broadcasts it), else broadcast on the host
        to the chunk.
      caption_iter: dicts with "question"/"input_mask"/"segment_ids" [T] and
        "target_index" (position of the true image in the pool).
      pool: host image arrays {"features" [P,R,D], "spatials" [P,R,5],
        "image_mask" [P,R]}; one chunk of them is on ``device`` at a time.
    """
    captions = list(caption_iter)
    scores = score_matrix(scorer, captions, pool, chunk=chunk, fast_mode=fast_mode,
                          device=device)
    return ranking_metrics(scores, np.asarray([int(c["target_index"]) for c in captions]))
