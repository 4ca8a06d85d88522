"""Task-head routing and the batch process-mode reshapes.

Counterpart of the host-side pieces of ``vilbert_tpu/train/multitask.py``
(``HEAD_FOR_TYPE``, ``MC_REGION_OFFSET``, ``process_batch``; reference
task_utils.py:199-310), which the evaluator needs. The multi-task trainer
itself comes with the training slice.
"""

from __future__ import annotations

from typing import Dict

import torch

#: head used per task type (reference task_utils.py:325-374)
HEAD_FOR_TYPE = {
    "VL-classifier": "vil_prediction",
    "VL-classifier-GQA": "vil_prediction_gqa",
    "VL-logit": "vil_logit",
    "V-logit": "vision_logit",
    "V-logit-mc": "vision_logit",
    "VL-binary-classifier": "vil_binary_prediction",
    "VL-tri-classifier": "vil_tri_prediction",
}

#: rows to skip before gathering multiple-choice options: the 100 detector
#: boxes + global row (reference task_utils.py:353 ``vision_logit[:, 101:]``)
MC_REGION_OFFSET = 101


def process_batch(process: str, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Process-mode reshapes into a flat [B', ...] model batch."""
    b = dict(batch)
    feats, question = b["features"], b["question"]
    if process == "normal":
        return b
    if process in ("expand", "dialog"):
        # question [B, (rounds,) N, T] with one image per sample
        q = question.reshape(-1, question.shape[-1])
        n_opt = q.shape[0] // feats.shape[0]
        for k in ("features", "spatials", "image_mask"):
            b[k] = torch.repeat_interleave(b[k], n_opt, dim=0)
        b["question"] = q
        b["input_mask"] = b["input_mask"].reshape(-1, q.shape[-1])
        b["segment_ids"] = b["segment_ids"].reshape(-1, q.shape[-1])
        if b.get("target") is not None and b["target"].dim() > 1:
            b["target"] = b["target"].reshape(-1)
        return b
    if process == "retrieval":
        # every field carries its own [B, 4, ...] axis
        for k in ("features", "spatials", "image_mask", "question",
                  "input_mask", "segment_ids"):
            b[k] = b[k].reshape(-1, *b[k].shape[2:])
        return b
    if process == "nlvr":
        # [B, 2R, D] image pair -> [2B, R, D]; text repeated per image
        bsz, two_r = feats.shape[0], feats.shape[1]
        r = two_r // 2
        b["features"] = feats.reshape(bsz * 2, r, feats.shape[2])
        b["spatials"] = b["spatials"].reshape(bsz * 2, r, b["spatials"].shape[2])
        b["image_mask"] = b["image_mask"].reshape(bsz * 2, r)
        for k in ("question", "input_mask", "segment_ids"):
            b[k] = torch.repeat_interleave(b[k], 2, dim=0)
        return b
    raise ValueError(process)
