"""The 12-in-1 tasks in the plain reference (task_utils.py, train_tasks.py).

A task's batch is unrolled by its process mode (retrieval: its 4 options a
row; nlvr: the two images of a pair as two rows, the text repeated), run
with the task token through the task type's head, and scored by its loss:
the classifiers' BCE (mean, times the label count), the V-logit types' BCE
over regions or options (mean, times their count), cross-entropy over
options or classes.

Learning rates of the first round-robin iteration (train_tasks.py: the
``mannul`` LambdaLR built after WarmupConstantSchedule re-applies the full
rate at construction, so the first task of iteration 0 steps at the base
rate; the warmup scheduler then steps after that task, so the others step
at base x 1 / warmup, warmup = 10% of iterations x epochs).

Which parameters a task's step moves: all but the other tasks' heads and
the pretraining heads, and for the V-logit types not the poolers, whose
output their loss never reads; a parameter its loss does not reach steps
on a zero gradient. (This is the JAX recipe's rule, which the program
follows; the published torch AdamW skips every parameter without a
gradient.)
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import torch
import torch.nn.functional as F

from reference.model import HEAD_FOR_TYPE

MC_OFFSET = 101
HEAD_MODULES = ("vil_prediction.", "vil_prediction_gqa.", "vil_logit.",
                "vil_binary_prediction.", "vil_tri_prediction.", "vision_logit.",
                "linguisic_logit.", "cls.")


def iteration_rates(optimizer: Dict, base_lr: float, tasks: Dict, loader_len: int
                    ) -> Tuple[float, float]:
    """(first task's rate, the other tasks' rate) of iteration 0."""
    epochs = max(t.get("num_epoch", 20) for t in tasks.values())
    per_epoch = max(int(t.get("num_epoch", 20) * loader_len / epochs) for t in tasks.values())
    warmup = per_epoch * epochs * optimizer["warmup_proportion"]
    return base_lr, base_lr * min(1.0 / max(warmup, 1.0), 1.0)


def participating(names: Iterable[str], task_type: str) -> List[str]:
    head = HEAD_FOR_TYPE[task_type] + "."
    no_pool = task_type in ("V-logit", "V-logit-mc")
    out = []
    for n in names:
        if n.startswith(HEAD_MODULES) and not n.startswith(head):
            continue
        if no_pool and n.startswith(("bert.t_pooler.", "bert.v_pooler.")):
            continue
        out.append(n)
    return out


def unroll(task: Dict, b: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    b = dict(b)
    process = task.get("process", "normal")
    if process == "retrieval":
        for k in ("features", "spatials", "image_mask", "question", "input_mask",
                  "segment_ids"):
            b[k] = b[k].reshape(-1, *b[k].shape[2:])
    elif process == "nlvr":
        n, two_r = b["features"].shape[:2]
        for k in ("features", "spatials"):
            b[k] = b[k].reshape(2 * n, two_r // 2, b[k].shape[-1])
        b["image_mask"] = b["image_mask"].reshape(2 * n, two_r // 2)
        for k in ("question", "input_mask", "segment_ids"):
            b[k] = b[k].repeat_interleave(2, dim=0)
    return b


def task_loss(model, task: Dict, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    b = unroll(task, batch)
    kind = task["type"]
    q = b["question"]
    task_ids = torch.full((q.shape[0], 1), task["task_id"], dtype=torch.long, device=q.device)
    logits = model(q, b["features"], b["spatials"], b["segment_ids"], b["input_mask"],
                   b["image_mask"], task_ids, head=HEAD_FOR_TYPE[kind])
    target = b["target"]
    if kind == "V-logit-mc":
        logits = logits[:, MC_OFFSET:, 0].gather(1, b["multiple_choice_ids"].long())[..., None]
    if kind in ("VL-classifier", "VL-classifier-GQA", "V-logit", "V-logit-mc"):
        bce = F.binary_cross_entropy_with_logits(logits.float(), target.float())
        return bce * target.shape[1]
    if kind == "VL-logit":
        logits = logits.reshape(target.shape[0], -1)
    return F.cross_entropy(logits.float(), target.long())
