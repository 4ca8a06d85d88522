"""Per-task evaluation producing submission records.

Counterpart of ``vilbert_tpu/eval/evaluators.py`` (reference
EvaluatingModel, task_utils.py:626-859, and eval_tasks.py:303-316): per head
type, eval loss and score plus the reference's submission records:

  VL-classifier      {"question_id", "answer"}          (VQA server format)
  VL-classifier-GQA  {"questionId", "prediction"}        (GQA server format)
  VL-logit           {"question_id", "answer": [probs]}  (option ranking)
  V-logit            {"id", "target": region, "IOU"}     (grounding)
  V-logit-mc         {"id", "target": option}            (pointing)

The model runs in ``eval()`` under ``torch.inference_mode()`` on the device
its parameters live on; host batches are numpy, as the loaders yield them.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from vilbert_tpu_torch.core.config import ModelConfig, TaskConfig
from vilbert_tpu_torch.data.tasks import pad_batch
from vilbert_tpu_torch.train.losses import task_loss_and_score_per_sample
from vilbert_tpu_torch.train.multitask import HEAD_FOR_TYPE, MC_REGION_OFFSET, process_batch


def make_eval_forward(
    model: nn.Module, model_cfg: ModelConfig, task: TaskConfig
) -> Callable[[Dict[str, np.ndarray]], torch.Tensor]:
    """Forward of one numpy batch returning this task's (reshaped) logits,
    on the model's device."""
    head = HEAD_FOR_TYPE[task.type]
    device = next(model.parameters()).device

    @torch.inference_mode()
    def forward(batch: Dict[str, np.ndarray]) -> torch.Tensor:
        orig_batch = batch["features"].shape[0]
        p = process_batch(
            task.process, {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
        )
        task_ids = None
        if model_cfg.task_specific_tokens:
            task_ids = torch.full(
                (p["question"].shape[0], 1), task.task_id, dtype=torch.long, device=device
            )
        out = model(
            p["question"], p["features"], p["spatials"], p["segment_ids"],
            p["input_mask"], p["image_mask"], p.get("co_attention_mask"), task_ids,
            heads=(head,),
        )
        logits = getattr(out, head)
        if task.type == "VL-logit":
            rows = p["target"].reshape(-1).shape[0] if "target" in p else orig_batch
            logits = logits.reshape(rows, -1)
        elif task.type == "V-logit-mc":
            logits = torch.gather(
                logits[:, MC_REGION_OFFSET:, 0], 1, p["multiple_choice_ids"].long()
            )[..., None]
        return logits

    return forward


def evaluate_task(
    model: nn.Module,
    model_cfg: ModelConfig,
    task: TaskConfig,
    loader: Iterable[Dict[str, np.ndarray]],
    *,
    label2ans: Optional[List[str]] = None,
    max_batches: Optional[int] = None,
    qid_map: Optional[Dict[int, Any]] = None,
) -> Tuple[Dict[str, float], List[Dict[str, Any]]]:
    """Returns ({"loss", "score", "num_samples"}, submission records).

    Ragged final batches are padded to the loader's batch size (every call
    sees one shape); metrics are sample-weighted over the valid rows.
    ``qid_map`` (dataset.qid_map) restores original string question ids.
    """
    model.eval()
    forward = make_eval_forward(model, model_cfg, task)
    results: List[Dict[str, Any]] = []
    qid_map = qid_map or {}

    def qid_of(q) -> Any:
        return qid_map.get(int(q), int(q))

    tot_loss = tot_score = 0.0
    n_rows = n_samples = 0
    full_bs = getattr(loader, "batch_size", 0)

    for bi, batch in enumerate(loader):
        if max_batches and bi >= max_batches:
            break
        question_id = np.asarray(batch["question_id"])
        bsz = question_id.shape[0]
        model_batch = {k: v for k, v in batch.items() if k != "question_id"}
        if full_bs:
            model_batch, _ = pad_batch(model_batch, full_bs)
        logits = forward(model_batch).float().cpu()
        rows_per_sample = max(logits.shape[0] // max(full_bs or bsz, 1), 1)
        valid = bsz * rows_per_sample
        logits = logits[:valid]
        target = np.asarray(batch["target"]) if "target" in batch else None
        n_samples += bsz

        if target is not None and target.size:
            if task.type == "VL-logit" and target.ndim > 1:
                target = target.reshape((valid,) + target.shape[2:])
            loss_v, score_v = task_loss_and_score_per_sample(
                task.type, logits, torch.from_numpy(target)
            )
            tot_loss += float(loss_v.sum())
            tot_score += float(score_v.sum())
            n_rows += valid

        logits_np = logits.numpy()
        if task.type in ("VL-classifier", "VL-classifier-GQA"):
            pred = logits_np.argmax(-1)
            for i in range(bsz):
                ans = label2ans[pred[i]] if label2ans else int(pred[i])
                if task.type == "VL-classifier":
                    results.append({"question_id": qid_of(question_id[i]), "answer": ans})
                else:
                    results.append({"questionId": str(qid_of(question_id[i])),
                                    "prediction": ans})
        elif task.type == "VL-logit":
            probs = torch.softmax(logits, dim=1).numpy()
            for i in range(bsz):
                results.append({"question_id": qid_of(question_id[i]),
                                "answer": [float(p) for p in probs[i]]})
        elif task.type == "V-logit":
            sel = logits_np[:, :, 0].argmax(1)
            tgt = np.asarray(batch["target"])[:, :, 0]
            sel_t = np.take_along_axis(tgt, sel[:, None], axis=1)[:, 0]
            for i in range(bsz):
                results.append({"id": qid_of(question_id[i]), "target": int(sel[i]),
                                "IOU": float(sel_t[i])})
        elif task.type == "V-logit-mc":
            pred = logits_np[:, :, 0].argmax(1)
            for i in range(bsz):
                results.append({"id": qid_of(question_id[i]), "target": int(pred[i])})
        # binary/tri classifiers produce no submission records (reference
        # task_utils.py:849-857)

    metrics = {
        "loss": tot_loss / max(n_rows, 1),
        "score": tot_score / max(n_rows, 1),
        "num_samples": n_samples,
    }
    return metrics, results


def save_results(
    results: List[Dict[str, Any]], out_dir: str, task_name: str, split: str
) -> str:
    """Write <task>_<split>_result.json (reference eval_tasks.py:303-316)."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{task_name}_{split}_result.json")
    with open(path, "w") as f:
        json.dump(results, f)
    return path
