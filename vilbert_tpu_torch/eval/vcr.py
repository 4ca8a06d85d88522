"""VCR joint evaluation & submission tooling.

The port's own copy of ``vilbert_tpu/eval/vcr.py``: the port imports
nothing of the JAX package, and ``tests/test_torch_host.py`` holds the
copy to the original.

Rebuilds script/VCR_Q_AR_evaluation.py (Q->A, QA->R, and joint Q->AR
accuracy from the two result jsons, :16-62) and script/VCR_submission.py
(leaderboard CSV with per-option probabilities, :12-44).
"""

from __future__ import annotations

import csv
import json
from typing import Dict, List, Sequence, Tuple

import numpy as np


def vcr_joint_accuracy(
    qa_results: Sequence[Dict],
    qar_results: Sequence[Dict],
    qa_targets: Dict[int, int],
    qar_targets: Dict[int, int],
) -> Dict[str, float]:
    """Q->A / QA->R / joint Q->AR accuracy.

    ``*_results`` entries follow the VL-logit record format
    {"question_id", "answer": [probs per option]}; targets map
    question_id -> correct option.
    """
    qa_pred = {r["question_id"]: int(np.argmax(r["answer"])) for r in qa_results}
    qar_pred = {r["question_id"]: int(np.argmax(r["answer"])) for r in qar_results}

    qa_correct = qar_correct = joint_correct = n = 0
    for qid, target in qa_targets.items():
        if qid not in qa_pred or qid not in qar_targets:
            continue
        n += 1
        a_ok = qa_pred[qid] == target
        r_ok = qar_pred.get(qid) == qar_targets[qid]
        qa_correct += a_ok
        qar_correct += r_ok
        joint_correct += a_ok and r_ok
    n = max(n, 1)
    return {
        "qa_accuracy": qa_correct / n,
        "qar_accuracy": qar_correct / n,
        "q_ar_accuracy": joint_correct / n,
        "num_samples": n,
    }


def write_vcr_submission_csv(
    qa_results: Sequence[Dict],
    qar_results: Sequence[Dict],
    out_path: str,
    *,
    num_answers: int = 4,
    num_rationales: int = 4,
) -> str:
    """Leaderboard CSV: one row per question with answer and rationale
    probabilities (reference VCR_submission.py:12-44)."""
    qar_by_id: Dict[int, List[float]] = {
        r["question_id"]: r["answer"] for r in qar_results
    }
    header = (
        ["annot_id"]
        + [f"answer_{i}" for i in range(num_answers)]
        + [f"rationale_conditioned_on_a{i}_{j}"
           for i in range(num_answers) for j in range(num_rationales)]
    )
    with open(out_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        for r in qa_results:
            qid = r["question_id"]
            rat = qar_by_id.get(qid, [1.0 / num_rationales] * num_rationales)
            # rationale probs conditioned on each answer: the reference
            # submits the same rationale distribution per answer option
            row = [qid] + list(r["answer"]) + list(rat) * num_answers
            w.writerow(row)
    return out_path


def load_results(path: str) -> List[Dict]:
    with open(path) as f:
        return json.load(f)
