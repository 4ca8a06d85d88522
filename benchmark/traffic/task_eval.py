"""Per-task evaluation: ``eval.evaluators.evaluate_task`` over a loader.

The program is the VL-tasks model as ``cli.eval_tasks.build_model`` makes
it (the family's class, in eval mode, on the device; the benchmark's
seeded weights in place of the class's host initialisation), and
``evaluate_task`` on the mix's task. The loader holds ``distinct`` numpy
batches made from the seed, at the task's eval batch and geometry, and
yields them in turn until the window's time is up; ``evaluate_task`` copies
each to the device from pageable memory, synchronises on its logits and
scores it on the host. A batch's time runs from one yield to the next (to
the return, for the last), read from CUDA events recorded at each: the
device is idle at a yield (``evaluate_task`` has synchronised), so an event
marks the host's moment.

A batch of questions: ``text_len`` [lo, hi] valid tokens padded to the
task's ``max_seq_length``, ``boxes`` [lo, hi] detector regions and the
global row, padded to ``max_region_num``; float32 features and boxes;
soft answer targets over ``num_labels`` (``answers`` labels a question,
each scored from ``answer_scores``).

The comparison (after the window, against the plain reference's float32
logits of the same batches):

- ``answer_gap``: over every answer the window's records hold, the widest
  gap by which the answer's reference logit lies below the reference's
  best for that question, over the reference logits' standard deviation;
- ``logit_err``: the largest difference of a timed batch's logits (two,
  captured as the window produced them, at occurrences drawn from the
  seed), in the same unit;
- ``loss_gap``: the relative gap of the mean loss ``evaluate_task``
  returned to the reference's over the same rows;
- ``score_gap``: the gap of its score to the reference's.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from harness import cell as harness_cell
from harness import seeded, yardstick


def make_batch(task: Dict, p: Dict, sizes: Dict, rng: np.random.Generator, first_qid: int):
    b, t, r = task["eval_batch_size"], task["max_seq_length"], task["max_region_num"]
    n_labels = p["num_labels"]
    lengths = rng.integers(p["text_len"][0], p["text_len"][1] + 1, b)
    boxes = rng.integers(p["boxes"][0], p["boxes"][1] + 1, b)
    text_valid = np.arange(t)[None] < lengths[:, None]
    img_valid = np.arange(r)[None] <= boxes[:, None]  # the global row and the boxes
    xy = rng.random((b, r, 2), dtype=np.float32) * 0.5
    wh = rng.random((b, r, 2), dtype=np.float32) * 0.5
    spatials = np.concatenate([xy, xy + wh, (wh[..., :1] * wh[..., 1:])], axis=-1)
    target = np.zeros((b, n_labels), np.float32)
    rows = np.arange(b)
    for _ in range(p["answers"]):
        label = rng.integers(0, n_labels, b)
        score = rng.choice(np.asarray(p["answer_scores"], np.float32), b)
        target[rows, label] = np.maximum(target[rows, label], score)
    return {
        "features": rng.standard_normal((b, r, sizes["v_feature_size"]), dtype=np.float32),
        "spatials": spatials.astype(np.float32),
        "image_mask": img_valid.astype(np.int64),
        "question": np.where(text_valid, rng.integers(1, sizes["vocab_size"], (b, t)), 0),
        "input_mask": text_valid.astype(np.int64),
        "segment_ids": np.zeros((b, t), np.int64),
        "co_attention_mask": np.zeros((b, r, t), np.float32),
        "target": target,
        "question_id": np.arange(first_qid, first_qid + b, dtype=np.int64),
    }


class _Loader:
    """The distinct batches in turn until the deadline, or until
    ``max_batches`` where that is given."""

    def __init__(self, batches, batch_size: int, deadline: float, max_batches, on_yield):
        self.batches, self.batch_size = batches, batch_size
        self.deadline, self.max_batches, self.on_yield = deadline, max_batches, on_yield

    def __iter__(self):
        i = 0
        while True:
            done = (i >= self.max_batches if self.max_batches
                    else time.perf_counter() >= self.deadline)
            if i and done:
                return
            self.on_yield(i % len(self.batches))
            yield self.batches[i % len(self.batches)]
            i += 1


class Driver:
    train = False
    rate_metric, tail_metric = "questions_per_s", "batch_ms_p90"

    def __init__(self, ctx: harness_cell.Context):
        self.ctx = ctx
        self.p = ctx.traffic
        self.sizes = ctx.sizes
        self.task = self.p["task"]

    def setup(self) -> None:
        from vilbert_tpu_torch.core.config import TaskConfig
        from vilbert_tpu_torch.models.basebert import BaseBertForVLTasks
        from vilbert_tpu_torch.models.vilbert import ViLBERTForVLTasks

        dev, p = self.ctx.device, self.p
        self.cfg = cfg = self.ctx.model_config()
        cls = {"vilbert": ViLBERTForVLTasks, "basebert": BaseBertForVLTasks}[self.ctx.family]
        with torch.device("meta"):  # the benchmark makes the weights, on the device
            model = cls(cfg, num_labels=p["num_labels"])
        model = model.to_empty(device=dev)
        seeded.load_into(model, seeded.weights(
            [(n, tuple(t.shape)) for n, t in model.named_parameters()], self.ctx.seed,
            cfg.initializer_range, dev))
        self.model = model.eval()
        self.task_cfg = TaskConfig(**self.task)
        rng = np.random.default_rng(seeded.stream(self.ctx.seed, "batches"))
        b = self.task["eval_batch_size"]
        self.batches = [make_batch(self.task, p, self.sizes, rng, i * b)
                        for i in range(p["distinct"])]
        # the timed logits kept for the comparison: occurrence k of each batch
        pick = np.random.default_rng(seeded.stream(self.ctx.seed, "sample"))
        self.keep_at = [int(pick.integers(0, p["keep_within"])) for _ in self.batches]
        self.seen = [0] * len(self.batches)
        self.kept: Dict[int, torch.Tensor] = {}
        self.current = None
        head = {"VL-classifier": "vil_prediction"}[self.task["type"]]
        getattr(model, head).register_forward_hook(self._keep)
        self.records: List[Dict] = []
        self.totals = []  # (loss, score, rows) of each evaluate_task call
        self.run(0.0, max_units=len(self.batches))  # warms every shape
        self.records, self.totals, self.seen, self.kept = [], [], [0] * len(self.batches), {}

    def _on_yield(self, index: int) -> None:
        self.clock.mark()
        keep = self.seen[index] == self.keep_at[index] and index not in self.kept
        self.current = index if keep else None
        self.seen[index] += 1

    def _keep(self, module, inputs, output) -> None:
        if self.current is not None:
            self.kept[self.current] = output.detach().float().clone()

    def run(self, seconds: float, max_units=None) -> harness_cell.Window:
        from vilbert_tpu_torch.eval.evaluators import evaluate_task

        b = self.task["eval_batch_size"]
        loader = _Loader(self.batches, b, time.perf_counter() + seconds, max_units,
                         self._on_yield)
        self.clock = harness_cell.UnitClock(self.ctx.device)
        t0 = time.perf_counter()
        metrics, records = evaluate_task(self.model, self.cfg, self.task_cfg, loader)
        self.clock.mark()
        harness_cell.sync(self.ctx.device)
        end = time.perf_counter()
        unit_ms = self.clock.intervals_ms()
        self.records.extend(records)
        self.totals.append((metrics["loss"], metrics["score"], metrics["num_samples"]))
        return harness_cell.Window(samples=int(metrics["num_samples"]),
                                   units=["batch"] * len(unit_ms), unit_ms=unit_ms,
                                   wall_s=end - t0)

    def unit_sites(self, unit: str) -> List[Dict]:
        c, t = self.sizes, self.task
        b = t["eval_batch_size"]
        bi = c.get("bi_hidden_size", c["hidden_size"])
        return yardstick.encoder_sites(self.ctx.family, c, b, t["max_seq_length"],
                                       t["max_region_num"]) + [
            yardstick.matmul("head.vqa_hidden", b, 2 * bi, bi),
            yardstick.matmul("head.vqa_out", b, self.p["num_labels"], 2 * bi),
        ]

    # -- the comparison ----------------------------------------------------------

    def reference_logits(self, precision: str = "fp32") -> List[torch.Tensor]:
        """Float32 logits of each distinct batch from the plain reference,
        ``block`` rows at a time."""
        from reference.model import Config, ViLBERTForVLTasks

        if self.ctx.family != "vilbert":
            raise ValueError("the evaluation reference is the two-stream model's")
        dev = self.ctx.device
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        with torch.device("meta"):
            ref = ViLBERTForVLTasks(Config(self.sizes), num_labels=self.p["num_labels"],
                                    precision=precision)
        ref = ref.to_empty(device=dev)
        seeded.load_into(ref, seeded.weights(
            [(n, tuple(t.shape)) for n, t in ref.named_parameters()], self.ctx.seed,
            self.sizes["initializer_range"], dev))
        ref.eval()
        out = []
        step = self.p["reference_block"]
        with torch.no_grad():
            for batch in self.batches:
                parts = []
                for i in range(0, len(batch["question_id"]), step):
                    x = {k: torch.as_tensor(v[i:i + step], device=dev) for k, v in batch.items()}
                    parts.append(ref(x["question"], x["features"], x["spatials"],
                                     x["segment_ids"], x["input_mask"], x["image_mask"],
                                     head="vil_prediction").float())
                out.append(torch.cat(parts))
        return out

    def gaps(self, ref_logits: List[torch.Tensor]) -> Dict[str, float]:
        ref = torch.cat(ref_logits).cpu()
        scale = float(ref.std())
        best = ref.max(1).values
        qid = torch.tensor([r["question_id"] for r in self.records])
        answer = torch.tensor([int(r["answer"]) for r in self.records])
        gap = (best[qid] - ref[qid, answer]) / scale
        answer_gap = float(gap.max())
        logit_err = max(float((self.kept[i].cpu() - ref_logits[i].cpu()).abs().max())
                        for i in range(len(ref_logits))) / scale
        target = torch.cat([torch.from_numpy(b["target"]) for b in self.batches])
        bce = (ref.clamp_min(0) - ref * target + torch.log1p(torch.exp(-ref.abs()))).sum(1)
        score = target.gather(1, ref.argmax(1, keepdim=True))[:, 0]
        # the rows the window scored, each as often as it was scored
        times = torch.bincount(qid, minlength=ref.shape[0]).double()
        loss_ref = float((bce.double() * times).sum() / times.sum())
        score_ref = float((score.double() * times).sum() / times.sum())
        rows = sum(n for _, _, n in self.totals)
        loss = sum(l * n for l, _, n in self.totals) / rows
        got_score = sum(s * n for _, s, n in self.totals) / rows
        return {"answer_gap": answer_gap, "logit_err": logit_err,
                "loss_gap": abs(loss - loss_ref) / loss_ref,
                "score_gap": abs(got_score - score_ref),
                "answer_gap_mean": float(gap.mean()), "answer_miss": float((gap > 0).double().mean())}

    def free(self) -> None:
        self.__dict__.pop("model", None)
        harness_cell.free_device_memory()

    def readings(self) -> Dict[str, float]:
        self.free()
        return self.gaps(self.reference_logits())

    def close(self) -> None:
        self.free()
