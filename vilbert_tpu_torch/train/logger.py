"""Training metrics logger.

Counterpart of ``vilbert_tpu/train/logger.py`` (the reference ``tbLogger``,
vilbert/utils.py:151-482): tensorboard scalars when tensorboardX is
installed, a plain-text ``out.txt`` of JSON records, per-task train/val
loss/score/LR, the CC pretraining 3-loss variant, running averages, and a
state that survives a checkpoint. The trace hooks run ``torch.profiler``
(CPU and, where there is one, CUDA activity) in place of ``jax.profiler``
and write a Chrome trace under ``<log_dir>/profile``. In a data-parallel
run only rank 0 writes (``write=False`` on the others): every rank keeps the
same running state, so a checkpoint of any rank restores it.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional


class MetricsLogger:
    def __init__(
        self,
        log_dir: str,
        task_ids: List[str],
        *,
        txt_name: str = "out.txt",
        use_tensorboard: bool = True,
        write: bool = True,
    ):
        self.log_dir = log_dir
        self.task_ids = list(task_ids)
        self.use_tensorboard = use_tensorboard
        self.write = write
        self._tb = None
        self._txt = None
        if write:
            os.makedirs(log_dir, exist_ok=True)
            self._txt = open(os.path.join(log_dir, txt_name), "a")
        if use_tensorboard and write:
            try:
                from tensorboardX import SummaryWriter

                self._tb = SummaryWriter(log_dir=log_dir)
            except Exception:
                self._tb = None
        self._txt_path = os.path.join(log_dir, txt_name)
        self._profiler = None
        # running sums since the last flush, per task
        self.task_loss_tmp = {t: 0.0 for t in task_ids}
        self.task_score_tmp = {t: 0.0 for t in task_ids}
        self.task_step_tmp = {t: 0 for t in task_ids}
        self.task_loss_total = {t: 0.0 for t in task_ids}
        self.task_step_total = {t: 0 for t in task_ids}
        self._step_t0 = time.perf_counter()

    # -- scalar plumbing ----------------------------------------------------

    def line_plot(self, step: int, value: float, split: str, key: str) -> None:
        if self._tb is not None:
            self._tb.add_scalar(f"{split}/{key}", value, step)

    # -- train / val steps --------------------------------------------------

    def step_train(self, step: int, task_id: str, loss: float, score: float,
                   lr: Optional[float] = None) -> None:
        self.task_loss_tmp[task_id] += loss
        self.task_score_tmp[task_id] += score
        self.task_step_tmp[task_id] += 1
        self.task_loss_total[task_id] += loss
        self.task_step_total[task_id] += 1
        self.line_plot(step, loss, f"train_{task_id}", "loss")
        self.line_plot(step, score, f"train_{task_id}", "score")
        if lr is not None:
            self.line_plot(step, lr, f"train_{task_id}", "lr")

    def step_train_cc(self, step: int, masked_t: float, masked_v: float,
                      nsp: float, lr: Optional[float] = None) -> None:
        """CC pretraining 3-loss variant (utils.py step_train_CC)."""
        for key, v in (("masked_loss_t", masked_t), ("masked_loss_v", masked_v),
                       ("next_sentence_loss", nsp)):
            self.line_plot(step, v, "train_CC", key)
        if lr is not None:
            self.line_plot(step, lr, "train_CC", "lr")

    def step_val(self, step: int, task_id: str, loss: float, score: float) -> None:
        self.line_plot(step, loss, f"val_{task_id}", "loss")
        self.line_plot(step, score, f"val_{task_id}", "score")
        self._write_txt({"step": step, "task": task_id, "split": "val",
                         "loss": loss, "score": score})

    def show_train(self, step: int) -> str:
        """Flush running averages to the txt log (reference showLossTrain)."""
        parts = []
        for t in self.task_ids:
            n = self.task_step_tmp[t]
            if n:
                parts.append(
                    f"{t} loss {self.task_loss_tmp[t] / n:.4f} "
                    f"score {self.task_score_tmp[t] / n:.4f}"
                )
            self.task_loss_tmp[t] = self.task_score_tmp[t] = 0.0
            self.task_step_tmp[t] = 0
        dt = time.perf_counter() - self._step_t0
        self._step_t0 = time.perf_counter()
        line = f"step {step} [{dt:.1f}s] " + " | ".join(parts)
        self._write_txt({"step": step, "summary": line})
        return line

    def _write_txt(self, record: Dict[str, Any]) -> None:
        if self._txt is None:
            return
        self._txt.write(json.dumps(record) + "\n")
        self._txt.flush()

    # -- profiler hooks (absent in the reference) ----------------------------

    def start_trace(self) -> None:
        """Start a ``torch.profiler`` session (CPU, and CUDA when available)."""
        import torch

        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._profiler = torch.profiler.profile(activities=activities)
        self._profiler.start()

    def stop_trace(self) -> str:
        """Stop the session and write its Chrome trace; returns the path."""
        prof, self._profiler = self._profiler, None
        if prof is None:
            raise RuntimeError("stop_trace without start_trace")
        prof.stop()
        out_dir = os.path.join(self.log_dir, "profile")
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"trace_{int(time.time() * 1e3)}.json")
        prof.export_chrome_trace(path)
        return path

    # -- checkpointable state ----------------------------------------------

    def state_dict(self) -> Dict[str, Any]:
        return {
            "task_loss_total": self.task_loss_total,
            "task_step_total": self.task_step_total,
        }

    def load_state_dict(self, d: Dict[str, Any]) -> None:
        self.task_loss_total.update(d.get("task_loss_total", {}))
        self.task_step_total.update(d.get("task_step_total", {}))

    def close(self) -> None:
        if self._txt is not None:
            self._txt.close()
        if self._tb is not None:
            self._tb.close()
