"""Per-task early-stop controller.

The port's own copy of ``vilbert_tpu/train/controllers.py`` (which imports
no jax): the port imports nothing of the JAX package, and
``tests/test_torch_host.py`` holds the copy to the original.

Faithful reimplementation of the reference ``MultiTaskStopOnPlateau``
(vilbert/utils.py:39-148): a task enters ``in_stop`` after ``patience``
consecutive evals without improvement; while stopped it *resumes* training if
the score keeps dropping past ``continue_threshold``; the multi-task driver
trains stopped tasks only every ``train_iter_gap`` iterations
(train_tasks.py:516-521) and resets all controllers on the LR-drop epochs
(train_tasks.py:607-610).

Kept host-side (plain Python state), outside the jit boundary.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Optional


class StopOnPlateau:
    def __init__(
        self,
        mode: str = "max",
        patience: int = 10,
        continue_threshold: float = 0.005,
        threshold: float = 1e-4,
        threshold_mode: str = "rel",
        cooldown: int = 0,
    ):
        assert mode in ("min", "max")
        assert threshold_mode in ("rel", "abs")
        self.mode = mode
        self.patience = patience
        self.continue_threshold = continue_threshold
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.cooldown = cooldown
        self.last_epoch = -1
        self.reset()

    def reset(self) -> None:
        self.best = math.inf if self.mode == "min" else -math.inf
        self.cooldown_counter = 0
        self.num_bad_epochs = 0
        self.in_stop = False

    @staticmethod
    def _cmp(mode: str, threshold_mode: str, threshold: float, a: float, best: float) -> bool:
        if mode == "min" and threshold_mode == "rel":
            return a < best * (1.0 - threshold)
        if mode == "min" and threshold_mode == "abs":
            return a < best - threshold
        if mode == "max" and threshold_mode == "rel":
            return a > best * (1.0 + threshold)
        return a > best + threshold

    def is_better(self, a: float, best: float) -> bool:
        return self._cmp(self.mode, self.threshold_mode, self.threshold, a, best)

    def continue_is_better(self, a: float, best: float) -> bool:
        # note: the reference initializes this comparator with mode="min"
        # regardless of self.mode (utils.py:71-73) — "score keeps dropping".
        return self._cmp("min", self.threshold_mode, self.continue_threshold, a, best)

    def step(self, metric: float, epoch: Optional[int] = None) -> None:
        current = float(metric)
        self.last_epoch = self.last_epoch + 1 if epoch is None else epoch

        if self.is_better(current, self.best):
            self.best = current
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1

        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0

        if self.num_bad_epochs > self.patience:
            self.in_stop = True
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0
        elif self.continue_is_better(current, self.best) and self.in_stop:
            self.in_stop = False
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0

    # -- checkpointable state ----------------------------------------------

    def state_dict(self) -> Dict:
        return {
            k: getattr(self, k)
            for k in (
                "mode", "patience", "continue_threshold", "threshold",
                "threshold_mode", "cooldown", "last_epoch", "best",
                "cooldown_counter", "num_bad_epochs", "in_stop",
            )
        }

    def load_state_dict(self, d: Dict) -> None:
        for k, v in d.items():
            setattr(self, k, v)


class MultiTaskStopController:
    """One StopOnPlateau per task plus the train_iter_gap gating."""

    def __init__(self, task_ids, patience: int = 1, train_iter_gap: int = 4):
        # reference recipe: MultiTaskStopOnPlateau(mode="max", patience=1,
        # continue_threshold=0.005, cooldown=1, threshold=0.001)
        # (train_tasks.py:342-348)
        self.controllers: Dict[str, StopOnPlateau] = {
            t: StopOnPlateau(
                mode="max", patience=patience, continue_threshold=0.005,
                cooldown=1, threshold=0.001,
            )
            for t in task_ids
        }
        self.train_iter_gap = train_iter_gap

    def should_train(self, task_id: str, iter_id: int) -> bool:
        c = self.controllers[task_id]
        return (not c.in_stop) or (iter_id % self.train_iter_gap == 0)

    def step(self, task_id: str, val_score: float) -> None:
        self.controllers[task_id].step(val_score)

    def reset_all(self) -> None:
        """Called on LR-drop epochs (reference resets at epochs {5, 7})."""
        for c in self.controllers.values():
            c.reset()

    def all_stopped(self) -> bool:
        return all(c.in_stop for c in self.controllers.values())

    def state_dict(self) -> Dict:
        return {t: c.state_dict() for t, c in self.controllers.items()}

    def load_state_dict(self, d: Dict) -> None:
        for t, s in d.items():
            self.controllers[t].load_state_dict(s)
