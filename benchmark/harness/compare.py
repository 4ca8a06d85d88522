"""The numbers that decide ``correct``, each held to its limit.

Training (the first steps of the object the window then drives; a cell's
workload file names the ones it compares):

- ``grad_gap``: the first gradient, as the optimizer holds it after one
  step (m / (1 - beta1)), by the worst leaf: |norm(program) - norm(ref)|
  over the larger of the reference leaf's norm and the median leaf's;
- ``grad_err_median``: the same gradient's difference, norm(program - ref),
  over the same floor, at the median leaf: the rounding of lower-precision
  products is noise of mean zero, which a leaf's norm averages away and
  its difference does not;
- ``update_gap``: the parameters' change after the steps, by the worst
  leaf as ``grad_gap``, over the leaves whose first reference gradient is
  at least a thousandth of the median leaf's (a key bias under softmax has
  a gradient that is rounding alone, and Adam moves it by rounding);
- read beside them, not compared: each step's loss (``loss_gap``, the
  first alone ``loss1_gap``), the other medians and worst differences.

Evaluation: see the evaluation generator.
"""

from __future__ import annotations

import math
import statistics
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional

import torch

#: a leaf whose first reference gradient is under this share of the median
#: leaf's moves by rounding alone and is left out of ``update_gap``
STILL_LEAF = 1e-3


@dataclass
class Trajectory:
    """What the first training steps left (host tensors): each step's loss,
    the first step's gradient as the optimizer took it, and every
    parameter's change after the last."""

    losses: List[float]
    grad1: Dict[str, torch.Tensor]
    change: Dict[str, torch.Tensor]


def _norms(tensors: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(torch.linalg.vector_norm(t.float())) for n, t in tensors.items()}


def _by_leaf(values: Mapping[str, float], want: Mapping[str, float], names) -> Dict[str, float]:
    """Each leaf's value over the larger of its reference norm and the
    median leaf's."""
    floor = statistics.median(want[n] for n in names)
    return {n: values[n] / max(want[n], floor) for n in names}


def training_gaps(got: Trajectory, want: Trajectory) -> Dict:
    """The numbers compared, and beside them what the calibration reads: the
    first step's loss alone and the worst leaf of the first gradient."""
    if set(got.grad1) != set(want.grad1) or len(got.losses) != len(want.losses):
        raise ValueError("the two trajectories cover different leaves or steps")
    g_want, c_want = _norms(want.grad1), _norms(want.change)
    g_got, c_got = _norms(got.grad1), _norms(got.change)
    g_med = statistics.median(g_want.values())
    moving = [n for n in g_want if g_want[n] >= STILL_LEAF * g_med]
    grad = _by_leaf({n: abs(g_got[n] - g_want[n]) for n in g_want}, g_want, list(g_want))
    change = _by_leaf({n: abs(c_got[n] - c_want[n]) for n in moving}, c_want, moving)
    grad_err = _by_leaf(_norms({n: got.grad1[n] - want.grad1[n] for n in g_want}), g_want,
                        list(g_want))
    losses = [abs(a - b) / abs(b) for a, b in zip(got.losses, want.losses)]
    return {
        "loss_gap": max(losses),
        "loss1_gap": losses[0],
        "grad_gap": max(grad.values()),
        "grad_err_median": statistics.median(grad_err.values()),
        "update_gap": max(change.values()),
        "worst_grad_leaf": max(grad, key=grad.get),
    }


def judge(readings: Mapping, limits: Mapping[str, Optional[float]]) -> Dict:
    """{name: {"value", "limit"}} for every limit, and whether all hold (a
    reading that is missing or not finite, or a limit not yet set, fails)."""
    checks, ok = {}, bool(limits)
    for name, limit in limits.items():
        value = readings.get(name)
        checks[name] = {"value": value, "limit": limit}
        if value is None or limit is None or not math.isfinite(value) or value > limit:
            ok = False
    return {"correct": ok, "checks": checks}
