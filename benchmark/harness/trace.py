"""Reduce a ``torch.profiler`` Chrome trace to what the per-layer metrics read.

The traced window is the host span the harness names ``WINDOW`` (a
``record_function`` that starts and ends on a synchronize); a trace of the
device alone, which holds no host span, spans its device activities.
Device activities (kernels, copies, fills) are clipped to it; the device is busy
in the union of their intervals, so work on two streams at once counts
once. Idle gaps are the window's time outside that union, each labelled by
what the host was doing at its middle: the innermost benchmark span and
the innermost operator then running on the host.
"""

from __future__ import annotations

import json
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

WINDOW = "bench.window"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_NAME_CHARS = 120


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernels: Dict[str, Tuple[int, float]] = field(default_factory=dict)  # name -> (calls, s)
    h2d_s: float = 0.0
    gaps: List[Tuple[str, float]] = field(default_factory=list)  # longest first

    @property
    def kernel_launches(self) -> int:
        return sum(n for n, _ in self.kernels.values())

    def kernel_seconds(self, pred) -> float:
        return sum(s for name, (_, s) in self.kernels.items() if pred(name))

    def top_ops(self, n: int = 10) -> List[List]:
        ranked = sorted(self.kernels.items(), key=lambda kv: -kv[1][1])[:n]
        return [[name[:_NAME_CHARS], s] for name, (_, s) in ranked]


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1] = (merged[-1][0], b)
        else:
            merged.append((a, b))
    return merged


def _host_label(host: List[Tuple[float, float, str, bool]], t: float) -> str:
    """The innermost benchmark span and host operator around time t; between
    operators, the one that ended last ("after ...")."""
    span: Optional[Tuple[float, str]] = None
    op: Optional[Tuple[float, str]] = None
    last: Optional[Tuple[float, str]] = None
    for a, b, name, is_span in host:
        if a > t:
            break
        if b < t:
            if not is_span and (last is None or b > last[0]):
                last = (b, name)
            continue
        if is_span and name != WINDOW and (span is None or b - a < span[0]):
            span = (b - a, name)
        elif not is_span and (op is None or b - a < op[0]):
            op = (b - a, name)
    parts = [span[1]] if span else []
    if op:
        parts.append(op[1])
    elif last:
        parts.append("after " + last[1])
    return " / ".join(parts)[:_NAME_CHARS] or "no host activity"


def summarize(events: List[dict], n_gaps: int = 10) -> TraceSummary:
    windows = [e for e in events if e.get("name") == WINDOW and e.get("ph") == "X"
               and e.get("cat") == "user_annotation"]
    device = [e for e in events if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATS]
    if len(windows) > 1 or not (windows or device):
        raise ValueError(f"the trace holds {len(windows)} '{WINDOW}' spans and "
                         f"{len(device)} device activities")
    if windows:
        w0 = float(windows[0]["ts"])
        w1 = w0 + float(windows[0]["dur"])
    else:
        w0 = min(float(e["ts"]) for e in device)
        w1 = max(float(e["ts"]) + float(e["dur"]) for e in device)
    busy: List[Tuple[float, float]] = []
    kernels: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    h2d = 0.0
    host: List[Tuple[float, float, str, bool]] = []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        a = float(e["ts"])
        b = a + float(e["dur"])
        if cat in _DEVICE_CATS:
            a, b = max(a, w0), min(b, w1)
            if b <= a:
                continue
            busy.append((a, b))
            if cat == "kernel":
                k = kernels[e["name"]]
                k[0] += 1
                k[1] += (b - a) * 1e-6
            elif cat == "gpu_memcpy" and "HtoD" in e["name"]:
                h2d += (b - a) * 1e-6
        elif cat in ("cpu_op", "user_annotation") and b >= w0 and a <= w1:
            host.append((a, b, e["name"], cat == "user_annotation"))
    merged = _union(busy)
    busy_s = sum(b - a for a, b in merged) * 1e-6
    host.sort()
    gaps, t = [], w0
    for a, b in merged + [(w1, w1)]:
        if a > t:
            gaps.append((a - t, t, a))
        t = max(t, b)
    gaps.sort(reverse=True)
    labelled = [(_host_label(host, (a + b) / 2), d * 1e-6) for d, a, b in gaps[:n_gaps]]
    return TraceSummary(window_s=(w1 - w0) * 1e-6, busy_s=busy_s,
                        kernels={k: (int(v[0]), v[1]) for k, v in kernels.items()},
                        h2d_s=h2d, gaps=labelled)


def load(path: str) -> TraceSummary:
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    return summarize(data["traceEvents"] if isinstance(data, dict) else data)
