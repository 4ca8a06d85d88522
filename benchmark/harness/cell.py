"""Run one cell once: set-up, the measured window, the comparison.

A generator (``traffic/<kind>.py``) gives a ``Driver(ctx)`` with:

- ``train``: whether a unit of work is a training step;
- ``rate_metric``, ``tail_metric``: the names of its end-to-end rate (units'
  samples over the window) and 90th-percentile unit time;
- ``setup()``: builds the program and its inputs from the seed and warms up
  every shape the window will use (training: through the first steps,
  which the comparison reads);
- ``run(seconds, max_units=None) -> Window``: drives the program's entry
  until the time is up (or ``max_units`` are done), ending on a
  synchronize;
- ``unit_sites(unit)``: the products one unit runs (``harness.yardstick``);
- ``readings()``: after the window, frees the program's state, runs the
  plain reference and returns the numbers that ``correct`` compares;
- ``close()``.

The untraced run reports the end-to-end metrics. The traced run profiles
``trace_units`` units of the window on the device alone (the per-layer
readers, ``metrics/<name>.py``, read it), then as many again with the host's
operators too (the breakdown's idle gaps name them), and times the rest of
the window with the profiler detached (the ``mfu`` stretch).
"""

from __future__ import annotations

import gc
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from harness import compare, spec, trace


@dataclass
class Window:
    samples: int = 0
    units: List[str] = field(default_factory=list)  # the kind of each unit done
    unit_ms: List[float] = field(default_factory=list)
    wall_s: float = 0.0
    failed: int = 0


@dataclass
class Context:
    """What a generator is given: the cell, the seed, the device, and (for
    the tests and the control) overrides of the model configuration."""

    cell: spec.Cell
    seed: int
    device: str = "cuda"
    model_overrides: Dict = field(default_factory=dict)

    @property
    def traffic(self) -> Dict:
        return self.cell.traffic

    @property
    def sizes(self) -> Dict:
        return self.cell.config

    @property
    def family(self) -> str:
        return self.cell.config["family"]

    def model_config(self):
        """The program's configuration: the file's sizes and precision."""
        from vilbert_tpu_torch.core.config import ModelConfig

        return ModelConfig.from_dict(self.cell.config, **self.model_overrides)


@dataclass
class Traced:
    """What the per-layer readers see."""

    trace: trace.TraceSummary
    window: Window        # the profiled units
    stretch: Window       # the rest, untraced
    sites: List[Dict]     # the products of the profiled units
    stretch_sites: List[Dict]
    train: bool
    peak_bytes: int


def percentile(values: List[float], q: float) -> float:
    """Linear interpolation between closest ranks (numpy's default)."""
    xs = sorted(values)
    pos = q * (len(xs) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def _sites(driver, window: Window) -> List[Dict]:
    out: List[Dict] = []
    for unit in window.units:
        out.extend(driver.unit_sites(unit))
    return out


class UnitClock:
    """Marks on the device's timeline: a CUDA event recorded on the current
    stream (no synchronise), or the host clock on a CPU. Read the intervals
    after a synchronise."""

    def __init__(self, device: str):
        self.cuda = device.startswith("cuda")
        self.marks: list = []

    def mark(self) -> None:
        if self.cuda:
            import torch

            event = torch.cuda.Event(enable_timing=True)
            event.record()
            self.marks.append(event)
        else:
            self.marks.append(time.perf_counter())

    def intervals_ms(self) -> List[float]:
        pairs = zip(self.marks, self.marks[1:])
        if self.cuda:
            return [a.elapsed_time(z) for a, z in pairs]
        return [(z - a) * 1e3 for a, z in pairs]


def sync(device: str) -> None:
    import torch

    if device.startswith("cuda"):
        torch.cuda.synchronize()


#: the port's kernels: (counter, substrings of their kernel names)
PORT_KERNELS = {"K1": ("attention", ("attention_fwd",)),
                "K2": ("attention_bwd", ("attention_bwd",)),
                "K4": ("layer_norm", ("layer_norm_fwd_kernel",))}


def port_counters() -> Dict[str, int]:
    """The port's own launch counters (``ops.attention``, ``ops.layernorm``)."""
    from vilbert_tpu_torch.ops import attention, layernorm

    fns = {"attention": attention.attention, "attention_bwd": attention.attention_bwd,
           "layer_norm": layernorm.layer_norm}
    return {k: fns[name].launches for k, (name, _) in PORT_KERNELS.items()}


def report_counters(before: Dict[str, int], after: Dict[str, int], summary) -> None:
    """One line on standard error: each port kernel's launches by its counter
    beside its kernels in the trace. They differ where a launch runs two
    kernels (K2's ``wg`` and long variants); a difference is not fatal."""
    import sys

    parts = []
    for k, (_, keys) in PORT_KERNELS.items():
        traced = sum(n for name, (n, _) in summary.kernels.items()
                     if any(key in name for key in keys))
        parts.append(f"{k} {after[k] - before[k]} launches / {traced} kernels")
    print("port counters over the traced window: " + ", ".join(parts), file=sys.stderr)


def _profile(driver, ctx: Context, seconds: float, host: bool):
    """Profile ``trace_units`` units of the window; ``host`` adds the CPU
    activity (operators, the benchmark's spans), which costs the host time
    a launch. Returns (window, summary); the summary's window is the host's,
    synchronize to synchronize."""
    from torch.profiler import ProfilerActivity, profile, record_function

    units = int(ctx.traffic["trace_units"])
    cuda = ctx.device.startswith("cuda")
    activities = [ProfilerActivity.CUDA] if cuda else []
    if host or not cuda:
        activities.append(ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        with record_function(trace.WINDOW):
            sync(ctx.device)
            t0 = time.perf_counter()
            window = driver.run(seconds, max_units=units)
            sync(ctx.device)
            wall = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        del prof
        summary = trace.load(path)
    finally:
        os.unlink(path)
    summary.window_s = wall
    return window, summary


def run(cell: spec.Cell, seed: int, seconds: float, traced: bool, *, device: str = "cuda",
        started: Optional[float] = None, model_overrides: Optional[Dict] = None) -> Dict:
    """One run of ``cell``: the result line's fields, ``checks`` last.
    ``started``: the process's start on ``time.perf_counter``'s clock."""
    import torch

    started = time.perf_counter() if started is None else started
    cuda = device.startswith("cuda")
    ctx = Context(cell, seed, device, dict(model_overrides or {}))
    driver = cell.generator().Driver(ctx)
    try:
        driver.setup()
        sync(device)
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        result: Dict = {}
        if not traced:
            setup_s = time.perf_counter() - started
            window = driver.run(seconds)
            values = {
                driver.rate_metric: window.samples / window.wall_s,
                driver.tail_metric: percentile(window.unit_ms, 0.9),
                "setup_s": setup_s,
            }
        else:
            # the device alone for the metrics; then the host too, for what
            # it was doing in the longest gaps (its recording slows the host)
            before = port_counters()
            window, summary = _profile(driver, ctx, seconds, host=False)
            report_counters(before, port_counters(), summary)
            hosted, with_host = _profile(driver, ctx, seconds, host=True)
            # the untraced rest of the window, at least a quarter of it
            stretch = driver.run(max(seconds - window.wall_s - hosted.wall_s, seconds / 4))
            info = Traced(summary, window, stretch, _sites(driver, window),
                          _sites(driver, stretch), driver.train,
                          torch.cuda.max_memory_allocated() if cuda else 0)
            values = {}
            for m in cell.per_layer:
                v = cell.metric_reader(m["name"]).read(info)
                if v is not None:
                    values[m["name"]] = v
            result["busy_s"] = summary.busy_s
            result["window_s"] = summary.window_s
            result["breakdown"] = {"device_ops": summary.top_ops(),
                                   "idle_gaps": [list(g) for g in with_host.gaps]}
            window = Window(window.samples + hosted.samples + stretch.samples,
                            window.units + hosted.units + stretch.units, [], 0.0,
                            window.failed + hosted.failed + stretch.failed)
        if cuda:
            peak = max(peak, torch.cuda.max_memory_allocated())
        readings = driver.readings()
    finally:
        driver.close()
        gc.collect()
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    device_info = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "count": cell.chips,
        "memory_peak_bytes": peak,
    }
    for k in ("busy_s", "window_s"):
        if k in result:
            device_info[k] = result[k]
    verdict = compare.judge(readings, cell.workload["limits"])
    out = {
        "correct": verdict["correct"],
        "attempted": len(window.units),
        "failed": window.failed,
        "metrics": {k: {"value": v, "unit": units[k]} for k, v in values.items()},
        "device": device_info,
    }
    if "breakdown" in result:
        out["breakdown"] = result["breakdown"]
    out["checks"] = verdict["checks"]
    return out


def free_device_memory() -> None:
    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
