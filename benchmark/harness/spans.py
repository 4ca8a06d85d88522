"""The program's own spans (``vilbert_tpu_torch.core.tracing``) over the
traced window, for the per-layer readers of ``source: program_span``.

The program records spans only while a profiler records. Set-up is not
profiled, so the first spans of a traced run are the device-only window's
(``harness.cell``), then the host-traced window's. The unit span is
``train.task_step`` where the log holds one (12-in-1), else ``train.step``
(CC), else ``eval.batch`` (VQA): one for each of the benchmark's units.
``window_spans`` keeps the first ``len(t.window.units)`` unit spans and
every span inside them. It gives None where the program keeps no log (one
without ``core.tracing``), where the log overflowed, where it holds fewer
unit spans than the window's units or more than the two windows' (a log
that a run before this one in the process left), or where their ``rows``
do not sum to the window's samples: the program's count of its rows, held
to the benchmark's.

A span's ``device_ms`` is its stream time, the interval between CUDA
events at its ends: the device's waits for the host's launches inside the
span count, so a phase's stream time moves with its launches as well as
with its kernels.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from harness.yardstick import optional_ratio

UNITS = ("train.task_step", "train.step", "eval.batch")


def program_log() -> Optional[Tuple[List[Dict], bool]]:
    """(records, overflowed) of the program's span log, or None where the
    program has none."""
    try:
        from vilbert_tpu_torch.core import tracing
    except ImportError:
        return None
    return tracing.records(), tracing.overflowed()


def window_spans(records: List[Dict], overflowed: bool, units: int,
                 samples: int) -> Optional[List[Dict]]:
    """The first ``units`` unit spans of ``records`` with their descendants,
    in the log's order; None where they cannot stand for the window."""
    if overflowed:
        return None
    names = {r["name"] for r in records}
    unit = next((u for u in UNITS if u in names), None)
    found = [i for i, r in enumerate(records) if r["name"] == unit]
    if unit is None or units <= 0 or not units <= len(found) <= 2 * units:
        return None
    picked = found[:units]
    if sum(records[i]["attrs"].get("rows", 0) for i in picked) != samples:
        return None
    keep = set(picked)
    for i, r in enumerate(records):  # a span comes after the span it ran inside
        if r["parent"] in keep:
            keep.add(i)
    return [records[i] for i in sorted(keep)]


def ms_per_sample(t, name: str, device: bool) -> Optional[float]:
    """The time of the window's spans named ``name`` over its samples, ms:
    their stream time (``device``; None where any lacks one, as on a CPU)
    or their host time."""
    log = program_log()
    if log is None:
        return None
    spans = window_spans(*log, len(t.window.units), t.window.samples)
    if spans is None:
        return None
    named = [r for r in spans if r["name"] == name]
    if not named:
        return None
    if device:
        if any(r["device_ms"] is None for r in named):
            return None
        total = sum(r["device_ms"] for r in named)
    else:
        total = sum(r["end_ns"] - r["start_ns"] for r in named) / 1e6
    return optional_ratio(total, t.window.samples)
