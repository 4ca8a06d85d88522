"""Spans at the port's layer boundaries, on the profiler's clock.

``span(name, **attrs)`` marks one phase of the program: a train step and
its forward, backward and update, a task's step, the wait for a staged
batch, an evaluation batch with its copy to the device and its scoring.
Each has a reader in the benchmark (``benchmark/harness/spans.py``). A span
records only while a ``torch.profiler`` session records (the benchmark's
traced run, ``train.logger.MetricsLogger.start_trace``, anyone's own
profiler); otherwise it is one shared no-op context, at the cost of a
function call and one attribute read. While one records, a span

- enters ``torch.profiler.record_function`` (named ``<name>:<task>`` where
  it has a ``task`` attribute), so that it lies in the profiler's Chrome
  trace as a ``user_annotation`` beside the kernels, on Kineto's clock;
- appends a record to a log in memory (``records()``): its name, the index
  of the span it ran inside on the same thread, its host start and end
  (``time.perf_counter_ns``), its attributes and, for a span opened with
  ``device=True`` once CUDA is initialised, its stream time: the interval
  between two CUDA events recorded on the current stream at its ends. That
  is the time the stream took to run the phase, the device's waits for the
  host's launches inside it included, and not the device's busy time.

The log holds at most ``MAX_RECORDS`` records. Past that it records
nothing more and ``overflowed()`` is true until ``clear()``, so that a
reader can refuse a log with a hole in it. Spans go at layer boundaries
only: none inside models, ops or kernels (the device trace times their
launches already), and none on a staging thread (a trace's idle gaps are
labelled by the innermost span over all the host's threads, which would
then be the producer's).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List

import torch
from torch.autograd import profiler as _autograd_profiler

#: records the log holds at most
MAX_RECORDS = 65536

_log: List[Dict[str, Any]] = []
_lock = threading.Lock()
_local = threading.local()  # .stack: indices of the spans open on this thread
_overflowed = False
_FLAG = hasattr(_autograd_profiler, "_is_profiler_enabled")


class _Off:
    """What ``span`` returns while no profiler records. It is false, so that
    an attribute that costs something to compute is set only on a span that
    records: ``if s: s.set(rows=...)``."""

    __slots__ = ()

    def __bool__(self) -> bool:
        return False

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()


def span(name: str, *, device: bool = False, **attrs):
    """A context manager over one phase of the program, named ``name``,
    with ``attrs`` (numbers or strings); ``device``: also take the current
    CUDA stream's time over it. ``set(**attrs)`` on the entered span adds
    attributes known only inside it."""
    on = (_autograd_profiler._is_profiler_enabled if _FLAG
          else torch.autograd._profiler_enabled())
    if not on:
        return _OFF
    return _Span(name, device, attrs)


def _stack() -> List:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "device", "attrs", "_fn", "_record", "_start")

    def __init__(self, name: str, device: bool, attrs: Dict[str, Any]):
        self.name, self.device, self.attrs = name, device, attrs

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self):
        global _overflowed
        task = self.attrs.get("task")
        self._fn = torch.profiler.record_function(
            self.name if task is None else f"{self.name}:{task}")
        self._fn.__enter__()
        stack = _stack()
        record = index = None
        with _lock:
            if len(_log) < MAX_RECORDS:
                index = len(_log)
                record = {"name": self.name, "parent": stack[-1] if stack else None,
                          "start_ns": time.perf_counter_ns(), "end_ns": None,
                          "attrs": self.attrs, "device_ms": None}
                _log.append(record)
            else:
                _overflowed = True
        stack.append(index)
        self._record, self._start = record, None
        if record is not None and self.device and torch.cuda.is_initialized():
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record()
        return self

    def __exit__(self, *exc) -> bool:
        record = self._record
        if record is not None:
            if self._start is not None:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                record["_events"] = (self._start, end)
            record["end_ns"] = time.perf_counter_ns()
        _stack().pop()
        self._fn.__exit__(*exc)
        return False


def records() -> List[Dict[str, Any]]:
    """The log, oldest span first: each record's ``name``, ``parent`` (the
    index in this list of the span it ran inside, or None), ``start_ns``
    and ``end_ns``, ``attrs`` and ``device_ms``, the stream time (None on a
    CPU and for a host-only span). Resolves the stream times, waiting for
    each span's end event: read it after a synchronize."""
    with _lock:
        log = list(_log)
    out = []
    for record in log:
        events = record.pop("_events", None)
        if events is not None:
            events[1].synchronize()
            record["device_ms"] = events[0].elapsed_time(events[1])
        out.append(dict(record, attrs=dict(record["attrs"])))
    return out


def overflowed() -> bool:
    """Whether a span found the log full since the last ``clear()``."""
    return _overflowed


def clear() -> None:
    """Empty the log (outside any open span)."""
    global _overflowed
    with _lock:
        _log.clear()
        _overflowed = False
