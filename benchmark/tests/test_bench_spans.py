"""``harness/spans.py`` and the readers of the program's spans, on hand-built
span logs; and a traced run of the tiny cells on the CPU, where the host
spans are read and the device ones are not."""

from types import SimpleNamespace

import pytest

import tiny
from harness import cell as run_cell
from harness import spans, spec


def rec(name, parent=None, ms=1.0, device_ms=None, **attrs):
    """A record as ``core.tracing.records()`` gives it, ``ms`` long."""
    return {"name": name, "parent": parent, "start_ns": 0, "end_ns": int(ms * 1e6),
            "attrs": attrs, "device_ms": device_ms}


def cc_log(steps=3, rows=4):
    """``steps`` CC steps, each with its three phases."""
    out = []
    for s in range(steps):
        i = len(out)
        out.append(rec("train.step", device_ms=10.0 + s, rows=rows))
        out.append(rec("step.forward", i, device_ms=2.0 + s))
        out.append(rec("step.backward", i, device_ms=5.0 + s))
        out.append(rec("step.optimizer", i, device_ms=1.5))
    return out


def test_first_units_and_their_descendants():
    log = cc_log(3)
    got = spans.window_spans(log, False, 2, 8)
    assert got == log[:8]


def test_task_steps_are_the_units_where_there_are_any():
    log = [rec("train.task_step", task="TASK1", rows=3),
           rec("data.stage_wait", 0, ms=0.25),
           rec("train.step", 0, device_ms=9.0, rows=3),
           rec("step.forward", 2, device_ms=4.0),
           rec("train.task_step", task="TASK4", rows=5),
           rec("data.stage_wait", 4, ms=0.75),
           rec("train.step", 4, device_ms=9.0, rows=5)]
    assert spans.window_spans(log, False, 2, 8) == log
    assert spans.window_spans(log, False, 1, 3) == log[:4]


@pytest.mark.parametrize("overflowed, units, samples", [
    (True, 2, 8),    # the log has a hole
    (False, 4, 16),  # fewer unit spans than units
    (False, 2, 9),   # rows that do not sum to the samples
    (False, 0, 0),   # no unit
    (False, 1, 4),   # more unit spans than two windows': a run before left its log
])
def test_nothing_where_the_log_cannot_stand_for_the_window(overflowed, units, samples):
    assert spans.window_spans(cc_log(3), overflowed, units, samples) is None


def test_no_unit_span_is_nothing():
    assert spans.window_spans([rec("data.stage_wait")], False, 1, 4) is None


def _window(units, samples):
    return SimpleNamespace(window=SimpleNamespace(units=["u"] * units, samples=samples))


def _reader(name):
    return spec.load_module(spec.BENCH_DIR / "metrics" / f"{name}.py")


@pytest.mark.parametrize("name, want", [
    ("forward_ms_per_sample", (2.0 + 3.0) / 8),
    ("backward_ms_per_sample", (5.0 + 6.0) / 8),
    ("optimizer_ms_per_sample", (1.5 + 1.5) / 8),
])
def test_step_phase_readers_by_hand(monkeypatch, name, want):
    monkeypatch.setattr(spans, "program_log", lambda: (cc_log(3), False))
    assert _reader(name).read(_window(2, 8)) == pytest.approx(want)


def test_readers_by_hand_on_host_spans(monkeypatch):
    log = [rec("train.task_step", task="TASK1", rows=3),
           rec("data.stage_wait", 0, ms=0.25),
           rec("train.task_step", task="TASK4", rows=5),
           rec("data.stage_wait", 2, ms=0.75)]
    monkeypatch.setattr(spans, "program_log", lambda: (log, False))
    assert _reader("stage_wait_ms_per_sample").read(_window(2, 8)) == pytest.approx(1.0 / 8)
    batches = [rec("eval.batch", rows=1024), rec("eval.h2d", 0, ms=80.0),
               rec("eval.score", 0, ms=40.0), rec("eval.batch", rows=1000),
               rec("eval.h2d", 3, ms=60.0), rec("eval.score", 3, ms=24.0)]
    monkeypatch.setattr(spans, "program_log", lambda: (batches, False))
    assert _reader("score_ms_per_sample.eval").read(_window(2, 2024)) == pytest.approx(
        64.0 / 2024)
    assert _reader("h2d_host_ms_per_sample.eval").read(_window(2, 2024)) == pytest.approx(
        140.0 / 2024)


def test_device_readers_read_nothing_without_device_times(monkeypatch):
    log = [dict(r, device_ms=None) for r in cc_log(2)]
    monkeypatch.setattr(spans, "program_log", lambda: (log, False))
    assert _reader("forward_ms_per_sample").read(_window(2, 8)) is None
    monkeypatch.setattr(spans, "program_log", lambda: None)  # a program without spans
    assert _reader("backward_ms_per_sample").read(_window(2, 8)) is None


@pytest.mark.parametrize("name, host, device", [
    ("vilbert_6l6c.multitask12", ["stage_wait_ms_per_sample"],
     ["forward_ms_per_sample", "backward_ms_per_sample", "optimizer_ms_per_sample"]),
    ("vilbert_6l6c.vqa_eval",
     ["score_ms_per_sample.eval", "h2d_host_ms_per_sample.eval"], []),
])
def test_a_traced_run_on_the_cpu_reads_the_host_spans(name, host, device):
    """A traced run of the tiny cell on the CPU: the host spans' metrics are
    read (the program's rows summed to the window's samples), the device
    ones are left out (no device time on a CPU)."""
    from vilbert_tpu_torch.core import tracing

    tracing.clear()
    try:
        out = run_cell.run(tiny.tiny_cell(name), 2 ** 32 + 5, 0.3, True, device="cpu")
    finally:
        tracing.clear()
    assert out["correct"]
    for m in host:
        assert out["metrics"][m]["value"] >= 0 and out["metrics"][m]["unit"] == "ms"
    assert not set(device) & set(out["metrics"])
