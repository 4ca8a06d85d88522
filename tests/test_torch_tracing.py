"""The port's spans (``core.tracing``), on the CPU.

Off without a profiler: one shared no-op context, nothing recorded. Under
``torch.profiler``: the train step and its phases, with the span each ran
inside, in the log and as ``user_annotation`` events of the Chrome trace;
the staging wait of ``device_prefetch``; an evaluation batch with its copy
and its scoring; a multi-task iteration's task steps; the log's bound.
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vilbert_tpu_torch.core import tracing
from vilbert_tpu_torch.core.config import ModelConfig, OptimizerConfig, TaskConfig, TrainConfig

TINY = ModelConfig(
    vocab_size=99, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
    intermediate_size=48, max_position_embeddings=64, v_feature_size=16, v_hidden_size=24,
    v_num_hidden_layers=2, v_num_attention_heads=2, v_intermediate_size=40, v_target_size=11,
    bi_hidden_size=32, bi_num_attention_heads=2, v_biattention_id=(0, 1),
    t_biattention_id=(0, 1), compute_dtype="float32")


@pytest.fixture(autouse=True)
def empty_log():
    tracing.clear()
    yield
    tracing.clear()


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


def _names(records):
    return [r["name"] for r in records]


def _children(records, index):
    return [r for r in records if r["parent"] == index]


def test_off_without_a_profiler():
    a = tracing.span("train.step", device=True, rows=3)
    assert a is tracing.span("eval.score")
    with a as entered:
        assert not entered
        entered.set(rows=4)
    assert tracing.records() == [] and not tracing.overflowed()


def test_spans_record_their_parent_times_and_attributes():
    with _profiled():
        with tracing.span("outer", rows=2) as s:
            with tracing.span("inner", device=True):
                pass
            assert s
            s.set(extra="x")
        with tracing.span("train.task_step", task="TASK1"):
            pass
    records = tracing.records()
    assert _names(records) == ["outer", "inner", "train.task_step"]
    assert [r["parent"] for r in records] == [None, 0, None]
    assert records[0]["attrs"] == {"rows": 2, "extra": "x"}
    assert records[2]["attrs"] == {"task": "TASK1"}
    outer, inner = records[0], records[1]
    assert outer["start_ns"] <= inner["start_ns"] <= inner["end_ns"] <= outer["end_ns"]
    assert all(r["device_ms"] is None for r in records)  # no CUDA here


# -- the train step ---------------------------------------------------------------

def _cc_batches(cfg, n=2, b=4, t=7, r=5):
    rng = np.random.RandomState(3)
    out = []
    for _ in range(n):
        target = rng.rand(b, r - 1, cfg.v_target_size).astype(np.float32)
        out.append({
            "input_ids": rng.randint(1, cfg.vocab_size, (b, t)).astype(np.int32),
            "image_feat": rng.randn(b, r, cfg.v_feature_size).astype(np.float32),
            "image_loc": rng.rand(b, r, 5).astype(np.float32),
            "segment_ids": np.zeros((b, t), np.int32),
            "input_mask": np.ones((b, t), np.int32),
            "image_mask": np.ones((b, r), np.int32),
            "lm_label_ids": np.where(rng.rand(b, t) < 0.4,
                                     rng.randint(0, cfg.vocab_size, (b, t)), -1).astype(np.int32),
            "image_label": np.where(rng.rand(b, r - 1) < 0.4, 1, -1).astype(np.int32),
            "image_target": target / target.sum(-1, keepdims=True),
            "is_next": rng.randint(0, 2, (b,)).astype(np.int32),
        })
    return out


def _user_annotations(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [e for e in events if e.get("cat") == "user_annotation" and e.get("ph") == "X"]


def _inside(inner, outer):
    return outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


@pytest.mark.parametrize("grad_accum, grad_dtype", [(1, ""), (2, "bfloat16")])
def test_cc_step_spans_its_phases(tmp_path, grad_accum, grad_dtype):
    """Two CC steps of ``run_pretraining`` (the step of ``make_train_step``):
    ``train.step`` with its 4 rows over a forward and a backward a
    microbatch and the optimizer, in that order, in the log and nested so
    in the trace; nothing between the steps."""
    from vilbert_tpu_torch.train.pretrain import run_pretraining

    with _profiled() as prof:
        run_pretraining(TINY, OptimizerConfig(learning_rate=1e-3, schedule="constant"),
                        _cc_batches(TINY), num_steps=2, device="cpu", lm_gather=3,
                        log_every=0, grad_accum=grad_accum, grad_dtype=grad_dtype)
    records = tracing.records()
    steps = [i for i, r in enumerate(records) if r["name"] == "train.step"]
    phases = ["step.forward", "step.backward"] * grad_accum + ["step.optimizer"]
    assert steps == [0, 1 + len(phases)] and len(records) == 2 * (1 + len(phases))
    for i in steps:
        assert records[i]["parent"] is None and records[i]["attrs"] == {"rows": 4}
        assert _names(_children(records, i)) == phases

    events = _user_annotations(prof, tmp_path)
    step_events = [e for e in events if e["name"] == "train.step"]
    assert len(step_events) == 2
    for name in ("step.forward", "step.backward", "step.optimizer"):
        found = [e for e in events if e["name"] == name]
        assert len(found) == 2 * (grad_accum if name != "step.optimizer" else 1)
        assert all(any(_inside(e, s) for s in step_events) for e in found)


# -- the staging wait -------------------------------------------------------------

@pytest.mark.parametrize("size, names", [(2, ["data.stage_wait"] * 5), (0, [])])
def test_prefetch_spans_each_batch(size, names):
    """One span a batch taken, on the consumer's side, with a staging
    thread: the wait for the staged batch. Without one there is no wait
    and no span."""
    from vilbert_tpu_torch.data.prefetch import device_prefetch, to_tensors

    def endless():
        i = 0
        while True:
            yield {"x": np.full((3,), i, np.float32)}
            i += 1

    with _profiled():
        stream = device_prefetch(endless(), size=size, device="cpu", transform=to_tensors)
        got = [float(next(stream)["x"][0]) for _ in range(5)]
        stream.close()
    assert got == [0.0, 1.0, 2.0, 3.0, 4.0]
    records = tracing.records()
    assert _names(records) == names
    assert all(r["parent"] is None and r["end_ns"] >= r["start_ns"] for r in records)


# -- evaluation -------------------------------------------------------------------

def _vqa_batches(cfg, sizes, t=6, r=5):
    rng = np.random.RandomState(5)
    out, qid = [], 0
    for b in sizes:
        out.append({
            "question": rng.randint(1, cfg.vocab_size, (b, t)).astype(np.int64),
            "features": rng.randn(b, r, cfg.v_feature_size).astype(np.float32),
            "spatials": rng.rand(b, r, 5).astype(np.float32),
            "segment_ids": np.zeros((b, t), np.int64),
            "input_mask": np.ones((b, t), np.int64),
            "image_mask": np.ones((b, r), np.int64),
            "co_attention_mask": np.zeros((b, r, t), np.float32),
            "question_id": np.arange(qid, qid + b),
            "target": rng.rand(b, 13).astype(np.float32),
        })
        qid += b
    return out


def test_evaluate_task_spans_each_batch():
    """Three batches (2, 2 and a short 1, padded): one ``eval.batch`` each
    over ``eval.h2d`` and ``eval.score``; their rows sum to the questions
    evaluated."""
    from vilbert_tpu_torch.eval.evaluators import evaluate_task
    from vilbert_tpu_torch.models.vilbert import ViLBERTForVLTasks

    class Loader(list):
        batch_size = 2

    task = TaskConfig(task_id=1, name="VQA", type="VL-classifier", loss="BCEWithLogitLoss",
                      num_labels=13)
    model = ViLBERTForVLTasks(TINY, num_labels=13, generator=torch.Generator().manual_seed(0))
    with _profiled():
        metrics, _ = evaluate_task(model, TINY, task, Loader(_vqa_batches(TINY, [2, 2, 1])))
    records = tracing.records()
    batches = [i for i, r in enumerate(records) if r["name"] == "eval.batch"]
    assert len(batches) == 3 and metrics["num_samples"] == 5
    assert sum(records[i]["attrs"]["rows"] for i in batches) == 5
    for i in batches:
        assert _names(_children(records, i)) == ["eval.h2d", "eval.score"]
    assert len(records) == 9


# -- the multi-task iteration -----------------------------------------------------

def test_train_iteration_spans_each_task_step():
    """One iteration over two tasks staged 2 ahead: a ``train.task_step`` a
    task with its key and its loader rows, over the staging wait and the
    task's train step."""
    from vilbert_tpu_torch.train.multitask import MultiTaskTrainer

    class Loader(list):
        batch_size = 3

    tasks = {
        "TASK1": TaskConfig(task_id=1, name="VQA", type="VL-classifier",
                            loss="BCEWithLogitLoss", batch_size=3, num_labels=13),
        "TASK13": TaskConfig(task_id=13, name="VisualEntailment", type="VL-tri-classifier",
                             loss="CrossEntropyLoss", batch_size=3, num_labels=3),
    }
    loaders = {k: Loader(_vqa_batches(TINY, [3, 3])) for k in tasks}
    for b in loaders["TASK13"]:  # three-way labels
        b["target"] = np.arange(3)
    trainer = MultiTaskTrainer(TINY, tasks, loaders, num_labels=13, seed=0, device="cpu",
                               train_cfg=TrainConfig(prefetch_batches=2))
    try:
        with _profiled():
            trainer.train_iteration(0)
    finally:
        trainer.close()
    records = tracing.records()
    steps = [i for i, r in enumerate(records) if r["name"] == "train.task_step"]
    assert [records[i]["attrs"] for i in steps] == [{"task": "TASK1", "rows": 3},
                                                    {"task": "TASK13", "rows": 3}]
    for i in steps:
        assert records[i]["parent"] is None
        assert _names(_children(records, i)) == ["data.stage_wait", "train.step"]


# -- the bound --------------------------------------------------------------------

def test_the_log_stops_at_its_bound(monkeypatch):
    monkeypatch.setattr(tracing, "MAX_RECORDS", 3)
    with _profiled():
        for _ in range(5):
            with tracing.span("train.step"):
                pass
    assert len(tracing.records()) == 3 and tracing.overflowed()
    tracing.clear()
    assert tracing.records() == [] and not tracing.overflowed()
