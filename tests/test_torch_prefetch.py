"""The port's batch staging (``data.prefetch.device_prefetch``), on the CPU.

The cases of ``tests/test_prefetch.py`` for the port (order, transform,
the loader's exception raised again at the consumer, epochs, the transfer
compression against the JAX package's), then what the staging thread must
not change: depths 0, 1 and 2 yield the same batches in the same order,
bit for bit, and a 3-step ``run_pretraining`` and a 2-iteration
multi-task trainer (with and without gradient accumulation) give identical
losses and weights at depths 0 and 2, with dropout on (the dropout and NCE
streams stay on the main thread). A loader that fails stops the step with
its exception. Closing the stream stops its thread.
"""

import threading

import numpy as np
import pytest
import torch

from vilbert_tpu.core.config import OptimizerConfig


def _batches(n=6):
    rng = np.random.RandomState(0)
    return [{"x": np.full((4,), i, np.float32), "y": rng.randn(3, 5).astype(np.float32),
             "ids": rng.randint(0, 9, (3, 2)).astype(np.int32)} for i in range(n)]


def _host(b):
    from vilbert_tpu_torch.data.prefetch import to_tensors

    return to_tensors(b)


def test_prefetch_preserves_order_and_places_on_device():
    from vilbert_tpu_torch.data.prefetch import device_prefetch

    out = list(device_prefetch(iter(_batches()), size=2, device="cpu", transform=_host))
    assert len(out) == 6
    for i, b in enumerate(out):
        assert isinstance(b["x"], torch.Tensor) and b["x"].device.type == "cpu"
        np.testing.assert_array_equal(b["x"].numpy(), np.full((4,), i))


@pytest.mark.parametrize("size", [0, 1, 2])
def test_depths_yield_the_same_batches_in_order(size):
    """Depth 0 (built on the caller's thread) and depths 1 and 2 (the
    staging thread) give the batches of the loader, in its order, bit for
    bit and in their dtypes."""
    from vilbert_tpu_torch.data.prefetch import device_prefetch

    want = _batches(7)
    got = list(device_prefetch(iter(want), size=size, device="cpu", transform=_host))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == torch.from_numpy(w[k]).dtype
            assert torch.equal(g[k], torch.from_numpy(w[k])), k


def test_prefetch_transform_applied():
    from vilbert_tpu_torch.data.prefetch import device_prefetch

    batches = [{"x": np.ones((2,)), "drop_me": np.zeros((1,))} for _ in range(3)]
    out = list(device_prefetch(
        iter(batches), size=1, device="cpu",
        transform=lambda b: _host({k: v for k, v in b.items() if k != "drop_me"})))
    assert all(set(b) == {"x"} for b in out)


def test_placer_replaces_the_copy():
    from vilbert_tpu_torch.data.prefetch import device_prefetch

    out = list(device_prefetch(iter(_batches(3)), size=2, device="cpu", transform=_host,
                               placer=lambda b: {"n": int(b["x"][0])}))
    assert out == [{"n": 0}, {"n": 1}, {"n": 2}]


@pytest.mark.parametrize("size", [0, 1, 2])
def test_prefetch_propagates_producer_errors(size):
    from vilbert_tpu_torch.data.prefetch import device_prefetch

    def bad_iter():
        yield {"x": np.ones((2,))}
        raise RuntimeError("boom")

    it = device_prefetch(bad_iter(), size=size, device="cpu", transform=_host)
    next(it)
    with pytest.raises(RuntimeError, match="boom"):
        list(it)


def test_closing_the_stream_stops_its_thread():
    """An endless loader behind a full queue: closing the consumer ends the
    producer thread."""
    from vilbert_tpu_torch.data.prefetch import device_prefetch

    def endless():
        i = 0
        while True:
            yield {"x": np.full((2,), i, np.float32)}
            i += 1

    before = {t.ident for t in threading.enumerate()}
    it = device_prefetch(endless(), size=2, device="cpu", transform=_host)
    assert int(next(it)["x"][0]) == 0
    started = [t for t in threading.enumerate()
               if t.ident not in before and t.name == "device_prefetch"]
    assert len(started) == 1
    it.close()
    started[0].join(timeout=10)
    assert not started[0].is_alive()


def test_repeat_iterator_restarts_epochs():
    from vilbert_tpu_torch.data.prefetch import repeat_iterator

    calls = []

    def make():
        calls.append(1)
        return iter([1, 2])

    it = repeat_iterator(make)
    got = [next(it) for _ in range(5)]
    assert got == [1, 2, 1, 2, 1]
    assert len(calls) == 3
    with pytest.raises(ValueError, match="no batch"):
        next(repeat_iterator(lambda: iter([])))


@pytest.mark.parametrize("compute, raw", [("float32", False), ("bfloat16", False),
                                          ("bfloat16", True)])
def test_compress_for_transfer_matches_jax(compute, raw):
    """The port's compression gives the JAX package's values and dtypes."""
    import ml_dtypes

    from vilbert_tpu.data.prefetch import compress_for_transfer as jax_compress
    from vilbert_tpu_torch.data.prefetch import compress_for_transfer, to_tensors

    rng = np.random.RandomState(0)
    b = {"image_feat": rng.randn(4, 5, 8).astype(np.float32),
         "features": rng.randn(4, 5, 8).astype(np.float32),
         "image_target": (rng.rand(4, 4, 6) * 1e3).astype(np.float32),
         "input_ids": np.ones((4, 7), np.int32)}
    want = jax_compress(b, compute, raw_feature_targets=raw)
    got = compress_for_transfer(to_tensors(b), compute, raw_feature_targets=raw)
    for k, w in want.items():
        w = np.asarray(w)
        g = got[k]
        if w.dtype == ml_dtypes.bfloat16:
            assert g.dtype == torch.bfloat16, k
            np.testing.assert_array_equal(g.float().numpy(), w.astype(np.float32))
        else:
            assert g.numpy().dtype == w.dtype, k
            np.testing.assert_array_equal(g.numpy(), w)


# -- the drivers at depths 0 and 2 ----------------------------------------------

def _dropout_cfg(cfg, **kw):
    return cfg.replace(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
                       v_hidden_dropout_prob=0.1, v_attention_probs_dropout_prob=0.1, **kw)


def _cc_batch(cfg, seed, b=4, t=7, r=5):
    rng = np.random.RandomState(seed)
    target_dim = cfg.v_feature_size if cfg.visual_target else cfg.v_target_size
    target = rng.rand(b, r - 1, target_dim).astype(np.float32)
    target /= target.sum(-1, keepdims=True)
    return {
        "input_ids": rng.randint(1, cfg.vocab_size, (b, t)).astype(np.int32),
        "image_feat": rng.randn(b, r, cfg.v_feature_size).astype(np.float32),
        "image_loc": rng.rand(b, r, 5).astype(np.float32),
        "segment_ids": np.zeros((b, t), np.int32),
        "input_mask": np.ones((b, t), np.int32),
        "image_mask": np.ones((b, r), np.int32),
        "lm_label_ids": np.where(rng.rand(b, t) < 0.4, rng.randint(0, cfg.vocab_size, (b, t)),
                                 -1).astype(np.int32),
        "image_label": np.where(rng.rand(b, r - 1) < 0.4, 1, -1).astype(np.int32),
        "image_target": target,
        "is_next": rng.randint(0, 2, (b,)).astype(np.int32),
        "image_id": np.arange(b),
    }


def _run_cc(cfg, batches, depth, **kw):
    from vilbert_tpu_torch.train.pretrain import run_pretraining

    losses = []
    state = run_pretraining(
        cfg, OptimizerConfig(learning_rate=1e-3, schedule="constant"), batches,
        num_steps=3, seed=0, device="cpu", lm_gather=3, log_every=0, prefetch_batches=depth,
        hooks=[lambda s, st, m: losses.append({k: v.item() for k, v in m.items()})], **kw)
    return losses, state.model.state_dict()


@pytest.mark.parametrize("visual_target, grad_accum", [(0, 1), (2, 2)])
def test_run_pretraining_is_the_same_at_depths_0_and_2(tiny_config, visual_target, grad_accum):
    """Three steps with dropout 0.1 (and NCE, whose negatives come from the
    main thread's generator, with gradient accumulation): the same metrics
    and weights, bit for bit, with and without the staging thread."""
    cfg = _dropout_cfg(tiny_config, visual_target=visual_target, num_negative=4)
    batches = [_cc_batch(cfg, 40 + i) for i in range(2)]  # the loader wraps
    a, wa = _run_cc(cfg, batches, 0, grad_accum=grad_accum)
    b, wb = _run_cc(cfg, batches, 2, grad_accum=grad_accum)
    assert len(a) == 3 and a == b and all(np.isfinite(m["loss"]) for m in a)
    assert all(torch.equal(wa[k], wb[k]) for k in wa)


class _FailingLoader:
    batch_size = 2

    def __init__(self, batches, fail_at):
        self.batches, self.fail_at = batches, fail_at

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        for i, b in enumerate(self.batches):
            if i == self.fail_at:
                raise RuntimeError("loader failed")
            yield b


@pytest.mark.parametrize("depth", [0, 2])
def test_a_loader_error_stops_run_pretraining(tiny_config, depth):
    cfg = _dropout_cfg(tiny_config)
    steps = []
    from vilbert_tpu_torch.train.pretrain import run_pretraining

    loader = _FailingLoader([_cc_batch(cfg, 50 + i) for i in range(3)], fail_at=2)
    with pytest.raises(RuntimeError, match="loader failed"):
        run_pretraining(cfg, OptimizerConfig(learning_rate=1e-3, schedule="constant"), loader,
                        num_steps=3, seed=0, device="cpu", lm_gather=3, log_every=0,
                        prefetch_batches=depth, hooks=[lambda s, st, m: steps.append(s)])
    assert steps == [0, 1]  # the two batches before the failure were trained on


def _task_setup(cfg, n=4):
    from vilbert_tpu_torch.core.config import TaskConfig

    tasks = {
        "TASK1": TaskConfig(task_id=1, name="VQA", type="VL-classifier",
                            loss="BCEWithLogitLoss", batch_size=2, lr=4e-5, num_epoch=2,
                            num_labels=13),
        "TASK9": TaskConfig(task_id=9, name="VE", type="VL-tri-classifier",
                            loss="CrossEntropyLoss", batch_size=2, lr=2e-5, num_epoch=2,
                            num_labels=3),
    }

    def batches(key, seed):
        rng = np.random.RandomState(seed)
        out = []
        for _ in range(n):
            out.append({
                "question": rng.randint(1, cfg.vocab_size, (2, 6)).astype(np.int64),
                "features": rng.randn(2, 5, cfg.v_feature_size).astype(np.float32),
                "spatials": rng.rand(2, 5, 5).astype(np.float32),
                "segment_ids": np.zeros((2, 6), np.int64),
                "input_mask": np.ones((2, 6), np.int64),
                "image_mask": np.ones((2, 5), np.int64),
                "co_attention_mask": np.zeros((2, 5, 6), np.float32),
                "question_id": np.arange(2),
                "target": (rng.rand(2, 13).astype(np.float32) if key == "TASK1"
                           else rng.randint(0, 3, (2,)).astype(np.int64)),
            })
        return out

    class Loader(list):
        batch_size = 2

    loaders = {k: Loader(batches(k, 60 + i)) for i, k in enumerate(tasks)}
    return tasks, loaders


def _run_trainer(cfg, depth, grad_accum, fail=False):
    from vilbert_tpu_torch.core.config import TrainConfig
    from vilbert_tpu_torch.train.multitask import MultiTaskTrainer

    tasks, loaders = _task_setup(cfg)
    if fail:
        loaders["TASK9"] = _FailingLoader(loaders["TASK9"], 1)
    trainer = MultiTaskTrainer(
        cfg, tasks, loaders, num_labels=13, seed=0, device="cpu", dropout_prob=0.1,
        train_cfg=TrainConfig(prefetch_batches=depth, gradient_accumulation_steps=grad_accum))
    losses = []
    trainer.train(max_iterations=2, log_every=0, hooks=[
        lambda e, it, tr, m: losses.append({k: v["loss"].item() for k, v in m.items()})])
    trainer.close()
    return losses, trainer.model.state_dict()


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_trainer_is_the_same_at_depths_0_and_2(tiny_config, grad_accum):
    """Two round-robin iterations over two tasks with dropout 0.1: the same
    losses and weights, bit for bit, at ``prefetch_batches`` 0 and 2 (with
    gradient accumulation the thread stacks the microbatches)."""
    cfg = _dropout_cfg(tiny_config)
    a, wa = _run_trainer(cfg, 0, grad_accum)
    b, wb = _run_trainer(cfg, 2, grad_accum)
    assert len(a) == 2 and a == b
    assert all(np.isfinite(v) for m in a for v in m.values())
    assert all(torch.equal(wa[k], wb[k]) for k in wa)


def test_a_loader_error_stops_the_trainer(tiny_config):
    """The second batch of a task fails in its staging thread: the step
    that asks for it raises the loader's exception."""
    with pytest.raises(RuntimeError, match="loader failed"):
        _run_trainer(tiny_config, 2, 1, fail=True)


def test_embed_is_the_embedding_lookup():
    """The lookup by selecting among a few rows (whose backward sums
    repeated ids in a fixed order on CUDA, so that a run repeats bit for bit
    at any depth) gives ``nn.Embedding``'s rows, and its gradient, with
    every id repeated: a token-type table of 2 rows, and one of 5."""
    from torch import nn

    from vilbert_tpu_torch.models.layers import embed

    g = torch.Generator().manual_seed(0)
    for rows in (2, 5):
        table = nn.Embedding(rows, 8)
        ids = torch.randint(0, rows, (6, 7), generator=g)
        up = torch.randn(6, 7, 8, generator=g)
        want = table(ids)
        (want * up).sum().backward()
        want_grad, table.weight.grad = table.weight.grad.clone(), None
        got = embed(table, ids)
        (got * up).sum().backward()
        assert torch.equal(got, want)
        torch.testing.assert_close(table.weight.grad, want_grad, rtol=1e-6, atol=1e-6)


def test_a_dropped_trainer_stops_its_threads(tiny_config):
    """A trainer dropped without ``close`` stops its staging threads and
    frees its optimizer (parameters and moments): the threads hold nothing
    of it."""
    import gc
    import time
    import weakref

    from vilbert_tpu_torch.core.config import TrainConfig
    from vilbert_tpu_torch.train.multitask import MultiTaskTrainer

    tasks, loaders = _task_setup(tiny_config)
    before = {t.ident for t in threading.enumerate()}
    trainer = MultiTaskTrainer(tiny_config, tasks, loaders, num_labels=13, seed=0,
                               device="cpu", train_cfg=TrainConfig(prefetch_batches=2))
    trainer.train_iteration(0)
    started = [t for t in threading.enumerate()
               if t.ident not in before and t.name == "device_prefetch"]
    assert len(started) == len(tasks)
    optimizer = weakref.ref(trainer.optimizer)
    del trainer
    gc.collect()
    for t in started:
        t.join(timeout=10)
    time.sleep(0.1)
    assert not any(t.is_alive() for t in started)
    assert optimizer() is None
