"""The port's multi-task slice against the JAX package, on the CPU.

Task losses and scores for every head type; ``HostLRScheduler`` (every
epoch schedule, with ``mid_iteration`` and ``on_epoch_end``) bit for bit;
``task_update_mask`` for every task type; the stop controllers; the eval
cadence; the metrics logger; and a three-iteration round-robin trajectory
of ``MultiTaskTrainer`` over four tasks (normal, V-logit-mc, retrieval,
nlvr) with the external learning rate and the ``mannul`` schedule: each
task's loss, every parameter and both Adam moments afterwards against the
JAX trainer, from the same weights, at fp32 with dropout off.

The pretraining heads' fuse dropout has a fixed rate of 0.1 (reference
BertPreTrainingHeads), which the JAX trainer's train-mode loss applies: its
task losses run ``deterministic=True`` here and the port sets that one
site to rate 0, as ``tests/test_torch_train.py`` does.
"""

import dataclasses
import functools
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vilbert_tpu.core.importer import _flatten

TASK_TYPES = ("VL-classifier", "VL-classifier-GQA", "VL-logit", "V-logit", "V-logit-mc",
              "VL-binary-classifier", "VL-tri-classifier")


def _t(a):
    return torch.from_numpy(np.array(a))


def _flax(named_tensors):
    from vilbert_tpu_torch.core.weights import flax_from_state_dict

    return _flatten(flax_from_state_dict(named_tensors))


# -- losses --------------------------------------------------------------------

def _logits_and_target(task_type, rng, B=6):
    if task_type in ("VL-classifier", "VL-classifier-GQA"):
        target = np.zeros((B, 17), np.float32)
        for i in range(B):
            target[i, rng.randint(0, 17, 3)] = rng.choice([0.3, 0.6, 1.0], 3)
        return rng.randn(B, 17).astype(np.float32) * 2, target
    if task_type in ("V-logit", "V-logit-mc"):
        n = 9 if task_type == "V-logit" else 4
        target = (rng.rand(B, n, 1) < 0.3).astype(np.float32)
        return rng.randn(B, n, 1).astype(np.float32) * 2, target
    classes = {"VL-logit": 4, "VL-binary-classifier": 2, "VL-tri-classifier": 3}[task_type]
    return (rng.randn(B, classes).astype(np.float32) * 2,
            rng.randint(0, classes, (B,)).astype(np.int32))


@pytest.mark.parametrize("task_type", TASK_TYPES)
def test_task_loss_and_score_match(task_type):
    from vilbert_tpu.train.losses import task_loss_and_score as jax_fn
    from vilbert_tpu_torch.train.losses import task_loss_and_score

    rng = np.random.RandomState(TASK_TYPES.index(task_type))
    logits, target = _logits_and_target(task_type, rng)
    want_loss, want_score = jax_fn(task_type, jnp.asarray(logits), jnp.asarray(target))
    loss, score = task_loss_and_score(task_type, _t(logits), _t(target))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-6)
    np.testing.assert_allclose(score.item(), float(want_score), rtol=1e-6, atol=1e-7)


def test_loss_helpers_match():
    from vilbert_tpu.train import losses as jl
    from vilbert_tpu_torch.train import losses as pl

    rng = np.random.RandomState(7)
    logits, soft = rng.randn(5, 11).astype(np.float32) * 3, rng.rand(5, 11).astype(np.float32)
    labels = rng.randint(0, 11, (5,)).astype(np.int32)
    np.testing.assert_allclose(pl.bce_with_logits(_t(logits), _t(soft)).item(),
                               float(jl.bce_with_logits(logits, soft)), rtol=1e-6)
    np.testing.assert_allclose(pl.cross_entropy(_t(logits), _t(labels)).item(),
                               float(jl.cross_entropy(logits, labels)), rtol=1e-6)
    np.testing.assert_allclose(pl.compute_score_with_logits(_t(logits), _t(soft)).item(),
                               float(jl.compute_score_with_logits(logits, soft)), rtol=1e-6)


# -- schedules -----------------------------------------------------------------

@pytest.mark.parametrize("kind", ["mannul", "automatic", "cosine", "cosine_warm"])
def test_host_lr_scheduler_matches_bit_for_bit(kind):
    """Iteration LRs, ``mid_iteration`` and the epoch-end transitions over 9
    epochs of 7 iterations; "automatic" sees a val-score sum that rises,
    plateaus and falls."""
    from vilbert_tpu.train.optim import HostLRScheduler as JaxScheduler
    from vilbert_tpu_torch.train.optim import HostLRScheduler

    port, ref = (cls(kind, 3e-5, 63, 0.1) for cls in (HostLRScheduler, JaxScheduler))
    scores = [0.1, 0.3, 0.31, 0.31, 0.2, 0.2, 0.2, 0.5, 0.4]
    for epoch in range(9):
        for it in range(7):
            step = epoch * 7 + it
            assert port(step) == ref(step), (epoch, it)
            assert port.mid_iteration(step) == ref.mid_iteration(step), (epoch, it)
        port.on_epoch_end(epoch, scores[epoch])
        ref.on_epoch_end(epoch, scores[epoch])
        assert port.state_dict() == ref.state_dict()
    if kind in ("mannul", "automatic"):
        assert port.decay_factor < 1.0  # a transition happened


@pytest.mark.parametrize("kind", ["mannul", "warmup_linear"])
def test_make_schedule_routes_epoch_schedules(kind):
    from vilbert_tpu_torch.core.config import OptimizerConfig
    from vilbert_tpu_torch.train.optim import HostLRScheduler, build_optimizer, make_schedule

    cfg = OptimizerConfig(learning_rate=1e-3, schedule=kind)
    assert isinstance(make_schedule(cfg, 1e-3, 10), HostLRScheduler) == (kind == "mannul")
    params = {"bert.encoder.layer.0.attention.self.query.bias": torch.zeros(3)}
    opt, _ = build_optimizer(cfg, params, 10, external_lr=True)
    assert opt.schedule is None
    if kind == "mannul":
        with pytest.raises(ValueError, match="external_lr"):
            build_optimizer(cfg, params, 10)


def test_external_lr_and_masked_update_match_reference_adamw():
    """Three steps of ``reference_adamw`` in external-lr mode, each with
    another participation mask and host learning rate (one optimizer state
    for all masks, as the trainer shares it), against the port's
    ``ReferenceAdamW.step(grads, lr=, mask=)``."""
    import optax

    from vilbert_tpu.core.config import OptimizerConfig
    from vilbert_tpu.train.optim import build_optimizer as jax_build
    from vilbert_tpu_torch.train.optim import build_optimizer

    rng = np.random.RandomState(0)
    names = ["bert.encoder.layer.0.attention.self.query.weight",
             "bert.encoder.layer.0.attention.self.query.bias",
             "vil_prediction.logit_fc.0.weight", "vil_logit.weight"]
    shapes = [(6, 5), (6,), (4, 5), (1, 5)]
    init = {n: rng.randn(*s).astype(np.float32) for n, s in zip(names, shapes)}
    cfg = OptimizerConfig(learning_rate=1e-3, schedule="mannul", head_lr=5e-3,
                          correct_bias=False)
    port = {n: torch.from_numpy(v.copy()) for n, v in init.items()}
    opt, _ = build_optimizer(cfg, port, 10, external_lr=True)
    jparams = jax.tree.map(jnp.asarray, _flatten_tree(init))
    state = None
    for step, (lr, drop) in enumerate([(1e-3, "vil_logit.weight"),
                                        (2e-4, "vil_prediction.logit_fc.0.weight"),
                                        (5e-4, None)]):
        mask = {n: n != drop for n in names}
        grads = {n: rng.randn(*s).astype(np.float32) for n, s in zip(names, shapes)}
        opt.step({n: torch.from_numpy(g) for n, g in grads.items() if mask[n]}, lr=lr, mask=mask)
        tx, _ = jax_build(cfg, jparams, 10, external_lr=True,
                          update_mask=_flatten_tree({n: m for n, m in mask.items()}))
        state = tx.init(jparams) if state is None else state
        updates, state = tx.update(jax.tree.map(jnp.asarray, _flatten_tree(grads)), state, jparams)
        jparams = optax.apply_updates(jparams, jax.tree.map(lambda u: u * np.float32(lr), updates))
    got = _flax(opt.params)
    for path, want in _flatten(jparams).items():
        np.testing.assert_allclose(got[path], np.asarray(want), rtol=1e-6, atol=1e-8,
                                   err_msg=path)
    assert opt.state.count == 3


def _flatten_tree(named):
    """{port name: array or bool} -> nested flax tree (Linear weights
    transposed where they are arrays)."""
    from vilbert_tpu_torch.core.importer import _needs_transpose, _to_flax_key, _unflatten

    out = {}
    for n, v in named.items():
        if isinstance(v, (bool, np.bool_)):
            out[_to_flax_key(n)] = bool(v)
        else:
            out[_to_flax_key(n)] = v.T.copy() if _needs_transpose(n) else v
    return _unflatten(out)


# -- masks ---------------------------------------------------------------------

@pytest.mark.parametrize("task_type", TASK_TYPES)
def test_task_update_mask_matches(task_type, tiny_config):
    from vilbert_tpu.train.optim import task_update_mask as jax_mask
    from vilbert_tpu_torch.models.vilbert import ViLBERTForVLTasks
    from vilbert_tpu_torch.train.optim import flax_path, task_update_mask

    model = ViLBERTForVLTasks(tiny_config.replace(task_specific_tokens=True), num_labels=13)
    names = [n for n, _ in model.named_parameters()]
    from vilbert_tpu_torch.core.weights import flax_from_state_dict

    want = _flatten(jax_mask(flax_from_state_dict(model.state_dict()), task_type))
    got = task_update_mask(names, task_type)
    assert {flax_path(n) for n in names} == set(want)
    for n in names:
        assert got[n] == bool(want[flax_path(n)]), n
    assert not any(got[n] for n in names if n.startswith("cls."))
    assert sum(got.values()) < len(names)


# -- controllers, cadence, logger ------------------------------------------------

def test_stop_controllers_match():
    from vilbert_tpu.train.controllers import MultiTaskStopController as JaxController
    from vilbert_tpu.train.controllers import StopOnPlateau as JaxPlateau
    from vilbert_tpu_torch.train.controllers import MultiTaskStopController, StopOnPlateau

    scores = [0.5, 0.6, 0.6, 0.59, 0.58, 0.5, 0.7, 0.69, 0.69, 0.2, 0.1]
    for kw in (dict(), dict(mode="min", patience=2, threshold_mode="abs", cooldown=1)):
        port, ref = StopOnPlateau(**kw), JaxPlateau(**kw)
        for s in scores:
            port.step(s)
            ref.step(s)
            assert port.state_dict() == ref.state_dict()
    port, ref = MultiTaskStopController(["A", "B"]), JaxController(["A", "B"])
    stopped = False
    for i, s in enumerate(scores):
        for c in (port, ref):
            c.step("A", s)
            c.step("B", 1.0 - s)
        assert port.state_dict() == ref.state_dict()
        assert [port.should_train(k, i) for k in "AB"] == [ref.should_train(k, i) for k in "AB"]
        assert port.all_stopped() == ref.all_stopped()
        stopped = stopped or any(c.in_stop for c in port.controllers.values())
    assert stopped
    port.reset_all()
    ref.reset_all()
    assert port.state_dict() == ref.state_dict()


def test_eval_due_reference_cadence():
    """The cases of tests/test_multitask.py::test_eval_due_reference_cadence."""
    from vilbert_tpu.train.multitask import MultiTaskTrainer as JaxTrainer
    from vilbert_tpu_torch.train.multitask import MultiTaskTrainer

    for ns, epochs, iters, keys in (
            (SimpleNamespace(task_num_iters={"A": 5, "B": 12}, median_num_iter=12,
                             grad_accum=1), 2, 12, "AB"),
            (SimpleNamespace(task_num_iters={"A": 5}, median_num_iter=6, grad_accum=2),
             2, 6, "A")):
        for k in keys:
            got = [(e, it) for e in range(epochs) for it in range(iters)
                   if MultiTaskTrainer._eval_due(ns, e, it, epochs, k)]
            want = [(e, it) for e in range(epochs) for it in range(iters)
                    if JaxTrainer._eval_due(ns, e, it, epochs, k)]
            assert got == want, k
    ns = SimpleNamespace(task_num_iters={"A": 5, "B": 12}, median_num_iter=12, grad_accum=1)
    assert [(e, it) for e in range(2) for it in range(12)
            if MultiTaskTrainer._eval_due(ns, e, it, 2, "A")] == [
        (0, 5), (0, 10), (1, 3), (1, 8), (1, 11)]


def _logger_records(cls, log_dir):
    log = cls(str(log_dir), ["TASK1", "TASK2"], use_tensorboard=False)
    for step in range(4):
        log.step_train(step, "TASK1", loss=1.0 - 0.1 * step, score=0.5, lr=1e-4)
    log.step_train(0, "TASK2", loss=2.0, score=0.25)
    line = log.show_train(4)
    log.step_val(4, "TASK1", loss=0.6, score=0.7)
    state = log.state_dict()
    log2 = cls(str(log_dir), ["TASK1", "TASK2"], use_tensorboard=False)
    log2.load_state_dict(state)
    tmp = (dict(log.task_step_tmp), dict(log.task_loss_tmp))
    log.close()
    log2.close()
    records = [json.loads(x) for x in open(os.path.join(str(log_dir), "out.txt"))]
    for r in records:  # the wall time of the summary line differs
        r.pop("summary", None)
    return line.split("] ", 1)[1], records, state, log2.task_step_total, tmp


def test_metrics_logger_matches(tmp_path):
    """The cases of tests/test_logger.py: txt records, running averages
    that reset on show_train, and the state round trip."""
    from vilbert_tpu.train.logger import MetricsLogger as JaxLogger
    from vilbert_tpu_torch.train.logger import MetricsLogger

    got = _logger_records(MetricsLogger, tmp_path / "port")
    want = _logger_records(JaxLogger, tmp_path / "jax")
    assert got == want
    assert got[3]["TASK1"] == 4 and got[4][0] == {"TASK1": 0, "TASK2": 0}
    np.testing.assert_allclose(got[2]["task_loss_total"]["TASK1"], 1.0 + 0.9 + 0.8 + 0.7)


def test_metrics_logger_trace(tmp_path):
    """start_trace / stop_trace run torch.profiler and write a Chrome trace."""
    from vilbert_tpu_torch.train.logger import MetricsLogger

    log = MetricsLogger(str(tmp_path), ["T"], use_tensorboard=False)
    log.start_trace()
    torch.ones(8).sum()
    path = log.stop_trace()
    log.close()
    assert os.path.exists(path) and path.startswith(str(tmp_path / "profile"))


# -- the trajectory --------------------------------------------------------------

class _FakeLoader:
    def __init__(self, batches, batch_size):
        self.batches = batches
        self.batch_size = batch_size

    def __iter__(self):
        return iter(self.batches)

    def __len__(self):
        return len(self.batches)


B, T, R, R_MC = 3, 7, 6, 108   # V-logit-mc needs rows past MC_REGION_OFFSET
NUM_LABELS = 13


def _task_batches(cfg, n=3):
    """numpy batches in each process mode's layout: TASK1 normal, TASK4
    V-logit-mc, TASK7 retrieval [B, 4, ...], TASK12 nlvr [B, 2R, ...]."""
    rng = np.random.RandomState(11)
    F = cfg.v_feature_size

    def image(lead, r):
        mask = np.ones(lead + (r,), np.int32)
        mask[..., -2:] = 0
        return {"features": rng.randn(*lead, r, F).astype(np.float32),
                "spatials": rng.rand(*lead, r, 5).astype(np.float32), "image_mask": mask}

    def text(lead):
        mask = np.ones(lead + (T,), np.int32)
        mask[..., -1:] = 0
        return {"question": rng.randint(1, cfg.vocab_size, lead + (T,)).astype(np.int32),
                "input_mask": mask, "segment_ids": np.zeros(lead + (T,), np.int32)}

    out = {k: [] for k in ("TASK1", "TASK4", "TASK7", "TASK12")}
    for _ in range(n):
        t = np.zeros((B, NUM_LABELS), np.float32)
        t[np.arange(B), rng.randint(0, NUM_LABELS, B)] = rng.choice([0.3, 0.6, 1.0], B)
        out["TASK1"].append({**image((B,), R), **text((B,)), "target": t,
                             "co_attention_mask": np.zeros((B, R, T), np.float32)})
        mc = rng.randint(0, R_MC - 101, (B, 4)).astype(np.int64)
        out["TASK4"].append({**image((B,), R_MC), **text((B,)), "multiple_choice_ids": mc,
                             "target": (rng.rand(B, 4, 1) < 0.4).astype(np.float32)})
        out["TASK7"].append({**image((B, 4), R), **text((B, 4)),
                             "target": np.zeros((B,), np.int64)})
        out["TASK12"].append({**image((B,), 2 * R), **text((B,)),
                              "target": rng.randint(0, 2, (B,)).astype(np.int64)})
    return out


def _tasks(config_module):
    TaskConfig = config_module.TaskConfig
    return {
        "TASK1": TaskConfig(task_id=1, name="VQA", type="VL-classifier", batch_size=B,
                            loss="BCEWithLogitLoss", lr=4e-4, num_labels=NUM_LABELS),
        "TASK4": TaskConfig(task_id=4, name="Visual7w", type="V-logit-mc", batch_size=B,
                            loss="BCEWithLogitLoss", lr=2e-4, max_region_num=R_MC),
        "TASK7": TaskConfig(task_id=7, name="RetrievalCOCO", type="VL-logit", batch_size=B,
                            loss="CrossEntropyLoss", process="retrieval", lr=2e-4),
        "TASK12": TaskConfig(task_id=12, name="NLVR2", type="VL-binary-classifier",
                             batch_size=B, loss="CrossEntropyLoss", process="nlvr", lr=2e-4),
    }


UNUSED_HEADS = ("vil_prediction_gqa", "vil_tri_prediction", "linguisic_logit", "cls.")


def test_three_iterations_match_jax_trainer(tiny_config, monkeypatch):
    import vilbert_tpu.train.multitask as jax_multitask
    from vilbert_tpu.core import config as jax_config
    from vilbert_tpu_torch.core import config as port_config
    from vilbert_tpu_torch.models.vilbert import ViLBERTForVLTasks
    from vilbert_tpu_torch.train.multitask import MultiTaskTrainer

    cfg = tiny_config.replace(task_specific_tokens=True, num_hidden_layers=2,
                              v_biattention_id=(0, 1), t_biattention_id=(0, 1))
    batches = _task_batches(cfg)
    model = ViLBERTForVLTasks(cfg, num_labels=NUM_LABELS, dropout_prob=0.0,
                              generator=torch.Generator().manual_seed(3))
    model.cls.dropout.rate = 0.0  # the fixed-rate fuse site (module docstring)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    opt_kw = dict(schedule="mannul", warmup_proportion=0.05, head_lr=1e-3, correct_bias=False,
                  weight_decay=0.01, eps=1e-6)

    monkeypatch.setattr(jax_multitask, "make_task_loss_fn", functools.partial(
        jax_multitask.make_task_loss_fn, deterministic=True))
    jax_tasks = _tasks(jax_config)
    ref = jax_multitask.MultiTaskTrainer(
        cfg, jax_tasks, {k: _FakeLoader(v, B) for k, v in batches.items()},
        opt_cfg=jax_config.OptimizerConfig(**opt_kw), num_labels=NUM_LABELS,
        init_params=jax.tree.map(np.asarray, _unflat(_flax(init))), dropout_prob=0.0)
    port = MultiTaskTrainer(
        cfg, _tasks(port_config), {k: _FakeLoader(v, B) for k, v in batches.items()},
        opt_cfg=port_config.OptimizerConfig(**opt_kw), init_model=model, device="cpu")
    assert port.median_num_iter == ref.median_num_iter == 3
    assert port.loss_scales == ref.loss_scales == {"TASK1": 2.0, "TASK4": 1.0, "TASK7": 1.0,
                                                   "TASK12": 1.0}

    for it in range(3):
        want = ref.train_iteration(it)
        got = port.train_iteration(it)
        assert list(got) == list(want) == list(batches)
        for k in batches:
            np.testing.assert_allclose(got[k]["loss"].item(), float(want[k]["loss"]),
                                       rtol=1e-4, err_msg=f"iteration {it} {k}")
            np.testing.assert_allclose(got[k]["score"].item(), float(want[k]["score"]),
                                       atol=1e-6, err_msg=f"iteration {it} {k}")
    assert port.global_step == ref.global_step == 3
    assert port.optimizer.state.count == int(ref.state.opt_state.count) == 12

    # parameters within 1e-4 relative, or 1e-5 absolute: a bias under a
    # softmax (vil_logit's over the options, the key biases) has a zero
    # gradient but for rounding, which Adam scales up to moves of ~1e-5
    got_p = _flax(dict(port.model.named_parameters()))
    want_p = _flatten(ref.state.params)
    assert set(got_p) == set(want_p)
    for path, w in want_p.items():
        np.testing.assert_allclose(got_p[path], np.asarray(w), rtol=1e-4, atol=1e-5,
                                   err_msg=path)
    # moments within 1e-4 of the largest entry of their tensor (an entry
    # summed from cancelling terms, a token-type row over every token,
    # carries the rounding of the larger ones) plus 1e-6 of the model's
    # largest (the key biases' gradients are zero but for rounding)
    for got, want in ((port.optimizer.state.mu, ref.state.opt_state.mu),
                      (port.optimizer.state.nu, ref.state.opt_state.nu)):
        got, want = _flax(got), {k: np.asarray(w) for k, w in _flatten(want).items()}
        top = max(np.abs(w).max() for w in want.values())
        for path, w in want.items():
            np.testing.assert_allclose(got[path], w, rtol=0,
                                       atol=1e-4 * np.abs(w).max() + 1e-6 * top, err_msg=path)
    # heads no task of the run uses, and cls, have not moved on either side;
    # the four heads in use have
    for name, p in port.model.named_parameters():
        if name.startswith(UNUSED_HEADS):
            assert torch.equal(p.detach(), init[name]), name
            np.testing.assert_array_equal(np.asarray(want_p[_path(name)]),
                                          _flax({name: init[name]})[_path(name)])
        elif name.startswith(("vil_prediction.", "vision_logit.", "vil_logit.",
                              "vil_binary_prediction.")):
            assert not torch.equal(p.detach(), init[name]), name


def _unflat(flat):
    from vilbert_tpu_torch.core.importer import _unflatten

    return _unflatten(flat)


def _path(name):
    from vilbert_tpu_torch.train.optim import flax_path

    return flax_path(name)


def test_each_task_step_leaves_the_other_heads_unchanged(tiny_config):
    """Per task step (the task hooks see the model before and after it),
    every head but the task's own, ``cls`` included, is bitwise unchanged."""
    from vilbert_tpu_torch.core import config as port_config
    from vilbert_tpu_torch.train.multitask import HEAD_FOR_TYPE, MultiTaskTrainer

    cfg = tiny_config.replace(task_specific_tokens=True)
    batches = _task_batches(cfg, n=1)
    trainer = MultiTaskTrainer(
        cfg, _tasks(port_config), {k: _FakeLoader(v, B) for k, v in batches.items()},
        opt_cfg=port_config.OptimizerConfig(schedule="mannul", correct_bias=False),
        num_labels=NUM_LABELS, dropout_prob=0.1, device="cpu")
    heads = ("vil_prediction.", "vil_prediction_gqa.", "vil_logit.", "vil_binary_prediction.",
             "vil_tri_prediction.", "vision_logit.", "linguisic_logit.", "cls.")
    before, checked = {}, []

    def hook(key, model, metrics):
        params = {n: p.detach().clone() for n, p in model.named_parameters()
                  if n.startswith(heads)}
        if metrics is None:
            before.update(params)
            return
        own = HEAD_FOR_TYPE[trainer.tasks[key].cfg.type] + "."
        for n, p in params.items():
            assert torch.equal(p, before[n]) != n.startswith(own), (key, n)
        checked.append(key)

    trainer.train(max_iterations=1, task_hooks=[hook], log_every=0)
    assert checked == list(batches)


def test_cli_refuses_what_is_not_ported():
    """The data-parallel flags are ported (tests/test_torch_distributed.py);
    an incomplete set of them raises before any process group is formed."""
    from vilbert_tpu_torch.cli.train_tasks import main

    for flag, match in ((["--num_processes", "2"], "--coordinator"),
                        (["--process_id", "1"], "--process_id"),
                        (["--coordinator", "localhost:1", "--num_processes", "2"],
                         "--process_id")):
        with pytest.raises(ValueError, match=match):
            main(["--synthetic", "--device", "cpu", *flag])


def test_trainer_refuses_what_is_not_ported(tiny_config, tmp_path):
    """in_batch_pairs is ported, and the two-stream trainer fails on it
    where the JAX trainer fails, with a ValueError that names it: the heads
    cannot score the B^2 pairs of a batch of B > 1
    (``test_in_batch_pairs_fails_where_jax_fails`` holds every path to
    JAX's). Full-state resume is ported: with nothing saved it raises."""
    from vilbert_tpu_torch.core import config as port_config
    from vilbert_tpu_torch.train.multitask import MultiTaskTrainer

    tasks = {"TASK1": _tasks(port_config)["TASK1"]}
    loaders = {"TASK1": _FakeLoader(_task_batches(tiny_config, n=1)["TASK1"], B)}
    with pytest.raises(ValueError, match="in_batch_pairs"):
        MultiTaskTrainer(tiny_config.replace(in_batch_pairs=True), tasks, loaders, device="cpu")
    trainer = MultiTaskTrainer(
        tiny_config, tasks, loaders, device="cpu", num_labels=NUM_LABELS,
        train_cfg=port_config.TrainConfig(checkpoint_dir=str(tmp_path / "ckpt")))
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        trainer.restore_checkpoint()  # full-state resume is ported: nothing saved yet


def _outcome(fn):
    """("ran", None), or ("raised", the exception)."""
    try:
        fn()
    except Exception as e:  # the outcome under test, whatever its type
        return "raised", e
    return "ran", None


def _pretrain_batch(cfg, b):
    rng = np.random.RandomState(2)
    return {
        "input_ids": rng.randint(1, cfg.vocab_size, (b, T)).astype(np.int32),
        "image_feat": rng.randn(b, R, cfg.v_feature_size).astype(np.float32),
        "image_loc": rng.rand(b, R, 5).astype(np.float32),
        "segment_ids": np.zeros((b, T), np.int32),
        "input_mask": np.ones((b, T), np.int32),
        "image_mask": np.ones((b, R), np.int32),
        "lm_label_ids": np.where(rng.rand(b, T) < 0.4, 5, -1).astype(np.int32),
        "image_label": np.where(rng.rand(b, R - 1) < 0.4, 1, -1).astype(np.int32),
        "image_target": np.full((b, R - 1, cfg.v_target_size), 1.0 / cfg.v_target_size,
                                np.float32),
        "is_next": np.zeros((b,), np.int32),
    }


#: (path, family, task key or None for pretraining, batch rows): the
#: retrieval task is the one whose step alone would run on the pairs
PAIR_PATHS = [
    ("pretrain", "vilbert", None, 3), ("pretrain_one_row", "vilbert", None, 1),
    ("pretrain_baseline", "basebert", None, 3), ("TASK1", "vilbert", "TASK1", 3),
    ("TASK7", "vilbert", "TASK7", 3), ("TASK1_baseline", "basebert", "TASK1", 3),
]


@pytest.mark.parametrize("path,family,key,rows", PAIR_PATHS, ids=[p[0] for p in PAIR_PATHS])
def test_in_batch_pairs_fails_where_jax_fails(tiny_config, path, family, key, rows):
    """Under in_batch_pairs, on one process: the pretraining loss (the JAX
    ``make_pretrain_loss_fn``, jitted) and a trainer iteration (built as a
    user builds it, weights from the seed) of each task process mode, for
    the two-stream model and the single-stream baseline (which has no
    pairs), raise in the port where they raise in JAX and run where they
    run; the port's error is a ValueError naming in_batch_pairs."""
    import vilbert_tpu.train.multitask as jax_multitask
    from vilbert_tpu.core import config as jax_config
    from vilbert_tpu.train.pretrain import _pretrain_model, make_pretrain_loss_fn as jax_loss_fn
    from vilbert_tpu_torch.core import config as port_config
    from vilbert_tpu_torch.train.multitask import MultiTaskTrainer
    from vilbert_tpu_torch.train.pretrain import make_pretrain_loss_fn, pretrain_model

    cfg = tiny_config.replace(in_batch_pairs=True, num_hidden_layers=2, v_biattention_id=(0, 1),
                              t_biattention_id=(0, 1))
    if key is None:
        batch = _pretrain_batch(cfg, rows)

        def jax_path():
            model = _pretrain_model(cfg, family)
            params = jax.jit(model.init)(jax.random.PRNGKey(0), batch["input_ids"],
                                         batch["image_feat"], batch["image_loc"])
            loss_fn = jax_loss_fn(model, cfg, deterministic=True)
            float(jax.jit(loss_fn)(params["params"], batch, jax.random.PRNGKey(1))[0])

        def port_path():
            model = pretrain_model(cfg, family, generator=torch.Generator().manual_seed(0))
            loss_fn = make_pretrain_loss_fn(cfg, deterministic=True)
            float(loss_fn(model, {k: _t(v) for k, v in batch.items()})[0].detach())
    else:
        batches = _task_batches(cfg, n=1)[key]

        def jax_path():
            trainer = jax_multitask.MultiTaskTrainer(
                cfg, {key: _tasks(jax_config)[key]}, {key: _FakeLoader(batches, B)},
                num_labels=NUM_LABELS, model_family=family)
            float(trainer.train_iteration(0)[key]["loss"])

        def port_path():
            trainer = MultiTaskTrainer(
                cfg, {key: _tasks(port_config)[key]}, {key: _FakeLoader(batches, B)},
                num_labels=NUM_LABELS, model_family=family, device="cpu")
            try:
                float(trainer.train_iteration(0)[key]["loss"])
            finally:
                trainer.close()

    want, _ = _outcome(jax_path)
    got, error = _outcome(port_path)
    assert got == want, (path, want, error)
    assert want == ("ran" if family == "basebert" or rows == 1 else "raised")
    if error is not None:
        assert isinstance(error, ValueError) and "in_batch_pairs" in str(error), error


def test_baseline_three_iterations_match_jax_trainer(tiny_config, monkeypatch):
    """The single-stream baseline (``model_family="basebert"``) through three
    round-robin iterations of a normal, a V-logit-mc and a retrieval task,
    against the JAX trainer from the same weights: each task's loss and
    score, every parameter and both Adam moments (no participation masks
    in either), with the bounds of ``test_three_iterations_match_jax_trainer``."""
    import vilbert_tpu.train.multitask as jax_multitask
    from vilbert_tpu.core import config as jax_config
    from vilbert_tpu_torch.core import config as port_config
    from vilbert_tpu_torch.core.weights import flax_from_state_dict
    from vilbert_tpu_torch.models.basebert import BaseBertForVLTasks
    from vilbert_tpu_torch.train.multitask import MultiTaskTrainer

    cfg = tiny_config
    keys = ("TASK1", "TASK4", "TASK7")
    batches = {k: v for k, v in _task_batches(cfg).items() if k in keys}
    model = BaseBertForVLTasks(cfg, num_labels=NUM_LABELS, dropout_prob=0.0,
                               generator=torch.Generator().manual_seed(3))
    init = {k: v.clone() for k, v in model.state_dict().items()}
    opt_kw = dict(schedule="mannul", warmup_proportion=0.05, head_lr=1e-3, correct_bias=False,
                  weight_decay=0.01, eps=1e-6)
    monkeypatch.setattr(jax_multitask, "make_task_loss_fn", functools.partial(
        jax_multitask.make_task_loss_fn, deterministic=True))
    jax_tasks = {k: t for k, t in _tasks(jax_config).items() if k in keys}
    ref = jax_multitask.MultiTaskTrainer(
        cfg, jax_tasks, {k: _FakeLoader(v, B) for k, v in batches.items()},
        opt_cfg=jax_config.OptimizerConfig(**opt_kw), num_labels=NUM_LABELS,
        init_params=jax.tree.map(np.asarray, flax_from_state_dict(init, "basebert")),
        model_family="basebert")
    port = MultiTaskTrainer(
        cfg, {k: t for k, t in _tasks(port_config).items() if k in keys},
        {k: _FakeLoader(v, B) for k, v in batches.items()},
        opt_cfg=port_config.OptimizerConfig(**opt_kw), init_model=model,
        model_family="basebert", device="cpu")
    assert all(t.mask is None for t in port.tasks.values())
    for it in range(3):
        want = ref.train_iteration(it)
        got = port.train_iteration(it)
        assert list(got) == list(want) == list(batches)
        for k in batches:
            np.testing.assert_allclose(got[k]["loss"].item(), float(want[k]["loss"]),
                                       rtol=1e-4, err_msg=f"iteration {it} {k}")
            np.testing.assert_allclose(got[k]["score"].item(), float(want[k]["score"]),
                                       atol=1e-6, err_msg=f"iteration {it} {k}")
    got_p = _flatten(flax_from_state_dict(dict(port.model.named_parameters()), "basebert"))
    want_p = _flatten(ref.state.params)
    assert set(got_p) == set(want_p)
    for path, w in want_p.items():
        np.testing.assert_allclose(got_p[path], np.asarray(w), rtol=1e-4, atol=1e-5,
                                   err_msg=path)
    for got, want in ((port.optimizer.state.mu, ref.state.opt_state.mu),
                      (port.optimizer.state.nu, ref.state.opt_state.nu)):
        got = _flatten(flax_from_state_dict(got, "basebert"))
        want = {k: np.asarray(w) for k, w in _flatten(want).items()}
        top = max(np.abs(w).max() for w in want.values())
        for path, w in want.items():
            np.testing.assert_allclose(got[path], w, rtol=0,
                                       atol=1e-4 * np.abs(w).max() + 1e-6 * top, err_msg=path)


def _headless_task(config_module, task_type):
    """(key, task, batch) of a task type BaseBertForVLTasks has no head for:
    GQA's 1,533 soft labels and the three-way classifier on TASK1's rows,
    NLVR2 as TASK12 (its [B, 2R] image pairs)."""
    rng = np.random.RandomState(5)
    tasks = _tasks(config_module)
    if task_type == "VL-binary-classifier":
        return "TASK12", tasks["TASK12"], None
    task = dataclasses.replace(tasks["TASK1"], type=task_type)
    if task_type == "VL-tri-classifier":
        return "TASK1", task, rng.randint(0, 3, (B,)).astype(np.int64)
    target = np.zeros((B, 1533), np.float32)
    target[np.arange(B), rng.randint(0, 1533, B)] = 1.0
    return "TASK1", task, target


@pytest.mark.parametrize("task_type,jax_error", [
    ("VL-classifier-GQA", (AttributeError, "vil_prediction_gqa")),
    ("VL-tri-classifier", (AttributeError, "vil_tri_prediction")),
    ("VL-binary-classifier", (ValueError, "broadcasting")),
])
def test_baseline_refuses_task_types_without_a_head(tiny_config, task_type, jax_error):
    """BaseBertForVLTasks has 7 heads: none for GQA or the three-way
    classifier, and a binary head over single (text, image) rows where NLVR2
    scores pairs. The port refuses these at construction; the JAX trainer
    with ``model_family="basebert"`` fails on the same task at its first
    iteration (no such output, or NLVR2's [2B] rows against its [B]
    targets)."""
    import vilbert_tpu.train.multitask as jax_multitask
    from vilbert_tpu.core import config as jax_config
    from vilbert_tpu_torch.core import config as port_config
    from vilbert_tpu_torch.train.multitask import MultiTaskTrainer

    key, _, target = _headless_task(port_config, task_type)
    batch = dict(_task_batches(tiny_config, n=1)[key][0])
    if target is not None:
        batch["target"] = target
    with pytest.raises(ValueError, match="no head"):
        MultiTaskTrainer(tiny_config, {key: _headless_task(port_config, task_type)[1]},
                         {key: _FakeLoader([batch], B)}, device="cpu",
                         model_family="basebert")
    ref = jax_multitask.MultiTaskTrainer(
        tiny_config, {key: _headless_task(jax_config, task_type)[1]},
        {key: _FakeLoader([batch], B)}, num_labels=NUM_LABELS, model_family="basebert")
    with pytest.raises(jax_error[0], match=jax_error[1]):
        ref.train_iteration(0)


def test_from_pretrained_npz_keeps_heads_of_other_shapes(tmp_path, tiny_config):
    """A pretraining ``.npz`` loads every matching trunk weight; the task
    heads, absent or of another width there, stay at their init."""
    from vilbert_tpu_torch.core.weights import save_params_npz
    from vilbert_tpu_torch.models.vilbert import ViLBERTForPretraining, ViLBERTForVLTasks
    from vilbert_tpu_torch.train.multitask import load_pretrained

    pre = ViLBERTForPretraining(tiny_config, generator=torch.Generator().manual_seed(1))
    save_params_npz(str(tmp_path / "pre.npz"), pre)
    model = ViLBERTForVLTasks(tiny_config, num_labels=NUM_LABELS,
                              generator=torch.Generator().manual_seed(2))
    init = {k: v.clone() for k, v in model.state_dict().items()}
    load_pretrained(model, str(tmp_path / "pre.npz"))
    got, pre_sd = model.state_dict(), pre.state_dict()
    for k, v in got.items():
        if k in pre_sd:
            assert torch.equal(v, pre_sd[k]), k
        else:
            assert torch.equal(v, init[k]), k
    assert any(k.startswith("vil_prediction.") for k in got)
