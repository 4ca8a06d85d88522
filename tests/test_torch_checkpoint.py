"""The port's training options and full-state checkpoints, on the CPU.

Against the JAX package (same inputs, numpy-seeded): AdamW with bf16
moments (``reference_adamw`` with bf16 moment dtypes), RAdam
(``build_optimizer(name="radam")``, ``optax.radam`` under
``multi_transform``) and a step with bf16 gradients
(``make_train_step(grad_dtype="bfloat16")``). The port alone: a resumed
``run_pretraining`` equals the uninterrupted run bitwise, the multi-task
trainer's save/restore carries every piece of its state (as
``tests/test_resume.py`` checks for JAX), restoring with the moment dtype
toggled converts and warns, and both training CLIs take the flags.

Tiny config, fp32 compute, dropout off; the JAX side runs its Pallas
kernels in interpret mode.
"""

import json
import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from vilbert_tpu.core.config import OptimizerConfig
from vilbert_tpu.core.importer import _flatten

K = 3  # lm_gather


def _tree(named):
    """{port name: array or bool} -> nested flax tree (Linear weights
    transposed)."""
    from vilbert_tpu_torch.core.importer import _needs_transpose, _to_flax_key, _unflatten

    out = {}
    for n, v in named.items():
        if isinstance(v, (bool, np.bool_)):
            out[_to_flax_key(n)] = bool(v)
        else:
            out[_to_flax_key(n)] = v.T.copy() if _needs_transpose(n) else v
    return _unflatten(out)


def _flax(named_tensors):
    from vilbert_tpu_torch.core.weights import flax_from_state_dict

    return _flatten(flax_from_state_dict(
        {n: t.float() if t.dtype == torch.bfloat16 else t for n, t in named_tensors.items()}))


def _bf16_ulp(x):
    """The spacing of bf16 at |x| (8 significant bits)."""
    x = np.abs(np.asarray(x, np.float32))
    return np.where(x > 0, 2.0 ** (np.floor(np.log2(np.maximum(x, 1e-38))) - 7), 2.0 ** -133)


# parameters of every label: "frozen" (embeddings), "head" (vil_prediction),
# "pretrained_scaled" (bert.*) and "base" (the rest); decayed and not
NAMES = ["bert.embeddings.word_embeddings.weight",
         "bert.encoder.layer.0.attention.self.query.weight",
         "bert.encoder.layer.0.attention.self.query.bias",
         "bert.encoder.layer.0.output.LayerNorm.weight",
         "vil_prediction.logit_fc.0.weight",
         "vil_logit.weight",
         "cls.predictions.bias"]
SHAPES = [(9, 5), (6, 5), (6,), (5,), (4, 5), (1, 5), (7,)]


def _init(rng):
    return {n: rng.randn(*s).astype(np.float32) for n, s in zip(NAMES, SHAPES)}


def _grads(rng, scale=1.0):
    return {n: (scale * rng.randn(*s)).astype(np.float32) for n, s in zip(NAMES, SHAPES)}


def _find_moments(state):
    """The ``ScaleByAdamState`` inside a chain's nested state tuples."""
    if hasattr(state, "mu"):
        return state
    for s in state if isinstance(state, tuple) else ():
        found = _find_moments(s)
        if found is not None:
            return found
    return None


class TestOptimizers:
    def test_bf16_moments_match_reference_adamw(self):
        """Five external-lr steps, each with another participation mask and
        host rate, head and scaled groups, bias correction and a clip:
        parameters within 1e-6 relative, the bf16 moments within one bf16
        ulp, masked moments untouched."""
        from vilbert_tpu.train.optim import build_optimizer as jax_build
        from vilbert_tpu_torch.train.optim import build_optimizer

        rng = np.random.RandomState(0)
        init = _init(rng)
        kw = dict(learning_rate=1e-3, schedule="mannul", head_lr=5e-3, correct_bias=True,
                  pretrained_lr_scale=0.5, weight_decay=0.01, grad_clip_norm=4.0,
                  first_moment_dtype="bfloat16", second_moment_dtype="bfloat16")
        cfg = OptimizerConfig(**kw)
        port = {n: torch.from_numpy(v.copy()) for n, v in init.items()}
        opt, _ = build_optimizer(cfg, port, 10, external_lr=True)
        assert {t.dtype for t in (*opt.state.mu.values(), *opt.state.nu.values())} == {
            torch.bfloat16}
        jparams = jax.tree.map(jnp.asarray, _tree(init))
        state = None
        drops = ["vil_logit.weight", "vil_prediction.logit_fc.0.weight", None,
                 "bert.encoder.layer.0.attention.self.query.bias", None]
        for step, drop in enumerate(drops):
            lr = [1e-3, 2e-4, 5e-4, 8e-4, 3e-4][step]
            mask = {n: n != drop for n in NAMES}
            grads = _grads(rng)
            before = {n: (opt.state.mu[n].clone(), opt.state.nu[n].clone()) for n in NAMES}
            opt.step({n: torch.from_numpy(g) for n, g in grads.items()}, lr=lr, mask=mask)
            if drop:
                assert all(torch.equal(a, b) for a, b in zip(
                    before[drop], (opt.state.mu[drop], opt.state.nu[drop])))
            tx, _ = jax_build(cfg, jparams, 10, external_lr=True, update_mask=_tree(mask))
            state = tx.init(jparams) if state is None else state
            updates, state = tx.update(jax.tree.map(jnp.asarray, _tree(grads)), state, jparams)
            jparams = optax.apply_updates(
                jparams, jax.tree.map(lambda u: u * np.float32(lr), updates))
        got = _flax(opt.params)
        for path, want in _flatten(jparams).items():
            np.testing.assert_allclose(got[path], np.asarray(want), rtol=1e-6, atol=1e-8,
                                       err_msg=path)
        adam = state[-1] if isinstance(state, tuple) else state
        for got_m, want_m in ((opt.state.mu, adam.mu), (opt.state.nu, adam.nu)):
            got_m = _flax(got_m)
            for path, w in _flatten(want_m).items():
                w = np.asarray(w.astype(jnp.float32))
                assert w.dtype == np.float32
                assert np.all(np.abs(got_m[path] - w) <= _bf16_ulp(w)), path
        assert opt.state.count == 5

    @pytest.mark.parametrize("external_lr", [False, True])
    def test_radam_matches_optax(self, external_lr):
        """Eight steps, past the rectification threshold (rho_t >= 5 from
        step 6 at b2 0.999), with coupled weight decay, a frozen prefix, head
        and scaled groups and a clip: parameters within 1e-6 relative, each
        label's count and moments within 1e-6 of their largest entry; the
        frozen parameter never moves."""
        from vilbert_tpu.train.optim import build_optimizer as jax_build
        from vilbert_tpu_torch.train.optim import ReferenceRAdam, build_optimizer

        rng = np.random.RandomState(1)
        init = _init(rng)
        kw = dict(name="radam", learning_rate=1e-3, head_lr=4e-3, pretrained_lr_scale=0.5,
                  weight_decay=0.01, grad_clip_norm=5.0, warmup_proportion=0.25,
                  schedule="warmup_linear")
        cfg = OptimizerConfig(**kw)
        freeze = "bert.embeddings."
        port = {n: torch.from_numpy(v.copy()) for n, v in init.items()}
        opt, _ = build_optimizer(cfg, port, 8, freeze_prefix=freeze, external_lr=external_lr,
                                 step_offset=0 if external_lr else 1)
        assert isinstance(opt, ReferenceRAdam)
        assert sorted(opt.labels) == ["base", "head", "pretrained_scaled"]
        jparams = jax.tree.map(jnp.asarray, _tree(init))
        tx, _ = jax_build(cfg, jparams, 8, freeze_prefix=freeze, external_lr=external_lr,
                          step_offset=0 if external_lr else 1)
        state = tx.init(jparams)
        update = jax.jit(tx.update)  # as the JAX step runs it
        for step in range(8):
            grads = _grads(rng, 0.3 + step)
            lr = np.float32(1e-3 * (1 + step) / 8)
            opt.step({n: torch.from_numpy(g) for n, g in grads.items()},
                     lr=float(lr) if external_lr else None)
            updates, state = update(jax.tree.map(jnp.asarray, _tree(grads)), state, jparams)
            if external_lr:
                updates = jax.tree.map(lambda u: u * lr, updates)
            jparams = optax.apply_updates(jparams, updates)
        got = _flax(opt.params)
        for path, want in _flatten(jparams).items():
            np.testing.assert_allclose(got[path], np.asarray(want), rtol=1e-6, atol=1e-8,
                                       err_msg=path)
        np.testing.assert_array_equal(opt.params[NAMES[0]].numpy(), init[NAMES[0]])
        inner = state[-1].inner_states  # (clip state, multi_transform state)
        for label, st in opt.state.items():
            radam = _find_moments(inner[label].inner_state)
            assert st.count == int(radam.count) == 8
            for got_m, want_m in ((st.mu, radam.mu), (st.nu, radam.nu)):
                got_m = _flax(got_m)
                for path, w in _flatten(want_m).items():
                    if path in got_m:  # the label's own parameters; a moment
                        # summed from cancelling terms carries the larger
                        # ones' rounding (XLA contracts to fused multiply-adds)
                        w = np.asarray(w)
                        np.testing.assert_allclose(got_m[path], w, rtol=1e-6,
                                                   atol=1e-6 * np.abs(w).max(),
                                                   err_msg=f"{label} {path}")

    def test_radam_refuses_a_mask(self):
        from vilbert_tpu_torch.core.config import OptimizerConfig as PortConfig
        from vilbert_tpu_torch.train.optim import build_optimizer

        params = {"bert.encoder.layer.0.attention.self.query.bias": torch.zeros(3)}
        cfg = PortConfig(name="radam", schedule="constant")
        with pytest.raises(ValueError, match="adamw"):
            build_optimizer(cfg, params, 10, update_mask={n: True for n in params})
        opt, _ = build_optimizer(cfg, params, 10)
        with pytest.raises(ValueError, match="mask"):
            opt.step({n: torch.ones(3) for n in params}, mask={n: True for n in params})


# -- bf16 gradients ----------------------------------------------------------------

def _pallas(cfg):
    return cfg.replace(use_pallas_attention=True, use_pallas_layernorm=True)


def _port_model(cfg, seed=0):
    from vilbert_tpu_torch.models.vilbert import ViLBERTForPretraining

    model = ViLBERTForPretraining(cfg, generator=torch.Generator().manual_seed(seed))
    model.cls.dropout.rate = 0.0  # the fixed-rate fuse site (tests/test_torch_train.py)
    return model


def _cc_batch(cfg, seed, b=4):
    from tests.test_torch_train import _batch

    return _batch(cfg, seed, b=b)


def _coarse_text_tables(model, seed=0):
    """Text embedding tables of multiples of 1/64 below 1/4 in magnitude: the
    sum of three entries is exact in bf16. XLA decides where a fused bf16
    sum rounds (the JAX package's own jitted and eager forwards differ by
    one bf16 spacing there), and that one spacing, through every text
    layer, would swamp the comparison."""
    g = torch.Generator().manual_seed(seed)
    emb = model.bert.embeddings
    with torch.no_grad():
        for table in (emb.word_embeddings, emb.position_embeddings, emb.token_type_embeddings):
            table.weight.copy_(torch.randint(-15, 16, table.weight.shape, generator=g) / 64)


def _recording():
    """An optax transformation that passes the updates on and keeps them as
    its state: the gradients a JAX step hands its optimizer."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params), lambda u, s, p=None: (u, u))


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_bf16_gradient_step_matches_jax(tiny_config, grad_accum):
    """One CC step with ``grad_dtype="bfloat16"`` and a clipping AdamW: the
    gradients the optimizer receives (bf16 at one microbatch, fp32 sums
    over two), their clipped norm and the updated parameters against the
    JAX step's, within bf16 rounding."""
    from vilbert_tpu.models.vilbert import ViLBERTForPretraining as JaxModel
    from vilbert_tpu.parallel.train_step import TrainState, make_train_step as jax_step
    from vilbert_tpu.train.optim import build_optimizer as jax_build
    from vilbert_tpu.train.pretrain import make_pretrain_loss_fn as jax_loss_fn
    from vilbert_tpu_torch.core.weights import flax_from_state_dict
    from vilbert_tpu_torch.parallel.train_step import make_train_step
    from vilbert_tpu_torch.train.optim import build_optimizer
    from vilbert_tpu_torch.train.pretrain import host_batch, make_pretrain_loss_fn

    cfg = tiny_config
    # eps 1e-3: Adam's first update is g / (|g| + eps) up to constants, so a
    # gradient near 0 moves it by up to lr / eps times its bf16 rounding
    opt_cfg = OptimizerConfig(learning_rate=1e-3, beta2=0.98, eps=1e-3, schedule="constant",
                              grad_clip_norm=0.5)
    model = _port_model(cfg)
    _coarse_text_tables(model)
    params = flax_from_state_dict(model.state_dict())
    batch = _cc_batch(cfg, 5)

    tx, _ = jax_build(opt_cfg, params, 4)
    tx = optax.chain(_recording(), tx)
    state = TrainState.create(params, tx)
    jbatch = batch if grad_accum == 1 else jax.tree.map(
        lambda x: x.reshape(grad_accum, x.shape[0] // grad_accum, *x.shape[1:]), batch)
    step = jax_step(jax_loss_fn(JaxModel(_pallas(cfg)), cfg, deterministic=True, lm_gather=K),
                    tx, grad_accum=grad_accum, grad_dtype="bfloat16")
    state, want_m = step(state, jbatch, jax.random.PRNGKey(0))
    want_g = {k: np.asarray(v.astype(jnp.float32)) for k, v in _flatten(state.opt_state[0]).items()}
    want_dtypes = {str(v.dtype) for v in jax.tree.leaves(state.opt_state[0])}

    opt, _ = build_optimizer(opt_cfg, dict(model.named_parameters()), 4)
    seen = {}
    inner = opt.step

    def spy(grads, **kw):
        seen.update(grads)
        return inner(grads, **kw)

    opt.step = spy
    got_m = make_train_step(make_pretrain_loss_fn(cfg, lm_gather=K), opt,
                            grad_accum=grad_accum, grad_dtype="bfloat16")(
        model, host_batch(batch, cfg, grad_accum))
    assert {str(g.dtype) for g in seen.values()} == {
        "torch.bfloat16" if grad_accum == 1 else "torch.float32"}
    assert want_dtypes == {"bfloat16" if grad_accum == 1 else "float32"}
    got_g = _flax(seen)
    assert set(got_g) == set(want_g)
    top = max(np.abs(w).max() for w in want_g.values())
    for path, w in want_g.items():
        np.testing.assert_allclose(got_g[path], w, rtol=2 ** -7,
                                   atol=2 ** -7 * np.abs(w).max() + 1e-6 * top, err_msg=path)
    np.testing.assert_allclose(got_m["loss"].item(), float(want_m["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(got_m["grad_norm"]), float(want_m["grad_norm"]),
                               rtol=2 ** -7)
    got_p = _flax(dict(model.named_parameters()))
    for path, w in _flatten(state.params).items():
        np.testing.assert_allclose(got_p[path], np.asarray(w), rtol=1e-4, atol=1e-5,
                                   err_msg=path)


# -- checkpoints and resume ----------------------------------------------------------

def test_resumed_pretraining_equals_the_uninterrupted_run(tiny_config, tmp_path):
    """Two steps, a checkpoint, a fresh model and optimizer resumed from it
    and two more steps give the parameters and moments of four
    uninterrupted steps bit for bit (one held batch, dropout off: the
    loader restarts on resume, as in the JAX package)."""
    from vilbert_tpu_torch.core.checkpoint import CheckpointManager
    from vilbert_tpu_torch.core.config import OptimizerConfig as PortConfig
    from vilbert_tpu_torch.parallel.train_step import train_state_dict
    from vilbert_tpu_torch.train.pretrain import run_pretraining

    cfg = tiny_config
    batches = [_cc_batch(cfg, 7)]
    opt_cfg = PortConfig(learning_rate=1e-3, beta2=0.98, schedule="warmup_linear",
                         warmup_proportion=0.5)
    kw = dict(num_steps=4, device="cpu", lm_gather=K, log_every=0)
    whole = run_pretraining(cfg, opt_cfg, batches, model=_port_model(cfg), **kw)

    mngr = CheckpointManager(str(tmp_path / "ckpt"))

    def save(step, state, metrics):
        if step + 1 == 2:
            mngr.save(2, train_state_dict(state))
            raise StopIteration  # interrupted after step 2

    with pytest.raises(StopIteration):
        run_pretraining(cfg, opt_cfg, batches, model=_port_model(cfg), hooks=[save], **kw)
    assert mngr.latest_step() == 2
    seen = []
    resumed = run_pretraining(cfg, opt_cfg, batches, model=_port_model(cfg, seed=9),
                              resume_dir=str(tmp_path / "ckpt"),
                              hooks=[lambda step, st, m: seen.append(step)], **kw)
    assert seen == [2, 3] and resumed.step == 4 and resumed.optimizer.state.count == 4
    for a, b in ((whole.model.state_dict(), resumed.model.state_dict()),
                 (whole.optimizer.state.mu, resumed.optimizer.state.mu),
                 (whole.optimizer.state.nu, resumed.optimizer.state.nu)):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_checkpoint_manager_keeps_the_last_three(tmp_path):
    from vilbert_tpu_torch.core.checkpoint import CheckpointManager

    mngr = CheckpointManager(str(tmp_path))
    for step in (1, 2, 5, 9):
        mngr.save(step, {"x": torch.full((2,), float(step)), "n": step}, host_state={"s": step})
    assert mngr.all_steps() == [2, 5, 9] and mngr.latest_step() == 9
    state, host, step = mngr.restore({"x": torch.zeros(2), "n": 0}, step=5)
    assert step == 5 and host == {"s": 5} and state["n"] == 5
    assert torch.equal(state["x"], torch.full((2,), 5.0))
    with pytest.raises(ValueError, match="missing"):
        mngr.restore({"x": torch.zeros(2), "n": 0, "y": torch.zeros(1)})
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore({})


def _multitask_trainer(cfg, tmp_path, *, bf16_moments=False, optim="adamw", seed=0):
    from tests.test_torch_multitask import B, NUM_LABELS, _FakeLoader, _task_batches, _tasks
    from vilbert_tpu_torch.core import config as port_config
    from vilbert_tpu_torch.train.multitask import MultiTaskTrainer

    moments = "bfloat16" if bf16_moments else "float32"
    tasks = {k: t for k, t in _tasks(port_config).items() if k in ("TASK1", "TASK12")}
    batches = _task_batches(cfg)
    return MultiTaskTrainer(
        cfg, tasks, {k: _FakeLoader(batches[k], B) for k in tasks},
        opt_cfg=port_config.OptimizerConfig(
            name=optim, schedule="mannul", correct_bias=False, head_lr=1e-3,
            first_moment_dtype=moments,
            second_moment_dtype=moments),
        train_cfg=port_config.TrainConfig(checkpoint_dir=str(tmp_path / "ckpt")),
        num_labels=NUM_LABELS, seed=seed, device="cpu")


def test_multitask_save_restore_carries_every_state(tiny_config, tmp_path):
    """The cases of tests/test_resume.py: after three iterations and a stop,
    a new trainer restores the parameters and moments bit for bit, the
    shared count, ``global_step``, ``epoch``, the controllers, the
    ``mannul`` schedule's state and the logger's."""
    t1 = _multitask_trainer(tiny_config, tmp_path)
    t1.attach_logger(str(tmp_path / "logs"))
    for it in range(3):
        t1.train_iteration(it)
    t1.controller.controllers["TASK1"].in_stop = True
    t1.schedule.on_epoch_end(5, 0.5)  # a mannul drop: decay_factor 0.2
    t1.epoch = 2
    path = t1.save_checkpoint()
    assert path.endswith("/3")

    t2 = _multitask_trainer(tiny_config, tmp_path, seed=1)
    t2.attach_logger(str(tmp_path / "logs2"))
    assert t2.restore_checkpoint() == 3
    assert (t2.global_step, t2.epoch) == (3, 2)
    assert t2.controller.controllers["TASK1"].in_stop
    assert t2.controller.state_dict() == t1.controller.state_dict()
    assert t2.schedule.state_dict() == t1.schedule.state_dict()
    assert t2.schedule.decay_factor < 1.0
    assert t2.metrics_logger.state_dict() == t1.metrics_logger.state_dict()
    assert t2.optimizer.state.count == t1.optimizer.state.count == 6
    for a, b in ((t1.model.state_dict(), t2.model.state_dict()),
                 (t1.optimizer.state.mu, t2.optimizer.state.mu),
                 (t1.optimizer.state.nu, t2.optimizer.state.nu)):
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_restore_with_bf16_moments_toggled_converts_and_warns(tiny_config, tmp_path, caplog):
    """A checkpoint saved with fp32 moments restores into a trainer with
    bf16 moments (and back): the moments are converted, the parameters are
    not, and a warning names the converted groups."""
    t1 = _multitask_trainer(tiny_config, tmp_path)
    t1.train_iteration(0)
    t1.save_checkpoint()
    t2 = _multitask_trainer(tiny_config, tmp_path, bf16_moments=True)
    with caplog.at_level(logging.WARNING, logger="vilbert_tpu_torch.core.checkpoint"):
        t2.restore_checkpoint()
    text = caplog.text
    assert "optimizer.mu" in text and "optimizer.nu" in text and "float32 -> bfloat16" in text
    assert "params" not in text
    for n, m in t1.optimizer.state.mu.items():
        assert t2.optimizer.state.mu[n].dtype == torch.bfloat16
        assert torch.equal(t2.optimizer.state.mu[n], m.to(torch.bfloat16)), n
    for k, v in t1.model.state_dict().items():
        assert torch.equal(t2.model.state_dict()[k], v), k
    t2.save_checkpoint(step=7)
    caplog.clear()
    t3 = _multitask_trainer(tiny_config, tmp_path)
    with caplog.at_level(logging.WARNING, logger="vilbert_tpu_torch.core.checkpoint"):
        assert t3.restore_checkpoint() == 7
    assert "bfloat16 -> float32" in caplog.text
    assert t3.optimizer.state.nu[n].dtype == torch.float32


def test_radam_trainer_steps_every_label_and_round_trips(tiny_config, tmp_path):
    """Under RAdam a task step moves the moments of every parameter it does
    not freeze, other heads' included (zero gradients, no mask), each label
    on its own count; the state round-trips through a checkpoint."""
    t1 = _multitask_trainer(tiny_config, tmp_path, optim="radam")
    assert all(t.mask is None for t in t1.tasks.values())
    t1.train_iteration(0)
    st = t1.optimizer.state
    assert {lb: s.count for lb, s in st.items()} == {"base": 2, "head": 2}
    # the GQA head is in no task's graph: weight decay alone moves its moments
    assert st["head"].mu["vil_prediction_gqa.logit_fc.0.weight"].abs().sum() > 0
    t1.save_checkpoint()
    t2 = _multitask_trainer(tiny_config, tmp_path, optim="radam", seed=1)
    t2.restore_checkpoint()
    for lb, s in t2.optimizer.state.items():
        assert s.count == st[lb].count
        for n, m in s.mu.items():
            assert torch.equal(m, st[lb].mu[n]), n


# -- the CLIs ------------------------------------------------------------------------

_TINY_JSON = dict(
    vocab_size=99, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
    intermediate_size=64, max_position_embeddings=64, v_feature_size=2048,
    v_hidden_size=24, v_num_hidden_layers=2, v_num_attention_heads=4,
    v_intermediate_size=48, v_target_size=1601, bi_hidden_size=32,
    bi_num_attention_heads=4, v_biattention_id=[0, 1], t_biattention_id=[0, 1])


def test_concap_cli_bf16_options_checkpoints_and_resume(tmp_path):
    """train_concap --bf16_grads --bf16_adam_state --checkpoint_every 1:
    bf16 moments, a step directory a step (the last three kept); then
    --resume_file from the latest (and from --start_step) runs the rest."""
    from vilbert_tpu_torch.cli.train_concap import main

    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(_TINY_JSON))
    common = ["--synthetic", "--device", "cpu", "--batch_size", "8", "--config", str(cfg),
              "--bf16_grads", "--bf16_adam_state"]
    out = tmp_path / "a"
    state = main([*common, "--num_steps", "4", "--checkpoint_every", "1",
                  "--output_dir", str(out)])
    assert state.step == 4
    assert {t.dtype for t in state.optimizer.state.mu.values()} == {torch.bfloat16}
    assert sorted(p.name for p in (out / "ckpt").iterdir()) == ["2", "3", "4"]
    seen = []
    resumed = main([*common, "--num_steps", "5", "--resume_file", str(out / "ckpt"),
                    "--output_dir", str(tmp_path / "b")])
    assert resumed.step == 5 and resumed.optimizer.state.count == 5
    from vilbert_tpu_torch.cli.train_concap import build_parser, train

    args = build_parser().parse_args([*common, "--num_steps", "5", "--resume_file",
                                      str(out / "ckpt"), "--start_step", "3",
                                      "--output_dir", str(tmp_path / "c")])
    train(args, hooks=[lambda step, st, m: seen.append(step)])
    assert seen == [3, 4]


def test_tasks_cli_radam_bf16_checkpoint_and_resume(tmp_path):
    """train_tasks --optim radam --bf16_grads --checkpoint_every 1 over two
    task types: finite losses, a checkpoint at the epoch end, and
    --resume_file restores it (global step, epoch, RAdam counts)."""
    from vilbert_tpu_torch.cli.train_tasks import main
    from vilbert_tpu_torch.train.optim import ReferenceRAdam

    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(dict(_TINY_JSON, v_target_size=11)))
    common = ["--synthetic", "--device", "cpu", "--tasks", "1-12", "--config", str(cfg),
              "--optim", "radam", "--bf16_grads", "--num_epochs", "1",
              "--train_iter_multiplier", "0.025"]  # two iterations an epoch
    out = tmp_path / "out"
    losses = []
    from vilbert_tpu_torch.cli.train_tasks import build_parser, train

    trainer = train(build_parser().parse_args([*common, "--checkpoint_every", "1",
                                               "--output_dir", str(out)]),
                    hooks=[lambda e, it, tr, m: losses.extend(float(v["loss"])
                                                              for v in m.values())])
    assert isinstance(trainer.optimizer, ReferenceRAdam)
    assert len(losses) == 4 and all(np.isfinite(losses))
    step = trainer.global_step
    assert step == 2
    assert (out / "ckpt" / str(step) / "state.pt").is_file()
    resumed = main([*common, "--num_epochs", "1", "--resume_file", str(out / "ckpt"),
                    "--output_dir", str(tmp_path / "again")])
    # the saved epoch (0) is complete: resuming into a 1-epoch run trains it
    # again from the restored state, as the JAX trainer does
    assert resumed.global_step == 2 * step
    assert {lb: s.count for lb, s in resumed.optimizer.state.items()} == {
        lb: 2 * s.count for lb, s in trainer.optimizer.state.items()}
