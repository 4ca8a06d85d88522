"""The port's pretraining slice against the JAX package, on the CPU.

Optimizer (schedules, decay mask, labels, ``reference_adamw``), pretraining
losses and gathers, the whole step (loss and every parameter gradient
against ``jax.value_and_grad``) and a 5-step trajectory, at fp32 on
``tiny_config`` with the same weights through the weight bridge; the JAX
side runs its Pallas kernels in interpret mode. Then determinism with
dropout on, and the CLI's checkpoint loading into the JAX package.

Dropout is off in the comparisons with JAX: the JAX package draws its seeds
from threefry, which the port does not reproduce. The pretraining heads'
fuse dropout has a fixed rate of 0.1 (reference BertPreTrainingHeads), so
the JAX side runs ``deterministic=True`` and the port runs in train mode
with that one site set to rate 0: the same function, through the port's
training code paths.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vilbert_tpu.core.config import OptimizerConfig
from vilbert_tpu.core.importer import _flatten

B, T, R, K = 4, 9, 6, 3  # batch, tokens, regions (with the global row), lm_gather


def _pallas(cfg):
    return cfg.replace(use_pallas_attention=True, use_pallas_layernorm=True)


def _batch(cfg, seed, visual_target=0, b=B):
    rng = np.random.RandomState(seed)
    target_dim = cfg.v_target_size if visual_target == 0 else cfg.v_feature_size
    input_mask = np.ones((b, T), np.int32)
    input_mask[1, -3:] = 0
    image_mask = np.ones((b, R), np.int32)
    image_mask[2, -2:] = 0
    target = rng.rand(b, R - 1, target_dim).astype(np.float32)
    if visual_target == 0:
        target /= target.sum(-1, keepdims=True)
        target[0, 1] = 0.0  # zero-target rows contribute 0 to the KL
    lm = np.where(rng.rand(b, T) < 0.35, rng.randint(0, cfg.vocab_size, (b, T)), -1)
    lm[3, :] = -1  # a sample with nothing masked
    lm[0, :6] = rng.randint(0, cfg.vocab_size, 6)  # more than K masked
    return {
        "input_ids": rng.randint(1, cfg.vocab_size, (b, T)).astype(np.int32),
        "image_feat": rng.randn(b, R, cfg.v_feature_size).astype(np.float32),
        "image_loc": rng.rand(b, R, 5).astype(np.float32),
        "segment_ids": rng.randint(0, 2, (b, T)).astype(np.int32),
        "input_mask": input_mask,
        "image_mask": image_mask,
        "lm_label_ids": lm.astype(np.int32),
        "image_label": np.where(rng.rand(b, R - 1) < 0.4, 1, -1).astype(np.int32),
        "image_target": target,
        "is_next": rng.randint(0, 2, (b,)).astype(np.int32),
    }


def _tensors(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _port_model(cfg, seed=0):
    from vilbert_tpu_torch.models.vilbert import ViLBERTForPretraining

    model = ViLBERTForPretraining(cfg, generator=torch.Generator().manual_seed(seed))
    model.cls.dropout.rate = 0.0  # the fixed-rate fuse site (module docstring)
    return model


def _flax(named_tensors):
    from vilbert_tpu_torch.core.weights import flax_from_state_dict

    return _flatten(flax_from_state_dict(named_tensors))


def _jax_params(model):
    from vilbert_tpu_torch.core.weights import flax_from_state_dict

    return flax_from_state_dict(model.state_dict())


class TestOptimizer:
    @pytest.mark.parametrize("kind", ["warmup_linear", "warmup_constant"])
    @pytest.mark.parametrize("total,warm", [(100, 0.1), (7, 0.3), (1000, 0.0)])
    def test_schedules_match_exactly(self, kind, total, warm):
        """Against the jitted JAX schedule, as the JAX step evaluates it."""
        import vilbert_tpu.train.optim as jax_optim
        import vilbert_tpu_torch.train.optim as port_optim

        want_fn = jax.jit(getattr(jax_optim, f"{kind}_schedule")(3e-4, total, warm))
        got_fn = getattr(port_optim, f"{kind}_schedule")(3e-4, total, warm)
        for step in range(total + 6):
            want = np.asarray(want_fn(step), np.float32)
            assert np.float32(got_fn(step)) == want, step

    def test_decay_mask_and_labels_match_leaf_for_leaf(self, tiny_config):
        from vilbert_tpu.train.optim import _decay_mask, label_params as jax_labels
        from vilbert_tpu_torch.train.optim import decay_mask, label_params

        model = _port_model(tiny_config)
        names = [n for n, _ in model.named_parameters()]
        params = _jax_params(model)
        by_path = {k: n for k, n in zip(_flax({n: torch.zeros(1) for n in names}), names)}
        assert len(by_path) == len(names)
        want = _flatten(_decay_mask(params))
        got = decay_mask(names)
        for path, n in by_path.items():
            assert got[n] == bool(want[path]), path
        assert got["bert.encoder.c_layer.0.biOutput.LayerNorm1.weight"]  # decayed, as the reference
        assert not got["bert.encoder.layer.0.output.LayerNorm.weight"]
        for kw in (dict(freeze_prefix=("bert.embeddings.", "bert.encoder.layer_0.")),
                   dict(pretrained_lr_scale=0.1), dict(vision_scratch=True, head_lr=1e-4)):
            want = _flatten(jax_labels(params, **kw))
            got = label_params(names, **kw)
            for path, n in by_path.items():
                assert got[n] == want[path], (kw, path)
            assert len(set(got.values())) > 1

    def test_reference_adamw_five_steps(self):
        """Same updates as ``reference_adamw`` over 5 steps of random
        gradients, within 1e-6 relative (float32 rounding of the moment
        updates; a weight-decayed, a not-decayed and a scaled group)."""
        import optax

        from vilbert_tpu.train.optim import build_optimizer as jax_build
        from vilbert_tpu_torch.train.optim import build_optimizer

        rng = np.random.RandomState(0)
        names = ["bert.encoder.layer.0.attention.self.query.weight",
                 "bert.encoder.layer.0.attention.self.query.bias",
                 "bert.encoder.c_layer.0.biOutput.LayerNorm1.weight",
                 "cls.predictions.bias"]
        shapes = [(6, 5), (6,), (5,), (7,)]
        init = {n: rng.randn(*s).astype(np.float32) for n, s in zip(names, shapes)}
        cfg = OptimizerConfig(learning_rate=1e-3, beta2=0.98, eps=1e-8,
                              pretrained_lr_scale=0.5, schedule="warmup_linear")
        port = {n: torch.from_numpy(v.copy()) for n, v in init.items()}
        opt, _ = build_optimizer(cfg, port, 10, step_offset=1)
        jparams = jax.tree.map(jnp.asarray, _flax_np(init))
        tx, _ = jax_build(cfg, jparams, 10, step_offset=1)
        state = tx.init(jparams)
        for _ in range(5):
            grads = {n: rng.randn(*s).astype(np.float32) for n, s in zip(names, shapes)}
            opt.step({n: torch.from_numpy(g) for n, g in grads.items()})
            updates, state = tx.update(jax.tree.map(jnp.asarray, _flax_np(grads)), state, jparams)
            jparams = optax.apply_updates(jparams, updates)
        got = _flax(opt.params)
        for path, want in _flatten(jparams).items():
            np.testing.assert_allclose(got[path], np.asarray(want), rtol=1e-6, atol=1e-7,
                                       err_msg=path)


def _flax_np(named):
    from vilbert_tpu_torch.core.weights import flax_from_state_dict

    return flax_from_state_dict({n: torch.from_numpy(v) for n, v in named.items()})


class TestLosses:
    @pytest.mark.parametrize("visual_target", [0, 1])
    @pytest.mark.parametrize("gathered", [False, True])
    def test_pretrain_losses_match(self, visual_target, gathered):
        from collections import namedtuple

        from vilbert_tpu.train.losses import pretrain_losses as jax_losses
        from vilbert_tpu_torch.train.losses import pretrain_losses

        rng = np.random.RandomState(visual_target)
        v_dim = 11 if visual_target == 0 else 16
        rows = R - 1 if gathered else R  # gathered: no global row
        Out = namedtuple("Out", "prediction_scores_t prediction_scores_v seq_relationship_score")
        out = Out(rng.randn(B, T, 13).astype(np.float32) * 3,
                  rng.randn(B, rows, v_dim).astype(np.float32),
                  rng.randn(B, 2).astype(np.float32))
        lm = np.where(rng.rand(B, T) < 0.4, rng.randint(0, 13, (B, T)), -1).astype(np.int32)
        lm[3] = -1
        image_label = np.where(rng.rand(B, R - 1) < 0.4, 1, -1).astype(np.int32)
        target = rng.rand(B, R - 1, v_dim).astype(np.float32)
        if visual_target == 0:
            target /= target.sum(-1, keepdims=True)
            target[0, 1] = 0.0
        is_next = np.array([0, 1, -1, 1], np.int32)
        args = (lm, image_label, target, is_next)
        want = jax_losses(Out(*map(jnp.asarray, out)), *map(jnp.asarray, args),
                          visual_target=visual_target, img_gathered=gathered)
        got = pretrain_losses(Out(*map(torch.from_numpy, out)), *map(torch.from_numpy, args),
                              visual_target=visual_target, img_gathered=gathered)
        for name, g, w in zip(want._fields, got, want):
            np.testing.assert_allclose(g.item(), float(w), rtol=1e-6, err_msg=name)

    def test_nce_is_refused(self, tiny_config):
        """What NCE still refuses, as the JAX package does: gathered rows
        (its negatives come from every region), and a draw without a
        generator."""
        from vilbert_tpu_torch.train.losses import masked_image_loss
        from vilbert_tpu_torch.train.pretrain import make_pretrain_loss_fn

        args = (torch.zeros(1, 3, 4), torch.ones(1, 2), torch.zeros(1, 2, 4))
        with pytest.raises(ValueError, match="NCE"):
            masked_image_loss(args[0][:, 1:], *args[1:], visual_target=2, gathered=True,
                              generator=torch.Generator())
        with pytest.raises(ValueError, match="generator"):
            masked_image_loss(*args, visual_target=2)
        with pytest.raises(ValueError, match="nce_generator"):
            make_pretrain_loss_fn(tiny_config.replace(visual_target=2))

    @pytest.mark.parametrize("objective", [0, 1, 2])
    def test_gathers_and_labels_match_as_integers(self, tiny_config, objective, monkeypatch):
        """The lm_gather / img_gather positions the models see and the
        labels the losses get equal JAX's exactly (recorded from both)."""
        import vilbert_tpu.train.pretrain as jax_pretrain
        import vilbert_tpu_torch.train.pretrain as port_pretrain
        from vilbert_tpu.models.vilbert import ViLBERTForPretraining as JaxModel

        cfg = tiny_config.replace(objective=objective)
        batch = _batch(cfg, 1)
        seen = {}

        def spy_losses(module, key):
            fn = module.pretrain_losses

            def spy(out, lm_labels, image_label, image_target, is_next, **kw):
                seen[key] = [np.asarray(lm_labels), np.asarray(image_label),
                             np.asarray(image_target)]
                return fn(out, lm_labels, image_label, image_target, is_next, **kw)

            monkeypatch.setattr(module, "pretrain_losses", spy)

        spy_losses(jax_pretrain, "jax_labels")
        spy_losses(port_pretrain, "port_labels")

        class Spy(JaxModel):
            def __call__(self, *a, lm_positions=None, img_positions=None, **kw):
                seen["jax"] = (np.asarray(lm_positions), np.asarray(img_positions))
                return super().__call__(*a, lm_positions=lm_positions,
                                        img_positions=img_positions, **kw)

        model = _port_model(cfg)
        params = _jax_params(model)
        jax_pretrain.make_pretrain_loss_fn(Spy(cfg), cfg, deterministic=True, lm_gather=K,
                                           img_gather=2)(params, batch, jax.random.PRNGKey(0))
        forward = model.forward

        def spy(*a, lm_positions=None, img_positions=None, **kw):
            seen["port"] = (lm_positions.numpy(), img_positions.numpy())
            return forward(*a, lm_positions=lm_positions, img_positions=img_positions, **kw)

        model.forward = spy
        port_pretrain.make_pretrain_loss_fn(cfg, deterministic=True, lm_gather=K,
                                            img_gather=2)(model, _tensors(batch))
        for got, want in zip([*seen["port"], *seen["port_labels"]],
                             [*seen["jax"], *seen["jax_labels"]]):
            np.testing.assert_array_equal(got, want)
        assert seen["port"][0].shape == (B, K)
        assert (seen["port_labels"][0] != -1).sum() > 0


class TestStep:
    def test_loss_and_every_gradient_match_jax(self, tiny_config):
        """fp32, lm_gather=K: loss within 1e-5 relative; every gradient leaf
        within 1e-4 relative or 1e-6 absolute (summation order differs over
        10 layers of backward)."""
        from vilbert_tpu.models.vilbert import ViLBERTForPretraining as JaxModel
        from vilbert_tpu.train.pretrain import make_pretrain_loss_fn as jax_loss_fn
        from vilbert_tpu_torch.train.pretrain import make_pretrain_loss_fn

        cfg = tiny_config
        model = _port_model(cfg)
        params = _jax_params(model)
        batch = _batch(cfg, 2)
        jfn = jax_loss_fn(JaxModel(_pallas(cfg)), cfg, deterministic=True, lm_gather=K)
        (want_loss, want_m), want_g = jax.jit(jax.value_and_grad(jfn, has_aux=True))(
            params, batch, jax.random.PRNGKey(0))
        loss, metrics = make_pretrain_loss_fn(cfg, lm_gather=K)(model, _tensors(batch))
        assert model.training
        loss.backward()
        np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
        for k, v in metrics.items():
            np.testing.assert_allclose(v.item(), float(want_m[k]), rtol=1e-5, err_msg=k)
        got_g = _flax({n: p.grad for n, p in model.named_parameters()})
        want_g = _flatten(want_g)
        assert set(got_g) == set(want_g)
        for path, w in want_g.items():
            np.testing.assert_allclose(got_g[path], np.asarray(w), rtol=1e-4, atol=1e-6,
                                       err_msg=path)

    def test_five_steps_of_run_pretraining_match_jax(self, tiny_config):
        """Losses at each of 5 steps within 1e-5 relative, and the Adam
        moments after step 1 within 1e-4 relative or 1e-9 absolute. The JAX
        side is its run_pretraining's loop (build_optimizer with
        step_offset=1, make_train_step) over the deterministic loss."""
        from vilbert_tpu.models.vilbert import ViLBERTForPretraining as JaxModel

        _five_steps_match_jax(tiny_config, JaxModel, _port_model(tiny_config), "vilbert")

    def test_five_steps_of_basebert_run_pretraining_match_jax(self, tiny_config):
        """The same for the single-stream baseline (``model_family=
        "basebert"``): its flax paths through the bridge, its losses, its
        moments; a first moment summed from cancelling terms (the LM
        transform's, over every gathered token) carries the rounding of the
        larger ones, so each moment is held within 1e-6 of its tensor's
        largest entry too."""
        from vilbert_tpu.models.basebert import BaseBertForPretraining as JaxModel
        from vilbert_tpu_torch.models.basebert import BaseBertForPretraining

        model = BaseBertForPretraining(tiny_config, generator=torch.Generator().manual_seed(0))
        _five_steps_match_jax(tiny_config, JaxModel, model, "basebert", moment_floor=1e-6)

    def test_grad_accumulation_is_the_mean(self, tiny_config):
        """Two microbatches of 2 give the mean of their gradients and losses."""
        from vilbert_tpu_torch.parallel.train_step import make_train_step
        from vilbert_tpu_torch.train.optim import build_optimizer
        from vilbert_tpu_torch.train.pretrain import host_batch, make_pretrain_loss_fn

        cfg = tiny_config
        batch = _batch(cfg, 3)
        model = _port_model(cfg)
        loss_fn = make_pretrain_loss_fn(cfg, lm_gather=K)
        want_loss = 0.0
        for half in (slice(0, 2), slice(2, 4)):
            loss, _ = loss_fn(model, {k: v[half] for k, v in _tensors(batch).items()})
            loss.backward()
            want_loss += loss.item() / 2
        want = {n: p.grad / 2 for n, p in model.named_parameters()}
        opt, _ = build_optimizer(OptimizerConfig(learning_rate=0.0, schedule="constant"),
                                 dict(model.named_parameters()), 1)
        m = make_train_step(loss_fn, opt, grad_accum=2)(model, host_batch(batch, cfg, 2))
        np.testing.assert_allclose(m["loss"].item(), want_loss, rtol=1e-6)
        for n, p in model.named_parameters():
            torch.testing.assert_close(p.grad, want[n], rtol=1e-5, atol=1e-7)




def _five_steps_match_jax(cfg, jax_model_cls, model, family, moment_floor=0.0):
    """5 steps of the port's run_pretraining against the JAX loop from the
    same weights: losses within 1e-5 relative, the moments after step 1
    within 1e-4 relative or 1e-9 absolute, plus ``moment_floor`` of their
    tensor's largest entry."""
    from vilbert_tpu.parallel.train_step import TrainState, make_train_step
    from vilbert_tpu.train.optim import build_optimizer as jax_build
    from vilbert_tpu.train.pretrain import make_pretrain_loss_fn as jax_loss_fn
    from vilbert_tpu_torch.core.weights import flax_from_state_dict
    from vilbert_tpu_torch.train.pretrain import run_pretraining

    JaxModel = jax_model_cls
    opt_cfg = OptimizerConfig(learning_rate=1e-3, beta2=0.98, eps=1e-8,
                              schedule="warmup_linear", warmup_proportion=0.3)
    batches = [_batch(cfg, 10 + i) for i in range(5)]
    params = flax_from_state_dict(model.state_dict(), family)
    tx, _ = jax_build(opt_cfg, params, 5, step_offset=1)
    state = TrainState.create(params, tx)
    step_fn = make_train_step(
        jax_loss_fn(JaxModel(_pallas(cfg)), cfg, deterministic=True, lm_gather=K), tx)
    want_losses, want_moments = [], None
    for i, b in enumerate(batches):
        state, m = step_fn(state, b, jax.random.PRNGKey(i))
        want_losses.append(float(m["loss"]))
        if i == 0:  # copied: the next step donates the state
            want_moments = [{k: np.array(v) for k, v in _flatten(t).items()}
                            for t in (state.opt_state.mu, state.opt_state.nu)]

    got_losses, got_moments = [], []

    def hook(step, st, metrics):
        got_losses.append(float(metrics["loss"]))
        if step == 0:
            mu, nu = st.optimizer.state.mu, st.optimizer.state.nu
            got_moments.extend(_flatten(flax_from_state_dict(t, family)) for t in (mu, nu))

    state = run_pretraining(cfg, opt_cfg, batches, num_steps=5, model=model, device="cpu",
                            lm_gather=K, log_every=0, hooks=[hook], model_family=family)
    assert state.step == 5 and state.optimizer.state.count == 5
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-5)
    for got, want in zip(got_moments, want_moments):
        for path, w in want.items():
            w = np.asarray(w)
            np.testing.assert_allclose(got[path], w, rtol=1e-4,
                                       atol=1e-9 + moment_floor * np.abs(w).max(), err_msg=path)


class TestDropoutOn:
    def test_same_seed_same_steps(self, tiny_config):
        """Two runs from one seed give bit-identical losses; another seed
        other losses (dropout 0.1 at every site, hidden and attention)."""
        from vilbert_tpu_torch.train.pretrain import run_pretraining

        cfg = tiny_config.replace(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
                                  v_hidden_dropout_prob=0.1, v_attention_probs_dropout_prob=0.1)
        batches = [_batch(cfg, 20 + i) for i in range(2)]
        opt_cfg = OptimizerConfig(learning_rate=1e-3, schedule="constant")

        def losses(seed):
            out = []
            run_pretraining(cfg, opt_cfg, batches, num_steps=2, seed=seed, device="cpu",
                            lm_gather=K, log_every=0,
                            hooks=[lambda s, st, m: out.append(m["loss"].item())])
            return out

        a, b, c = losses(0), losses(0), losses(1)
        assert a == b and a != c and all(np.isfinite(a))

    @pytest.mark.parametrize("family", ["vilbert", "basebert"])
    def test_nce_same_seed_same_steps(self, tiny_config, family):
        """Visual target 2 with dropout: the negatives follow the run's seed
        (two runs of one seed give bit-identical losses, another seed other
        losses), and the validation pass draws the same negatives each
        time it runs."""
        from vilbert_tpu_torch.train.pretrain import evaluate_pretraining, run_pretraining

        cfg = tiny_config.replace(visual_target=2, num_negative=6, hidden_dropout_prob=0.1,
                                  attention_probs_dropout_prob=0.1)
        batches = [_batch(cfg, 30 + i, visual_target=2) for i in range(2)]
        opt_cfg = OptimizerConfig(learning_rate=1e-3, schedule="constant")

        def run(seed):
            out = []
            state = run_pretraining(cfg, opt_cfg, batches, num_steps=2, seed=seed, device="cpu",
                                    lm_gather=K, log_every=0, model_family=family,
                                    hooks=[lambda s, st, m: out.append(m["loss"].item())])
            return out, state.model

        (a, model), (b, _), (c, _) = run(0), run(0), run(1)
        assert a == b and a != c and all(np.isfinite(a))
        v1, v2 = (evaluate_pretraining(cfg, model, batches, lm_gather=K, device="cpu")
                  for _ in range(2))
        assert v1 == v2 and np.isfinite(v1["masked_loss_v"])


class TestCLI:
    def test_params_final_loads_into_the_jax_model(self, tmp_path):
        """train_concap --synthetic on a tiny config writes params_final.npz,
        which vilbert_tpu.core.checkpoint.load_params reads into exactly the
        JAX ViLBERTForPretraining tree; state_dict_from_flax carries it back."""
        from vilbert_tpu.core.checkpoint import load_params
        from vilbert_tpu.core.config import ModelConfig
        from vilbert_tpu.models.vilbert import ViLBERTForPretraining as JaxModel
        from vilbert_tpu_torch.cli.train_concap import main
        from vilbert_tpu_torch.core.weights import state_dict_from_flax

        cfg_path = tmp_path / "tiny.json"
        cfg_path.write_text(json.dumps(dict(
            vocab_size=99, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=64, max_position_embeddings=64, v_feature_size=2048,
            v_hidden_size=24, v_num_hidden_layers=2, v_num_attention_heads=4,
            v_intermediate_size=48, v_target_size=1601, bi_hidden_size=32,
            bi_num_attention_heads=4, v_biattention_id=[0, 1], t_biattention_id=[0, 1])))
        state = main(["--synthetic", "--device", "cpu", "--num_steps", "3", "--batch_size", "8",
                      "--config", str(cfg_path), "--output_dir", str(tmp_path / "out")])
        params = load_params(str(tmp_path / "out" / "params_final.npz"))
        cfg = ModelConfig.from_json_file(str(cfg_path))
        shapes = jax.eval_shape(JaxModel(cfg).init, jax.random.PRNGKey(0),
                                np.zeros((1, 5), np.int32), np.zeros((1, 3, 2048), np.float32),
                                np.zeros((1, 3, 5), np.float32))["params"]
        assert {k: v.shape for k, v in _flatten(params).items()} == {
            k: s.shape for k, s in _flatten(shapes).items()}
        sd = state_dict_from_flax(params, state.model.state_dict().keys())
        for k, v in state.model.state_dict().items():
            assert torch.equal(sd[k], v), k
        # and a tree the JAX model made carries into the port's model
        rng = np.random.RandomState(0)
        jax_tree = jax.tree.map(lambda s: rng.randn(*s.shape).astype(np.float32), shapes)
        state.model.load_state_dict(state_dict_from_flax(jax_tree, sd.keys()))
        for path, want in _flatten(jax_tree).items():
            np.testing.assert_array_equal(_flax(state.model.state_dict())[path], want)

    @pytest.mark.parametrize("flags", [["--baseline"], ["--visual_target", "2"],
                                       ["--baseline", "--visual_target", "2"]])
    def test_baseline_and_nce_params_final_have_the_jax_tree(self, tmp_path, flags,
                                                              monkeypatch):
        """train_concap --synthetic with --baseline and/or --visual_target 2
        (NCE over 128 negatives) runs 2 steps with finite losses and writes
        a params_final.npz of exactly the JAX model's tree (paths and
        shapes: BaseBertForPretraining for the baseline, the image head
        predicting 2048-d features under NCE)."""
        from vilbert_tpu.core.checkpoint import load_params
        from vilbert_tpu.core.config import ModelConfig
        from vilbert_tpu.models.basebert import BaseBertForPretraining
        from vilbert_tpu.models.vilbert import ViLBERTForPretraining as JaxModel
        from vilbert_tpu_torch.cli.train_concap import main

        cfg_path = tmp_path / "tiny.json"
        cfg_path.write_text(json.dumps(dict(
            vocab_size=99, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=64, max_position_embeddings=64, v_feature_size=2048,
            v_hidden_size=24, v_num_hidden_layers=2, v_num_attention_heads=4,
            v_intermediate_size=48, v_target_size=1601, bi_hidden_size=32,
            bi_num_attention_heads=4, v_biattention_id=[0, 1], t_biattention_id=[0, 1])))
        losses = []
        import vilbert_tpu_torch.train.pretrain as port_pretrain

        run = port_pretrain.run_pretraining

        def spy(*a, hooks=None, **kw):
            hooks = [*(hooks or ()), lambda s, st, m: losses.append(float(m["loss"]))]
            return run(*a, hooks=hooks, **kw)

        monkeypatch.setattr(port_pretrain, "run_pretraining", spy)
        main(["--synthetic", "--device", "cpu", "--num_steps", "2", "--batch_size", "8",
              "--config", str(cfg_path), "--output_dir", str(tmp_path / "out"), *flags])
        assert len(losses) == 2 and all(np.isfinite(losses))
        vt = 2 if "--visual_target" in flags else 0
        cfg = ModelConfig.from_json_file(str(cfg_path), visual_target=vt)
        model = BaseBertForPretraining(cfg) if "--baseline" in flags else JaxModel(cfg)
        shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), np.zeros((1, 5), np.int32),
                                np.zeros((1, 3, 2048), np.float32),
                                np.zeros((1, 3, 5), np.float32))["params"]
        got = _flatten(load_params(str(tmp_path / "out" / "params_final.npz")))
        assert {k: v.shape for k, v in got.items()} == {
            k: s.shape for k, s in _flatten(shapes).items()}
        assert got["bert.embeddings.word_embeddings.embedding"].shape == (99, 32)

    @pytest.mark.parametrize("flag", [(["--num_processes", "2"], "--coordinator"),
                                      (["--process_id", "1"], "--process_id"),
                                      (["--num_shards", "2", "--shard_id", "2"], "--shard_id")])
    def test_refused_flags_name_their_roadmap_item(self, flag):
        """The data-parallel flags are ported (tests/test_torch_distributed.py);
        an incomplete or inconsistent set raises, naming the flag, before any
        process group is formed."""
        from vilbert_tpu_torch.cli.train_concap import main

        flags, match = flag
        with pytest.raises(ValueError, match=match):
            main(["--synthetic", "--device", "cpu", *flags])

    @pytest.mark.parametrize("schedule", ["warmup_linear", "constant"])
    def test_optimizer_config_is_the_jax_clis(self, schedule):
        """The AdamW settings of ``vilbert_tpu.cli.train_concap`` (beta2 0.98,
        eps from --adam_epsilon), with the schedule the caller asks for."""
        from vilbert_tpu_torch.cli.train_concap import build_parser, optimizer_config

        import dataclasses

        from vilbert_tpu_torch.core import config

        args = build_parser().parse_args(["--learning_rate", "3e-5", "--adam_epsilon", "1e-6"])
        got = optimizer_config(args, schedule=schedule)
        assert type(got) is config.OptimizerConfig  # the port's own copy
        assert dataclasses.asdict(got) == dataclasses.asdict(OptimizerConfig(
            learning_rate=3e-5, warmup_proportion=0.1, schedule=schedule, beta2=0.98, eps=1e-6))


class TestRemat:
    """``remat``: each text, image and connection layer recomputed in the
    backward (``torch.utils.checkpoint``), its dropout seeds replayed."""

    def test_gradients_bit_equal_with_dropout_and_generator_state(self, tiny_config):
        """fp32 with dropout 0.1 at every site: remat's loss and every
        gradient equal the plain model's bit for bit, the dropout generator
        ends in the same state, and every encoder block ran twice (the
        forward and its recompute)."""
        from vilbert_tpu_torch.models.coattention import ConnectionLayer
        from vilbert_tpu_torch.models.layers import ImageLayer, TextLayer, set_dropout_generator
        from vilbert_tpu_torch.train.pretrain import make_pretrain_loss_fn

        cfg = tiny_config.replace(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
                                  v_hidden_dropout_prob=0.1, v_attention_probs_dropout_prob=0.1)
        batch = _tensors(_batch(cfg, 6))
        runs = {}
        for remat in (False, True):
            model = _port_model(cfg.replace(remat=remat)).train()
            gen = torch.Generator().manual_seed(11)
            set_dropout_generator(model, gen)
            calls = []

            def counted(forward):
                return lambda *a: calls.append(1) or forward(*a)

            for m in model.modules():
                if isinstance(m, (TextLayer, ImageLayer, ConnectionLayer)):
                    m.forward = counted(m.forward)
            loss, _ = make_pretrain_loss_fn(cfg, lm_gather=K)(model, batch)
            loss.backward()
            runs[remat] = (loss.detach(), {n: p.grad for n, p in model.named_parameters()},
                           gen.get_state(), len(calls))
        blocks = cfg.num_hidden_layers + cfg.v_num_hidden_layers + cfg.num_connection_layers
        (l0, g0, s0, n0), (l1, g1, s1, n1) = runs[False], runs[True]
        assert torch.equal(l0, l1) and torch.equal(s0, s1)
        assert (n0, n1) == (blocks, 2 * blocks)
        assert g0.keys() == g1.keys()
        for name in g0:
            assert (g0[name] is None) == (g1[name] is None), name
            if g0[name] is not None:
                assert torch.equal(g0[name], g1[name]), name

    def test_gradients_match_flax_remat(self, tiny_config):
        """Dropout off: the remat step's loss and every gradient against
        ``jax.value_and_grad`` of the flax model with ``remat=True``, each
        gradient within 1e-3 of its largest plus 1e-6 of the model's largest
        (the key biases' gradients are zero but for rounding: softmax is
        shift-invariant)."""
        from vilbert_tpu.models.vilbert import ViLBERTForPretraining as JaxModel
        from vilbert_tpu.train.pretrain import make_pretrain_loss_fn as jax_loss_fn
        from vilbert_tpu_torch.train.pretrain import make_pretrain_loss_fn

        cfg = tiny_config.replace(remat=True)
        model = _port_model(cfg, seed=3)
        batch = _batch(cfg, 7)
        jfn = jax_loss_fn(JaxModel(_pallas(cfg)), cfg, deterministic=True, lm_gather=K)
        (want_loss, _), want_g = jax.jit(jax.value_and_grad(jfn, has_aux=True))(
            _jax_params(model), batch, jax.random.PRNGKey(0))
        loss, _ = make_pretrain_loss_fn(cfg, lm_gather=K)(model, _tensors(batch))
        loss.backward()
        np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
        got_g = _flax({n: p.grad for n, p in model.named_parameters()})
        want_g = _flatten(want_g)
        assert set(got_g) == set(want_g)
        top = max(float(np.abs(np.asarray(w)).max()) for w in want_g.values())
        for path, w in want_g.items():
            w = np.asarray(w)
            np.testing.assert_allclose(got_g[path], w, rtol=0,
                                       atol=1e-3 * float(np.abs(w).max()) + 1e-6 * top,
                                       err_msg=path)

    def test_cli_flag_sets_remat(self, tmp_path):
        """``train_concap --remat`` builds the model with ``cfg.remat`` (the
        flag used to be accepted and ignored), and the baseline ignores it,
        as the JAX baseline does."""
        import json

        from vilbert_tpu_torch.cli.train_concap import main

        cfg = tmp_path / "tiny.json"
        cfg.write_text(json.dumps(dict(
            vocab_size=99, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=64, max_position_embeddings=64, v_feature_size=2048,
            v_hidden_size=24, v_num_hidden_layers=2, v_num_attention_heads=4,
            v_intermediate_size=48, v_target_size=1601, bi_hidden_size=32,
            bi_num_attention_heads=4, v_biattention_id=[0, 1], t_biattention_id=[0, 1],
            hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)))
        common = ["--synthetic", "--device", "cpu", "--num_steps", "2", "--batch_size", "4",
                  "--config", str(cfg)]
        plain = main([*common, "--output_dir", str(tmp_path / "a")])
        remat = main([*common, "--remat", "--output_dir", str(tmp_path / "b")])
        assert remat.model.cfg.remat and not plain.model.cfg.remat
        for name, p in plain.model.state_dict().items():
            assert torch.equal(p, remat.model.state_dict()[name]), name
