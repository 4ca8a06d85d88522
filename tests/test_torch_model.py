"""The PyTorch port's VQA evaluation slice against the JAX package, on the CPU.

Same weights in both packages through the weight bridge; the JAX side runs
with ``use_pallas_attention`` and ``use_pallas_layernorm`` (Pallas in
interpret mode on the CPU), the port on the plain versions of its kernels.
fp32 compute, ``tiny_config``.
"""

import functools
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vilbert_tpu.core.importer import _flatten, _unflatten

REPO = Path(__file__).resolve().parents[1]


def _pallas(cfg):
    return cfg.replace(use_pallas_attention=True, use_pallas_layernorm=True)


def _inputs(cfg, B=4, T=7, R=5, seed=0):
    rng = np.random.RandomState(seed)
    am = np.ones((B, T), np.int32)
    am[:, -2:] = 0
    im = np.ones((B, R), np.int32)
    im[1, -2:] = 0
    return dict(
        input_txt=rng.randint(0, cfg.vocab_size, (B, T)).astype(np.int32),
        input_imgs=rng.randn(B, R, cfg.v_feature_size).astype(np.float32),
        image_loc=rng.rand(B, R, cfg.num_locs).astype(np.float32),
        token_type_ids=rng.randint(0, 2, (B, T)).astype(np.int32),
        attention_mask=am,
        image_attention_mask=im,
    )


#: encoder variants of ModelConfig, each held to the flax apply
ENCODER_VARIANTS = {
    "no_coattention": dict(with_coattention=False),
    "fixed_layers": dict(fixed_t_layer=2, fixed_v_layer=1),
    "fast_mode": dict(fast_mode=True),
    "roberta": dict(model="roberta"),
    "fusion_sum": dict(fusion_method="sum"),
    "relu": dict(hidden_act="relu", v_hidden_act="relu"),
    "no_connection_layers": dict(v_biattention_id=(), t_biattention_id=()),
}
#: variants whose gradients only are held to the flax apply here
GRADIENT_VARIANTS = {"dynamic_attention": dict(dynamic_attention=True)}


def _variant_inputs(cfg):
    """``_inputs``, with one text for the four images under fast_mode."""
    x = _inputs(cfg, seed=5)
    if cfg.fast_mode:
        for k in ("input_txt", "token_type_ids", "attention_mask"):
            x[k] = x[k][:1]
    return x


def _port_model(cfg, seed=0):
    from vilbert_tpu_torch.models.vilbert import ViLBERTForVLTasks

    return ViLBERTForVLTasks(cfg, generator=torch.Generator().manual_seed(seed)).eval()


@pytest.fixture(scope="module")
def port_and_params(tiny_config):
    """A seeded port model and the same weights as a flax params tree."""
    from vilbert_tpu_torch.core.weights import flax_from_state_dict

    model = _port_model(tiny_config)
    return model, flax_from_state_dict(model.state_dict())


class TestWeightBridge:
    def test_port_names_are_reference_torch_names(self, port_and_params):
        from vilbert_tpu.core.importer import _to_flax_key

        keys = set(port_and_params[0].state_dict())
        for name in (
            "bert.embeddings.word_embeddings.weight",
            "bert.encoder.layer.0.attention.self.query.weight",
            "bert.encoder.layer.0.attention.output.LayerNorm.weight",
            "bert.encoder.layer.0.intermediate.dense.weight",
            "bert.encoder.v_layer.1.output.dense.bias",
            "bert.encoder.c_layer.0.biattention.query1.weight",
            "bert.encoder.c_layer.0.biOutput.LayerNorm2.bias",
            "bert.encoder.c_layer.1.t_output.dense.weight",
            "bert.v_pooler.dense.weight",
            "cls.predictions.bias",
            "cls.imagePredictions.decoder.weight",
            "vil_prediction.logit_fc.0.weight",
            "vil_prediction.logit_fc.2.weight",
            "vil_logit.weight",
        ):
            assert name in keys, name
        assert all(_to_flax_key(k) is not None for k in keys)

    def test_jax_params_round_trip_exactly(self, tiny_config, port_and_params):
        """JAX params -> port state_dict -> JAX params, bit for bit, over the
        exact param tree the flax model creates."""
        from vilbert_tpu.models.vilbert import ViLBERTForVLTasks as JaxModel
        from vilbert_tpu_torch.core.weights import flax_from_state_dict, state_dict_from_flax

        model, params = port_and_params
        x = _inputs(tiny_config)
        shapes = jax.eval_shape(
            JaxModel(tiny_config).init, jax.random.PRNGKey(0),
            x["input_txt"], x["input_imgs"], x["image_loc"],
        )["params"]
        want = {k: s.shape for k, s in _flatten(shapes).items()}
        assert {k: v.shape for k, v in _flatten(params).items()} == want

        rng = np.random.RandomState(1)
        jax_params = jax.tree.map(
            lambda s: rng.randn(*s.shape).astype(np.float32), shapes
        )
        fresh = _port_model(tiny_config, seed=5)
        fresh.load_state_dict(state_dict_from_flax(jax_params, fresh.state_dict().keys()))
        back = _flatten(flax_from_state_dict(fresh.state_dict()))
        for k, v in _flatten(jax_params).items():
            np.testing.assert_array_equal(back[k], v, err_msg=k)

    def test_state_dict_from_flax_names_mismatches(self, port_and_params):
        from vilbert_tpu_torch.core.weights import state_dict_from_flax

        model, params = port_and_params
        flat = dict(_flatten(params))
        del flat["vil_logit_dense.kernel"]
        with pytest.raises(ValueError, match="vil_logit_dense.kernel"):
            state_dict_from_flax(_unflatten(flat), model.state_dict().keys())

    def test_load_npz_and_reference_bin(self, tiny_config, port_and_params, tmp_path):
        """``.npz`` in flax paths (as core/checkpoint.save_params writes it)
        and a reference-style ``.bin`` (DDP prefix, tied decoder, dead
        q_dense weights) both load into a fresh model exactly."""
        from vilbert_tpu_torch.core.weights import load_weights

        model, params = port_and_params
        want = model.state_dict()
        npz = tmp_path / "params.npz"
        np.savez(npz, **_flatten(params))
        m = _port_model(tiny_config, seed=3)
        load_weights(m, str(npz))
        for k, v in m.state_dict().items():
            assert torch.equal(v, want[k]), k

        ref_sd = {f"module.{k}": v.clone() for k, v in want.items()}
        ref_sd["module.cls.predictions.decoder.weight"] = want[
            "bert.embeddings.word_embeddings.weight"].clone()
        ref_sd["module.bert.encoder.c_layer.0.biOutput.q_dense1.weight"] = torch.zeros(3, 3)
        torch.save(ref_sd, tmp_path / "pytorch_model.bin")
        m = _port_model(tiny_config, seed=4)
        load_weights(m, str(tmp_path / "pytorch_model.bin"))
        for k, v in m.state_dict().items():
            assert torch.equal(v, want[k]), k


class TestSlice:
    def test_all_heads_match_flax(self, tiny_config, port_and_params):
        """Every head with heads=None, and vil_prediction alone, within 1e-4
        of the flax apply through the Pallas kernels."""
        from vilbert_tpu.models.vilbert import ViLBERTForVLTasks as JaxModel

        model, params = port_and_params
        x = _inputs(tiny_config)
        apply = jax.jit(functools.partial(JaxModel(_pallas(tiny_config)).apply, heads=None))
        want = apply({"params": params}, **x)
        with torch.inference_mode():
            got = model(**{k: torch.from_numpy(v) for k, v in x.items()})
            alone = model(**{k: torch.from_numpy(v) for k, v in x.items()},
                          heads=("vil_prediction",))
        for name in want._fields:
            np.testing.assert_allclose(
                getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                atol=1e-4, rtol=1e-4, err_msg=name,
            )
        assert [n for n in alone._fields if getattr(alone, n) is not None] == ["vil_prediction"]
        np.testing.assert_allclose(alone.vil_prediction.numpy(),
                                   np.asarray(want.vil_prediction), atol=1e-4, rtol=1e-4)

    def test_task_token_and_dynamic_attention_match_flax(self, tiny_config):
        """The task-token splice and the dynamic-attention gates (XLA path on
        the JAX side: its math is the Pallas kernels' at fp32)."""
        from vilbert_tpu.models.vilbert import ViLBERTForVLTasks as JaxModel
        from vilbert_tpu_torch.core.weights import flax_from_state_dict

        cfg = tiny_config.replace(task_specific_tokens=True, dynamic_attention=True)
        model = _port_model(cfg, seed=2)
        params = flax_from_state_dict(model.state_dict())
        x = _inputs(cfg, seed=2)
        x["task_ids"] = np.array([[1], [3], [5], [7]], np.int32)
        heads = ("vil_prediction", "linguisic_logit")
        want = jax.jit(functools.partial(JaxModel(cfg).apply, heads=heads))(
            {"params": params}, **x)
        with torch.inference_mode():
            got = model(**{k: torch.from_numpy(v) for k, v in x.items()}, heads=heads)
        assert got.linguisic_logit.shape == (4, 8, 1)  # one extra token
        for name in heads:
            np.testing.assert_allclose(
                getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                atol=1e-4, rtol=1e-4, err_msg=name,
            )

    @pytest.mark.parametrize("variant", sorted(ENCODER_VARIANTS))
    def test_encoder_variant_matches_flax(self, tiny_config, variant):
        """Every head of the forward within 1e-4 of the flax apply through
        the Pallas kernels, for each encoder variant; fast_mode runs one text
        against the batch of images."""
        from vilbert_tpu.models.vilbert import ViLBERTForVLTasks as JaxModel
        from vilbert_tpu_torch.core.weights import flax_from_state_dict

        cfg = tiny_config.replace(**ENCODER_VARIANTS[variant])
        model = _port_model(cfg, seed=5)
        params = flax_from_state_dict(model.state_dict())
        x = _variant_inputs(cfg)
        want = jax.jit(functools.partial(JaxModel(_pallas(cfg)).apply, heads=None))(
            {"params": params}, **x)
        with torch.inference_mode():
            got = model(**{k: torch.from_numpy(v) for k, v in x.items()})
        compared = 0
        for name in want._fields:
            w = getattr(want, name)
            assert (getattr(got, name) is None) == (w is None), name
            if w is not None:
                np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(w),
                                           atol=1e-4, rtol=1e-4, err_msg=name)
                compared += 1
        assert compared >= 6

    @pytest.mark.parametrize("variant", ["fixed_layers", "no_connection_layers",
                                         "dynamic_attention"])
    def test_encoder_variant_gradients_match_flax(self, tiny_config, variant):
        """The gradient of a fixed random projection of four heads' outputs,
        each parameter's within 1e-3 of its own max|grad| plus 1e-6 of the
        largest gradient of the model: the key biases' gradients are zero
        but for rounding (softmax is shift-invariant), as in chip_smoke.py's
        fp32 steps. Zero where the flax apply stops the gradient (below the
        fixed layers)."""
        from vilbert_tpu.models.vilbert import ViLBERTForVLTasks as JaxModel
        from vilbert_tpu_torch.core.weights import flax_from_state_dict

        cfg = tiny_config.replace(**{**ENCODER_VARIANTS, **GRADIENT_VARIANTS}[variant])
        model = _port_model(cfg, seed=6)
        params = flax_from_state_dict(model.state_dict())
        x = _variant_inputs(cfg)
        heads = ("vil_prediction", "vil_logit", "vision_logit", "linguisic_logit")
        jax_model = JaxModel(_pallas(cfg))
        shapes = jax.eval_shape(functools.partial(jax_model.apply, heads=heads),
                                {"params": params}, **x)
        rng = np.random.RandomState(7)
        cots = {h: rng.randn(*getattr(shapes, h).shape).astype(np.float32) for h in heads}

        def jax_objective(p):
            out = jax_model.apply({"params": p}, **x, heads=heads)
            return sum(jnp.sum(getattr(out, h) * cots[h]) for h in heads)

        want = _flatten(jax.jit(jax.grad(jax_objective))(params))
        out = model(**{k: torch.from_numpy(v) for k, v in x.items()}, heads=heads)
        sum((getattr(out, h) * torch.from_numpy(cots[h])).sum() for h in heads).backward()
        got = _flatten(flax_from_state_dict(
            {n: torch.zeros_like(p) if p.grad is None else p.grad
             for n, p in model.named_parameters()}))
        assert set(got) == set(want)
        top = max(np.abs(np.asarray(w)).max() for w in want.values())
        for path, w in want.items():
            w = np.asarray(w)
            err = np.abs(np.asarray(got[path]) - w).max()
            assert err <= 1e-3 * np.abs(w).max() + 1e-6 * top, (path, err, np.abs(w).max())
        if variant == "fixed_layers":  # below the fixed layers nothing moves
            fixed = [p for p in want if p.startswith(("bert.encoder.layer_0.",
                                                      "bert.encoder.layer_1.",
                                                      "bert.encoder.v_layer_0."))]
            assert fixed and not any(np.asarray(want[p]).any() or np.asarray(got[p]).any()
                                     for p in fixed)

    def test_evaluate_task_matches_jax(self, tiny_config, port_and_params, tmp_path):
        """Synthetic TASK1 through both evaluators: same loss and score, the
        same submission records; run through the port's run_eval."""
        import json

        from vilbert_tpu.core.config import load_task_configs
        from vilbert_tpu.data import synthetic as syn
        from vilbert_tpu.data.tasks import DataLoader, VQADataset
        from vilbert_tpu.data.tokenization import HashTokenizer
        from vilbert_tpu.eval.evaluators import evaluate_task as jax_evaluate
        from vilbert_tpu.models.vilbert import ViLBERTForVLTasks as JaxModel
        from vilbert_tpu_torch.cli.eval_tasks import run_eval

        model, params = port_and_params
        task = load_task_configs(str(REPO / "configs" / "tasks.yml"))["TASK1"]
        # as cli/train_tasks._synthetic_world builds it, at the model's feature width
        store = syn.synthetic_store(num_images=16, num_boxes=8,
                                    feature_dim=tiny_config.v_feature_size)
        ds = VQADataset(syn.vqa_annotations(num=16, num_labels=3129), store,
                        num_labels=3129, tokenizer=HashTokenizer(tiny_config.vocab_size),
                        max_seq_length=task.max_seq_length,
                        max_region_num=min(task.max_region_num, 20))

        def loader():  # batches of 6, 6, 4: the last one is padded
            return DataLoader(ds, batch_size=6, shuffle=False, drop_last=False)

        want_m, want_r = jax_evaluate(JaxModel(_pallas(tiny_config)), tiny_config, task,
                                      params, loader())
        out = run_eval(model, tiny_config, {"TASK1": task}, {"TASK1": loader()},
                       output_dir=str(tmp_path), split="minval")
        got_m, got_r = out["TASK1"]
        assert got_m["num_samples"] == want_m["num_samples"] == 16
        np.testing.assert_allclose(got_m["loss"], want_m["loss"], rtol=1e-5)
        np.testing.assert_allclose(got_m["score"], want_m["score"], rtol=1e-5, atol=1e-7)
        assert got_r == want_r
        with open(tmp_path / "VQA_minval_result.json") as f:
            assert json.load(f) == want_r
        with open(tmp_path / "metrics_VQA_minval.json") as f:
            assert json.load(f)["num_samples"] == 16

    def test_synthetic_vqa_loader_has_the_tasks_geometry(self, tiny_config):
        """TASK1's geometry, unclipped: 23 tokens, 100 boxes plus the global
        row, 3129 answer labels, the last batch short."""
        from vilbert_tpu.core.config import load_task_configs
        from vilbert_tpu_torch.cli.eval_tasks import synthetic_vqa_loader

        task = load_task_configs(str(REPO / "configs" / "tasks.yml"))["TASK1"]
        loader = synthetic_vqa_loader(tiny_config, task, num=10, batch_size=4)
        batches = list(loader)
        assert len(batches) == len(loader) == 3 and len(loader.dataset) == 10
        b = batches[0]
        assert b["features"].shape == (4, task.max_region_num, tiny_config.v_feature_size)
        assert b["question"].shape == (4, task.max_seq_length)
        assert b["image_mask"].sum(1).min() == task.max_region_num
        assert b["target"].shape == (4, 3129)


class TestInBatchPairs:
    @pytest.mark.parametrize("fast_mode", [False, True])
    def test_matches_flax(self, tiny_config, fast_mode):
        """in_batch_pairs as tests/test_encoder_modes.py sets it up: B texts
        and B images become the B^2 (text i, image j) pairs before the first
        connection layer; the encoder's four outputs within 1e-4 of the flax
        ``BertModel``, and pair (i, i) equals the plain run. With fast_mode
        (one text for the images) the expansion comes first and is a no-op,
        then the broadcast, as in the JAX encoder."""
        from vilbert_tpu.models.vilbert import BertModel as JaxModel
        from vilbert_tpu_torch.core.weights import flax_from_state_dict

        cfg = tiny_config.replace(in_batch_pairs=True, fast_mode=fast_mode)
        whole = _port_model(cfg, seed=8)
        model, plain = whole.bert, _port_model(tiny_config, seed=8).bert
        params = flax_from_state_dict(whole.state_dict())["bert"]
        x = _inputs(cfg, B=3, seed=8)
        args = [x["input_txt"], x["input_imgs"], x["image_loc"], x["token_type_ids"],
                x["attention_mask"], x["image_attention_mask"]]
        if fast_mode:
            for i in (0, 3, 4):
                args[i] = args[i][:1]
        want = jax.jit(JaxModel(_pallas(cfg)).apply)({"params": params}, *args)
        with torch.inference_mode():
            got = model(*map(torch.from_numpy, args))
            base = plain(*map(torch.from_numpy, args))
        pairs = 3 if fast_mode else 9
        for name in want._fields:
            assert getattr(got, name).shape[0] == pairs, name
            np.testing.assert_allclose(getattr(got, name).numpy(),
                                       np.asarray(getattr(want, name)), atol=1e-4, rtol=1e-4,
                                       err_msg=name)
        if not fast_mode:
            diag = got.sequence_t.reshape(3, 3, *got.sequence_t.shape[1:])
            for i in range(3):
                torch.testing.assert_close(diag[i, i], base.sequence_t[i], atol=1e-5,
                                           rtol=1e-5)


class TestTaskLosses:
    @pytest.mark.parametrize("task_type", [
        "VL-classifier", "VL-classifier-GQA", "VL-logit", "V-logit", "V-logit-mc",
        "VL-binary-classifier", "VL-tri-classifier",
    ])
    def test_per_sample_matches_jax(self, task_type):
        from vilbert_tpu.train.losses import task_loss_and_score_per_sample as jax_fn
        from vilbert_tpu_torch.train.losses import task_loss_and_score_per_sample

        rng = np.random.RandomState(0)
        B = 6
        if task_type.startswith("VL-classifier"):
            logits = rng.randn(B, 13).astype(np.float32) * 3
            target = (rng.rand(B, 13) * (rng.rand(B, 13) > 0.7)).astype(np.float32)
        elif task_type.startswith("V-logit"):
            logits = rng.randn(B, 9, 1).astype(np.float32) * 3
            target = rng.rand(B, 9, 1).astype(np.float32)
        else:
            n = {"VL-logit": 4, "VL-binary-classifier": 2, "VL-tri-classifier": 3}[task_type]
            logits = rng.randn(B, n).astype(np.float32) * 3
            target = rng.randint(0, n, B).astype(np.int32)
        want_l, want_s = jax_fn(task_type, jnp.asarray(logits), jnp.asarray(target))
        got_l, got_s = task_loss_and_score_per_sample(
            task_type, torch.from_numpy(logits), torch.from_numpy(target))
        np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


class TestProcessBatch:
    @pytest.mark.parametrize("process", ["normal", "expand", "retrieval", "nlvr"])
    def test_matches_jax(self, process):
        from vilbert_tpu.train.multitask import process_batch as jax_fn
        from vilbert_tpu_torch.train.multitask import process_batch

        rng = np.random.RandomState(0)
        B, R, T, D = 2, 6, 5, 3
        lead = {"expand": (), "retrieval": (4,), "nlvr": (), "normal": ()}[process]
        opts = (4,) if process == "expand" else ()
        r = 2 * R if process == "nlvr" else R
        batch = {
            "features": rng.randn(B, *lead, r, D).astype(np.float32),
            "spatials": rng.rand(B, *lead, r, 5).astype(np.float32),
            "image_mask": rng.randint(0, 2, (B, *lead, r)).astype(np.int32),
            "question": rng.randint(0, 9, (B, *lead, *opts, T)).astype(np.int32),
            "input_mask": rng.randint(0, 2, (B, *lead, *opts, T)).astype(np.int32),
            "segment_ids": rng.randint(0, 2, (B, *lead, *opts, T)).astype(np.int32),
            "target": rng.randint(0, 4, (B, 1) if process == "expand" else (B,)).astype(
                np.int32),
        }
        want = jax_fn(process, {k: jnp.asarray(v) for k, v in batch.items()})
        got = process_batch(process, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


class TestRefusedKnobs:
    def test_train_mode_with_dropout_raises(self, tiny_config, port_and_params):
        """Train-mode dropout draws its seeds from a generator the trainer
        hands over: without one it raises; with one it runs, one seed gives
        the same logits, another seed others, and eval mode drops nothing."""
        from vilbert_tpu_torch.models.layers import set_dropout_generator

        cfg = tiny_config.replace(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
                                  v_hidden_dropout_prob=0.1,
                                  v_attention_probs_dropout_prob=0.1)
        model = _port_model(cfg).train()
        x = {k: torch.from_numpy(v) for k, v in _inputs(cfg).items()}
        with pytest.raises(ValueError, match="set_dropout_generator"):
            model(**x)

        def logits(seed):
            set_dropout_generator(model, torch.Generator().manual_seed(seed))
            with torch.no_grad():
                return model(**x, heads=("vil_prediction",)).vil_prediction

        a, b, c = logits(3), logits(3), logits(4)
        assert torch.isfinite(a).all() and torch.equal(a, b) and not torch.equal(a, c)
        with torch.inference_mode():
            e1 = model.eval()(**x, heads=("vil_prediction",)).vil_prediction
            e2 = _port_model(cfg).eval()(**x, heads=("vil_prediction",)).vil_prediction
        assert torch.equal(e1, e2) and not torch.equal(e1, a)

    def test_layout_knobs_are_ignored(self, tiny_config, port_and_params):
        model, _ = port_and_params
        other = _port_model(tiny_config.replace(
            head_major_attention=False, fused_qkv=True, proj_impl="gemm", remat=True))
        x = {k: torch.from_numpy(v) for k, v in _inputs(tiny_config).items()}
        with torch.inference_mode():
            a = model(**x, heads=("vil_prediction",)).vil_prediction
            b = other(**x, heads=("vil_prediction",)).vil_prediction
        assert torch.equal(a, b)
