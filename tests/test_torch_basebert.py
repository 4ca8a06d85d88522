"""The port's single-stream baseline and NCE against the JAX package, on the CPU.

``vilbert_tpu_torch.models.basebert`` against ``vilbert_tpu.models.basebert``
(every head of ``BaseBertForVLTasks``, ``BaseBertForPretraining`` with the
LM and image gathers, the gradients of the pretraining loss, a sequence past
512 tokens), the weight bridge with ``family="basebert"``, the NCE loss of
visual target 2, and the baseline through the four CLIs. Same weights in
both packages through the bridge; the JAX side runs ``use_pallas_attention``
and ``use_pallas_layernorm`` (Pallas in interpret mode), the port the plain
versions of its kernels. A config of ``configs/bert_base_baseline.json`` cut
to 2 layers at width 64 (4 heads), fp32, dropout off.

NCE draws its negatives from a ``torch.Generator`` where the JAX package
draws from threefry: the two agree exactly where every draw has one outcome
(two rows of one region), and in distribution elsewhere.
"""

import functools
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vilbert_tpu.core.importer import _flatten, _unflatten

REPO = Path(__file__).resolve().parents[1]
BASELINE_JSON = str(REPO / "configs" / "bert_base_baseline.json")
B, T, R, K = 3, 7, 5, 3  # batch, tokens, regions (with the global row), gather


def _cfg(**kw):
    from vilbert_tpu.core.config import ModelConfig

    return ModelConfig.from_json_file(BASELINE_JSON, **{
        **dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
               intermediate_size=256, t_biattention_id=(0, 1), compute_dtype="float32",
               hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0), **kw})


def _pallas(cfg):
    return cfg.replace(use_pallas_attention=True, use_pallas_layernorm=True)


def _inputs(cfg, b=B, t=T, r=R, seed=0):
    rng = np.random.RandomState(seed)
    am = np.ones((b, t), np.int32)
    am[:, -2:] = 0
    im = np.ones((b, r), np.int32)
    im[1, -2:] = 0
    return dict(
        input_txt=rng.randint(1, cfg.vocab_size, (b, t)).astype(np.int32),
        input_imgs=rng.randn(b, r, cfg.v_feature_size).astype(np.float32),
        image_loc=rng.rand(b, r, cfg.num_locs).astype(np.float32),
        token_type_ids=rng.randint(0, 2, (b, t)).astype(np.int32),
        attention_mask=am,
        image_attention_mask=im,
    )


def _torch(x):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in x.items()}


def _port(kind, cfg, seed=0, **kw):
    from vilbert_tpu_torch.models import basebert

    cls = getattr(basebert, kind)
    return cls(cfg, generator=torch.Generator().manual_seed(seed), **kw).eval()


def _flax(model_or_sd):
    from vilbert_tpu_torch.core.weights import flax_from_state_dict

    sd = model_or_sd.state_dict() if hasattr(model_or_sd, "state_dict") else model_or_sd
    return flax_from_state_dict(sd, "basebert")


def _jax_shapes(kind, cfg):
    from vilbert_tpu.models import basebert

    x = _inputs(cfg)
    return jax.eval_shape(getattr(basebert, kind)(cfg).init, jax.random.PRNGKey(0),
                          x["input_txt"], x["input_imgs"], x["image_loc"])["params"]


KINDS = ["BaseBertForVLTasks", "BaseBertForPretraining"]


class TestWeightBridge:
    @pytest.mark.parametrize("kind", KINDS)
    def test_port_tree_is_the_flax_tree(self, kind):
        """Every port parameter lands on a flax path of the JAX model's
        tree, with its shape, and every flax leaf has a port parameter."""
        cfg = _cfg()
        got = {k: v.shape for k, v in _flatten(_flax(_port(kind, cfg))).items()}
        want = {k: s.shape for k, s in _flatten(_jax_shapes(kind, cfg)).items()}
        assert got == want

    @pytest.mark.parametrize("kind", KINDS)
    def test_jax_params_round_trip_exactly(self, kind):
        from vilbert_tpu_torch.core.weights import state_dict_from_flax

        cfg = _cfg()
        rng = np.random.RandomState(1)
        params = jax.tree.map(lambda s: rng.randn(*s.shape).astype(np.float32),
                              _jax_shapes(kind, cfg))
        model = _port(kind, cfg, seed=5)
        model.load_state_dict(state_dict_from_flax(params, model.state_dict().keys(),
                                                   "basebert"))
        back = _flatten(_flax(model))
        for k, v in _flatten(params).items():
            np.testing.assert_array_equal(back[k], v, err_msg=k)

    def test_reference_bin_loads_into_both_packages(self, tmp_path):
        """A reference-named state_dict (the tied decoder, the classifier's
        weight norm as weight_g / weight_v) loads into the
        port's model and, through the JAX importer with
        ``family="basebert"``, into the flax tree: the same weights."""
        from vilbert_tpu.core.importer import import_torch_state_dict
        from vilbert_tpu_torch.core.weights import load_weights

        cfg = _cfg()
        donor = _port("BaseBertForVLTasks", cfg, seed=2)
        want = donor.state_dict()
        ref = {k: v.clone() for k, v in want.items()}
        ref["cls.predictions.decoder.weight"] = want[
            "bert.embeddings.word_embeddings.weight"].clone()
        for i in (0, 3):  # weight_norm(dim=None): w = g v / ||v||_F
            w = ref.pop(f"vil_prediction.main.{i}.weight")
            ref[f"vil_prediction.main.{i}.weight_v"] = 2.0 * w
            ref[f"vil_prediction.main.{i}.weight_g"] = torch.linalg.norm(w.double()).float()
        torch.save(ref, tmp_path / "pytorch_model.bin")

        model = _port("BaseBertForVLTasks", cfg, seed=3)
        load_weights(model, str(tmp_path / "pytorch_model.bin"))
        for k, v in model.state_dict().items():
            # the fold rounds g v / ||v|| once in fp32
            torch.testing.assert_close(v, want[k], rtol=1e-6, atol=1e-7, msg=k)

        target = jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                              _jax_shapes("BaseBertForVLTasks", cfg))
        params, report = import_torch_state_dict(
            {k: v.numpy() for k, v in ref.items()}, target, family="basebert")
        assert not report.missing and not report.unexpected
        flat = _flatten(_flax(donor))
        for k, v in _flatten(params).items():
            np.testing.assert_allclose(v, flat[k], rtol=1e-6, atol=1e-7, err_msg=k)

    def test_families_name_other_paths(self):
        """The same port name has other flax paths in the two families."""
        from vilbert_tpu_torch.core.importer import _to_flax_key

        name = "bert.encoder.layer.1.attention.self.query.weight"
        assert _to_flax_key(name, "basebert") == "bert.layer_1.attention_self.query.kernel"
        assert _to_flax_key(name) == "bert.encoder.layer_1.attention_self.query.kernel"


def _jax_apply(kind, cfg, params, x, **kw):
    from vilbert_tpu.models import basebert

    fn = jax.jit(functools.partial(getattr(basebert, kind)(_pallas(cfg)).apply, **kw))
    return fn({"params": params}, **x)


class TestModels:
    @pytest.mark.parametrize("heads", [None, ("vil_prediction",),
                                       ("vision_logit", "linguisic_logit", "vil_logit")])
    def test_vl_tasks_heads_match_flax(self, heads):
        """The 7 heads (or the named ones) within 1e-4 of the flax apply; the
        others are not computed."""
        cfg = _cfg()
        model = _port("BaseBertForVLTasks", cfg, seed=1)
        x = _inputs(cfg)
        want = _jax_apply("BaseBertForVLTasks", cfg, _flax(model), x, heads=heads)
        with torch.inference_mode():
            got = model(**_torch(x), heads=heads)
        assert got._fields == (*want._fields, "attention_probs")  # the maps, None here
        assert got.attention_probs is None
        computed = 0
        for name in want._fields:
            w = getattr(want, name)
            assert (getattr(got, name) is None) == (w is None), name
            if w is not None:
                np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(w),
                                           atol=1e-4, rtol=1e-4, err_msg=name)
                computed += 1
        assert computed == (7 if heads is None else len(heads))

    @pytest.mark.parametrize("gathered", [False, True])
    def test_pretraining_matches_flax(self, gathered):
        cfg = _cfg()
        model = _port("BaseBertForPretraining", cfg, seed=2)
        x = _inputs(cfg, seed=3)
        kw = {}
        if gathered:
            rng = np.random.RandomState(4)
            kw = dict(lm_positions=rng.randint(0, T, (B, K)).astype(np.int32),
                      img_positions=rng.randint(1, R, (B, K)).astype(np.int32))
        args = [x[k] for k in ("input_txt", "input_imgs", "image_loc", "token_type_ids",
                               "attention_mask", "image_attention_mask")]
        from vilbert_tpu.models.basebert import BaseBertForPretraining as JaxModel

        want = jax.jit(functools.partial(JaxModel(_pallas(cfg)).apply, **kw))(
            {"params": _flax(model)}, *args)
        with torch.inference_mode():
            got = model(*map(torch.from_numpy, args),
                        **{k: torch.from_numpy(v) for k, v in kw.items()})
        assert got.prediction_scores_t.shape == (B, K if gathered else T, cfg.vocab_size)
        for name, g, w in zip(want._fields, got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4,
                                       err_msg=name)

    def test_sequence_past_512_matches_flax(self):
        """300 tokens + 250 regions = 550 keys: the plain attention of the
        port against the Pallas kernel, vil_prediction and vision_logit."""
        cfg = _cfg(num_hidden_layers=1, t_biattention_id=(0,), v_biattention_id=(0,))
        model = _port("BaseBertForVLTasks", cfg, seed=6)
        x = _inputs(cfg, b=2, t=300, r=250, seed=6)
        heads = ("vil_prediction", "vision_logit")
        want = _jax_apply("BaseBertForVLTasks", cfg, _flax(model), x, heads=heads)
        with torch.inference_mode():
            got = model(**_torch(x), heads=heads)
        for name in heads:
            np.testing.assert_allclose(getattr(got, name).numpy(),
                                       np.asarray(getattr(want, name)), atol=1e-4, rtol=1e-4,
                                       err_msg=name)

    def test_task_tokens_are_refused(self):
        with pytest.raises(ValueError, match="task token"):
            _port("BaseBertForVLTasks", _cfg(task_specific_tokens=True))


def _pretrain_batch(cfg, seed, b=4, visual_target=0):
    rng = np.random.RandomState(seed)
    target_dim = cfg.v_target_size if visual_target == 0 else cfg.v_feature_size
    target = rng.rand(b, R - 1, target_dim).astype(np.float32)
    if visual_target == 0:
        target /= target.sum(-1, keepdims=True)
    input_mask = np.ones((b, T), np.int32)
    input_mask[1, -3:] = 0
    image_mask = np.ones((b, R), np.int32)
    image_mask[2, -2:] = 0
    lm = np.where(rng.rand(b, T) < 0.35, rng.randint(0, cfg.vocab_size, (b, T)), -1)
    lm[0, :5] = rng.randint(0, cfg.vocab_size, 5)  # more than K masked
    return {
        "input_ids": rng.randint(1, cfg.vocab_size, (b, T)).astype(np.int32),
        "image_feat": rng.randn(b, R, cfg.v_feature_size).astype(np.float32),
        "image_loc": rng.rand(b, R, 5).astype(np.float32),
        "segment_ids": rng.randint(0, 2, (b, T)).astype(np.int32),
        "input_mask": input_mask,
        "image_mask": image_mask,
        "lm_label_ids": lm.astype(np.int32),
        "image_label": np.where(rng.rand(b, R - 1) < 0.5, 1, -1).astype(np.int32),
        "image_target": target,
        "is_next": rng.randint(0, 2, (b,)).astype(np.int32),
    }


class TestPretrainingLoss:
    def test_every_gradient_matches_jax(self):
        """The basebert pretraining loss (lm_gather=K): loss within 1e-5
        relative, every gradient within 1e-3 of its own max|grad| plus 1e-6
        of the model's largest (the key biases' are zero but for rounding)."""
        from vilbert_tpu.models.basebert import BaseBertForPretraining as JaxModel
        from vilbert_tpu.train.pretrain import make_pretrain_loss_fn as jax_loss_fn
        from vilbert_tpu_torch.train.pretrain import make_pretrain_loss_fn

        cfg = _cfg()
        model = _port("BaseBertForPretraining", cfg, seed=7)
        batch = _pretrain_batch(cfg, 8)
        jfn = jax_loss_fn(JaxModel(_pallas(cfg)), cfg, deterministic=True, lm_gather=K)
        (want_loss, _), want_g = jax.jit(jax.value_and_grad(jfn, has_aux=True))(
            _flax(model), batch, jax.random.PRNGKey(0))
        loss, _ = make_pretrain_loss_fn(cfg, lm_gather=K)(model, _torch(batch))
        loss.backward()
        np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
        got = _flatten(_flax({n: p.grad for n, p in model.named_parameters()}))
        want = {k: np.asarray(v) for k, v in _flatten(want_g).items()}
        assert set(got) == set(want)
        top = max(np.abs(w).max() for w in want.values())
        for path, w in want.items():
            err = np.abs(got[path] - w).max()
            assert err <= 1e-3 * np.abs(w).max() + 1e-6 * top, (path, err)


# -- NCE -------------------------------------------------------------------------

def _nce_inputs(b, r, d, seed):
    rng = np.random.RandomState(seed)
    pred = rng.randn(b, r + 1, d).astype(np.float32)  # with the global row
    target = rng.randn(b, r, d).astype(np.float32)
    label = np.where(rng.rand(b, r) < 0.5, 1, -1).astype(np.int32)
    label[0, 0] = 1
    return pred, label, target


class TestNCE:
    def test_exact_where_every_draw_has_one_outcome(self):
        """B=2, one region row besides the global row: every negative is
        fixed (the other row's region, or the row's own), so the loss is a
        function of the inputs alone: within 1e-5 of JAX's."""
        from vilbert_tpu.train.losses import masked_image_loss as jax_loss
        from vilbert_tpu_torch.train.losses import masked_image_loss

        pred, label, target = _nce_inputs(2, 1, 8, 0)
        label[:] = 1
        want = jax_loss(jnp.asarray(pred), jnp.asarray(label), jnp.asarray(target),
                        visual_target=2, num_negative=10, rng=jax.random.PRNGKey(3))
        for seed in (0, 1):
            got = masked_image_loss(torch.from_numpy(pred), torch.from_numpy(label),
                                    torch.from_numpy(target), visual_target=2,
                                    num_negative=10,
                                    generator=torch.Generator().manual_seed(seed))
            np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)

    def test_negatives_are_drawn_as_the_jax_package_draws_them(self):
        """Across-batch negatives never in their own row, in-row negatives
        never in their own column, the first index the true one; a
        chi-square test of uniformity over the rows, columns and in-row
        columns they may take (p > 1e-3)."""
        from scipy.stats import chisquare

        from vilbert_tpu_torch.train.losses import nce_index

        b, r, n = 5, 7, 100
        index = nce_index(b, r, n, torch.Generator().manual_seed(0), "cpu").numpy()
        n_across, n_inside = int(n * 0.7), int(n * 0.3)
        assert index.shape == (b, r, 1 + n_across + n_inside)
        rows = np.arange(b)[:, None, None]
        cols = np.arange(r)[None, :, None]
        np.testing.assert_array_equal(index[..., 0], (rows * r + cols)[..., 0])
        across, inside = index[..., 1:1 + n_across], index[..., 1 + n_across:]
        assert (across // r != rows).all()
        assert (inside // r == rows).all() and (inside % r != cols).all()
        # relative to self, the other rows 1..b-1 and the other columns
        # 1..r-1 are each equally likely; the across-batch column any of 0..r-1
        for values, k in (((across // r - rows) % b - 1, b - 1), (across % r, r),
                          ((inside % r - cols) % r - 1, r - 1)):
            counts = np.bincount(values.ravel(), minlength=k)
            assert counts.shape == (k,) and chisquare(counts).pvalue > 1e-3, counts

    def test_mean_loss_agrees_with_jax_in_distribution(self):
        """The mean over 300 draws of each, within 4 standard errors of the
        difference."""
        from vilbert_tpu.train.losses import masked_image_loss as jax_loss
        from vilbert_tpu_torch.train.losses import masked_image_loss

        pred, label, target = _nce_inputs(3, 4, 6, 1)
        pred *= 0.5
        args = (jnp.asarray(pred), jnp.asarray(label), jnp.asarray(target))
        draw = jax.jit(jax.vmap(lambda key: jax_loss(*args, visual_target=2, num_negative=10,
                                                     rng=key)))
        want = np.asarray(draw(jax.random.split(jax.random.PRNGKey(0), 300)))
        g = torch.Generator().manual_seed(0)
        got = np.array([masked_image_loss(
            torch.from_numpy(pred), torch.from_numpy(label), torch.from_numpy(target),
            visual_target=2, num_negative=10, generator=g).item() for _ in range(300)])
        assert want.std() > 0 and got.std() > 0
        se = np.sqrt(want.var(ddof=1) / len(want) + got.var(ddof=1) / len(got))
        assert abs(got.mean() - want.mean()) <= 4 * se, (got.mean(), want.mean(), se)

    def test_scores_stay_fp32_and_gathered_is_refused(self):
        """bf16 predictions and targets score in fp32; NCE takes no gather."""
        from vilbert_tpu_torch.train.losses import masked_image_loss

        pred, label, target = _nce_inputs(2, 3, 8, 2)
        kw = dict(visual_target=2, num_negative=6)
        p, l_, t = (torch.from_numpy(a) for a in (pred, label, target))
        lo = masked_image_loss(p.bfloat16(), l_, t.bfloat16(),
                               generator=torch.Generator().manual_seed(0), **kw)
        hi = masked_image_loss(p.bfloat16().float(), l_, t.bfloat16().float(),
                               generator=torch.Generator().manual_seed(0), **kw)
        assert lo.dtype == torch.float32 and lo.item() == hi.item()
        with pytest.raises(ValueError, match="NCE"):
            masked_image_loss(p[:, 1:], l_, t, gathered=True,
                              generator=torch.Generator(), **kw)


# -- the CLIs --------------------------------------------------------------------

def _cfg_file(tmp_path, **kw):
    """The baseline config cut to size as a JSON file, for the CLIs, at fp32
    (in bf16 the two frameworks round at other places)."""
    with open(BASELINE_JSON) as f:
        raw = json.load(f)
    raw.update(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
               intermediate_size=256, t_biattention_id=[0, 1], compute_dtype="float32", **kw)
    path = tmp_path / "tiny_baseline.json"
    path.write_text(json.dumps(raw))
    return str(path)


def _spread_npz(tmp_path, cfg_path, kind):
    """A JAX-initialised, JAX-saved .npz of the baseline with every weight
    matrix and table scaled by 10: at the initialiser's 0.02 the pooled
    [CLS] row barely sees the image, and argmaxes and ranks tie within fp32
    rounding."""
    from vilbert_tpu.core.checkpoint import save_params
    from vilbert_tpu.core.config import ModelConfig
    from vilbert_tpu.models import basebert

    cfg = ModelConfig.from_json_file(cfg_path)
    params = getattr(basebert, kind)(cfg).init(
        jax.random.PRNGKey(1), np.zeros((2, 5), np.int32),
        np.zeros((2, 3, cfg.v_feature_size), np.float32), np.zeros((2, 3, 5), np.float32))
    flat = {k: np.asarray(v) * (10 if k.endswith(("kernel", "embedding")) else 1)
            for k, v in _flatten(params["params"]).items()}
    path = str(tmp_path / f"{kind}.npz")
    save_params(path, _unflatten(flat))
    return path


class TestCLIs:
    @pytest.mark.parametrize("task", ["1", "4", "9"])
    def test_eval_tasks_records_equal_the_jax_clis(self, tmp_path, task):
        """eval_tasks --baseline --synthetic with a JAX-saved .npz, at VQA,
        Visual7w and RefCOCO: the same submission records and metrics files
        (losses within 1e-5 relative). Not a retrieval task: its synthetic
        dataset draws negatives from a stateful generator, and the JAX CLI
        draws a batch to initialise its model first (the retrieval heads
        are held to JAX in test_torch_retrieval.py and the trainer's)."""
        from vilbert_tpu.cli.eval_tasks import main as jax_main
        from vilbert_tpu_torch.cli.eval_tasks import main

        cfg = _cfg_file(tmp_path)
        common = ["--synthetic", "--baseline", "--tasks", task, "--config", cfg, "--params",
                  _spread_npz(tmp_path, cfg, "BaseBertForVLTasks")]
        jax_main([*common, "--output_dir", str(tmp_path / "jax")])
        main([*common, "--device", "cpu", "--output_dir", str(tmp_path / "port")])
        names = sorted(p.name for p in (tmp_path / "jax").iterdir())
        assert names == sorted(p.name for p in (tmp_path / "port").iterdir()) and names
        for name in names:
            want = json.loads((tmp_path / "jax" / name).read_text())
            got = json.loads((tmp_path / "port" / name).read_text())
            if name.startswith("metrics_"):
                assert set(got) == set(want)
                for k, w in want.items():
                    np.testing.assert_allclose(got[k], w, rtol=1e-5, atol=1e-7, err_msg=k)
            else:
                assert got == want, name

    def test_train_tasks_params_have_the_jax_tree(self, tmp_path):
        """train_tasks --baseline --synthetic over a task of each kind the
        baseline trains (normal, V-logit-mc, retrieval, V-logit): one
        iteration, and params_final.npz is exactly the JAX
        BaseBertForVLTasks tree (paths and shapes), every value finite."""
        from vilbert_tpu.core.checkpoint import load_params
        from vilbert_tpu.core.config import ModelConfig
        from vilbert_tpu.models.basebert import BaseBertForVLTasks as JaxModel
        from vilbert_tpu_torch.cli.train_tasks import main

        cfg = _cfg_file(tmp_path)
        trainer = main(["--synthetic", "--baseline", "--device", "cpu", "--tasks", "1-4-7-9",
                        "--num_iterations", "1", "--config", cfg,
                        "--output_dir", str(tmp_path / "out")])
        assert trainer.global_step == 1 and trainer.model.family == "basebert"
        got = _flatten(load_params(str(tmp_path / "out" / "params_final.npz")))
        jcfg = ModelConfig.from_json_file(cfg)
        shapes = jax.eval_shape(JaxModel(jcfg).init, jax.random.PRNGKey(0),
                                np.zeros((1, 5), np.int32), np.zeros((1, 3, 2048), np.float32),
                                np.zeros((1, 3, 5), np.float32))["params"]
        assert {k: v.shape for k, v in got.items()} == {
            k: s.shape for k, s in _flatten(shapes).items()}
        assert all(np.isfinite(v).all() for v in got.values())
