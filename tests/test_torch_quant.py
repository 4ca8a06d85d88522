"""The port's int8 inference (``vilbert_tpu_torch/ops/quant.py``, the int8
``Linear``, static calibration, ``core.weights``' ``quant`` bridge and the
CLIs' ``--int8``) against the JAX package, on the CPU.

The JAX int8 functions run as XLA; the flax applies run the Pallas kernels
in interpret mode (``_pallas``). Same weights through the weight bridge,
fp32 compute on ``tiny_config`` unless a test says otherwise. Tolerances:
the int8 values and scales are bit-equal, the dense outputs within 1e-6
relative (one fp32 rescale, the int32 product is exact), and whole-model
int8 logits within 1e-3 of the largest (a rounding boundary crossed by an
fp32 ulp moves one int8 step somewhere).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vilbert_tpu.core.importer import _flatten

B, T, R = 4, 7, 5


def _pallas(cfg):
    return cfg.replace(use_pallas_attention=True, use_pallas_layernorm=True)


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _jnp(x, dtype):
    return jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)


def _torch(x, dtype):
    return torch.from_numpy(np.asarray(x, np.float32)).to(getattr(torch, dtype))


def _inputs(cfg, seed=0, b=B):
    rng = np.random.RandomState(seed)
    am = np.ones((b, T), np.int32)
    am[:, -2:] = 0
    im = np.ones((b, R), np.int32)
    im[1, -2:] = 0
    return dict(
        input_txt=rng.randint(0, cfg.vocab_size, (b, T)).astype(np.int32),
        input_imgs=(rng.randn(b, R, cfg.v_feature_size) * 2).astype(np.float32),
        image_loc=rng.rand(b, R, cfg.num_locs).astype(np.float32),
        token_type_ids=rng.randint(0, 2, (b, T)).astype(np.int32),
        attention_mask=am,
        image_attention_mask=im,
    )


def _port(family, cfg, seed=0):
    if family == "vilbert":
        from vilbert_tpu_torch.models.vilbert import ViLBERTForVLTasks as cls
    else:
        from vilbert_tpu_torch.models.basebert import BaseBertForVLTasks as cls
    return cls(cfg, generator=torch.Generator().manual_seed(seed)).eval()


def _jax_model(family, cfg):
    if family == "vilbert":
        from vilbert_tpu.models.vilbert import ViLBERTForVLTasks as cls
    else:
        from vilbert_tpu.models.basebert import BaseBertForVLTasks as cls
    return cls(_pallas(cfg))


def _params(model):
    from vilbert_tpu_torch.core.weights import flax_from_state_dict

    return flax_from_state_dict(model.state_dict(), model.family)


def _run(model, x, heads=None):
    with torch.inference_mode():
        return model(**{k: torch.from_numpy(v) for k, v in x.items()}, heads=heads)


def _flax_calibrate(jmodel, params, batches, heads=None, jit=False):
    """flax's calibration: ``mutable=["quant"]`` passes, the running max
    carried from batch to batch. Eager unless ``jit`` (XLA's fusions round
    otherwise, and an int8 step moved upstream shows in a later range)."""
    apply = functools.partial(jmodel.apply, heads=heads, mutable=["quant"])
    apply = jax.jit(apply) if jit else apply
    quant = None
    for x in batches:
        variables = {"params": params} if quant is None else {"params": params, "quant": quant}
        _, mut = apply(variables, **x)
        quant = mut["quant"]
    return quant


class TestOps:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_dynamic_quantize_bit_equal(self, dtype, rng_np):
        """Per tensor (activations, in their dtype) and per output channel
        (weights: [in, out] axis 0 in JAX, [out, in] dim 1 here)."""
        from vilbert_tpu.ops.quant import _quantize
        from vilbert_tpu_torch.ops.quant import quantize

        x = (rng_np.randn(3, 5, 48) * rng_np.rand(48) * 3).astype(np.float32)
        x[0, 0, 0] = 0.0
        q, s = quantize(_torch(x, dtype), None)
        jq, js = _quantize(_jnp(x, dtype), axes=None)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy().ravel(), np.asarray(js).ravel())
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        w = (rng_np.randn(48, 40) * rng_np.rand(40)).astype(np.float32)
        wq, ws = quantize(torch.from_numpy(w.T.copy()), 1)
        jwq, jws = _quantize(jnp.asarray(w), axes=0)
        np.testing.assert_array_equal(wq.numpy(), np.asarray(jwq).T)
        np.testing.assert_array_equal(ws.numpy()[:, 0], np.asarray(jws)[0])

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_static_quantize_bit_equal(self, dtype, rng_np):
        """Calibrated per-channel scales; values past the range saturate."""
        from vilbert_tpu.ops.quant import _quantize_act_static
        from vilbert_tpu_torch.ops.quant import quantize_act_static

        x = (rng_np.randn(4, 6, 32) * (0.05 + rng_np.rand(32) * 4)).astype(np.float32)
        amax = np.abs(x).max(axis=(0, 1)) * 0.8  # some values clip
        q, s = quantize_act_static(_torch(x, dtype), torch.from_numpy(amax))
        jq, js = _quantize_act_static(_jnp(x, dtype), jnp.asarray(amax))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        assert int(q.abs().max()) == 127

    def test_int_mm_ref_is_exact(self, rng_np):
        """The plain int8 product against numpy's int64, at the extremes."""
        from vilbert_tpu_torch.ops.quant import int_mm_ref

        a = rng_np.randint(-127, 128, (9, 3072)).astype(np.int8)
        b = rng_np.randint(-127, 128, (5, 3072)).astype(np.int8)
        a[0], b[0] = 127, 127
        a[1], b[1] = -127, 127
        got = int_mm_ref(torch.from_numpy(a), torch.from_numpy(b))
        want = a.astype(np.int64) @ b.astype(np.int64).T
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        assert int(got[0, 0]) == 127 * 127 * 3072

    @pytest.mark.parametrize("mode", ["dynamic", "static"])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_int8_dense_and_projections_match_jax(self, mode, dtype, rng_np):
        """int8_dense on [out, in] weights against the JAX int8_dense,
        int8_head_proj and int8_merge_proj on the [in, out] kernels: the
        head projection is int8_dense with the heads split after, the merge
        int8_dense on the heads merged before."""
        from vilbert_tpu.ops import quant as jq
        from vilbert_tpu_torch.ops import quant as pq

        b, s, i, h, d = 2, 5, 48, 4, 8
        x = (rng_np.randn(b, s, i) * (0.1 + rng_np.rand(i) * 3)).astype(np.float32)
        w = (rng_np.randn(i, h * d) * rng_np.rand(h * d)).astype(np.float32)
        amax = np.abs(x).max(axis=(0, 1)).astype(np.float32) if mode == "static" else None
        j_amax = None if amax is None else jnp.asarray(amax)
        p_amax = None if amax is None else torch.from_numpy(amax)
        out_j, out_p = jnp.dtype(dtype), getattr(torch, dtype)
        wt = torch.from_numpy(w.T.copy())

        def close(got, want):
            want = np.asarray(want, np.float32)
            np.testing.assert_allclose(_np(got), want, rtol=0,
                                       atol=1e-6 * float(np.abs(want).max()))

        close(pq.int8_dense(_torch(x, dtype), wt, out_p, p_amax),
              jq.int8_dense(_jnp(x, dtype), jnp.asarray(w), out_j, act_amax=j_amax))
        close(pq.int8_dense(_torch(x, dtype), wt, out_p, p_amax).reshape(b, s, h, d)
              .transpose(1, 2),
              jq.int8_head_proj(_jnp(x, dtype), jnp.asarray(w.reshape(i, h, d)), out_j,
                                act_amax=j_amax))
        ctx = (rng_np.randn(b, h, s, d) * 2).astype(np.float32)
        wm = rng_np.randn(h * d, 24).astype(np.float32)
        m_amax = (np.abs(ctx).max(axis=(0, 2)).reshape(-1).astype(np.float32)
                  if mode == "static" else None)
        close(pq.int8_dense(_torch(ctx, dtype).transpose(1, 2).reshape(b, s, h * d),
                            torch.from_numpy(wm.T.copy()), out_p,
                            None if m_amax is None else torch.from_numpy(m_amax)),
              jq.int8_merge_proj(_jnp(ctx, dtype), jnp.asarray(wm), out_j,
                                 act_amax=None if m_amax is None else jnp.asarray(m_amax)))

    def test_int_mm_counts_no_cpu_call(self):
        from vilbert_tpu_torch.ops.quant import int_mm

        before = (int_mm.launches, int_mm.launches_padded)
        a = torch.randint(-127, 128, (3, 5), dtype=torch.int8)
        assert int_mm(a, a).shape == (3, 3)
        assert (int_mm.launches, int_mm.launches_padded) == before
        with pytest.raises(ValueError, match="int8"):
            int_mm(a.int(), a)


@pytest.mark.parametrize("family", ["vilbert", "basebert"])
class TestModel:
    def test_int8_sites_are_the_flax_quant_sites(self, tiny_config, family):
        """One calibration pass computing every head: the port's static
        sites are exactly the keys of flax's ``quant`` collection."""
        from vilbert_tpu_torch.core.weights import flax_path, quant_from_model
        from vilbert_tpu_torch.ops.quant import calibrating, static_sites

        cfg = tiny_config.replace(int8_static=True)
        model = _port(family, cfg)
        x = _inputs(cfg)
        with calibrating(model):
            _run(model, x)
        quant = _flax_calibrate(_jax_model(family, cfg), _params(model), [x], jit=True)
        want = set(_flatten(quant))
        assert want == set(_flatten(quant_from_model(model)))
        assert want == {flax_path(f"{n}.act_amax", family) for n in static_sites(model)}
        n_linear = sum(type(m).__name__ == "Linear" for m in model.modules())
        assert len(want) == n_linear > 10

    def test_calibrated_ranges_match_flax(self, tiny_config, family):
        from vilbert_tpu_torch.core.weights import quant_from_model
        from vilbert_tpu_torch.ops.quant import calibrating

        cfg = tiny_config.replace(int8_static=True)
        model = _port(family, cfg, seed=1)
        batches = [_inputs(cfg, seed=s) for s in (1, 2)]
        with calibrating(model):
            for x in batches:
                _run(model, x, heads=("vil_prediction",))
        want = _flatten(_flax_calibrate(_jax_model(family, cfg), _params(model), batches,
                                        heads=("vil_prediction",)))
        got = _flatten(quant_from_model(model))
        assert set(got) == set(want)
        for k, w in want.items():
            np.testing.assert_allclose(got[k], np.asarray(w), rtol=1e-5, atol=1e-7, err_msg=k)

    @pytest.mark.parametrize("mode", ["int8_static", "int8_matmul"])
    def test_int8_logits_match_flax(self, tiny_config, family, mode):
        """fp32 int8 logits within 1e-3 of the largest; static int8 with
        flax's calibration loaded through ``core.weights.load_quant``."""
        from vilbert_tpu_torch.core.weights import load_quant

        cfg = tiny_config.replace(**{mode: True})
        model = _port(family, cfg, seed=2)
        params = _params(model)
        jmodel = _jax_model(family, cfg)
        heads = ("vil_prediction", "vil_logit", "vision_logit")
        variables = {"params": params}
        if mode == "int8_static":
            quant = _flax_calibrate(jmodel, params, [_inputs(cfg, seed=s) for s in (3, 4)],
                                    heads=heads)
            load_quant(model, quant)
            variables["quant"] = quant
        x = _inputs(cfg, seed=5)
        want = jax.jit(functools.partial(jmodel.apply, heads=heads))(variables, **x)
        got = _run(model, x, heads=heads)
        for name in heads:
            w = np.asarray(getattr(want, name))
            np.testing.assert_allclose(getattr(got, name).numpy(), w, rtol=0,
                                       atol=1e-3 * float(np.abs(w).max()), err_msg=name)

    def test_uncalibrated_static_site_raises(self, tiny_config, family):
        from vilbert_tpu_torch.core.weights import load_quant

        cfg = tiny_config.replace(int8_static=True)
        model = _port(family, cfg)
        with pytest.raises(ValueError, match="calibrat"):
            _run(model, _inputs(cfg), heads=("vil_prediction",))
        with pytest.raises(ValueError, match="no int8_static site"):
            load_quant(model, {"no_such": {"act_amax": np.zeros(3, np.float32)}})


def test_int8_is_inference_only_and_keeps_the_param_tree(tiny_config):
    """The int8 model's parameters are the bf16/fp32 model's (checkpoints
    need no conversion); its static ranges are no parameters."""
    plain = _port("vilbert", tiny_config)
    static = _port("vilbert", tiny_config.replace(int8_static=True))
    assert list(plain.state_dict()) == list(static.state_dict())
    assert all("act_amax" not in k for k in static.state_dict())


#: a tiny two-stream config at the synthetic stores' feature width
_TINY = dict(
    vocab_size=99, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
    intermediate_size=64, max_position_embeddings=64, v_feature_size=2048,
    v_hidden_size=24, v_num_hidden_layers=2, v_num_attention_heads=4,
    v_intermediate_size=48, v_target_size=11, bi_hidden_size=32,
    bi_num_attention_heads=4, v_biattention_id=[0, 1], t_biattention_id=[0, 1],
    compute_dtype="float32",
)


def _spread_npz(tmp_path, cfg_path):
    """A JAX-initialised, JAX-saved ``.npz`` with every weight matrix and
    table scaled by 10, so that the argmaxes are not near ties (at the
    initialiser's 0.02 one int8 step would reorder them)."""
    from vilbert_tpu.core.checkpoint import save_params
    from vilbert_tpu.core.config import ModelConfig
    from vilbert_tpu.core.importer import _unflatten
    from vilbert_tpu.models.vilbert import ViLBERTForVLTasks

    cfg = ModelConfig.from_json_file(str(cfg_path))
    params = ViLBERTForVLTasks(cfg).init(
        jax.random.PRNGKey(1), np.zeros((2, 5), np.int32),
        np.zeros((2, 3, cfg.v_feature_size), np.float32), np.zeros((2, 3, 5), np.float32))
    flat = {k: np.asarray(v) * (10 if k.endswith(("kernel", "embedding")) else 1)
            for k, v in _flatten(params["params"]).items()}
    path = str(tmp_path / "spread.npz")
    save_params(path, _unflatten(flat))
    return path


def test_eval_cli_int8_matches_the_jax_cli(tmp_path):
    """``eval_tasks --int8 --synthetic`` on TASK1 with one JAX-saved
    ``.npz``: the same submission records as the JAX CLI's ``--int8``, and
    its metrics within 1e-3 relative."""
    import json

    from vilbert_tpu.cli.eval_tasks import main as jax_main
    from vilbert_tpu_torch.cli.eval_tasks import main

    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(_TINY))
    argv = ["--synthetic", "--tasks", "1", "--int8", "--config", str(cfg), "--params",
            _spread_npz(tmp_path, cfg)]
    jax_main([*argv, "--output_dir", str(tmp_path / "jax")])
    main([*argv, "--device", "cpu", "--output_dir", str(tmp_path / "port")])
    want, got = (json.loads((tmp_path / d / "metrics_VQA_val.json").read_text())
                 for d in ("jax", "port"))
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-3 * max(1.0, abs(want[k])), (k, got[k], want[k])
    assert ((tmp_path / "port" / "VQA_val_result.json").read_text()
            == (tmp_path / "jax" / "VQA_val_result.json").read_text())
