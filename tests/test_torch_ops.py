"""The PyTorch port's ops against the JAX package, on the CPU.

The plain PyTorch versions (the CPU path of each op and the oracle of each
CUDA kernel) are held to the Pallas TPU kernels run in interpret mode, as
tests/test_pallas_ops.py runs them. The kernels' operand checks are pure
shape logic and run here too; the kernels themselves run only on a card
(chip_smoke.py compares them with the plain versions there).
"""

import ctypes

import numpy as np
import pytest
import torch

import jax.numpy as jnp


def _t(a):
    return torch.from_numpy(np.asarray(a))


class TestAttention:
    # (Sq, Sk, heads, d): self-attention, Sq < Sk with d=6, Sq > Sk
    @pytest.mark.parametrize("sq,sk,h,d", [(5, 5, 4, 8), (5, 7, 4, 6), (7, 3, 2, 8)])
    def test_ref_matches_pallas_kernel(self, sq, sk, h, d, rng_np):
        from vilbert_tpu.ops.pallas_attention_train import fused_attention_train
        from vilbert_tpu_torch.ops.attention import attention, attention_ref, make_additive_mask

        B, H = 3, h * d
        q = rng_np.randn(B, sq, H).astype(np.float32)
        k = rng_np.randn(B, sk, H).astype(np.float32)
        v = rng_np.randn(B, sk, H).astype(np.float32)
        mask = np.ones((B, sk), np.int32)
        mask[0, -2:] = 0   # padded keys
        mask[2, :] = 0     # a fully padded row: uniform over -10000 biases
        bias = make_additive_mask(_t(mask))

        want = fused_attention_train(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias.numpy()),
            num_heads=h, interpret=True,
        )
        got = attention_ref(_t(q), _t(k), _t(v), bias, num_heads=h)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
        # the entry point takes the plain version for CPU tensors, uncounted
        before = attention.launches
        assert torch.equal(attention(_t(q), _t(k), _t(v), bias, num_heads=h), got)
        assert attention.launches == before

    def test_make_additive_mask_matches_jax(self):
        from vilbert_tpu.ops.attention import make_additive_mask as jax_mask
        from vilbert_tpu_torch.ops.attention import make_additive_mask

        mask = np.array([[1, 1, 0], [0, 1, 1]], np.int32)
        got = make_additive_mask(_t(mask))
        assert got.shape == (2, 1, 1, 3)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jax_mask(jnp.asarray(mask))))

    def test_dropout_rate_is_refused(self):
        """A dropout rate without a uint32 seed, or outside [0, 1), is refused."""
        from vilbert_tpu_torch.ops.attention import attention

        x = torch.zeros(1, 2, 8)
        for rate, seed in ((0.1, None), (0.1, -1), (0.1, 2 ** 32), (1.0, 3), (-0.1, 3)):
            with pytest.raises(ValueError, match="dropout"):
                attention(x, x, x, None, num_heads=1, dropout_rate=rate, seed=seed)


def _qkv(b=2, sq=23, sk=101, hd=1024, dtype=torch.bfloat16):
    return (torch.zeros(b, sq, hd, dtype=dtype), torch.zeros(b, sk, hd, dtype=dtype),
            torch.zeros(b, sk, hd, dtype=dtype), torch.zeros(b, sk))


class TestAttentionKernelOperands:
    """What the CUDA wrapper accepts and refuses, before any launch."""

    @pytest.mark.parametrize("sq,sk,hd,heads", [(23, 23, 768, 12), (101, 101, 1024, 8),
                                                (23, 101, 1024, 8), (101, 23, 1024, 8),
                                                (7, 1, 1024, 8), (3, 512, 768, 12)])
    def test_accepts_slice_shapes(self, sq, sk, hd, heads):
        from vilbert_tpu_torch.ops.attention import kernel_geometry

        q, k, v, bias = _qkv(sq=sq, sk=sk, hd=hd)
        assert kernel_geometry(q, k, v, bias, heads) == (2, sq, sk, hd // heads)

    def test_accepts_broadcast_batch(self):
        """fast_mode broadcasts one text row over the batch: stride 0."""
        from vilbert_tpu_torch.ops.attention import kernel_geometry

        q, k, v, bias = _qkv(b=1)
        q, k, v, bias = (t.expand(4, *t.shape[1:]) for t in (q, k, v, bias))
        assert kernel_geometry(q, k, v, bias, 8) == (4, 23, 101, 128)

    @pytest.mark.parametrize("case", ["head_dim", "too_many_keys", "fp16", "mixed_dtype",
                                      "kv_shape", "h_stride", "bias_dtype"])
    def test_refuses(self, case):
        from vilbert_tpu_torch.ops.attention import kernel_geometry

        q, k, v, bias = _qkv()
        heads = 8
        if case == "head_dim":
            heads = 32  # d = 32
        elif case == "too_many_keys":
            q, k, v, bias = _qkv(sk=1025)
        elif case == "fp16":
            q, k, v, bias = _qkv(dtype=torch.float16)
        elif case == "mixed_dtype":
            v = v.float()
        elif case == "kv_shape":
            k = k[:, :50]
        elif case == "h_stride":
            q = torch.zeros(2, 23, 2048, dtype=torch.bfloat16)[:, :, ::2]
        elif case == "bias_dtype":
            bias = bias.to(torch.bfloat16)
        with pytest.raises(ValueError):
            kernel_geometry(q, k, v, bias, heads)


class TestAttentionVariants:
    """Which kernel variant the wrappers pick, and what the tensor-core
    variants take, before any launch."""

    @pytest.mark.parametrize("dtype,sq,sk,d,want", [
        (torch.bfloat16, 23, 1, 128, "tc"), (torch.bfloat16, 101, 101, 128, "wg"),
        (torch.bfloat16, 128, 128, 64, "wg"),
        (torch.bfloat16, 129, 129, 128, "long_tc"), (torch.bfloat16, 512, 512, 64, "long_tc"),
        (torch.float32, 23, 23, 64, "cc"), (torch.float32, 129, 129, 64, "cc"),
        (torch.float32, 512, 512, 128, "cc"),
        (torch.bfloat16, 562, 562, 64, "wg"), (torch.bfloat16, 1024, 1024, 128, "long_tc"),
        (torch.float32, 1024, 1024, 64, "cc"),
        (torch.bfloat16, 200, 200, 128, "long_tc"), (torch.bfloat16, 257, 257, 64, "long_tc"),
        (torch.bfloat16, 306, 306, 128, "long_tc"),
    ])
    def test_forward_variant_by_dtype_and_keys(self, dtype, sq, sk, d, want):
        """fp32 on the CUDA cores; bf16 by sequence lengths and head width
        (``fwd_variant``; the path shapes are pinned in
        tests/test_torch_attention_fwd.py)."""
        from vilbert_tpu_torch.ops.attention import fwd_variant

        assert fwd_variant(dtype, sq, sk, d) == want

    def test_backward_variant_by_dtype(self):
        """Up to 128 queries and keys at d = 128 (but text->image), bf16 runs
        on the mma.sync tensor-core variant and fp32 on the CUDA cores."""
        from vilbert_tpu_torch.ops.attention import bwd_variant

        for sq, sk in ((1, 1), (37, 36), (128, 128)):
            assert (bwd_variant(torch.bfloat16, sq, sk, 128),
                    bwd_variant(torch.float32, sq, sk, 128)) == ("tc", "cc")

    @pytest.mark.parametrize("d", [64, 128])
    @pytest.mark.parametrize("sq,sk", [(129, 1), (1, 129), (21, 200), (200, 21), (257, 306),
                                       (512, 512), (562, 562), (1024, 1)])
    @pytest.mark.parametrize("dtype,want", [(torch.bfloat16, "wg"), (torch.float32, "long")])
    def test_backward_variant_past_128_is_long(self, sq, sk, dtype, want, d):
        """Past 128 queries or keys, bf16 runs the wgmma variant (which took
        over from the long mma.sync one) and fp32 the long variant on the
        CUDA cores, at either head width."""
        from vilbert_tpu_torch.ops.attention import bwd_variant

        assert bwd_variant(dtype, sq, sk, d) == want

    @pytest.mark.parametrize("sq,sk,d,want", [
        (36, 36, 64, "tc"), (57, 57, 64, "tc"), (64, 64, 64, "tc"), (65, 65, 64, "wg"),
        (73, 73, 64, "wg"), (121, 121, 64, "wg"), (124, 124, 64, "wg"), (128, 1, 64, "wg"),
        (37, 37, 128, "tc"), (36, 37, 128, "tc"), (101, 101, 128, "tc"), (101, 24, 128, "tc"),
        (24, 101, 128, "wg"), (64, 65, 128, "wg"), (65, 101, 128, "tc"), (1, 128, 128, "wg"),
    ])
    def test_backward_variant_at_or_under_128(self, sq, sk, d, want):
        """At or under 128, bf16 takes "wg" where it beat "tc" on the card:
        past one 64-row tile at d = 64, and at d = 128 where at most 64
        queries meet more than 64 keys; fp32 stays on "cc"."""
        from vilbert_tpu_torch.ops.attention import bwd_variant

        assert bwd_variant(torch.bfloat16, sq, sk, d) == want
        assert bwd_variant(torch.float32, sq, sk, d) == "cc"

    @pytest.mark.parametrize("sq,sk,ok", [(512, 512, True), (306, 257, True), (513, 20, True),
                                          (20, 513, True), (562, 562, True), (1024, 1024, True),
                                          (1025, 20, False), (20, 1025, False)])
    def test_backward_geometry_takes_up_to_512(self, sq, sk, ok):
        """Up to BWD_KERNEL_MAX_SEQ (1024; 512 before the single-stream
        baseline needed 562) queries and keys, and no further."""
        from vilbert_tpu_torch.ops.attention import bwd_kernel_geometry

        q, k, v, bias = _qkv(sq=sq, sk=sk, hd=256)
        if ok:
            assert bwd_kernel_geometry(q, k, v, bias, q, 2) == (2, sq, sk, 128)
        else:
            with pytest.raises(ValueError):
                bwd_kernel_geometry(q, k, v, bias, q, 2)

    def test_tc_strides_of_projections(self):
        """[B, S, H] projections and a stride-0 batch pass; the stride of a
        dimension of size 1 goes in as 0."""
        from vilbert_tpu_torch.ops.attention import _tc_strides

        q, k, _, _ = _qkv(sq=23, sk=101, hd=768)
        one = torch.zeros(1, 1, 768, dtype=torch.bfloat16)
        assert _tc_strides(q=q, k=k, b=k[:1].expand(4, 101, 768), one=one) == [
            23 * 768, 768, 101 * 768, 768, 0, 768, 0, 0]

    @pytest.mark.parametrize("case", ["offset", "row_stride"])
    def test_tc_refuses_unaligned(self, case):
        from vilbert_tpu_torch.ops.attention import _tc_strides

        if case == "offset":  # rows start 2 bytes off a 16-byte boundary
            x = torch.zeros(2, 23, 776, dtype=torch.bfloat16)[..., 1:769]
        else:  # aligned start, rows 772 elements apart
            x = torch.zeros(2, 23, 772, dtype=torch.bfloat16)[..., :768]
        with pytest.raises(ValueError):
            _tc_strides(q=x)

    def test_named_variant_needs_cuda_tensors(self):
        from vilbert_tpu_torch.ops.attention import (
            VARIANTS,
            attention_bwd_kernel,
            attention_kernel,
        )

        q, k, v, _ = _qkv()
        for variant in VARIANTS:
            with pytest.raises(ValueError, match="cpu or cuda"):
                attention_kernel(q, k, v, None, num_heads=8, variant=variant)
        with pytest.raises(ValueError, match="cpu or cuda"):
            attention_bwd_kernel(q, k, v, None, q, num_heads=8, variant="cc")

    def test_each_variant_has_a_counter(self):
        from vilbert_tpu_torch.ops.attention import (
            BWD_VARIANTS,
            VARIANTS,
            attention,
            attention_bwd,
        )

        for wrapper, variants in ((attention, VARIANTS), (attention_bwd, BWD_VARIANTS)):
            for variant in variants:
                assert isinstance(getattr(wrapper, f"launches_{variant}"), int)
        assert {"long", "long_tc"} <= set(BWD_VARIANTS) and "long" not in VARIANTS
        assert isinstance(attention.launches_long_tc, int) and "long_tc" in VARIANTS


class _FakeLibrary:
    """Stands in for the kernels' ctypes library: records each entry point's
    arguments and returns cudaSuccess, so the wrapper's dispatch runs on CPU
    tensors."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("vt_"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0


def _fake_library(monkeypatch, wrapper, variants) -> _FakeLibrary:
    """A recording library in place of the kernels', no CUDA stream, and
    ``wrapper``'s counters at 0 (restored after the test)."""
    import contextlib
    import types

    from vilbert_tpu_torch.ops import _build

    for counter in ("launches", *(f"launches_{v}" for v in variants)):
        monkeypatch.setattr(wrapper, counter, 0)
    lib = _FakeLibrary()
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda _: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    return lib


@pytest.fixture
def fake_kernels(monkeypatch):
    """The attention ``_fwd_cuda`` with a recording library."""
    from vilbert_tpu_torch.ops.attention import VARIANTS, attention

    return _fake_library(monkeypatch, attention, VARIANTS)


@pytest.fixture
def fake_ln_kernels(monkeypatch):
    """The LayerNorm ``_fwd_cuda`` with a recording library."""
    from vilbert_tpu_torch.ops.layernorm import VARIANTS, layer_norm

    return _fake_library(monkeypatch, layer_norm, (*VARIANTS, "bf16_weight"))


class TestLongForwardDispatch:
    """What ``_fwd_cuda`` hands the tensor-core K1 past 128 keys, with the
    library replaced by a recorder (the kernel itself runs on a card)."""

    @pytest.mark.parametrize("sq,sk,hd,heads", [(200, 200, 1024, 8), (257, 306, 1024, 8),
                                                (21, 200, 1024, 8), (257, 257, 768, 12)])
    def test_long_shapes_reach_long_tc_with_tc_strides(self, fake_kernels, sq, sk, hd, heads):
        """``long_tc``, the variant ``fwd_variant`` routes these shapes
        (Visual7w, GuessWhatPointing) to."""
        from vilbert_tpu_torch.ops.attention import _fwd_cuda, attention, fwd_variant

        q, k, v, bias = _qkv(sq=sq, sk=sk, hd=hd)
        variant = "long_tc"
        before = (attention.launches, attention.launches_long_tc)
        out = _fwd_cuda(q, k, v, bias, heads, 0.1, 2 ** 31 + 5, variant)
        assert fwd_variant(q.dtype, sq, sk, hd // heads) == variant
        assert out.shape == q.shape and out.dtype == q.dtype
        assert (attention.launches, attention.launches_long_tc) == (before[0] + 1,
                                                                   before[1] + 1)
        (name, args), = fake_kernels.calls
        assert name == "vt_attention_fwd_long_tc"
        # pointers, batch, heads, head_dim, Sq, Sk, strides, bias stride, scale, dropout, stream
        assert args[5:10] == (2, heads, hd // heads, sq, sk)
        assert list(args[10:16]) == [sq * hd, hd, sk * hd, hd, sk * hd, hd]
        assert args[16] == sk and args[17] == pytest.approx((hd // heads) ** -0.5)
        assert args[18] == 2 ** 31 + 5 and args[-1] == 0

    def test_stride0_batch_passes(self, fake_kernels):
        """retrieval's fast_mode: one k, v row block broadcast over the batch."""
        from vilbert_tpu_torch.ops.attention import _fwd_cuda

        q, k, v, bias = _qkv(b=4, sq=23, sk=200)
        k, v = (t[:1].expand(4, 200, 1024) for t in (k, v))
        _fwd_cuda(q, k, v, bias, 8, 0.0, None, "long_tc")
        (_, args), = fake_kernels.calls
        assert list(args[10:16]) == [23 * 1024, 1024, 0, 1024, 0, 1024]

    @pytest.mark.parametrize("case", ["offset", "row_stride", "fp32"])
    def test_refuses_before_launch(self, fake_kernels, case):
        from vilbert_tpu_torch.ops.attention import _fwd_cuda

        q, k, v, bias = _qkv(sq=23, sk=200, hd=768)
        if case == "offset":  # rows start 2 bytes off a 16-byte boundary
            k = torch.zeros(2, 200, 776, dtype=torch.bfloat16)[..., 1:769]
        elif case == "row_stride":  # aligned start, rows 772 elements apart
            v = torch.zeros(2, 200, 772, dtype=torch.bfloat16)[..., :768]
        else:
            q, k, v = (t.float() for t in (q, k, v))
        with pytest.raises(ValueError):
            _fwd_cuda(q, k, v, bias, 12, 0.0, None, "long_tc")
        assert fake_kernels.calls == []


class TestLayerNorm:
    @pytest.mark.parametrize("with_residual", [False, True])
    def test_ref_matches_pallas_kernel(self, with_residual, rng_np):
        from vilbert_tpu.ops.pallas_layernorm import fused_layer_norm
        from vilbert_tpu_torch.ops.layernorm import layer_norm, layer_norm_ref

        x = rng_np.randn(3, 7, 32).astype(np.float32) * 3 + 1
        res = rng_np.randn(3, 7, 32).astype(np.float32) if with_residual else None
        w = rng_np.randn(32).astype(np.float32)
        b = rng_np.randn(32).astype(np.float32)
        want = fused_layer_norm(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
            residual=None if res is None else jnp.asarray(res), interpret=True,
        )
        r = None if res is None else _t(res)
        got = layer_norm_ref(_t(x), _t(w), _t(b), residual=r)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
        before = layer_norm.launches
        assert torch.equal(layer_norm(_t(x), _t(w), _t(b), residual=r), got)
        assert layer_norm.launches == before

    def test_bf16_output_dtype_and_fp32_statistics(self, rng_np):
        from vilbert_tpu.ops.layernorm import layer_norm as jax_ln
        from vilbert_tpu_torch.ops.layernorm import layer_norm_ref

        x = rng_np.randn(5, 32).astype(np.float32)
        w, b = np.ones(32, np.float32), np.zeros(32, np.float32)
        got = layer_norm_ref(_t(x).to(torch.bfloat16), _t(w), _t(b))
        want = jax_ln(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), jnp.asarray(b))
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   atol=1e-2, rtol=1e-2)

    @pytest.mark.parametrize("with_residual", [False, True])
    @pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
    def test_bf16_weight_and_bias_match_pallas_kernel(self, with_residual, x_dtype, rng_np):
        """bf16 weight and bias (what a ``--bf16_grads`` step hands K4),
        widened to fp32 inside the plain version as inside the Pallas
        kernel, at either dtype of x: fp32 within 1e-5, bf16 within one
        rounding of the output. The backward returns dw and db in bf16."""
        from vilbert_tpu.ops.pallas_layernorm import fused_layer_norm
        from vilbert_tpu_torch.ops.layernorm import layer_norm, layer_norm_ref

        x = rng_np.randn(3, 7, 128).astype(np.float32) * 3 + 1
        res = rng_np.randn(3, 7, 128).astype(np.float32) if with_residual else None
        w = rng_np.randn(128).astype(np.float32)
        b = rng_np.randn(128).astype(np.float32)
        jdt, tdt = jnp.dtype(x_dtype), getattr(torch, x_dtype)
        want = fused_layer_norm(
            jnp.asarray(x, jdt), jnp.asarray(w, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16),
            residual=None if res is None else jnp.asarray(res, jdt), interpret=True,
        )
        wt, bt = _t(w).to(torch.bfloat16), _t(b).to(torch.bfloat16)
        r = None if res is None else _t(res).to(tdt)
        got = layer_norm_ref(_t(x).to(tdt), wt, bt, residual=r)
        assert got.dtype == tdt
        tol = 1e-5 if x_dtype == "float32" else 2 ** -7
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   atol=tol * 4, rtol=tol)
        wl, bl = (t.clone().requires_grad_() for t in (wt, bt))
        layer_norm(_t(x).to(tdt), wl, bl, residual=r).sum().backward()
        assert wl.grad.dtype == bl.grad.dtype == torch.bfloat16


class TestLayerNormKernelOperands:
    @pytest.mark.parametrize("h", [768, 1024, 2048])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_accepts_slice_widths(self, h, dtype):
        from vilbert_tpu_torch.ops.layernorm import kernel_rows

        x = torch.zeros(811, h, dtype=dtype)
        assert kernel_rows(x, torch.ones(h), torch.zeros(h), x.clone()) == 811
        # bf16 weight and bias, at either dtype of x
        ones, zeros = torch.ones(h, dtype=torch.bfloat16), torch.zeros(h, dtype=torch.bfloat16)
        assert kernel_rows(x, ones, zeros, None) == 811

    @pytest.mark.parametrize("case", ["h_96", "h_4096", "fp16", "residual_dtype",
                                      "weight_dtype", "strided", "misaligned"])
    def test_refuses(self, case):
        from vilbert_tpu_torch.ops.layernorm import kernel_rows

        h = {"h_96": 96, "h_4096": 4096}.get(case, 768)
        x = torch.zeros(4, h, dtype=torch.float16 if case == "fp16" else torch.bfloat16)
        w, b, res = torch.ones(h), torch.zeros(h), None
        if case == "residual_dtype":
            res = x.float()
        elif case == "weight_dtype":
            w = w.to(torch.bfloat16)
        elif case == "strided":
            x = torch.zeros(h, 4, dtype=torch.bfloat16).T
        elif case == "misaligned":
            x = torch.zeros(4 * h + 1, dtype=torch.bfloat16)[1:].view(4, h)
        with pytest.raises(ValueError):
            kernel_rows(x, w, b, res)


class TestLayerNormVariants:
    """Which K4 variant the wrapper picks and what it hands the kernel's
    entry point, with the library replaced by a recorder (the kernel itself
    runs on a card)."""

    @pytest.mark.parametrize("h", [128, 768, 1024, 2048])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_variant_by_rows(self, h, dtype):
        """"block" up to the first crossover and past the second,
        "persistent" between; the paths' shapes on their measured side."""
        from vilbert_tpu_torch.ops.layernorm import (
            PERSISTENT_MAX_ROWS,
            PERSISTENT_MIN_ROWS,
            ln_variant,
        )

        top = PERSISTENT_MAX_ROWS[dtype]
        for rows, want in ((1, "block"), (64, "block"), (PERSISTENT_MIN_ROWS, "block"),
                           (PERSISTENT_MIN_ROWS + 1, "persistent"), (top, "persistent"),
                           (top + 1, "block"), (103424, "block")):
            assert ln_variant(rows, h, dtype) == want, rows
        assert ln_variant(9216, 768, torch.bfloat16) == "persistent"  # the CC step's text
        assert ln_variant(16448, 768, torch.bfloat16) == "block"  # GuessWhatPointing's text
        assert ln_variant(9216, 768, torch.float32) == "block"  # the CC text embedding

    def test_each_variant_has_a_counter_and_an_entry_point(self):
        from vilbert_tpu_torch.ops import _build
        from vilbert_tpu_torch.ops.layernorm import VARIANTS, layer_norm

        assert set(VARIANTS) == {"block", "persistent"}
        for variant in VARIANTS:
            assert isinstance(getattr(layer_norm, f"launches_{variant}"), int)
            assert _build._SIGNATURES[f"vt_layer_norm_fwd_{variant}"] == (
                [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p])
        assert layer_norm.launches_bf16_weight == 0

    @pytest.mark.parametrize("rows,lead", [(1, ()), (64, ()), (1024, ()), (9216, ()),
                                           (6 * 101, (6,))])
    @pytest.mark.parametrize("with_res", [False, True])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_hands_the_entry_point_its_operands(self, fake_ln_kernels, rows, lead, with_res,
                                                 dtype):
        from vilbert_tpu_torch.ops import _build
        from vilbert_tpu_torch.ops.layernorm import _fwd_cuda, layer_norm, ln_variant

        h = 1024
        x = torch.zeros(*lead, rows // int(np.prod(lead)), h, dtype=dtype)
        res = torch.ones_like(x) if with_res else None
        w, b = torch.ones(h), torch.zeros(h)
        variant = ln_variant(rows, h, dtype)
        out = _fwd_cuda(x, w, b, 1e-12, res)
        assert out.shape == x.shape and out.dtype == dtype
        (name, args), = fake_ln_kernels.calls
        assert name == f"vt_layer_norm_fwd_{variant}"
        assert args[:5] == (x.data_ptr(), res.data_ptr() if with_res else None, w.data_ptr(),
                            b.data_ptr(), out.data_ptr())
        assert args[5:] == (_build.DTYPE_CODES[dtype], 0, rows, h, 1e-12, 0)
        other, = {"block", "persistent"} - {variant}
        assert (layer_norm.launches, getattr(layer_norm, f"launches_{variant}"),
                getattr(layer_norm, f"launches_{other}"), layer_norm.launches_bf16_weight) == (
                    1, 1, 0, 0)

    @pytest.mark.parametrize("rows", [1, 9216, 50_000])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_bf16_weight_reaches_its_instantiation(self, fake_ln_kernels, rows, dtype):
        """bf16 weight and bias go to the entry point as they are, with the
        weight dtype code 1, no cast launched: the same variant as fp32
        weights, and one more on ``launches_bf16_weight``."""
        from vilbert_tpu_torch.ops.layernorm import _fwd_cuda, layer_norm, ln_variant

        x = torch.zeros(rows, 768, dtype=dtype)
        w, b = torch.ones(768, dtype=torch.bfloat16), torch.zeros(768, dtype=torch.bfloat16)
        _fwd_cuda(x, w, b, 1e-12, None)
        variant = ln_variant(rows, 768, dtype)
        (name, args), = fake_ln_kernels.calls
        assert name == f"vt_layer_norm_fwd_{variant}"
        assert args[2:4] == (w.data_ptr(), b.data_ptr()) and args[6] == 1
        assert (layer_norm.launches, getattr(layer_norm, f"launches_{variant}"),
                layer_norm.launches_bf16_weight) == (1, 1, 1)

    @pytest.mark.parametrize("variant", ["block", "persistent"])
    def test_named_variant_launches_it(self, fake_ln_kernels, variant):
        """``layer_norm_kernel``'s variant, whatever ``ln_variant`` would pick."""
        from vilbert_tpu_torch.ops.layernorm import _fwd_cuda, layer_norm

        for rows in (1, 50_000):
            x = torch.zeros(rows, 768, dtype=torch.bfloat16)
            _fwd_cuda(x, torch.ones(768), torch.zeros(768), 1e-5, None, variant)
        assert [name for name, _ in fake_ln_kernels.calls] == [f"vt_layer_norm_fwd_{variant}"] * 2
        assert fake_ln_kernels.calls[0][1][9] == 1e-5
        assert (layer_norm.launches, getattr(layer_norm, f"launches_{variant}")) == (2, 2)

    @pytest.mark.parametrize("case", ["misaligned", "strided", "fp16", "h_96", "h_200",
                                      "h_2176", "h_4096", "variant"])
    def test_refuses_before_launch(self, fake_ln_kernels, case):
        from vilbert_tpu_torch.ops.layernorm import _fwd_cuda, layer_norm

        h = {"h_96": 96, "h_200": 200, "h_2176": 2176, "h_4096": 4096}.get(case, 768)
        x = torch.zeros(4, h, dtype=torch.float16 if case == "fp16" else torch.bfloat16)
        if case == "misaligned":
            x = torch.zeros(4 * h + 1, dtype=torch.bfloat16)[1:].view(4, h)
        elif case == "strided":
            x = torch.zeros(h, 4, dtype=torch.bfloat16).T
        with pytest.raises(ValueError):
            _fwd_cuda(x, torch.ones(h), torch.zeros(h), 1e-12, None,
                      "tiles" if case == "variant" else None)
        assert fake_ln_kernels.calls == [] and layer_norm.launches == 0

    def test_cuda_entry_needs_cuda_tensors(self):
        from vilbert_tpu_torch.ops.layernorm import VARIANTS, layer_norm_kernel

        x = torch.zeros(4, 768)
        for variant in VARIANTS:
            with pytest.raises(ValueError, match="cpu or cuda"):
                layer_norm_kernel(x, torch.ones(768), torch.zeros(768), variant=variant)


def _kernel_row_sum(v, warps, vec):
    """The sum of each row of v [rows, H] (fp32) in the K4 kernel's order,
    with the row over ``warps`` warps of 32 lanes and vectors of ``vec``
    elements: thread t holds vectors t, t + 32 warps, ... and sums its
    elements in column order; a butterfly over each warp's lanes
    (``__shfl_xor_sync`` by 16, 8, 4, 2, 1); then the warps' sums in order."""
    rows, h = v.shape
    threads = 32 * warps
    parts = v.reshape(rows, h // (vec * threads), threads, vec)
    s = np.zeros((rows, threads), np.float32)
    for i in range(parts.shape[1]):
        for e in range(vec):
            s = s + parts[:, i, :, e]
    s = s.reshape(rows, warps, 32)
    for o in (16, 8, 4, 2, 1):
        s = s + s[:, :, np.arange(32) ^ o]
    total = s[:, 0, 0]
    for k in range(1, warps):
        total = total + s[:, k, 0]
    return total


def _kernel_layer_norm(x, w, b, res, warps, vec, eps=1e-12):
    """K4's arithmetic in numpy fp32, its sums in the kernel's order (fused
    multiply-adds aside)."""
    v = x + res if res is not None else x
    h = np.float32(v.shape[1])
    mean = _kernel_row_sum(v, warps, vec) / h
    d = v - mean[:, None]
    inv = np.float32(1) / np.sqrt(_kernel_row_sum(d * d, warps, vec) / h + np.float32(eps))
    return d * inv[:, None] * w + b


class TestLayerNormSummationOrder:
    """The kernel's order of summation, emulated in numpy, against the
    Pallas kernel in interpret mode at fp32: both variants sum a row over
    H / (32 x vector) warps with one vector a thread. Vectors of 4 are
    fp32's layout (and bf16's at H a multiple of 128 but not of 256),
    vectors of 8 bf16's, here on fp32 values. One warp a row (32 lanes of
    several vectors each) is emulated beside it: the same function in
    another order, within the same bound."""

    @pytest.mark.parametrize("h,vec", [(128, 4), (384, 4), (768, 4), (1024, 4), (2048, 4),
                                       (768, 8), (1024, 8), (2048, 8)])
    @pytest.mark.parametrize("layout", ["kernel", "one warp a row"])
    @pytest.mark.parametrize("with_res", [False, True])
    def test_matches_pallas(self, h, vec, layout, with_res, rng_np):
        from vilbert_tpu.ops.pallas_layernorm import fused_layer_norm

        x = rng_np.randn(5, h).astype(np.float32) * 3 + 1
        res = rng_np.randn(5, h).astype(np.float32) if with_res else None
        w = rng_np.randn(h).astype(np.float32)
        b = rng_np.randn(h).astype(np.float32)
        want = fused_layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                residual=None if res is None else jnp.asarray(res),
                                interpret=True)
        warps = 1 if layout == "one warp a row" else h // (32 * vec)
        got = _kernel_layer_norm(x, w, b, res, warps, vec)
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)


class TestActivations:
    def test_gelu_rational_matches_jax(self):
        from vilbert_tpu.models.layers import gelu_rational as jax_gelu_rational
        from vilbert_tpu_torch.models.layers import gelu_rational

        x = np.linspace(-8, 8, 4001).astype(np.float32)
        want = np.asarray(jax_gelu_rational(jnp.asarray(x)))
        np.testing.assert_allclose(gelu_rational(_t(x)).numpy(), want, atol=1e-6, rtol=1e-6)
        # bf16 in, bf16 out, computed in fp32: at most one bf16 rounding apart
        xb = torch.from_numpy(x).to(torch.bfloat16)
        got_b = gelu_rational(xb)
        want_b = np.asarray(jax_gelu_rational(jnp.asarray(xb.float().numpy(), jnp.bfloat16)),
                            np.float32)
        assert got_b.dtype == torch.bfloat16
        np.testing.assert_allclose(got_b.float().numpy(), want_b, atol=1e-2, rtol=2 ** -7)

    def test_gelu_exact_matches_jax(self):
        from vilbert_tpu.models.layers import gelu as jax_gelu
        from vilbert_tpu_torch.models.layers import gelu

        x = np.linspace(-6, 6, 1001).astype(np.float32)
        np.testing.assert_allclose(gelu(_t(x)).numpy(), np.asarray(jax_gelu(jnp.asarray(x))),
                                   atol=1e-6, rtol=1e-6)


@pytest.fixture
def fake_gelu_kernels(monkeypatch):
    """The rational gelu's launches with a recording library."""
    from vilbert_tpu_torch.ops.gelu import gelu_rational

    return _fake_library(monkeypatch, gelu_rational, ("bwd",))


def _extern_c(src) -> dict:
    """{entry point: number of parameters} of a source's ``extern "C"``
    functions."""
    import re

    decls = re.findall(r'extern "C" [\w\s*]+?\b(vt_\w+)\(([^)]*)\)', src.read_text())
    return {name: len([p for p in params.split(",") if p.strip()]) for name, params in decls}


class TestGeluRational:
    """The wrapper of the rational gelu's kernels (``ops/gelu.py``,
    ``csrc/gelu.cu``): the CPU path, the binding, the constants and the
    dispatch. The kernels themselves run on a card (chip_smoke.py holds them
    bit-equal to the plain chain there)."""

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_cpu_takes_the_plain_chain_uncounted(self, dtype, monkeypatch):
        from vilbert_tpu_torch.ops.gelu import (
            gelu_rational,
            gelu_rational_bwd,
            gelu_rational_bwd_ref,
            gelu_rational_ref,
        )

        monkeypatch.setattr(gelu_rational, "launches", 0)
        monkeypatch.setattr(gelu_rational, "launches_bwd", 0)
        x = torch.linspace(-7, 7, 1001).to(dtype).requires_grad_()
        dy = torch.from_numpy(np.random.RandomState(1).randn(1001).astype(np.float32)).to(dtype)
        y = gelu_rational(x)
        y.backward(dy)
        assert torch.equal(y.detach(), gelu_rational_ref(x.detach()))
        assert torch.equal(x.grad, gelu_rational_bwd_ref(x.detach(), dy))
        assert torch.equal(gelu_rational_bwd(x.detach(), dy), x.grad)
        assert y.dtype == x.grad.dtype == dtype
        assert (gelu_rational.launches, gelu_rational.launches_bwd) == (0, 0)

    def test_models_use_the_ops_entry_point(self):
        import vilbert_tpu_torch.models.layers as layers
        from vilbert_tpu_torch.ops import gelu

        assert layers.gelu_rational is gelu.gelu_rational
        assert layers.ACT2FN["gelu_rational"] is gelu.gelu_rational

    def test_gelu_entry_points_are_bound(self):
        """Both entry points in ``_SIGNATURES`` with the arity of their
        ``extern "C"`` declarations in ``csrc/gelu.cu``."""
        from vilbert_tpu_torch.ops import _build

        assert _extern_c(_build.CSRC_DIR / "gelu.cu") == {
            "vt_gelu_rational_fwd": len(_build._SIGNATURES["vt_gelu_rational_fwd"]),
            "vt_gelu_rational_bwd": len(_build._SIGNATURES["vt_gelu_rational_bwd"])}
        assert _build._SIGNATURES["vt_gelu_rational_fwd"][3] is ctypes.c_longlong  # n

    @pytest.mark.parametrize("source", ["attention.cu", "attention_bwd.cu", "attention_bwd_wg.cu",
                                        "attention_fwd_wg.cu", "gelu.cu", "layernorm.cu",
                                        "dropout.cu"])
    def test_each_source_matches_its_signatures(self, source):
        """Every entry point of a source (but the error message's) is bound
        with as many arguments as it declares."""
        from vilbert_tpu_torch.ops import _build

        declared = _extern_c(_build.CSRC_DIR / source)
        declared.pop("vt_error_string", None)
        assert declared
        for name, n in declared.items():
            assert len(_build._SIGNATURES[name]) == n, name

    def test_kernel_literals_are_the_constants(self):
        """Each named constant of ``csrc/gelu.cu`` is np.float32 of the
        Python constant the JAX-parity tests pin, and every one is there."""
        import re

        from vilbert_tpu_torch.ops import _build, gelu

        src = (_build.CSRC_DIR / "gelu.cu").read_text()
        found = dict(re.findall(r"constexpr float (k\w+) = (-?[0-9.eE+-]+)f;", src))
        want = {"kSqrtHalf": gelu.SQRT_HALF, "kErfClamp": gelu.ERF_CLAMP,
                "kDgeluClamp": gelu.DGELU_CLAMP}
        for prefix, coeffs in (("kErfP", gelu._ERF_P), ("kErfQ", gelu._ERF_Q),
                               ("kDgeluP", gelu._DGELU_P), ("kDgeluQ", gelu._DGELU_Q)):
            want.update({f"{prefix}{i}": c for i, c in enumerate(coeffs)})
        assert set(found) == set(want)
        for name, value in want.items():
            assert np.float32(float(found[name])) == np.float32(value), name

    @pytest.mark.parametrize("dtype,code", [(torch.float32, 0), (torch.bfloat16, 1)])
    def test_forward_launch(self, fake_gelu_kernels, dtype, code):
        from vilbert_tpu_torch.ops.gelu import _fwd_cuda, gelu_rational

        x = torch.zeros(3, 7, 1027, dtype=dtype)  # n not a multiple of a vector
        y = _fwd_cuda(x)
        assert y.shape == x.shape and y.dtype == dtype
        ((name, args),) = fake_gelu_kernels.calls
        assert name == "vt_gelu_rational_fwd"
        assert args == (x.data_ptr(), y.data_ptr(), code, 3 * 7 * 1027, 0)
        assert (gelu_rational.launches, gelu_rational.launches_bwd) == (1, 0)

    @pytest.mark.parametrize("dtype,code", [(torch.float32, 0), (torch.bfloat16, 1)])
    def test_backward_launch(self, fake_gelu_kernels, dtype, code):
        from vilbert_tpu_torch.ops.gelu import _bwd_cuda, gelu_rational

        x, dy = torch.zeros(5, 3072, dtype=dtype), torch.ones(5, 3072, dtype=dtype)
        dx = _bwd_cuda(x, dy)
        assert dx.shape == x.shape and dx.dtype == dtype
        ((name, args),) = fake_gelu_kernels.calls
        assert name == "vt_gelu_rational_bwd"
        assert args == (x.data_ptr(), dy.data_ptr(), dx.data_ptr(), code, 5 * 3072, 0)
        assert (gelu_rational.launches, gelu_rational.launches_bwd) == (0, 1)

    @pytest.mark.parametrize("case", ["fp16", "offset", "strided", "dy_dtype", "dy_shape",
                                      "dy_offset", "dy_strided"])
    def test_refuses_before_launch(self, fake_gelu_kernels, case):
        from vilbert_tpu_torch.ops.gelu import _bwd_cuda, _fwd_cuda, gelu_rational

        x = torch.zeros(4, 768, dtype=torch.bfloat16)
        dy = torch.zeros(4, 768, dtype=torch.bfloat16)
        offset = torch.zeros(4 * 768 + 1, dtype=torch.bfloat16)[1:].view(4, 768)  # 2 bytes off
        strided = torch.zeros(4, 1536, dtype=torch.bfloat16)[:, ::2]
        if case == "fp16":
            x = x.half()
        elif case == "offset":
            x = offset
        elif case == "strided":
            x = strided
        elif case == "dy_dtype":
            dy = dy.float()
        elif case == "dy_shape":
            dy = dy[:2]
        elif case == "dy_offset":
            dy = offset
        else:
            dy = strided
        with pytest.raises(ValueError):
            if case.startswith("dy"):
                _bwd_cuda(x, dy)
            else:
                _fwd_cuda(x)
        assert fake_gelu_kernels.calls == []
        assert (gelu_rational.launches, gelu_rational.launches_bwd) == (0, 0)

    def test_other_devices_are_refused(self):
        from vilbert_tpu_torch.ops.gelu import gelu_rational, gelu_rational_bwd

        x = torch.empty(4, 768, device="meta")
        with pytest.raises(ValueError, match="cpu or cuda"):
            gelu_rational(x)
        with pytest.raises(ValueError, match="cpu or cuda"):
            gelu_rational_bwd(x, x)


@pytest.fixture
def fake_dropout_kernels(monkeypatch):
    """The hidden-state dropout's launches with a recording library."""
    from vilbert_tpu_torch.ops.dropout import hash_dropout

    return _fake_library(monkeypatch, hash_dropout, ("bwd",))


class TestHashDropoutKernels:
    """The wrapper of the hidden-state dropout's kernels (``ops/dropout.py``,
    ``csrc/dropout.cu``): the binding, the constants and the dispatch. The
    CPU path and the kernels' arithmetic are held to the int64 chain in
    tests/test_torch_dropout.py; the kernels themselves run on a card
    (chip_smoke.py holds them bit-equal to the chain there)."""

    def test_models_use_the_ops_entry_point(self):
        import vilbert_tpu_torch.models.layers as layers
        from vilbert_tpu_torch.ops import dropout

        assert layers.hash_dropout is dropout.hash_dropout

    def test_entry_points_are_bound(self):
        from vilbert_tpu_torch.ops import _build

        assert _extern_c(_build.CSRC_DIR / "dropout.cu") == {
            name: len(_build._SIGNATURES[name])
            for name in ("vt_hidden_dropout_fwd", "vt_hidden_dropout_bwd")}
        # n, then the offset, seed term and threshold as uint32, the divisor
        assert _build._SIGNATURES["vt_hidden_dropout_fwd"][3:8] == [
            ctypes.c_longlong, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_float]

    def test_hash_constants_are_the_masks(self):
        """``csrc/keep_mask.cuh``'s constants, shared by K1, K2 and the
        hidden-state kernels, are ``ops/dropout.py``'s."""
        import re

        from vilbert_tpu_torch.ops import _build, dropout

        src = (_build.CSRC_DIR / "keep_mask.cuh").read_text()
        found = {k: int(v, 16) for k, v in
                 re.findall(r"constexpr uint32_t (k\w+) = (0x[0-9A-Fa-f]+)u;", src)}
        assert found == {"kGolden": dropout._GOLDEN, "kSeedMul": dropout._SEED_MUL,
                         "kColAdd": dropout._COL_ADD, "kColMul": dropout._COL_MUL}

    @pytest.mark.parametrize("dtype,code,divisor", [(torch.float32, 0, float(np.float32(0.9))),
                                                    (torch.bfloat16, 1, 0.8984375)])
    @pytest.mark.parametrize("backward", [False, True])
    def test_launch(self, fake_dropout_kernels, dtype, code, divisor, backward):
        from vilbert_tpu_torch.ops.dropout import _bwd_cuda, _fwd_cuda, hash_dropout

        x = torch.zeros(3, 7, 1027, dtype=dtype)  # n not a multiple of a vector
        seed, offset = 2 ** 32 - 5, 5 * 2 ** 32 + 3 * 7 * 1027
        y = (_bwd_cuda if backward else _fwd_cuda)(x, 0.1, seed, offset)
        assert y.shape == x.shape and y.dtype == dtype and y.data_ptr() != x.data_ptr()
        ((name, args),) = fake_dropout_kernels.calls
        assert name == ("vt_hidden_dropout_bwd" if backward else "vt_hidden_dropout_fwd")
        assert args == (x.data_ptr(), y.data_ptr(), code, 3 * 7 * 1027, 3 * 7 * 1027,
                        (seed * 0x27D4EB2F) % 2 ** 32, int(0.1 * 2 ** 32), divisor, 0)
        assert (hash_dropout.launches, hash_dropout.launches_bwd) == (
            (0, 1) if backward else (1, 0))

    @pytest.mark.parametrize("case", ["fp16", "fp64", "offset", "strided"])
    @pytest.mark.parametrize("backward", [False, True])
    def test_refuses_before_launch(self, fake_dropout_kernels, case, backward):
        from vilbert_tpu_torch.ops.dropout import (
            _bwd_cuda,
            _fwd_cuda,
            hash_dropout,
            kernel_numel,
        )

        x = {"fp16": torch.zeros(4, 768, dtype=torch.float16),
             "fp64": torch.zeros(4, 768, dtype=torch.float64),
             # 2 bytes off
             "offset": torch.zeros(4 * 768 + 1, dtype=torch.bfloat16)[1:].view(4, 768),
             "strided": torch.zeros(4, 1536, dtype=torch.bfloat16)[:, ::2]}[case]
        with pytest.raises(ValueError):
            kernel_numel(x)
        with pytest.raises(ValueError):
            (_bwd_cuda if backward else _fwd_cuda)(x, 0.1, 1)
        assert fake_dropout_kernels.calls == []
        assert (hash_dropout.launches, hash_dropout.launches_bwd) == (0, 0)
        assert kernel_numel(torch.zeros(4, 768, dtype=torch.bfloat16)) == 4 * 768

    def test_other_devices_are_refused(self):
        from vilbert_tpu_torch.ops.dropout import hash_dropout

        with pytest.raises(ValueError, match="cpu or cuda"):
            hash_dropout(torch.empty(4, 768, device="meta"), 0.1, 1)


class TestBuild:
    def test_library_is_named_by_source_hash(self):
        from vilbert_tpu_torch.ops import _build

        path = _build.library_path()
        assert path == _build.library_path()
        assert path.parent == _build.BUILD_DIR
        assert path.name.startswith("libvilbert_kernels_") and path.suffix == ".so"
        assert {p.name for p in _build.CSRC_DIR.glob("*.cu")} == {
            "attention.cu", "attention_bwd.cu", "attention_bwd_wg.cu", "attention_fwd_wg.cu",
            "dropout.cu", "gelu.cu", "layernorm.cu"}
        assert {p.name for p in _build.CSRC_DIR.glob("*.cuh")} == {
            "keep_mask.cuh", "mma_bf16.cuh", "vectors.cuh", "wgmma_bf16.cuh"}

    def test_missing_nvcc_raises(self, monkeypatch, tmp_path):
        from vilbert_tpu_torch.ops import _build

        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
        monkeypatch.setattr(_build.shutil, "which", lambda _: None)
        monkeypatch.setattr(_build.os.path, "exists", lambda _: False)
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.build()
        assert not (tmp_path / "build").exists()
