"""The port's training ops against the JAX package, on the CPU.

Dropout masks bit for bit (``vilbert_tpu/ops/dropout.py`` and the Pallas
kernels' ``_keep_mask``); the plain twins of the attention forward (K1, with
dropout) and backward (K2) against ``fused_attention_train`` in interpret
mode, given the seed JAX draws from its rng; the K3 entry against
``pallas_attention.fused_attention``; the gradients of ``layer_norm`` and
``gelu_rational`` against ``jax.vjp``. Inputs come from numpy seeds.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_seed(rng):
    """The uint32 seed ``fused_attention_train`` draws from ``rng``."""
    return int(np.asarray(jax.random.bits(rng, (1,), jnp.uint32))[0])


class TestMasks:
    @pytest.mark.parametrize("shape,seed,rate", [
        ((2, 3, 5), 12345, 0.1), ((7, 11), 2 ** 32 - 5, 0.3), ((4, 36, 768), 2 ** 31 + 7, 0.1),
        ((1000,), 0, 0.5), ((3, 37, 1024), 2 ** 31 - 1, 0.9),
    ])
    def test_hash_keep_mask_is_bit_exact(self, shape, seed, rate):
        from vilbert_tpu.ops.dropout import hash_keep_mask as jax_mask
        from vilbert_tpu_torch.ops.dropout import hash_keep_mask

        want = np.asarray(jax_mask(shape, rate, jnp.uint32(seed)))
        np.testing.assert_array_equal(hash_keep_mask(shape, rate, seed).numpy(), want)

    @pytest.mark.parametrize("sq,sk", [(36, 36), (37, 36), (5, 1)])
    @pytest.mark.parametrize("seed", [0, 123456789, 2 ** 31 - 3, 2 ** 31, 2 ** 32 - 1])
    def test_tile_keep_mask_is_bit_exact(self, sq, sk, seed):
        from vilbert_tpu.ops.pallas_attention_train import _keep_mask
        from vilbert_tpu_torch.ops.dropout import tile_keep_mask

        as_int32 = np.array(seed, np.uint32).view(np.int32)
        want = np.asarray(_keep_mask((sq, sk), 0.1, jnp.asarray(as_int32)))
        got = tile_keep_mask(sq, sk, 0.1, torch.tensor([seed]))[0]
        np.testing.assert_array_equal(got.numpy(), want)

    def test_tile_seeds_wrap_as_the_kernel_does(self):
        """seed + program_id * 7919 in int32 wraps past 2^31 (and 2^32 as
        uint32) exactly as the port's tile seeds do."""
        from vilbert_tpu.ops.pallas_attention_train import _keep_mask
        from vilbert_tpu_torch.ops.dropout import attention_keep_mask

        B, h, sq, sk = 3, 4, 6, 7
        for seed in (2 ** 31 - 8000, 2 ** 32 - 20000):
            got = attention_keep_mask(B, h, sq, sk, 0.2, seed).numpy()
            s32 = jnp.asarray(np.array(seed, np.uint32).view(np.int32))
            for bh in range(B * h):
                tile = s32 + jnp.int32(bh) * jnp.int32(7919)
                want = np.asarray(_keep_mask((sq, sk), 0.2, tile))
                np.testing.assert_array_equal(got[bh // h, bh % h], want)

    @pytest.mark.parametrize("jdt,tdt", [(jnp.float32, torch.float32),
                                         (jnp.bfloat16, torch.bfloat16)])
    def test_hash_dropout_is_bit_equal(self, jdt, tdt):
        from vilbert_tpu.ops.dropout import hash_dropout as jax_dropout
        from vilbert_tpu_torch.ops.dropout import hash_dropout

        x = np.random.RandomState(0).randn(4, 9, 48).astype(np.float32) * 3
        for k in range(3):
            rng = jax.random.PRNGKey(k)
            seed = int(np.asarray(jax.random.bits(rng, (), jnp.uint32)))
            want = np.asarray(jax_dropout(jnp.asarray(x, jdt), 0.1, rng), np.float32)
            got = hash_dropout(_t(x).to(tdt), 0.1, seed)
            assert got.dtype == tdt
            np.testing.assert_array_equal(got.float().numpy(), want)

    def test_keep_rate(self):
        from vilbert_tpu_torch.ops.dropout import attention_keep_mask, hash_keep_mask

        assert abs(hash_keep_mask((1000, 1000), 0.1, 7).float().mean().item() - 0.9) < 0.005
        m = attention_keep_mask(64, 12, 36, 36, 0.1, 2 ** 32 - 1)  # ~1e6 elements
        assert abs(m.float().mean().item() - 0.9) < 0.005


def _kernel_keep(n, rate, seed, offset):
    """``csrc/dropout.cu``'s mask in numpy uint32, as the kernel computes it:
    the flat index cut to uint32 plus the offset, wrapping; the seed term and
    the threshold from the host's arithmetic."""
    from vilbert_tpu_torch.ops.dropout import keep_threshold

    index = np.arange(n, dtype=np.int64).astype(np.uint32) + np.uint32(offset & 0xFFFFFFFF)
    x = (index * np.uint32(0x9E3779B1)) ^ np.uint32((seed * 0x27D4EB2F) & 0xFFFFFFFF)
    x ^= x >> np.uint32(16)
    x *= np.uint32(0x85EBCA6B)
    x ^= x >> np.uint32(13)
    x *= np.uint32(0xC2B2AE35)
    x ^= x >> np.uint32(16)
    return x >= np.uint32(keep_threshold(rate))


def _kernel_dropout(x, rate, seed, offset):
    """The kernels' pass over x (or a cotangent): kept elements divided by
    the divisor in fp32 and rounded once to x's dtype, dropped ones +0."""
    from vilbert_tpu_torch.ops.dropout import _divisor

    keep = _kernel_keep(x.numel(), rate, seed, offset).reshape(tuple(x.shape))
    with np.errstate(invalid="ignore"):  # NaN in, NaN out
        q = x.float().numpy() / np.float32(_divisor(rate, x.dtype))
    return torch.from_numpy(np.where(keep, q, np.float32(0))).to(x.dtype)


class TestKernelTwin:
    """The arithmetic of ``csrc/dropout.cu`` in numpy uint32 against the
    int64 chain (``hash_keep_mask``, ``hash_dropout_ref``), and the
    ``hash_dropout`` entry point on CPU tensors against that chain."""

    @pytest.mark.parametrize("rate", [0.1, 0.5, 2.0 ** -32, 1 - 2.0 ** -32, 0.0])
    @pytest.mark.parametrize("seed,offset", [(0, 0), (2 ** 32 - 1, 2 ** 32 - 700),
                                             (2 ** 31 + 7, 3 * 2 ** 32 + 17),
                                             (123456789, 5 * 4 * 36 * 48)])
    def test_uint32_twin_is_hash_keep_mask(self, rate, seed, offset):
        from vilbert_tpu_torch.ops.dropout import hash_keep_mask, keep_threshold

        shape = (4, 36, 48)
        want = hash_keep_mask(shape, rate, seed, offset=offset).numpy()
        np.testing.assert_array_equal(_kernel_keep(4 * 36 * 48, rate, seed, offset).reshape(shape),
                                      want)
        # the thresholds' edges: keep every hash, all but 0, only 2^32 - 1
        assert keep_threshold(rate) in (0, 1, 2 ** 32 - 1) or 0.4 < want.mean() < 0.95
        if keep_threshold(rate) == 0:
            assert want.all()
        elif keep_threshold(rate) == 1:
            assert want.mean() > 0.999
        elif keep_threshold(rate) == 2 ** 32 - 1:
            assert want.mean() < 1e-3

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("rate", [0.1, 0.5])
    def test_uint32_twin_divides_as_the_chain(self, dtype, rate):
        """Every bf16 pattern (NaN, infinities, signed zeros, subnormals)
        through the kernels' arithmetic equals the chain bit for bit."""
        from vilbert_tpu_torch.ops.dropout import hash_dropout_ref

        x = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
        x = x.to(dtype)
        seed, offset = 2 ** 32 - 3, 2 ** 32 - 30000
        got, want = _kernel_dropout(x, rate, seed, offset), hash_dropout_ref(x, rate, seed, offset)
        ints = {torch.bfloat16: torch.int16, torch.float32: torch.int32}[dtype]
        same = (got.view(ints) == want.view(ints)) | (got.isnan() & want.isnan())
        assert bool(same.all())

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("offset", [0, 2 ** 32 - 100])
    def test_entry_point_is_the_chain_forward_and_backward(self, dtype, offset, monkeypatch):
        from vilbert_tpu_torch.ops.dropout import hash_dropout, hash_dropout_ref

        monkeypatch.setattr(hash_dropout, "launches", 0)
        monkeypatch.setattr(hash_dropout, "launches_bwd", 0)
        rng = np.random.RandomState(3)
        x = _t(rng.randn(4, 9, 48).astype(np.float32) * 3).to(dtype).requires_grad_()
        g = _t(rng.randn(4, 9, 48).astype(np.float32)).to(dtype)
        seed = 2 ** 31 + 11
        y = hash_dropout(x, 0.1, seed, offset)
        assert y.grad_fn.saved_tensors == ()  # the mask is recomputed, not saved
        (dx,) = torch.autograd.grad(y, x, g)
        x2 = x.detach().clone().requires_grad_()
        y2 = hash_dropout_ref(x2, 0.1, seed, offset)
        (dx2,) = torch.autograd.grad(y2, x2, g)
        assert torch.equal(y.detach(), y2.detach()) and torch.equal(dx, dx2)
        assert torch.equal(dx, hash_dropout_ref(g, 0.1, seed, offset))
        assert y.dtype == dx.dtype == dtype
        assert torch.equal(y.detach(), _kernel_dropout(x.detach(), 0.1, seed, offset))
        assert (hash_dropout.launches, hash_dropout.launches_bwd) == (0, 0)

    def test_rate_zero_is_the_identity(self):
        from vilbert_tpu_torch.ops.dropout import hash_dropout

        x = torch.randn(3, 5)
        assert hash_dropout(x, 0.0, 7) is x


def _attention_inputs(B, sq, sk, H, seed=0):
    rng = np.random.RandomState(seed)
    q, g = (rng.randn(B, sq, H).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(B, sk, H).astype(np.float32) for _ in range(2))
    mask = np.ones((B, sk), np.int32)
    mask[0, -2:] = 0   # padded keys
    mask[-1, :] = 0    # a fully padded row: uniform over -10000 biases
    return q, k, v, g, mask


#: (Sq, Sk) past 128 keys: Visual7w image self and text->image,
#: GuessWhatPointing's two co-attention directions, one query over 512 keys
LONG_FORWARD_SHAPES = [(200, 200), (21, 200), (257, 306), (306, 257), (1, 512)]


class TestAttentionTwins:
    """The plain twins (and the autograd entry on the CPU) within 1e-5 of
    ``fused_attention_train`` and its ``jax.vjp``, at fp32."""

    @pytest.mark.parametrize("rate", [0.0, 0.1])
    @pytest.mark.parametrize("sq,sk,h,d", [(5, 5, 4, 8), (6, 9, 2, 8), (9, 4, 2, 16)])
    def test_forward_and_vjp_match_pallas(self, rate, sq, sk, h, d):
        from vilbert_tpu.ops.pallas_attention_train import fused_attention_train
        from vilbert_tpu_torch.ops.attention import (
            attention,
            attention_bwd_ref,
            attention_ref,
            make_additive_mask,
        )

        B = 3
        q, k, v, g, mask = _attention_inputs(B, sq, sk, h * d)
        bias = make_additive_mask(_t(mask))
        rng = jax.random.PRNGKey(sq * 100 + sk)
        seed = _jax_seed(rng) if rate else None

        def jax_fn(q_, k_, v_):
            return fused_attention_train(q_, k_, v_, jnp.asarray(bias.numpy()), num_heads=h,
                                         dropout_rate=rate, dropout_rng=rng, interpret=True)

        want, vjp = jax.vjp(jax_fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        want_grads = vjp(jnp.asarray(g))
        kw = dict(num_heads=h, dropout_rate=rate, seed=seed)
        np.testing.assert_allclose(attention_ref(_t(q), _t(k), _t(v), bias, **kw).numpy(),
                                   np.asarray(want), atol=1e-5, rtol=1e-5)
        got_grads = attention_bwd_ref(_t(q), _t(k), _t(v), bias, _t(g), **kw)
        for name, got, w in zip("qkv", got_grads, want_grads):
            np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5,
                                       err_msg=f"d{name}")
        # the differentiable entry runs the same twins on the CPU
        qt, kt, vt = (_t(a).requires_grad_() for a in (q, k, v))
        out = attention(qt, kt, vt, bias, **kw)
        out.backward(_t(g))
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
        for t, w in zip((qt, kt, vt), got_grads):
            assert torch.equal(t.grad, w)

    @pytest.mark.parametrize("rate", [0.0, 0.1])
    @pytest.mark.parametrize("d", [64, 128])
    @pytest.mark.parametrize("sq,sk", [(200, 200), (21, 200), (257, 306), (306, 257)])
    def test_long_backward_matches_pallas(self, sq, sk, d, rate):
        """The backward twin past 128 keys or queries, where the kernel runs
        its long-sequence variant (Visual7w, GuessWhatPointing), against
        the VJP of ``fused_attention_train``, which takes a whole (batch,
        head) at any length."""
        from vilbert_tpu.ops.pallas_attention_train import fused_attention_train
        from vilbert_tpu_torch.ops.attention import attention_bwd_ref, make_additive_mask

        B, h = 2, 1
        q, k, v, g, mask = _attention_inputs(B, sq, sk, h * d, seed=sq + sk)
        # half the keys of the last row padded, not all: at -10000 fp32
        # spacing is 2^-10, where the two matmuls' summation orders round
        # scores apart (the fully padded row is held at the short shapes)
        mask[-1, : sk - sk // 2] = 1
        bias = make_additive_mask(_t(mask))
        rng = jax.random.PRNGKey(sq * 1000 + sk)
        seed = _jax_seed(rng) if rate else None
        _, vjp = jax.vjp(
            lambda q_, k_, v_: fused_attention_train(
                q_, k_, v_, jnp.asarray(bias.numpy()), num_heads=h, dropout_rate=rate,
                dropout_rng=rng, interpret=True),
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        got = attention_bwd_ref(_t(q), _t(k), _t(v), bias, _t(g), num_heads=h,
                                dropout_rate=rate, seed=seed)
        for name, a, w in zip("qkv", got, vjp(jnp.asarray(g))):
            np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5,
                                       err_msg=f"d{name}")

    @pytest.mark.parametrize("rate", [0.0, 0.1])
    @pytest.mark.parametrize("d", [64, 128])
    @pytest.mark.parametrize("sq,sk", LONG_FORWARD_SHAPES)
    def test_long_forward_matches_pallas(self, sq, sk, d, rate):
        """The forward twin past 128 keys, where the kernel runs its
        ``long_tc`` variant (Visual7w, GuessWhatPointing, and one query over
        512 keys), against ``fused_attention_train``."""
        from vilbert_tpu.ops.pallas_attention_train import fused_attention_train
        from vilbert_tpu_torch.ops.attention import attention_ref, make_additive_mask

        B, h = 2, 1
        q, k, v, _, mask = _attention_inputs(B, sq, sk, h * d, seed=sq + sk + 1)
        mask[-1, : sk - sk // 2] = 1  # half padded, as in the backward's long cases
        bias = make_additive_mask(_t(mask))
        rng = jax.random.PRNGKey(sq * 1000 + sk + 1)
        seed = _jax_seed(rng) if rate else None
        want = fused_attention_train(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     jnp.asarray(bias.numpy()), num_heads=h, dropout_rate=rate,
                                     dropout_rng=rng, interpret=True)
        got = attention_ref(_t(q), _t(k), _t(v), bias, num_heads=h, dropout_rate=rate, seed=seed)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)

    def test_dropout_changes_the_output_and_seeds_differ(self):
        from vilbert_tpu_torch.ops.attention import attention_ref

        q, k, v, _, _ = _attention_inputs(2, 8, 8, 32)
        a = attention_ref(_t(q), _t(k), _t(v), None, num_heads=4)
        b = attention_ref(_t(q), _t(k), _t(v), None, num_heads=4, dropout_rate=0.1, seed=1)
        c = attention_ref(_t(q), _t(k), _t(v), None, num_heads=4, dropout_rate=0.1, seed=2)
        assert not torch.equal(a, b) and not torch.equal(b, c)

    @pytest.mark.parametrize("sq,sk,h,d,masked", [(9, 9, 4, 8, True), (12, 7, 2, 16, True),
                                                  (8, 8, 2, 8, False)])
    def test_fused_attention_matches_k3(self, sq, sk, h, d, masked):
        """The K3 entry against ``pallas_attention.fused_attention`` (the
        cases of tests/test_pallas_ops.py): forward and ``jax.vjp``."""
        from vilbert_tpu.ops.pallas_attention import fused_attention as jax_fused
        from vilbert_tpu_torch.ops.attention import fused_attention, make_additive_mask

        B = 3
        q, k, v, g, mask = _attention_inputs(B, sq, sk, h * d, seed=1)
        mask[:, -2:] = 0
        bias = make_additive_mask(_t(mask)) if masked else None
        jbias = None if bias is None else jnp.asarray(bias.numpy())
        want, vjp = jax.vjp(lambda a, b, c: jax_fused(a, b, c, jbias, num_heads=h, interpret=True),
                            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        qt, kt, vt = (_t(a).requires_grad_() for a in (q, k, v))
        out = fused_attention(qt, kt, vt, bias, num_heads=h)
        out.backward(_t(g))
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
        for name, t, w in zip("qkv", (qt, kt, vt), vjp(jnp.asarray(g))):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5,
                                       err_msg=f"d{name}")


def _bf16_close(got, want):
    """Within one bf16 rounding (2^-7 relative) of the larger magnitude."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, atol=2 ** -7 * np.abs(want).max(), rtol=2 ** -7)


def _long_tc_walk(q, k, v, bias, *, num_heads, dropout_rate=0.0, seed=None, pad=-np.inf):
    """The arithmetic of the tensor-core K1 past 128 keys (``ltc::`` in
    ``csrc/attention.cu``) in PyTorch: bf16 q, k, v; fp32 scores; the keys
    in softmax steps of 32 at d = 128 and 64 at d = 64 (the kernel's
    ``kStep``; its tiles of 64 split into steps), the last step's keys
    past Sk scored ``pad``; an online row max m and row sum l of the
    UNDROPPED exps; exp(s - m) rescaled as m grows, dropped, rounded to bf16
    before P V; O (1/(1 - rate)) / l at the end, rounded to bf16."""
    from vilbert_tpu_torch.ops.attention import _bias_rows, _heads, _merge
    from vilbert_tpu_torch.ops.dropout import attention_keep_mask

    B, sq, H = q.shape
    sk, d = k.shape[1], H // num_heads
    tile = 32 if d == 128 else 64
    qh, kh, vh = (_heads(t, num_heads) for t in (q, k, v))
    bias_rows = _bias_rows(bias, q, sk)
    keep = attention_keep_mask(B, num_heads, sq, sk, dropout_rate, seed) if dropout_rate else None
    m = torch.full((B, num_heads, sq, 1), -np.inf)
    l = torch.zeros(B, num_heads, sq, 1)
    o = torch.zeros(B, num_heads, sq, d)
    for k0 in range(0, sk, tile):
        n = min(tile, sk - k0)
        s = (qh @ kh[:, :, k0:k0 + n].transpose(-1, -2)) * (1.0 / np.sqrt(d)) \
            + bias_rows[:, None, None, k0:k0 + n]
        s = torch.cat([s, torch.full((B, num_heads, sq, tile - n), pad)], -1)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        c = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * c + p.sum(-1, keepdim=True)
        p = p[..., :n]
        if keep is not None:
            p = torch.where(keep[..., k0:k0 + n], p, 0.0)
        o = o * c + p.to(torch.bfloat16).float() @ vh[:, :, k0:k0 + n]
        m = m_new
    return _merge(o * ((1.0 / (1.0 - dropout_rate)) / l), torch.bfloat16)


def _bf16_bound(ref) -> float:
    """chip_smoke.py's bf16 bound: one bf16 rounding of max|ref| plus one
    bf16 ulp of it."""
    top = float(ref.float().abs().max())
    return 2.0 ** -7 * top + 2.0 ** (np.floor(np.log2(top)) - 7)


class TestLongTensorCoreWalk:
    """The tiled walk of the tensor-core K1 past 128 keys, emulated in
    PyTorch, against the plain twin within chip_smoke.py's bf16 bound: the
    kernel's rounding (exp(s - running max) to bf16 before 1/l) and tiling
    checked here, where the kernel cannot run. The last batch row is fully
    padded: every key at -10000, none past Sk."""

    @pytest.mark.parametrize("rate", [0.0, 0.1])
    @pytest.mark.parametrize("d", [64, 128])
    @pytest.mark.parametrize("sq,sk", LONG_FORWARD_SHAPES)
    def test_walk_matches_plain_within_bf16(self, sq, sk, d, rate):
        from vilbert_tpu_torch.ops.attention import attention_ref, make_additive_mask

        B, h = 2, 2
        q, k, v, _, mask = _attention_inputs(B, sq, sk, h * d, seed=sq * 7 + sk)
        q, k, v = (_t(a).to(torch.bfloat16) for a in (q, k, v))
        bias = make_additive_mask(_t(mask))
        kw = dict(num_heads=h, dropout_rate=rate, seed=2 ** 31 + sq if rate else None)
        got = _long_tc_walk(q, k, v, bias, **kw)
        want = attention_ref(q, k, v, bias, **kw)
        assert got.dtype == want.dtype == torch.bfloat16 and got.shape == want.shape
        err = float((got.float() - want.float()).abs().max())
        assert err <= _bf16_bound(want), (err, _bf16_bound(want))

    def test_keys_past_sk_need_minus_inf(self):
        """Scoring the last tile's keys past Sk at the padding bias (-10000)
        instead of -inf would let a fully padded row (every score near
        -10000) spread its softmax over 256 keys, not 200: outside the
        bound."""
        from vilbert_tpu_torch.ops.attention import attention_ref, make_additive_mask

        q, k, v, _, mask = _attention_inputs(2, 21, 200, 64)
        q, k, v = (_t(a).to(torch.bfloat16) for a in (q, k, v))
        bias = make_additive_mask(_t(mask))
        want = attention_ref(q, k, v, bias, num_heads=1)
        bad = _long_tc_walk(q, k, v, bias, num_heads=1, pad=-10000.0)
        assert float((bad[-1].float() - want[-1].float()).abs().max()) > _bf16_bound(want)
        good = _long_tc_walk(q, k, v, bias, num_heads=1)
        assert float((good.float() - want.float()).abs().max()) <= _bf16_bound(want)


class TestGradients:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("with_residual", [False, True])
    def test_layer_norm_vjp(self, dtype, with_residual, rng_np):
        """fp32: within 1e-5; bf16: within one bf16 rounding (both sides
        compute in fp32 and round the results to bf16)."""
        from vilbert_tpu.ops.pallas_layernorm import fused_layer_norm
        from vilbert_tpu_torch.ops.layernorm import layer_norm

        jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
        x = rng_np.randn(3, 7, 32).astype(np.float32) * 3 + 1
        res = rng_np.randn(3, 7, 32).astype(np.float32)
        w = rng_np.randn(32).astype(np.float32)
        b = rng_np.randn(32).astype(np.float32)
        g = rng_np.randn(3, 7, 32).astype(np.float32)

        def jax_fn(x_, r_, w_, b_):
            return fused_layer_norm(x_, w_, b_, residual=r_ if with_residual else None,
                                    interpret=True)

        primals = (jnp.asarray(x, jdt), jnp.asarray(res, jdt), jnp.asarray(w), jnp.asarray(b))
        want, vjp = jax.vjp(jax_fn, *primals)
        want_grads = vjp(jnp.asarray(g, jdt))
        xt = _t(x).to(tdt).requires_grad_()
        rt = _t(res).to(tdt).requires_grad_()
        wt, bt = _t(w).requires_grad_(), _t(b).requires_grad_()
        out = layer_norm(xt, wt, bt, residual=rt if with_residual else None)
        out.backward(_t(g).to(tdt))
        names = ("x", "residual", "weight", "bias")
        pairs = [(out, want)] + [(t.grad, wg) for t, wg in zip((xt, rt, wt, bt), want_grads)]
        if not with_residual:
            assert rt.grad is None
            pairs.pop(2)
            names = ("x", "weight", "bias")
        for name, (got, w_) in zip(("out",) + names, pairs):
            got = got.detach().float().numpy()
            if dtype == "float32":
                np.testing.assert_allclose(got, np.asarray(w_), atol=1e-5, rtol=1e-5,
                                           err_msg=name)
            else:
                _bf16_close(got, w_)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_gelu_rational_vjp(self, dtype):
        """The custom derivative: fp32 within 1e-6; bf16 within one bf16
        rounding (``dgelu.astype(x.dtype) * dx`` rounds twice in bf16)."""
        from vilbert_tpu.models.layers import gelu_rational as jax_gelu
        from vilbert_tpu_torch.models.layers import gelu_rational

        jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
        x = np.linspace(-7, 7, 2001).astype(np.float32)
        g = np.random.RandomState(0).randn(2001).astype(np.float32)
        want, vjp = jax.vjp(jax_gelu, jnp.asarray(x, jdt))
        (want_dx,) = vjp(jnp.asarray(g, jdt))
        xt = _t(x).to(tdt).requires_grad_()
        out = gelu_rational(xt)
        out.backward(_t(g).to(tdt))
        assert xt.grad.dtype == tdt
        if dtype == "float32":
            np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx), atol=1e-6, rtol=1e-6)
        else:
            _bf16_close(xt.grad.float().numpy(), want_dx)
            _bf16_close(out.detach().float().numpy(), want)

    def test_gelu_constants_are_the_jax_modules(self):
        import vilbert_tpu.models.layers as jax_layers
        import vilbert_tpu_torch.models.layers as port_layers

        for name in ("_ERF_P", "_ERF_Q", "_DGELU_P", "_DGELU_Q"):
            assert getattr(port_layers, name) == getattr(jax_layers, name), name
