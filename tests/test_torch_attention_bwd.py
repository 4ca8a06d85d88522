"""The wgmma attention backward (K2's ``"wg"`` variant) against the JAX
package, on the CPU.

The kernel (``vilbert_tpu_torch/csrc/attention_bwd_wg.cu``) runs only on a
card, so its walk is emulated here in PyTorch and held to the VJP of
``fused_attention_train`` (Pallas in interpret mode) within chip_smoke.py's
bf16 bound: query tiles of 64 and key tiles of 64 (32 in the dq kernel at
d = 128), the last one narrowed to its rows rounded up to 16, P from the
forward's row log-sum-exp, D = rowsum(g O) in the dq kernel and the walk's
rowsum(dp P) in the dkdv kernel, P_drop and ds rounded to bf16 as wgmma
operands, the mask at each element's global (query, key) with the tile
seed. Two identities the design rests on are checked in fp32, and the
wrapper's dispatch to the C entry runs against a recording library. Inputs
come from numpy seeds.
"""

import contextlib
import math
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

LOG2E = 1.4426950408889634
TILE = 64


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_seed(rng):
    """The uint32 seed ``fused_attention_train`` draws from ``rng``."""
    return int(np.asarray(jax.random.bits(rng, (1,), jnp.uint32))[0])


def _bf16(a):
    """numpy fp32 values rounded to bf16 (what the kernel reads)."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _inputs(B, sq, sk, H, seed):
    """bf16-valued q, g [B, Sq, H], k, v [B, Sk, H] and a key mask with
    padded keys and a fully padded last batch row."""
    rng = np.random.RandomState(seed)
    q, g = (_bf16(rng.randn(B, sq, H).astype(np.float32)) for _ in range(2))
    k, v = (_bf16(rng.randn(B, sk, H).astype(np.float32)) for _ in range(2))
    mask = np.ones((B, sk), np.int32)
    mask[0, -(sk // 3):] = 0
    mask[-1, :] = 0
    return q, k, v, g, mask


def _scores(q, k, bias_rows, num_heads):
    """fp32 q k^T / sqrt(d) + bias [B, h, Sq, Sk], rounded after the product
    and after the sum, as the port's ``_probs`` computes them."""
    from vilbert_tpu_torch.ops.attention import _heads

    d = q.shape[-1] // num_heads
    s = _heads(q, num_heads) @ _heads(k, num_heads).transpose(-1, -2)
    return s * (1.0 / math.sqrt(d)) + bias_rows[:, None, None, :]


def _rows16(n):
    return (n + 15) // 16 * 16


def _pad_rows(x, n):
    """[..., m, d] zero-padded to n rows (the zero-filled tile rows)."""
    return torch.cat([x, x.new_zeros(*x.shape[:-2], n - x.shape[-2], x.shape[-1])], -2)


def _wg_walk(q, k, v, bias, g, out, lse, *, num_heads, dropout_rate=0.0, seed=None):
    """The arithmetic of ``attention_bwd_wg.cu`` in PyTorch, from bf16 q, k,
    v, g, the forward's bf16 output ``out`` and fp32 row log-sum-exps
    ``lse`` [B, h, Sq]:

    dq kernel: query tiles of 64; D = rowsum(g O) in fp32 and L log2(e);
    per key tile (64 keys, 32 at d = 128; the last one's rows rounded up to
    16, zero-filled, bias -inf past Sk) S = Q K^T and dP = G V^T in fp32, P = 2^(s scale log2(e)
    + bias log2(e) - L log2(e)), dp masked and rescaled at the global
    (query, key), ds = P (dp - D) rounded to bf16, dQ += ds K; the walk's
    rowsum(dp P) is the D of the dkdv kernel. dkdv kernel: key tiles of 64;
    per query tile (the last narrowed likewise, L = +inf and D = 0 past Sq)
    S^T = K Q^T and dP^T = V G^T, P_drop^T and ds^T rounded to bf16, dV +=
    P_drop^T G, dK += ds^T Q. dq and dk times 1/sqrt(d); all three in bf16.
    """
    from vilbert_tpu_torch.ops.attention import _bias_rows, _heads, _merge
    from vilbert_tpu_torch.ops.dropout import attention_keep_mask

    B, sq, H = q.shape
    sk, d = k.shape[1], H // num_heads
    scale = 1.0 / math.sqrt(d)
    qh, kh, vh, gh, oh = (_heads(t, num_heads) for t in (q, k, v, g, out))
    bias_rows = _bias_rows(bias, q, sk)
    keep = (attention_keep_mask(B, num_heads, sq, sk, dropout_rate, seed)
            if dropout_rate else None)
    inv_keep = 1.0 / (1.0 - dropout_rate)
    lse2 = lse * LOG2E
    dd = (gh * oh).sum(-1)  # the dq kernel's D, fp32
    dd_walk = torch.zeros_like(dd)  # the dkdv kernel's

    def drop(x, q0, nq, k0, nk, transposed=False):
        if keep is None:
            return x
        kp = keep[:, :, q0:q0 + nq, k0:k0 + nk]
        kp = kp.transpose(-1, -2) if transposed else kp
        return torch.where(kp, x * inv_keep, 0.0)

    dq = torch.zeros(B, num_heads, sq, d)
    key_tile = 32 if d == 128 else TILE
    for q0 in range(0, sq, TILE):
        nq = min(TILE, sq - q0)
        rows = slice(q0, q0 + nq)
        for k0 in range(0, sk, key_tile):
            nk = min(key_tile, sk - k0)
            n = _rows16(nk)
            kt = _pad_rows(kh[:, :, k0:k0 + nk], n)
            vt = _pad_rows(vh[:, :, k0:k0 + nk], n)
            bt = torch.cat([bias_rows[:, k0:k0 + nk], torch.full((B, n - nk), -math.inf)], -1)
            s = qh[:, :, rows] @ kt.transpose(-1, -2)
            dp = gh[:, :, rows] @ vt.transpose(-1, -2)
            p = torch.exp2(s * (scale * LOG2E) + bt[:, None, None, :] * LOG2E
                           - lse2[:, :, rows, None])
            dp = torch.cat([drop(dp[..., :nk], q0, nq, k0, nk), dp[..., nk:]], -1)
            dd_walk[:, :, rows] += (p * dp).sum(-1)
            ds = (p * (dp - dd[:, :, rows, None])).to(torch.bfloat16).float()
            dq[:, :, rows] += ds @ kt
    dk = torch.zeros(B, num_heads, sk, d)
    dv = torch.zeros(B, num_heads, sk, d)
    for k0 in range(0, sk, TILE):
        nk = min(TILE, sk - k0)
        keys = slice(k0, k0 + nk)
        for q0 in range(0, sq, TILE):
            nq = min(TILE, sq - q0)
            n = _rows16(nq)
            qt = _pad_rows(qh[:, :, q0:q0 + nq], n)
            gt = _pad_rows(gh[:, :, q0:q0 + nq], n)
            lt = torch.cat([lse2[:, :, q0:q0 + nq], torch.full((B, num_heads, n - nq), math.inf)],
                           -1)
            dt = torch.cat([dd_walk[:, :, q0:q0 + nq], torch.zeros(B, num_heads, n - nq)],
                           -1)
            st = kh[:, :, keys] @ qt.transpose(-1, -2)
            dpt = vh[:, :, keys] @ gt.transpose(-1, -2)
            p = torch.exp2(st * (scale * LOG2E) + bias_rows[:, None, keys, None] * LOG2E
                           - lt[:, :, None])
            pd = torch.cat([drop(p[..., :nq], q0, nq, k0, nk, True), p[..., nq:]], -1)
            dpt = torch.cat([drop(dpt[..., :nq], q0, nq, k0, nk, True), dpt[..., nq:]], -1)
            ds = p * (dpt - dt[:, :, None])
            dv[:, :, keys] += pd.to(torch.bfloat16).float() @ gt
            dk[:, :, keys] += ds.to(torch.bfloat16).float() @ qt
    return (_merge(dq * scale, torch.bfloat16), _merge(dk * scale, torch.bfloat16),
            _merge(dv, torch.bfloat16))


def _bf16_bound(ref) -> float:
    """chip_smoke.py's bf16 bound: one bf16 rounding of max|ref| plus one
    bf16 ulp of it."""
    top = float(np.abs(ref).max())
    return 2.0 ** -7 * top + 2.0 ** (np.floor(np.log2(top)) - 7)


def _jax_fwd_vjp(q, k, v, g, bias, *, num_heads, rate, rng):
    """``fused_attention_train`` (interpret mode) at fp32: its output and
    the VJP of g."""
    from vilbert_tpu.ops.pallas_attention_train import fused_attention_train

    out, vjp = jax.vjp(
        lambda q_, k_, v_: fused_attention_train(
            q_, k_, v_, jnp.asarray(bias.numpy()), num_heads=num_heads, dropout_rate=rate,
            dropout_rng=rng, interpret=True),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(x) for x in vjp(jnp.asarray(g))]


#: Visual7w text->image and image self, GuessWhatPointing text->image,
#: the baseline's retrieval pairs and GuessWhatPointing (one sequence)
WALK_SHAPES = [(21, 200), (200, 200), (257, 306), (131, 131), (562, 562)]


class TestWgWalk:
    """The emulated walk of the wgmma K2 against the VJP of
    ``fused_attention_train`` within chip_smoke.py's bf16 bound, each
    gradient on its own; the last batch row's keys are all padded."""

    @pytest.mark.parametrize("rate", [0.0, 0.1])
    @pytest.mark.parametrize("d", [64, 128])
    @pytest.mark.parametrize("sq,sk", WALK_SHAPES)
    def test_walk_matches_jax_vjp(self, sq, sk, d, rate):
        from vilbert_tpu_torch.ops.attention import make_additive_mask

        B, h = 2, 1
        q, k, v, g, mask = _inputs(B, sq, sk, h * d, seed=sq * 3 + sk + d)
        bias = make_additive_mask(_t(mask))
        rng = jax.random.PRNGKey(sq * 1000 + sk)
        seed = _jax_seed(rng) if rate else None
        out, want = _jax_fwd_vjp(q, k, v, g, bias, num_heads=h, rate=rate, rng=rng)
        lse = torch.logsumexp(_scores(_t(q), _t(k), bias.reshape(B, sk), h), -1)
        bf = (lambda a: _t(a).to(torch.bfloat16))
        got = _wg_walk(bf(q), bf(k), bf(v), bias, bf(g), bf(out), lse, num_heads=h,
                       dropout_rate=rate, seed=seed)
        for name, a, w in zip("qkv", got, want):
            assert a.dtype == torch.bfloat16 and a.shape == w.shape
            err = float(np.abs(a.float().numpy() - w).max())
            assert err <= _bf16_bound(w), (f"d{name}", err, _bf16_bound(w))


class TestIdentities:
    """What lets the kernel skip the walk over the row: fp32, against the
    JAX package's ``_probs`` and ``_keep_mask``."""

    @pytest.mark.parametrize("sq,sk", [(7, 9), (21, 200)])
    def test_lse_gives_the_probs(self, sq, sk):
        """exp(s - L), L = logsumexp of the scores, is ``_probs``'s P. On
        the fully padded batch row the scores and L sit near -10000, where
        fp32 spacing is 2^-10: L's own rounding moves each P by up to that
        much relative (``_probs`` subtracts the max, exact there)."""
        from vilbert_tpu.ops.pallas_attention_train import _probs
        from vilbert_tpu_torch.ops.attention import make_additive_mask

        B, d = 2, 16
        q, k, _, _, mask = _inputs(B, sq, sk, d, seed=sq + sk)
        bias = make_additive_mask(_t(mask)).reshape(B, sk)
        s = _scores(_t(q), _t(k), bias, 1)[:, 0]
        lse = torch.logsumexp(s, -1)
        for b in range(B):
            want = np.asarray(_probs(jnp.asarray(q[b][None]), jnp.asarray(k[b][None]),
                                     jnp.asarray(bias[b].numpy()[None, None]),
                                     1.0 / math.sqrt(d)))
            np.testing.assert_allclose(torch.exp(s[b] - lse[b, :, None]).numpy(), want,
                                       rtol=2.0 ** -10 if b == B - 1 else 2e-5, atol=1e-7)

    @pytest.mark.parametrize("rate", [0.0, 0.1])
    def test_d_from_the_output(self, rate):
        """rowsum(dp P) = rowsum(g O) with O = P_drop v, under dropout too
        (dp = keep ? g v^T / (1 - rate) : 0, P undropped), O from
        ``fused_attention_train``."""
        from vilbert_tpu.ops.pallas_attention_train import _keep_mask, _probs
        from vilbert_tpu_torch.ops.attention import make_additive_mask

        B, sq, sk, d = 2, 13, 37, 32
        q, k, v, g, mask = _inputs(B, sq, sk, d, seed=11)
        bias = make_additive_mask(_t(mask))
        rng = jax.random.PRNGKey(7)
        seed = _jax_seed(rng) if rate else 0
        out, _ = _jax_fwd_vjp(q, k, v, g, bias, num_heads=1, rate=rate, rng=rng)
        for b in range(B):
            p = np.asarray(_probs(jnp.asarray(q[b][None]), jnp.asarray(k[b][None]),
                                  jnp.asarray(bias.reshape(B, sk)[b].numpy()[None, None]),
                                  1.0 / math.sqrt(d)))
            dp = g[b] @ v[b].T
            if rate:
                tile_seed = np.array(seed + b * 7919, np.uint32).view(np.int32)
                keep = np.asarray(_keep_mask((sq, sk), rate, jnp.asarray(tile_seed)))
                dp = np.where(keep, dp / (1.0 - rate), 0.0)
            np.testing.assert_allclose((g[b] * out[b]).sum(-1), (dp * p).sum(-1),
                                       rtol=1e-4, atol=1e-5)


class _Recorder:
    """Stands in for the kernels' ctypes library: records each entry point's
    arguments and returns cudaSuccess, so the wrapper's dispatch runs on CPU
    tensors."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("vt_"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.fixture
def recorder(monkeypatch):
    """A recording library in place of the kernels', no CUDA stream, both
    wrappers' counters at 0 (restored after the test)."""
    from vilbert_tpu_torch.ops import _build
    from vilbert_tpu_torch.ops.attention import (
        BWD_VARIANTS,
        VARIANTS,
        attention,
        attention_bwd,
    )

    for wrapper, variants in ((attention, VARIANTS), (attention_bwd, BWD_VARIANTS)):
        for counter in ("launches", *(f"launches_{v}" for v in variants)):
            monkeypatch.setattr(wrapper, counter, 0)
    lib = _Recorder()
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda _: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    return lib


def _operands(B, sq, sk, H, dtype=torch.bfloat16):
    q = torch.zeros(B, sq, H, dtype=dtype)
    k, v = torch.zeros(B, sk, H, dtype=dtype), torch.zeros(B, sk, H, dtype=dtype)
    return q, k, v, torch.zeros(B, sk), torch.zeros(B, sq, H, dtype=dtype)


class TestWgDispatch:
    """What ``_bwd_cuda`` hands ``vt_attention_bwd_wg`` (the kernel itself
    runs on a card)."""

    @pytest.mark.parametrize("sq,sk,H,heads", [(200, 200, 1024, 8), (21, 200, 1024, 8),
                                               (562, 562, 768, 12), (131, 131, 768, 12)])
    def test_arguments_and_counters(self, recorder, sq, sk, H, heads):
        from vilbert_tpu_torch.ops.attention import _bwd_cuda, attention_bwd

        q, k, v, bias, g = _operands(2, sq, sk, H)
        out = torch.zeros_like(q)
        lse = torch.zeros(2, heads, sq)
        dq, dk, dv = _bwd_cuda(q, k, v, bias, g, heads, 0.1, 2 ** 31 + 5, "wg", out, lse)
        assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
        assert (attention_bwd.launches, attention_bwd.launches_wg) == (1, 1)
        (name, args), = recorder.calls
        assert name == "vt_attention_bwd_wg"
        # q, k, v, bias, g, out, lse, dq, dk, dv, workspace
        assert args[5] == out.data_ptr() and args[6] == lse.data_ptr()
        assert args[7:10] == (dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
        assert args[11:16] == (2, heads, H // heads, sq, sk)
        assert list(args[16:24]) == [sq * H, H, sk * H, H, sk * H, H, sq * H, H]
        assert args[24] == sk and args[25] == pytest.approx((H // heads) ** -0.5)
        assert args[26] == 2 ** 31 + 5 and args[-1] == 0

    def test_called_alone_gets_the_statistics_from_one_forward(self, recorder):
        """Without the forward's output and row log-sum-exps, one K1 launch
        of the routed forward variant writes them first."""
        from vilbert_tpu_torch.ops.attention import (
            _bwd_cuda,
            attention,
            attention_bwd,
            fwd_variant,
        )

        for sq, sk, fv in ((21, 200, "long_tc"), (24, 101, "wg")):
            recorder.calls.clear()
            before = (attention.launches, getattr(attention, f"launches_{fv}"),
                      attention_bwd.launches_wg)
            q, k, v, bias, g = _operands(2, sq, sk, 1024)
            _bwd_cuda(q, k, v, bias, g, 8, 0.0, None, "wg")
            (fwd, fargs), (bwd, bargs) = recorder.calls
            assert fwd_variant(q.dtype, sq, sk, 128) == fv
            assert (fwd, bwd) == (f"vt_attention_fwd_{fv}", "vt_attention_bwd_wg")
            assert fargs[-3] is not None and fargs[-2] is None  # the lse, no probabilities
            assert bargs[5] == fargs[4] and bargs[6] == fargs[-3]  # the forward's out and lse
            assert (attention.launches, getattr(attention, f"launches_{fv}"),
                    attention_bwd.launches_wg) == tuple(n + 1 for n in before)

    def test_stride0_batch_of_g_passes(self, recorder):
        """A cotangent broadcast over the batch (stride 0) goes in as a 0
        batch stride."""
        from vilbert_tpu_torch.ops.attention import _bwd_cuda

        q, k, v, bias, _ = _operands(4, 200, 200, 1024)
        g = torch.zeros(1, 200, 1024, dtype=torch.bfloat16).expand(4, 200, 1024)
        _bwd_cuda(q, k, v, bias, g, 8, 0.0, None, "wg", torch.zeros_like(q),
                  torch.zeros(4, 8, 200))
        (_, args), = recorder.calls
        assert list(args[22:24]) == [0, 1024]

    @pytest.mark.parametrize("case", ["fp32", "offset", "row_stride", "long", "out_shape",
                                      "out_dtype", "lse_shape", "lse_dtype"])
    def test_refuses_before_launch(self, recorder, case):
        from vilbert_tpu_torch.ops.attention import _bwd_cuda, attention_bwd

        sq = 1025 if case == "long" else 200
        q, k, v, bias, g = _operands(2, sq, 200, 1024)
        out, lse = torch.zeros_like(q), torch.zeros(2, 8, sq)
        if case == "fp32":
            q, k, v, g, out = (t.float() for t in (q, k, v, g, out))
        elif case == "offset":  # rows start 2 bytes off a 16-byte boundary
            k = torch.zeros(2, 200, 1032, dtype=torch.bfloat16)[..., 1:1025]
        elif case == "row_stride":  # aligned start, rows 1028 elements apart
            v = torch.zeros(2, 200, 1028, dtype=torch.bfloat16)[..., :1024]
        elif case == "out_shape":
            out = torch.zeros(2, sq - 1, 1024, dtype=torch.bfloat16)
        elif case == "out_dtype":
            out = out.float()
        elif case == "lse_shape":
            lse = torch.zeros(2, sq, 8)
        elif case == "lse_dtype":
            lse = lse.to(torch.bfloat16)
        with pytest.raises(ValueError):
            _bwd_cuda(q, k, v, bias, g, 8, 0.0, None, "wg", out, lse)
        assert recorder.calls == [] and attention_bwd.launches == 0
