"""K1's wgmma variant (``wg``, ``csrc/attention_fwd_wg.cu``) on the CPU.

The kernel runs on a card only (``chip_smoke.py`` holds it to the plain
version there). Here: which variant ``fwd_variant`` routes each shape of
the paths to; what ``_fwd_cuda`` hands ``vt_attention_fwd_wg``, with the
library replaced by a recorder; and the kernel's tile arithmetic emulated
in PyTorch (``_wg_walk``: tiles of 64 keys, the exact branch that
normalizes and drops P before rounding it where the ring holds the whole
key axis, the online branch past it) against the JAX package's
``fused_attention_train`` forward (Pallas in interpret mode) within the
bf16 bound, with the dropout mask the walk applies tile by tile checked bit
for bit against ``_keep_mask``. Inputs come from numpy seeds.
"""

import contextlib
import math
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

#: keys a streamed tile of the kernel (``kKeys``), and the longest key axis
#: its exact branch takes (``kExactKeys``: two tiles, the whole ring)
WG_KEYS, WG_EXACT_KEYS = 64, 128
LOG2E = 1.4426950408889634


def _t(a):
    return torch.from_numpy(np.array(a))


def _tile_keep(rows, cols, tile_seeds, rate):
    """The kernel's ``vt::keep`` at global query rows ``rows`` [Sq, 1] and
    keys ``cols`` [1, n] for each tile seed [N] -> [N, Sq, n]."""
    from vilbert_tpu_torch.ops import dropout as D

    base = D._mul32(rows, D._GOLDEN) ^ D._mul32((cols + D._COL_ADD) & D._M32, D._COL_MUL)
    x = base[None] ^ D._mul32(tile_seeds, D._SEED_MUL)[:, None, None]
    return D._murmur_mix(x) >= D.keep_threshold(rate)


def _wg_walk(q, k, v, bias, *, num_heads, dropout_rate=0.0, seed=None):
    """The arithmetic of ``wg`` in PyTorch: bf16 q, k, v; per key tile of
    64 (its keys rounded up to 16, -inf past Sk) x = q.k scale log2(e) +
    bias log2(e) in fp32; the mask hashed at each element's global (row,
    key) with the tile seed of (batch, head). Sk <= 128 (exact branch): the
    row max m and sum l of 2^(x - m) over every tile, P = 2^(x - m)
    keep_scale / l where kept, rounded to bf16, then P V. Past 128 (online
    branch): m and l of the UNDROPPED exps carried over the tiles, O
    rescaled by 2^(m_old - m_new), the kept 2^(x - m) rounded to bf16 for
    P V, O keep_scale / l at the end. The probabilities, bf16 [B, h, Sq,
    Sk]: the exact branch's P as P V takes it; past 128 keys a second sweep
    with the final m and l, 2^(x - m) keep_scale / l where kept. Returns
    (out bf16 [B, Sq, H], the row log-sum-exps (m + log2 l) ln 2
    [B, h, Sq], the mask [B, h, Sq, Sk] the walk applied, the
    probabilities)."""
    from vilbert_tpu_torch.ops.attention import _bias_rows, _heads, _merge
    from vilbert_tpu_torch.ops.dropout import TILE_SEED_STRIDE

    B, sq, H = q.shape
    sk, d = k.shape[1], H // num_heads
    qh, kh, vh = (_heads(t, num_heads) for t in (q, k, v))
    b2 = _bias_rows(bias, q, sk)[:, None, None, :] * LOG2E
    sl2 = (1.0 / math.sqrt(d)) * LOG2E
    keep_scale = 1.0 / (1.0 - dropout_rate)
    tile_seeds = (seed + torch.arange(B * num_heads) * TILE_SEED_STRIDE) & 0xFFFFFFFF \
        if dropout_rate else None
    rows = torch.arange(sq, dtype=torch.int64)[:, None]

    def tile(k0):
        """(x of the tile's keys rounded to 16, the keep mask of its n keys, n)."""
        n = min(WG_KEYS, sk - k0)
        x = (qh @ kh[:, :, k0:k0 + n].transpose(-1, -2)) * sl2 + b2[..., k0:k0 + n]
        pad = -(-n // 16) * 16 - n
        x = torch.cat([x, torch.full((B, num_heads, sq, pad), -math.inf)], -1)
        keep = torch.ones(B, num_heads, sq, n, dtype=torch.bool)
        if dropout_rate:
            cols = torch.arange(k0, k0 + n, dtype=torch.int64)[None, :]
            keep = _tile_keep(rows, cols, tile_seeds, dropout_rate).reshape(keep.shape)
        return x, keep, n

    tiles = [tile(k0) for k0 in range(0, sk, WG_KEYS)]
    mask = torch.cat([keep for _, keep, _ in tiles], -1)
    if sk <= WG_EXACT_KEYS:
        x = torch.cat([x for x, _, _ in tiles], -1)
        m = x.amax(-1, keepdim=True)
        p = torch.exp2(x - m)
        l = p.sum(-1, keepdim=True)
        p = _valid(p, sk)
        p = torch.where(mask, p * (keep_scale / l), 0.0)
        probs = p.to(torch.bfloat16)
        o = probs.float() @ vh
    else:
        m = torch.full((B, num_heads, sq, 1), -math.inf)
        l = torch.zeros(B, num_heads, sq, 1)
        o = torch.zeros(B, num_heads, sq, d)
        for i, (x, keep, n) in enumerate(tiles):
            m_new = torch.maximum(m, x.amax(-1, keepdim=True))
            c = torch.exp2(m - m_new)
            p = torch.exp2(x - m_new)
            l = l * c + p.sum(-1, keepdim=True)
            p = torch.where(keep, p[..., :n], 0.0)
            k0 = i * WG_KEYS
            o = o * c + p.to(torch.bfloat16).float() @ vh[:, :, k0:k0 + n]
            m = m_new
        o = o * (keep_scale / l)
        probs = torch.cat([torch.where(keep, torch.exp2(x[..., :n] - m) * (keep_scale / l), 0.0)
                           for x, keep, n in tiles], -1).to(torch.bfloat16)
    lse = ((m + torch.log2(l)) * math.log(2.0))[..., 0]
    return _merge(o, torch.bfloat16), lse, mask, probs


def _valid(p, sk):
    """The first Sk keys of tiles padded to 16 keys each: drop each tile's
    padding."""
    parts, at = [], 0
    for k0 in range(0, sk, WG_KEYS):
        n = min(WG_KEYS, sk - k0)
        parts.append(p[..., at:at + n])
        at += -(-n // 16) * 16
    return torch.cat(parts, -1)


def _bf16_bound(ref) -> float:
    """chip_smoke.py's bf16 bound: one bf16 rounding of max|ref| plus one
    bf16 ulp of it."""
    top = float(ref.float().abs().max())
    return 2.0 ** -7 * top + 2.0 ** (np.floor(np.log2(top)) - 7)


def _inputs(B, sq, sk, H, seed):
    """bf16 q, k, v and an additive bias: padded keys in the first batch
    row, the last batch row fully padded (every key at -10000)."""
    from vilbert_tpu_torch.ops.attention import make_additive_mask

    rng = np.random.RandomState(seed)
    q, k, v = (_t(rng.randn(B, s, H).astype(np.float32)).to(torch.bfloat16)
               for s in (sq, sk, sk))
    mask = np.ones((B, sk), np.int32)
    mask[0, -(sk // 3):] = 0 if sk > 2 else 1
    mask[-1, :] = 0
    return q, k, v, make_additive_mask(_t(mask))


#: (Sq, Sk, head_dim): the exact branch at one tile (Sk 1, 23, 37, 64) and
#: two (65, 101, 128), the online branch past it (129, 200, 306, 562), the
#: warpgroups' 64-row edges in Sq
WALK_SHAPES = [
    (23, 23, 64), (1, 1, 128), (37, 64, 128), (17, 65, 64), (101, 101, 128), (23, 101, 128),
    (128, 128, 64), (65, 129, 128), (21, 200, 64), (200, 200, 128), (257, 306, 128),
    (1, 562, 64),
]


class TestWgWalk:
    """``_wg_walk`` against ``fused_attention_train`` (interpret mode)."""

    @pytest.mark.parametrize("rate", [0.0, 0.1])
    @pytest.mark.parametrize("sq,sk,d", WALK_SHAPES)
    def test_walk_matches_pallas_forward(self, sq, sk, d, rate):
        """The output within the bf16 bound of the Pallas forward at the
        same seed, the row log-sum-exps within chip_smoke.py's bound of
        torch.logsumexp of the fp32 scores, the probabilities within
        chip_smoke.py's (``_probs_error``: 2^-7 |ref| + 2^-8 / Sk, 2^-8 |ref|
        more on the fully padded row) of the plain version's, and the mask
        the walk applied tile by tile equal to ``_keep_mask`` of each
        (batch, head) tile."""
        from vilbert_tpu.ops.pallas_attention_train import _keep_mask, fused_attention_train
        from vilbert_tpu_torch.ops.attention import _bias_rows, _heads, attention_ref

        B, h = 2, 2
        q, k, v, bias = _inputs(B, sq, sk, h * d, seed=sq * 31 + sk + d)
        rng = jax.random.PRNGKey(sq * 1000 + sk)
        seed = int(np.asarray(jax.random.bits(rng, (1,), jnp.uint32))[0]) if rate else None
        got, lse, mask, probs = _wg_walk(q, k, v, bias, num_heads=h, dropout_rate=rate,
                                         seed=seed)
        as_jax = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (q, k, v)]
        want = fused_attention_train(*as_jax, jnp.asarray(bias.numpy()), num_heads=h,
                                     dropout_rate=rate, dropout_rng=rng, interpret=True)
        want = _t(np.asarray(want.astype(jnp.float32)))
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        err = float((got.float() - want).abs().max())
        assert err <= _bf16_bound(want), (err, _bf16_bound(want))

        s = _heads(q, h) @ _heads(k, h).transpose(-1, -2) * (1.0 / math.sqrt(d))
        ref = torch.logsumexp(s + _bias_rows(bias, q, sk)[:, None, None, :], -1)
        assert bool(((lse - ref).abs() <= 1e-4 + 1e-6 * ref.abs()).all())

        _, ref_p = attention_ref(q, k, v, bias, num_heads=h, dropout_rate=rate, seed=seed,
                                 return_probs=True)
        ref_p = ref_p.float()
        bound = 2.0 ** -7 * ref_p.abs() + 2.0 ** -8 / sk
        bound[-1] += 2.0 ** -8 * ref_p[-1].abs()  # the fully padded batch row
        assert probs.dtype == torch.bfloat16
        assert bool(((probs.float() - ref_p).abs() <= bound).all())

        if rate:
            s32 = np.array(seed, np.uint32).view(np.int32)
            for bh in range(B * h):
                tile_seed = jnp.asarray(s32) + bh * 7919
                want_mask = np.asarray(_keep_mask((sq, sk), rate, tile_seed))
                np.testing.assert_array_equal(mask.reshape(B * h, sq, sk)[bh].numpy(),
                                              want_mask)
        else:
            assert bool(mask.all())

    def test_exact_branch_rounds_the_normalized_probabilities(self):
        """At Sk <= 128 the walk rounds P after normalizing and dropping it,
        as the TPU kernel does; the online branch's rounding of the
        unnormalized exps differs from it by more than nothing at the same
        inputs, so the branch taken is visible."""
        from vilbert_tpu_torch.ops.attention import attention_ref

        q, k, v, bias = _inputs(2, 37, 101, 256, seed=3)
        kw = dict(num_heads=2, dropout_rate=0.1, seed=2 ** 31 + 9)
        exact = _wg_walk(q, k, v, bias, **kw)[0]
        want = attention_ref(q, k, v, bias, **kw)
        global WG_EXACT_KEYS
        saved, WG_EXACT_KEYS = WG_EXACT_KEYS, 0
        try:
            online = _wg_walk(q, k, v, bias, **kw)[0]
        finally:
            WG_EXACT_KEYS = saved
        e_exact = float((exact.float() - want.float()).abs().max())
        e_online = float((online.float() - want.float()).abs().max())
        assert e_exact <= e_online and e_online > 0.0
        assert e_exact <= _bf16_bound(want) and e_online <= _bf16_bound(want)


class _Recorder:
    """Stands in for the kernels' ctypes library: records each entry point's
    arguments and returns cudaSuccess."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("vt_"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.fixture
def recorder(monkeypatch):
    """A recording library in place of the kernels', no CUDA stream, K1's
    counters at 0 (restored after the test)."""
    from vilbert_tpu_torch.ops import _build
    from vilbert_tpu_torch.ops.attention import VARIANTS, attention

    for counter in ("launches", "launches_probs", *(f"launches_{v}" for v in VARIANTS)):
        monkeypatch.setattr(attention, counter, 0)
    lib = _Recorder()
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda _: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    return lib


def _operands(B, sq, sk, H):
    return (torch.zeros(B, sq, H, dtype=torch.bfloat16), torch.zeros(B, sk, H, dtype=torch.bfloat16),
            torch.zeros(B, sk, H, dtype=torch.bfloat16), torch.zeros(B, sk))


class TestWgDispatch:
    """What ``_fwd_cuda`` hands ``vt_attention_fwd_wg`` (the kernel itself
    runs on a card)."""

    @pytest.mark.parametrize("sq,sk,H,heads", [(101, 101, 1024, 8), (23, 101, 1024, 8),
                                               (124, 124, 768, 12), (562, 562, 768, 12)])
    def test_arguments_and_counters(self, recorder, sq, sk, H, heads):
        """Pointers, geometry, the [B, S, H] strides, the bias's batch
        stride, the scale, the dropout arguments, the row log-sum-exps'
        pointer, no probabilities, the stream; one launch on its counters."""
        from vilbert_tpu_torch.ops.attention import _fwd_cuda, attention
        from vilbert_tpu_torch.ops.dropout import keep_threshold

        q, k, v, bias = _operands(2, sq, sk, H)
        out, lse = _fwd_cuda(q, k, v, bias, heads, 0.1, 2 ** 31 + 5, "wg", return_lse=True)
        assert out.shape == q.shape and out.dtype == torch.bfloat16
        assert lse.shape == (2, heads, sq) and lse.dtype == torch.float32
        (name, args), = recorder.calls
        assert name == "vt_attention_fwd_wg"
        assert args[:5] == (q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                            out.data_ptr())
        assert args[5:10] == (2, heads, H // heads, sq, sk)
        assert list(args[10:16]) == [sq * H, H, sk * H, H, sk * H, H] and args[16] == sk
        assert args[17] == pytest.approx((H // heads) ** -0.5)
        assert args[18:21] == (2 ** 31 + 5, keep_threshold(0.1), pytest.approx(1 / 0.9))
        assert args[21] == lse.data_ptr() and args[22] is None and args[23] == 0
        assert (attention.launches, attention.launches_wg, attention.launches_probs) == (1, 1, 0)

    def test_probabilities_pointer(self, recorder):
        """With ``return_probs`` a bf16 [B, h, Sq, Sk] goes in as the
        probabilities pointer, after the row log-sum-exps'; it counts on
        ``launches_probs`` and in the variant's launches."""
        from vilbert_tpu_torch.ops.attention import _fwd_cuda, attention

        q, k, v, bias = _operands(2, 101, 101, 1024)
        out, probs, lse = _fwd_cuda(q, k, v, bias, 8, 0.0, None, "wg", return_probs=True,
                                    return_lse=True)
        assert probs.shape == (2, 8, 101, 101) and probs.dtype == torch.bfloat16
        (name, args), = recorder.calls
        assert name == "vt_attention_fwd_wg" and args[21:23] == (lse.data_ptr(), probs.data_ptr())
        assert (attention.launches_wg, attention.launches_probs) == (1, 1)

    def test_stride0_batch_and_no_statistics(self, recorder):
        """Retrieval's fast_mode: one k, v row block broadcast over the
        batch goes in as a 0 batch stride; without ``return_lse`` a null
        pointer; at rate 0 threshold 0 and scale 1."""
        from vilbert_tpu_torch.ops.attention import _fwd_cuda

        q, k, v, bias = _operands(4, 23, 30, 768)
        k, v = (t[:1].expand(4, 30, 768) for t in (k, v))
        _fwd_cuda(q, k, v, bias, 12, 0.0, None, "wg")
        (_, args), = recorder.calls
        assert list(args[10:16]) == [23 * 768, 768, 0, 768, 0, 768]
        assert args[18:22] == (0, 0, 1.0, None)

    @pytest.mark.parametrize("case", ["offset", "row_stride", "fp32", "past_cap"])
    def test_refuses_before_launch(self, recorder, case):
        """Operands the 16-byte copies cannot take, fp32 and more than 1,024
        keys raise ValueError; nothing launches."""
        from vilbert_tpu_torch.ops.attention import _fwd_cuda

        q, k, v, bias = _operands(2, 23, 101, 768)
        if case == "offset":  # rows start 2 bytes off a 16-byte boundary
            k = torch.zeros(2, 101, 776, dtype=torch.bfloat16)[..., 1:769]
        elif case == "row_stride":  # aligned start, rows 772 elements apart
            v = torch.zeros(2, 101, 772, dtype=torch.bfloat16)[..., :768]
        elif case == "fp32":
            q, k, v = (t.float() for t in (q, k, v))
        else:
            q, k, v, bias = _operands(1, 2, 1025, 768)
        with pytest.raises(ValueError):
            _fwd_cuda(q, k, v, bias, 12, 0.0, None, "wg")
        assert recorder.calls == []


#: (label, Sq, Sk, head width, the variant K1 runs there): every bf16 K1
#: shape of the paths (PERF.md's kernel table and the two-stream multi-task
#: steps at or under 128), routed to "wg" where it beat both "tc" and
#: "long_tc" on an H100 at the rate the path runs, else to the faster of
#: those two
PATH_ROUTES = [
    ("VQA text self", 23, 23, 64, "tc"), ("VQA image self", 101, 101, 128, "wg"),
    ("VQA text->image", 23, 101, 128, "wg"), ("VQA image->text", 101, 23, 128, "long_tc"),
    ("retrieval text self", 30, 30, 64, "tc"), ("retrieval text->image", 30, 101, 128, "wg"),
    ("retrieval image->text", 101, 30, 128, "long_tc"),
    ("demo image self", 37, 37, 128, "tc"), ("demo text->image", 30, 37, 128, "tc"),
    ("demo image->text", 37, 30, 128, "tc"),
    ("CC text self", 36, 36, 64, "long_tc"), ("CC image self", 37, 37, 128, "tc"),
    ("CC text->image", 36, 37, 128, "tc"), ("CC image->text", 37, 36, 128, "tc"),
    ("VQA step text self", 24, 24, 64, "tc"), ("VQA step text->image", 24, 101, 128, "wg"),
    ("VQA step image->text", 101, 24, 128, "long_tc"),
    ("refcoco step text->image", 21, 101, 128, "wg"),
    ("VisualEntailment step text->image", 57, 101, 128, "wg"),
    ("VisualEntailment step text self", 57, 57, 64, "long_tc"),
    ("Visual7w image self", 200, 200, 128, "long_tc"),
    ("Visual7w text->image", 21, 200, 128, "long_tc"),
    ("Visual7w image->text", 200, 21, 128, "long_tc"),
    ("GuessWhatPointing text self", 257, 257, 64, "long_tc"),
    ("GuessWhatPointing image self", 306, 306, 128, "long_tc"),
    ("GuessWhatPointing text->image", 257, 306, 128, "long_tc"),
    ("baseline VQA self", 124, 124, 64, "wg"), ("baseline CC self", 73, 73, 64, "long_tc"),
    ("baseline GenomeQA step self", 127, 127, 64, "wg"),
    ("baseline refcoco step self", 121, 121, 64, "wg"),
    ("baseline retrieval self", 131, 131, 64, "long_tc"),
    ("baseline Visual7w step self", 220, 220, 64, "long_tc"),
    ("baseline GuessWhatPointing step self", 562, 562, 64, "wg"),
]


class TestRouting:
    @pytest.mark.parametrize("label,sq,sk,d,want", PATH_ROUTES,
                             ids=[r[0].replace(" ", "_") for r in PATH_ROUTES])
    def test_path_shape_routes(self, label, sq, sk, d, want):
        """bf16 at each path shape on the variant the card chose; fp32 on
        the CUDA cores."""
        from vilbert_tpu_torch.ops.attention import fwd_variant

        assert fwd_variant(torch.bfloat16, sq, sk, d) == want
        assert fwd_variant(torch.float32, sq, sk, d) == "cc"

    def test_every_length_routes_to_a_variant_that_takes_it(self):
        """Over Sq, Sk in 1..1,024 at both head widths, "tc" only at
        Sk <= 128 and every route one of the bf16 variants."""
        from vilbert_tpu_torch.ops.attention import TC_MAX_SEQ, fwd_variant

        lengths = (1, 16, 17, 32, 33, 63, 64, 65, 96, 97, 127, 128, 129, 200, 512, 513, 1024)
        for d in (64, 128):
            for sq in lengths:
                for sk in lengths:
                    v = fwd_variant(torch.bfloat16, sq, sk, d)
                    assert v in ("tc", "long_tc", "wg") and (v != "tc" or sk <= TC_MAX_SEQ)
