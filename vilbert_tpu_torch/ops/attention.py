"""Multi-head attention core: plain PyTorch versions and the Hopper kernels.

Counterpart of ``vilbert_tpu/ops/attention.py`` (``attention_core`` over
[B, S, H] projections, ``make_additive_mask``) and of the TPU kernels of
``vilbert_tpu/ops/pallas_attention_train.py``: ``_fwd_kernel`` (K1, with
its in-kernel attention-probability dropout) and ``_bwd_kernel`` (K2), and
of ``vilbert_tpu/ops/pallas_attention.py::fused_attention`` (K3, K1's rate-0
function with the same backward). One entry point serves the text and image
self-attention and both co-attention directions (Sq != Sk).

Arithmetic, as in the Pallas kernels: scores q.k^T * (1/sqrt(d)) + key bias
in fp32, fp32 softmax; with dropout, P is multiplied by the fp32
1/(1 - rate) where ``_keep_mask`` keeps and zeroed elsewhere; P rounded to
v's dtype, then P.V accumulated in fp32 and returned in q's dtype. The
backward recomputes P and the mask from (q, k, v, bias, seed) and follows
``_bwd_kernel`` (P_drop stays fp32 for dv; the rowsum uses the undropped P).
The JAX XLA path would run a bf16 softmax under ``softmax_dtype="auto"``;
the port follows the kernels.

``attention`` is the entry point of the model, differentiable through one
``autograd.Function``; ``fused_attention`` is K3's API counterpart over it. On CPU tensors
they run ``attention_ref`` and ``attention_bwd_ref``; on CUDA tensors they
launch ``csrc/attention.cu``, ``csrc/attention_fwd_wg.cu``,
``csrc/attention_bwd.cu`` and ``csrc/attention_bwd_wg.cu`` or raise.

The wrapper picks a kernel variant by dtype and shape alone
(``fwd_variant``, ``bwd_variant``), never by catching a failure. K1 has
four: ``"wg"`` for bf16 on Hopper's wgmma (``csrc/attention_fwd_wg.cu``:
keys streamed in tiles of 64 from the first tile on; where the ring holds
the whole key axis, Sk <= 128, P is normalized and dropped before it is
rounded, past it an online softmax), ``"tc"`` on the tensor cores'
mma.sync for bf16 at Sk <= 128 (the whole key axis in shared memory),
``"long_tc"`` on mma.sync for bf16 at any Sk <= 1024 (K and V streamed in
tiles of 64 keys under an online softmax; it rounds exp(s - max) to bf16
before dividing by the row sum, where the TPU kernel rounds the normalized
P), and ``"cc"`` on the CUDA cores for fp32. ``fwd_variant`` sends each
bf16 shape of the paths to whichever of the three ran it fastest on an
H100. K2 has five: ``"tc"`` for bf16 at
Sq, Sk <= 128, ``"cc"`` for fp32 there; when Sq or Sk is above 128, up to
1024, ``"wg"`` for bf16 (``csrc/attention_bwd_wg.cu``, on Hopper's wgmma)
and ``"long"`` (CUDA cores) for fp32; ``"wg"`` also takes the bf16 shapes
at or under 128 where it beat ``"tc"`` (``bwd_variant``); ``"long_tc"``,
the bf16 variant on ``mma.sync`` that ``"wg"`` replaced, stays launchable
by name. The long variants cut the work into tiles of 64 queries and keys
over two kernels and an fp32 workspace of row statistics. K2's ``"wg"``
takes the row statistics from the forward: K1's bf16 variants also write
each row's log-sum-exp of the scores (``return_lse``), and the backward
reads it with the forward's output O (rowsum(dp P) = rowsum(g O));
``_Attention`` saves both where ``bwd_variant`` picks ``"wg"``, and
``attention_bwd`` called alone runs one K1 launch for them first. Every
variant stays launchable by name (``attention_kernel``,
``attention_bwd_kernel``); ``"cc"`` and ``"long"`` take bf16 too there.
The tensor-core variants load rows by 16-byte copies, so they refuse
(ValueError) operands that are not 16-byte aligned or whose batch and row
strides are not multiples of 8 elements. The bf16 tensor-core K2 variants
round P_drop and ds to bf16 as mma operands (the TPU kernel keeps them in
fp32). ``attention.launches`` counts every K1 launch and
``attention.launches_<variant>`` each variant's; likewise
``attention_bwd``.

``return_probs=True`` (the model's ``visualization`` maps; the JAX
package's ``attention_core(..., return_probs=True)``, which computes them
in XLA) also returns P after dropout, [B, h, Sq, Sk] in v's dtype, as
``_probs_from_scores`` returns it. On a CUDA tensor the routed K1 variant
writes it (``attention.launches_probs`` counts those launches): ``tc`` and
``cc`` from the row they hold, ``wg`` from the P its exact branch (Sk <=
128) normalizes, ``long_tc`` and ``wg``'s online branch in a second sweep
over the key tiles with the row's final max and sum. Without it nothing
changes.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch

from vilbert_tpu_torch.ops import _build
from vilbert_tpu_torch.ops.dropout import attention_keep_mask, keep_threshold

#: shapes the forward kernel takes: the CUDA-core variant's fp32 score
#: block [32][Sk + 1] fills shared memory at 1024 keys; the streaming
#: variants take that cap too (the single-stream baseline's longest
#: sequence is GuessWhatPointing's 256 + 306 = 562)
KERNEL_HEAD_DIMS = (64, 128)
KERNEL_MAX_KEYS = 1024
#: longest Sq and Sk the backward kernel takes
BWD_KERNEL_MAX_SEQ = 1024
#: longest sequence of the "tc" variants, and of K2's "cc" variant, which
#: keep a whole (batch, head) in shared memory
TC_MAX_SEQ = 128
#: kernel variants: K1's tensor cores (bf16, mma.sync) up to 128 keys and
#: past them, CUDA cores, and bf16 on wgmma ("wg"); K2's tensor-core and
#: CUDA-core variants each have a long twin past 128 queries or keys, and
#: the bf16 one ("long_tc", mma.sync) a wgmma successor ("wg")
VARIANTS = ("tc", "long_tc", "cc", "wg")
BWD_VARIANTS = ("tc", "cc", "long_tc", "long", "wg")
#: rows of the wgmma variants' tiles: K2 "wg"'s owned and streamed tiles, K1
#: "wg"'s key tiles
WG_TILE = 64


def make_additive_mask(mask: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """[B, S] {0,1} validity mask -> [B, 1, 1, S] additive bias (0 / -10000)."""
    bias = (1.0 - mask.to(torch.float32)) * -10000.0
    return bias[:, None, None, :].to(dtype)


def _bias_rows(bias: Optional[torch.Tensor], q: torch.Tensor, sk: int) -> torch.Tensor:
    """Additive key bias [B, 1, 1, Sk] (or [B, Sk]) -> fp32 [B, Sk] view."""
    if bias is None:
        return torch.zeros(q.shape[0], sk, dtype=torch.float32, device=q.device)
    if bias.shape[-1] != sk or any(n != 1 for n in bias.shape[1:-1]):
        raise ValueError(f"bias {tuple(bias.shape)} is not a key bias for Sk={sk}")
    return bias.reshape(bias.shape[0], sk).to(torch.float32)


def _check_rate(dropout_rate: float, seed: Optional[int]) -> None:
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"attention dropout rate must be in [0, 1), got {dropout_rate}")
    if dropout_rate > 0.0 and (seed is None or not 0 <= seed < 2 ** 32):
        raise ValueError(
            f"attention dropout at rate {dropout_rate} needs a uint32 seed, got {seed}")


def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, S, H] -> fp32 [B, h, S, d]."""
    b, s, hd = x.shape
    return x.reshape(b, s, num_heads, hd // num_heads).transpose(1, 2).float()


def _merge(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """[B, h, S, d] -> [B, S, H] in ``dtype``."""
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d).to(dtype)


def _probs(q, k, bias_rows, num_heads):
    """fp32 softmax(q k^T / sqrt(d) + bias) [B, h, Sq, Sk] (``_probs``)."""
    d = q.shape[-1] // num_heads
    scores = _heads(q, num_heads) @ _heads(k, num_heads).transpose(-1, -2)
    scores = scores * (1.0 / math.sqrt(d)) + bias_rows[:, None, None, :]
    return torch.softmax(scores, dim=-1)


def _keep(p: torch.Tensor, dropout_rate: float, seed: int) -> torch.Tensor:
    b, h, sq, sk = p.shape
    return attention_keep_mask(b, h, sq, sk, dropout_rate, seed, device=p.device)


def attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor],
    *,
    num_heads: int,
    dropout_rate: float = 0.0,
    seed: Optional[int] = None,
    return_probs: bool = False,
):
    """Plain PyTorch attention (``_fwd_kernel``). q [B, Sq, H], k/v
    [B, Sk, H] -> [B, Sq, H]; ``seed`` is the call's uint32 dropout seed.
    With ``return_probs``, ``(out, probs)``: probs [B, h, Sq, Sk] in v's
    dtype, P after dropout as the P.V product takes it."""
    _check_rate(dropout_rate, seed)
    p = _probs(q, k, _bias_rows(bias, q, k.shape[1]), num_heads)
    if dropout_rate > 0.0:
        p = torch.where(_keep(p, dropout_rate, seed), p * (1.0 / (1.0 - dropout_rate)), 0.0)
    p = p.to(v.dtype)
    out = _merge(p.float() @ _heads(v, num_heads), q.dtype)
    return (out, p) if return_probs else out


def attention_bwd_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor],
    g: torch.Tensor,
    *,
    num_heads: int,
    dropout_rate: float = 0.0,
    seed: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch backward of the attention (``_bwd_kernel``): g, the
    cotangent of the [B, Sq, H] output -> (dq, dk, dv) in q's, k's and v's
    dtypes."""
    _check_rate(dropout_rate, seed)
    d = q.shape[-1] // num_heads
    p = _probs(q, k, _bias_rows(bias, q, k.shape[1]), num_heads)
    g32, v32 = _heads(g, num_heads), _heads(v, num_heads)
    dp = g32 @ v32.transpose(-1, -2)
    if dropout_rate > 0.0:
        keep = _keep(p, dropout_rate, seed)
        inv_keep = 1.0 / (1.0 - dropout_rate)
        p_dropped = torch.where(keep, p * inv_keep, 0.0)
        dp = torch.where(keep, dp * inv_keep, 0.0)
    else:
        p_dropped = p
    dv = p_dropped.transpose(-1, -2) @ g32
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    scale = 1.0 / math.sqrt(d)
    dq = (ds @ _heads(k, num_heads)) * scale
    dk = (ds.transpose(-1, -2) @ _heads(q, num_heads)) * scale
    return _merge(dq, q.dtype), _merge(dk, k.dtype), _merge(dv, v.dtype)


def kernel_geometry(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias_rows: torch.Tensor,
    num_heads: int,
) -> tuple:
    """Validate the forward kernel's operands; return (B, Sq, Sk, d).

    Raises ValueError for anything the kernel does not take: q [B, Sq, H]
    and k, v [B, Sk, H] of one dtype (float32 or bfloat16) with unit stride
    along H (batch and row strides are free, so broadcast and sliced views
    pass); d = H / heads in (64, 128); 1 <= Sk <= 1024; an fp32 [B, Sk] bias
    with unit stride along Sk.
    """
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("attention kernel takes [B, S, H] q, k and v")
    b, sq, hd = q.shape
    sk = k.shape[1]
    if tuple(k.shape) != (b, sk, hd) or tuple(v.shape) != (b, sk, hd):
        raise ValueError(
            f"k {tuple(k.shape)} and v {tuple(v.shape)} must be [{b}, Sk, {hd}]"
        )
    if q.dtype not in _build.DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"attention kernel takes float32 or bfloat16 q, k, v of one dtype, "
            f"got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    if hd % num_heads or hd // num_heads not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"attention kernel takes head_dim in {KERNEL_HEAD_DIMS}, got "
            f"H={hd} over {num_heads} heads"
        )
    if not 1 <= sk <= KERNEL_MAX_KEYS or sq < 1:
        raise ValueError(
            f"attention kernel takes 1 <= Sk <= {KERNEL_MAX_KEYS} and Sq >= 1, "
            f"got Sq={sq}, Sk={sk}"
        )
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(2) != 1:
            raise ValueError(f"attention kernel needs unit stride along H in {name}")
    if (
        bias_rows.dtype != torch.float32
        or tuple(bias_rows.shape) != (b, sk)
        or bias_rows.stride(1) != 1
    ):
        raise ValueError(
            f"attention kernel takes an fp32 [{b}, {sk}] bias with unit "
            f"stride along Sk, got {bias_rows.dtype} {tuple(bias_rows.shape)}"
        )
    return b, sq, sk, hd // num_heads


def bwd_kernel_geometry(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias_rows: torch.Tensor,
    g: torch.Tensor, num_heads: int,
) -> tuple:
    """Validate the backward kernel's operands; return (B, Sq, Sk, d).

    On top of the forward's rules: 1 <= Sq, Sk <= 1024; no stride-0 (broadcast)
    batch or row in q, k, v (their dk and dv would need a reduction); g of
    q's shape and dtype with unit stride along H.
    """
    b, sq, sk, d = kernel_geometry(q, k, v, bias_rows, num_heads)
    if sq > BWD_KERNEL_MAX_SEQ or sk > BWD_KERNEL_MAX_SEQ:
        raise ValueError(
            f"attention backward kernel takes Sq, Sk <= {BWD_KERNEL_MAX_SEQ}, "
            f"got Sq={sq}, Sk={sk}"
        )
    for name, t in (("q", q), ("k", k), ("v", v)):
        if (t.shape[0] > 1 and t.stride(0) == 0) or (t.shape[1] > 1 and t.stride(1) == 0):
            raise ValueError(f"attention backward kernel refuses a broadcast {name}")
    if tuple(g.shape) != tuple(q.shape) or g.dtype != q.dtype or g.stride(2) != 1:
        raise ValueError(
            f"attention backward kernel takes g of q's shape {tuple(q.shape)} and "
            f"dtype {q.dtype} with unit stride along H, got {g.dtype} {tuple(g.shape)}"
        )
    return b, sq, sk, d


def fwd_variant(dtype: torch.dtype, sq: int, sk: int, head_dim: int) -> str:
    """The forward kernel's variant for a dtype, sequence lengths and head
    width. fp32: ``"cc"`` (CUDA cores). bf16: ``"wg"`` (wgmma) at every
    shape of the paths where it beat both ``"tc"`` and ``"long_tc"`` on an
    H100 (scripts/ab_kernels.py --kernel attention, at the rate the path
    runs the shape: 0 in eval, 0.1 in training), else the faster of those
    two there:

    * d = 128: ``"wg"`` at 64 < Sk <= 128 (image self-attention and
      text->image over 101 regions: 0.74-0.96x ``long_tc``'s time, at VQA
      image self 0.52x ``tc``'s); at Sk <= 64 ``"tc"`` where Sq <= 64 (the
      CC step's 36 x 37, where ``wg`` ties at rate 0 and loses at 0.1; the
      demo's same shapes at batch 1 take 5-9 us on any variant) and
      ``"long_tc"`` above (image->text over 21-30 tokens: 0.85-0.89x
      ``wg``'s time); ``"long_tc"`` past 128 keys (Visual7w,
      GuessWhatPointing: 0.78-0.97x ``wg``'s).
    * d = 64 (self-attention only): ``"wg"`` at 96 < Sk <= 128 (the
      baseline's 121-127 tokens and regions) and past 512 (its
      GuessWhatPointing 562); ``"tc"`` at Sk <= 32; ``"long_tc"``
      between (CC's 36 and 73, VisualEntailment's 57, retrieval's 131,
      Visual7w's 220 and GuessWhatPointing's 257).

    Every variant also writes the probabilities when asked, so a call that
    returns them runs the same variant, and the same arithmetic, as one
    that does not."""
    if dtype != torch.bfloat16:
        return "cc"
    if head_dim == 128:
        if WG_TILE < sk <= TC_MAX_SEQ:
            return "wg"
        return "tc" if sk <= WG_TILE and sq <= WG_TILE else "long_tc"
    if 96 < sk <= TC_MAX_SEQ or sk > 512:
        return "wg"
    return "tc" if sk <= 32 else "long_tc"


def bwd_variant(dtype: torch.dtype, sq: int, sk: int, head_dim: int) -> str:
    """The backward kernel's variant for a dtype, sequence lengths and head
    width. fp32: ``"cc"`` at Sq, Sk <= 128, ``"long"`` when Sq or Sk is
    above. bf16: ``"wg"`` past 128, and at or under 128 where it beat
    ``"tc"`` on an H100 (scripts/ab_kernels.py --kernel attention_bwd): at
    d = 64 past one 64-row tile (73 to 128 keys: 0.59-0.65x tc's time), at
    d = 128 where at most 64 queries meet more than 64 keys (text->image
    co-attention, 21-57 x 101: 0.63-0.75x); ``"tc"`` elsewhere (at d = 128
    the two run within 4% of each other from 80 to 128 keys, and ``tc``
    wins at 64 keys and below)."""
    long = max(sq, sk) > TC_MAX_SEQ
    if dtype == torch.bfloat16:
        if head_dim == 64:
            short_wg = max(sq, sk) > WG_TILE
        else:
            short_wg = sq <= WG_TILE < sk
        return "wg" if long or short_wg else "tc"
    return "long" if long else "cc"


def _tc_strides(**tensors) -> list:
    """Batch and row strides of [B, S, H] bf16 operands for the tensor-core
    kernels, which copy 16-byte chunks: each operand 16-byte aligned, each
    stride a multiple of 8 elements (the stride of a dimension of size 1 is
    never used and goes in as 0). Raises ValueError otherwise."""
    strides = []
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"tensor-core attention kernel needs a 16-byte aligned {name}")
        for dim in (0, 1):
            st = t.stride(dim) if t.shape[dim] > 1 else 0
            if st % 8:
                raise ValueError(
                    f"tensor-core attention kernel needs {name}'s batch and row strides "
                    f"in multiples of 8 elements, got {tuple(t.stride())}")
            strides.append(st)
    return strides


def _dropout_args(dropout_rate: float, seed: Optional[int]) -> tuple:
    """(seed, uint32 threshold, fp32 keep scale) of the kernels' C entries."""
    if dropout_rate == 0.0:
        return 0, 0, 1.0
    return seed, keep_threshold(dropout_rate), 1.0 / (1.0 - dropout_rate)


def _check_devices(q: torch.Tensor, **others) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"attention runs on cpu or cuda, got {q.device}")
    for name, t in others.items():
        if t is not None and t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")


def _count(wrapper, variant: str) -> None:
    """One launch of ``variant`` on ``wrapper``'s counters."""
    wrapper.launches += 1
    name = f"launches_{variant}"
    setattr(wrapper, name, getattr(wrapper, name) + 1)


def _fwd_cuda(q, k, v, bias_rows, num_heads, dropout_rate, seed, variant, return_probs=False,
              return_lse=False):
    """One K1 launch of ``variant``: out, or (out, probs), (out, lse) or
    (out, probs, lse) as asked; lse fp32 [B, h, Sq], from the bf16 variants
    only."""
    b, sq, sk, d = kernel_geometry(q, k, v, bias_rows, num_heads)
    out = torch.empty(b, sq, q.shape[2], dtype=q.dtype, device=q.device)
    probs = (torch.empty(b, num_heads, sq, sk, dtype=v.dtype, device=q.device)
             if return_probs else None)
    lse = (torch.empty(b, num_heads, sq, dtype=torch.float32, device=q.device)
           if return_lse else None)
    lib = _build.load_library()
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_rows.data_ptr(), out.data_ptr())
    if variant in ("tc", "long_tc", "wg"):
        max_keys = TC_MAX_SEQ if variant == "tc" else KERNEL_MAX_KEYS
        if q.dtype != torch.bfloat16 or sk > max_keys:
            raise ValueError(f"tensor-core attention kernel {variant!r} takes bf16 at Sk <= "
                             f"{max_keys}, got {q.dtype} at Sk={sk}")
        fn = getattr(lib, f"vt_attention_fwd_{variant}")
        call = functools.partial(fn, *ptrs, b, num_heads, d, sq, sk,
                                 *_tc_strides(q=q, k=k, v=v), bias_rows.stride(0))
        stats = (None if lse is None else lse.data_ptr(),)
    elif variant == "cc":
        if return_lse:
            raise ValueError("the row log-sum-exps come from the bf16 variants (tc, long_tc, "
                             "wg)")
        call = functools.partial(lib.vt_attention_fwd, *ptrs, _build.DTYPE_CODES[q.dtype], b,
                                 num_heads, d, sq, sk, q.stride(0), q.stride(1), k.stride(0),
                                 k.stride(1), v.stride(0), v.stride(1), bias_rows.stride(0))
        stats = ()
    else:
        raise ValueError(f"attention kernel variant must be one of {VARIANTS}, got {variant!r}")
    with torch.cuda.device(q.device):
        err = call(1.0 / math.sqrt(d), *_dropout_args(dropout_rate, seed), *stats,
                   None if probs is None else probs.data_ptr(),
                   torch.cuda.current_stream().cuda_stream)
    _build.check(err, f"attention kernel ({variant})")
    _count(attention, variant)
    if probs is not None:
        attention.launches_probs += 1
    extra = tuple(t for t in (probs, lse) if t is not None)
    return (out, *extra) if extra else out


def _bwd_cuda(q, k, v, bias_rows, g, num_heads, dropout_rate, seed, variant, out=None,
              lse=None):
    if g.stride(2) != 1:
        g = g.contiguous()  # autograd may hand the cotangent over as a view
    b, sq, sk, d = bwd_kernel_geometry(q, k, v, bias_rows, g, num_heads)
    dq = torch.empty(b, sq, q.shape[2], dtype=q.dtype, device=q.device)
    dk = torch.empty(b, sk, k.shape[2], dtype=k.dtype, device=k.device)
    dv = torch.empty_like(dk)
    lib = _build.load_library()
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_rows.data_ptr(), g.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
    strides = (q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
               g.stride(0), g.stride(1), bias_rows.stride(0))
    if variant in ("tc", "cc") and max(sq, sk) > TC_MAX_SEQ:
        raise ValueError(f"attention backward kernel variant {variant!r} takes Sq, Sk <= "
                         f"{TC_MAX_SEQ}, got Sq={sq}, Sk={sk}")
    if variant in ("tc", "long_tc", "wg") and q.dtype != torch.bfloat16:
        raise ValueError(f"tensor-core attention backward kernel takes bf16, got {q.dtype}")
    if variant == "tc":
        call = functools.partial(lib.vt_attention_bwd_tc, *ptrs, b, num_heads, d, sq, sk,
                                 *_tc_strides(q=q, k=k, v=v, g=g), bias_rows.stride(0))
    elif variant == "cc":
        call = functools.partial(lib.vt_attention_bwd, *ptrs, _build.DTYPE_CODES[q.dtype], b,
                                 num_heads, d, sq, sk, *strides)
    elif variant in ("long_tc", "long"):
        # each row's softmax max, sum and D, passed between the two kernels
        stats = torch.empty(3 * b * num_heads * sq, dtype=torch.float32, device=q.device)
        if variant == "long":
            call = functools.partial(lib.vt_attention_bwd_long, *ptrs, stats.data_ptr(),
                                     _build.DTYPE_CODES[q.dtype], b, num_heads, d, sq, sk,
                                     *strides)
        else:
            call = functools.partial(lib.vt_attention_bwd_long_tc, *ptrs, stats.data_ptr(), b,
                                     num_heads, d, sq, sk, *_tc_strides(q=q, k=k, v=v, g=g),
                                     bias_rows.stride(0))
    elif variant == "wg":
        tc_strides = _tc_strides(q=q, k=k, v=v, g=g)
        if out is None or lse is None:  # called alone: the forward's O and row statistics
            out, lse = _fwd_cuda(q, k, v, bias_rows, num_heads, dropout_rate, seed,
                                 fwd_variant(q.dtype, sq, sk, d), return_lse=True)
        if (out.shape != q.shape or out.dtype != q.dtype or not out.is_contiguous()
                or out.data_ptr() % 16 or out.device != q.device):
            raise ValueError(f"attention backward kernel 'wg' takes the forward's output as a "
                             f"contiguous {q.dtype} {tuple(q.shape)}, 16-byte aligned")
        if (tuple(lse.shape) != (b, num_heads, sq) or lse.dtype != torch.float32
                or not lse.is_contiguous() or lse.device != q.device):
            raise ValueError(f"attention backward kernel 'wg' takes the forward's row "
                             f"log-sum-exps as a contiguous fp32 [{b}, {num_heads}, {sq}]")
        # each row's log-sum-exp times log2(e) and D = rowsum(g O), written
        # by the dq kernel for the dkdv kernel
        stats = torch.empty(2 * b * num_heads * sq, dtype=torch.float32, device=q.device)
        call = functools.partial(lib.vt_attention_bwd_wg, *ptrs[:5], out.data_ptr(),
                                 lse.data_ptr(), *ptrs[5:], stats.data_ptr(), b, num_heads, d,
                                 sq, sk, *tc_strides, bias_rows.stride(0))
    else:
        raise ValueError(f"attention backward kernel variant must be one of {BWD_VARIANTS}, "
                         f"got {variant!r}")
    with torch.cuda.device(q.device):
        err = call(1.0 / math.sqrt(d), *_dropout_args(dropout_rate, seed),
                   torch.cuda.current_stream().cuda_stream)
    _build.check(err, f"attention backward kernel ({variant})")
    _count(attention_bwd, variant)
    return dq, dk, dv


class _Attention(torch.autograd.Function):
    """K1 forward and K2 backward; saves (q, k, v, bias_rows, seed) and no
    probabilities, and where the backward runs ``"wg"`` (``with_stats``) the
    output and K1's row log-sum-exps too. The bias is the constant mask: no
    gradient. With ``return_probs`` the forward also returns the
    probabilities, which take no gradient (as the K2 backward computes none
    through them)."""

    @staticmethod
    def forward(ctx, q, k, v, bias_rows, num_heads, dropout_rate, seed, return_probs,
                with_stats):
        ctx.args = (num_heads, dropout_rate, seed)
        if q.device.type == "cpu":
            out = attention_ref(q, k, v, bias_rows, num_heads=num_heads,
                                dropout_rate=dropout_rate, seed=seed, return_probs=return_probs)
            ctx.save_for_backward(q, k, v, bias_rows)
        else:
            out = _fwd_cuda(q, k, v, bias_rows, num_heads, dropout_rate, seed,
                            fwd_variant(q.dtype, q.shape[1], k.shape[1], q.shape[2] // num_heads),
                            return_probs, with_stats)
            stats = ()
            if with_stats:
                *out, lse = out
                out = tuple(out) if return_probs else out[0]
                stats = (out[0] if return_probs else out, lse)
            ctx.save_for_backward(q, k, v, bias_rows, *stats)
        if return_probs:
            ctx.mark_non_differentiable(out[1])
        return out

    @staticmethod
    def backward(ctx, g, *_):
        q, k, v, bias_rows, *stats = ctx.saved_tensors
        num_heads, dropout_rate, seed = ctx.args
        out, lse = stats or (None, None)
        grads = attention_bwd(q, k, v, bias_rows, g, num_heads=num_heads,
                              dropout_rate=dropout_rate, seed=seed, out=out, lse=lse)
        return (*grads, None, None, None, None, None, None)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor],
    *,
    num_heads: int,
    dropout_rate: float = 0.0,
    seed: Optional[int] = None,
    return_probs: bool = False,
):
    """Scaled dot-product attention over projected inputs, differentiable.

    q [B, Sq, H], k/v [B, Sk, H], bias an additive key bias [B, 1, 1, Sk]
    (0 / -10000, see ``make_additive_mask``) or None; ``dropout_rate`` > 0
    drops attention probabilities with the mask of the call's uint32
    ``seed``. Returns [B, Sq, H] in q's dtype; with ``return_probs``,
    ``(out, probs)``, probs [B, h, Sq, Sk] in v's dtype: P after dropout,
    the ``visualization`` maps. CPU tensors take the plain versions; CUDA
    tensors launch the kernels' variants that ``fwd_variant`` and
    ``bwd_variant`` pick (``attention.launches*`` and
    ``attention_bwd.launches*`` count them; ``attention.launches_probs``
    counts the forward launches that also wrote the probabilities).
    """
    _check_rate(dropout_rate, seed)
    if q.device.type != "cpu":
        _check_devices(q, k=k, v=v, bias=bias)
    bias_rows = _bias_rows(bias, q, k.shape[1])
    with_stats = (q.device.type != "cpu" and torch.is_grad_enabled()
                  and any(t.requires_grad for t in (q, k, v))
                  and bwd_variant(q.dtype, q.shape[1], k.shape[1],
                                  q.shape[2] // num_heads) == "wg")
    return _Attention.apply(q, k, v, bias_rows, num_heads, float(dropout_rate), seed,
                            return_probs, with_stats)


def fused_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor],
    *,
    num_heads: int,
) -> torch.Tensor:
    """``vilbert_tpu.ops.pallas_attention.fused_attention`` (K3): attention
    without dropout. Its forward is the K1 kernel at rate 0 and its backward
    the K2 kernel at rate 0, which computes ``_folded_bwd``; the launches
    count in ``attention.launches`` and ``attention_bwd.launches``."""
    return attention(q, k, v, bias, num_heads=num_heads)


def attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor],
    g: torch.Tensor,
    *,
    num_heads: int,
    dropout_rate: float = 0.0,
    seed: Optional[int] = None,
    out: Optional[torch.Tensor] = None,
    lse: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The attention's backward (K2): (dq, dk, dv) for the cotangent g of
    ``attention(q, k, v, bias, ...)`` with the same rate and seed. CPU
    tensors take ``attention_bwd_ref``; CUDA tensors launch the variant
    ``bwd_variant`` picks and add one to ``attention_bwd.launches`` and to
    the variant's count. ``out`` and ``lse``, the forward's output and row
    log-sum-exps (``attention_kernel(..., return_lse=True)``), are what
    ``"wg"`` reads; without them it gets both from one K1 launch first."""
    _check_rate(dropout_rate, seed)
    if q.device.type == "cpu":
        return attention_bwd_ref(q, k, v, bias, g, num_heads=num_heads,
                                 dropout_rate=dropout_rate, seed=seed)
    _check_devices(q, k=k, v=v, bias=bias, g=g, out=out, lse=lse)
    bias_rows = _bias_rows(bias, q, k.shape[1])
    return _bwd_cuda(q, k, v, bias_rows, g, num_heads, dropout_rate, seed,
                     bwd_variant(q.dtype, q.shape[1], k.shape[1], q.shape[2] // num_heads),
                     out, lse)


def attention_kernel(q, k, v, bias, *, num_heads: int, variant: str, dropout_rate: float = 0.0,
                     seed: Optional[int] = None, return_probs: bool = False,
                     return_lse: bool = False):
    """One launch of the named forward variant (one of ``VARIANTS``) on CUDA
    tensors, bypassing ``fwd_variant``: for comparing the variants on the
    card. Counts like ``attention``; not differentiable. With
    ``return_probs``, the probabilities after ``out`` (as ``attention``
    returns them); with ``return_lse`` (bf16 variants), last, the fp32
    [B, h, Sq] log-sum-exp of each row's scaled, biased scores."""
    _check_rate(dropout_rate, seed)
    _check_devices(q, k=k, v=v, bias=bias)
    return _fwd_cuda(q, k, v, _bias_rows(bias, q, k.shape[1]), num_heads, float(dropout_rate),
                     seed, variant, return_probs=return_probs, return_lse=return_lse)


def attention_bwd_kernel(q, k, v, bias, g, *, num_heads: int, variant: str,
                         dropout_rate: float = 0.0, seed: Optional[int] = None,
                         out: Optional[torch.Tensor] = None, lse: Optional[torch.Tensor] = None):
    """One launch of the named backward variant on CUDA tensors, bypassing
    ``bwd_variant`` (see ``attention_kernel``; ``out`` and ``lse`` as for
    ``attention_bwd``, read by ``"wg"`` only)."""
    _check_rate(dropout_rate, seed)
    _check_devices(q, k=k, v=v, bias=bias, g=g, out=out, lse=lse)
    return _bwd_cuda(q, k, v, _bias_rows(bias, q, k.shape[1]), g, num_heads,
                     float(dropout_rate), seed, variant, out, lse)


#: kernel launches since the last reset, in all and by variant (CPU calls
#: do not count); ``attention.launches_probs``: forward launches that also
#: wrote the probabilities (each counts in its variant's too)
for _wrapper, _variants in ((attention, VARIANTS), (attention_bwd, BWD_VARIANTS)):
    _wrapper.launches = 0
    for _variant in _variants:
        setattr(_wrapper, f"launches_{_variant}", 0)
del _wrapper, _variants, _variant
attention.launches_probs = 0
