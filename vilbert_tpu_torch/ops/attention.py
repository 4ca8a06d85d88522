"""Multi-head attention core: plain PyTorch version and the Hopper kernel.

Counterpart of ``vilbert_tpu/ops/attention.py`` (``attention_core`` over
[B, S, H] projections, ``make_additive_mask``) and of the forward of the TPU
kernel ``vilbert_tpu/ops/pallas_attention_train.py::_fwd_kernel`` at dropout
rate 0, the rate evaluation runs. One entry point serves the text and image
self-attention and both co-attention directions (Sq != Sk).

Arithmetic, as in the Pallas kernel: scores q.k^T * (1/sqrt(d)) + key bias in
fp32, fp32 softmax, P rounded to v's dtype, then P.V accumulated in fp32 and
returned in q's dtype. The JAX XLA path would run a bf16 softmax under
``softmax_dtype="auto"``; the port follows the kernel.

``attention`` is the entry point. On CPU tensors it runs ``attention_ref``;
on CUDA tensors it launches ``csrc/attention.cu`` or raises. Attention-
probability dropout is a training feature and is not ported yet: a rate
above 0 raises.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from vilbert_tpu_torch.ops import _build

#: shapes the kernel takes
KERNEL_HEAD_DIMS = (64, 128)
KERNEL_MAX_KEYS = 512


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


def _check_rate(dropout_rate: float) -> None:
    if dropout_rate > 0.0:
        raise NotImplementedError(
            "attention-probability dropout is training-only and not ported "
            "yet (ROADMAP: slice 2, in-kernel hash dropout)"
        )


def attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor],
    *,
    num_heads: int,
    dropout_rate: float = 0.0,
) -> torch.Tensor:
    """Plain PyTorch attention. q [B, Sq, H], k/v [B, Sk, H] -> [B, Sq, H]."""
    _check_rate(dropout_rate)
    b, sq, hd = q.shape
    sk = k.shape[1]
    d = hd // num_heads

    def heads(x, s):
        return x.reshape(x.shape[0], s, num_heads, d).transpose(1, 2)

    scores = heads(q, sq).float() @ heads(k, sk).float().transpose(-1, -2)
    scores = scores * (1.0 / math.sqrt(d)) + _bias_rows(bias, q, sk)[:, None, None, :]
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    ctx = probs.float() @ heads(v, sk).float()
    return ctx.transpose(1, 2).reshape(b, sq, hd).to(q.dtype)


def kernel_geometry(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias_rows: torch.Tensor,
    num_heads: int,
) -> tuple:
    """Validate the kernel's operands; return (B, Sq, Sk, d).

    Raises ValueError for anything the kernel does not take: q [B, Sq, H]
    and k, v [B, Sk, H] of one dtype (float32 or bfloat16) with unit stride
    along H (batch and row strides are free, so broadcast and sliced views
    pass); d = H / heads in (64, 128); 1 <= Sk <= 512; an fp32 [B, Sk] bias
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


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor],
    *,
    num_heads: int,
    dropout_rate: float = 0.0,
) -> torch.Tensor:
    """Scaled dot-product attention over projected inputs.

    q [B, Sq, H], k/v [B, Sk, H], bias an additive key bias [B, 1, 1, Sk]
    (0 / -10000, see ``make_additive_mask``) or None. Returns [B, Sq, H] in
    q's dtype. CPU tensors take ``attention_ref``; CUDA tensors launch the
    kernel and add one to ``attention.launches``.
    """
    if q.device.type == "cpu":
        return attention_ref(q, k, v, bias, num_heads=num_heads, dropout_rate=dropout_rate)
    if q.device.type != "cuda":
        raise ValueError(f"attention runs on cpu or cuda, got {q.device}")
    _check_rate(dropout_rate)
    for name, t in (("k", k), ("v", v), ("bias", bias)):
        if t is not None and t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    bias_rows = _bias_rows(bias, q, k.shape[1])
    b, sq, sk, d = kernel_geometry(q, k, v, bias_rows, num_heads)
    out = torch.empty(b, sq, q.shape[2], dtype=q.dtype, device=q.device)
    lib = _build.load_library()
    with torch.cuda.device(q.device):
        err = lib.vt_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_rows.data_ptr(),
            out.data_ptr(), _build.DTYPE_CODES[q.dtype], b, num_heads, d, sq, sk,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), bias_rows.stride(0),
            1.0 / math.sqrt(d), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "attention kernel")
    attention.launches += 1
    return out


#: kernel launches since the last reset (CPU calls do not count)
attention.launches = 0
