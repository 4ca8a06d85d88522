"""LayerNorm(x [+ residual]): plain PyTorch version and the Hopper kernel.

Counterpart of ``vilbert_tpu/ops/layernorm.py`` and of the TPU kernel
``vilbert_tpu/ops/pallas_layernorm.py::_ln_kernel``: TF-style LayerNorm
(eps inside the sqrt, 1e-12), fp32 statistics, the residual added in fp32,
fp32 weight and bias, output in x's dtype. The kernel (``csrc/layernorm.cu``)
is bandwidth-bound; its source note says how it keeps to one read and one
write of each element.

``layer_norm`` is the entry point, differentiable through an
``autograd.Function``. Its forward runs ``layer_norm_ref`` on a CPU tensor
and launches the kernel on a CUDA tensor (or raises). Its backward is
``layer_norm_bwd_ref`` on both: the JAX package's backward
(``pallas_layernorm.py::_ln_bwd``) is XLA, not a Pallas kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from vilbert_tpu_torch.ops import _build

#: the kernel keeps a row in registers: H a multiple of 32 lanes x 4 elements
KERNEL_H_MULTIPLE = 128
KERNEL_MAX_H = 2048


def layer_norm_ref(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    *,
    eps: float = 1e-12,
    residual: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """y = weight * (x [+ residual] - mean) / sqrt(var + eps) + bias over the
    last axis, in fp32, returned in x's dtype."""
    xf = x.float()
    if residual is not None:
        xf = xf + residual.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


def layer_norm_bwd_ref(
    x: torch.Tensor,
    weight: torch.Tensor,
    g: torch.Tensor,
    *,
    eps: float = 1e-12,
    residual: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor, torch.Tensor]:
    """Backward of ``layer_norm`` for the cotangent g, as
    ``vilbert_tpu/ops/pallas_layernorm.py::_ln_bwd``: fp32 math, then
    (dx, dresidual = dx, dweight = sum g xhat, dbias = sum g) in the inputs'
    dtypes (dresidual None without a residual)."""
    h = x.shape[-1]
    xf = x.float().reshape(-1, h)
    if residual is not None:
        xf = xf + residual.float().reshape(-1, h)
    g32 = g.float().reshape(-1, h)
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    xhat = (xf - mean) * inv
    dw = (g32 * xhat).sum(0)
    db = g32.sum(0)
    gw = g32 * weight.float()[None, :]
    dx = inv * (gw - gw.mean(-1, keepdim=True)
                - xhat * (gw * xhat).mean(-1, keepdim=True))
    dx = dx.reshape(x.shape).to(x.dtype)
    dres = None if residual is None else dx.to(residual.dtype)
    return dx, dres, dw.to(weight.dtype), db.to(weight.dtype)


def kernel_rows(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    residual: Optional[torch.Tensor],
) -> int:
    """Validate the kernel's operands; return the number of rows.

    Raises ValueError for anything the kernel does not take: x and residual
    of one shape and one dtype (float32 or bfloat16), contiguous and 16-byte
    aligned; fp32 contiguous weight and bias of length H; H a multiple of
    128 and at most 2048.
    """
    h = x.shape[-1]
    if x.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"layer_norm kernel takes float32 or bfloat16, got {x.dtype}")
    if h % KERNEL_H_MULTIPLE or not 0 < h <= KERNEL_MAX_H:
        raise ValueError(
            f"layer_norm kernel takes H a multiple of {KERNEL_H_MULTIPLE} "
            f"up to {KERNEL_MAX_H}, got {h}"
        )
    operands = [("x", x)]
    if residual is not None:
        if residual.shape != x.shape or residual.dtype != x.dtype:
            raise ValueError(
                f"residual {tuple(residual.shape)} {residual.dtype} does not "
                f"match x {tuple(x.shape)} {x.dtype}"
            )
        operands.append(("residual", residual))
    for name, t in (("weight", weight), ("bias", bias)):
        if t.dtype != torch.float32 or tuple(t.shape) != (h,):
            raise ValueError(f"{name} must be float32 [{h}], got {t.dtype} {tuple(t.shape)}")
        operands.append((name, t))
    for name, t in operands:
        if not t.is_contiguous():
            raise ValueError(f"layer_norm kernel needs a contiguous {name}")
        if t.data_ptr() % 16:
            raise ValueError(f"layer_norm kernel needs {name} 16-byte aligned")
    return x.numel() // h


def _fwd_cuda(x, weight, bias, eps, residual):
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm runs on cpu or cuda, got {x.device}")
    for name, t in (("weight", weight), ("bias", bias), ("residual", residual)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
    rows = kernel_rows(x, weight, bias, residual)
    out = torch.empty_like(x)
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        err = lib.vt_layer_norm_fwd(
            x.data_ptr(),
            residual.data_ptr() if residual is not None else None,
            weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
            _build.DTYPE_CODES[x.dtype], rows, x.shape[-1], eps,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "layer_norm kernel")
    layer_norm.launches += 1
    return out


class _LayerNorm(torch.autograd.Function):
    """K4 forward (the plain version on the CPU), ``_ln_bwd`` backward."""

    @staticmethod
    def forward(ctx, x, residual, weight, bias, eps):
        ctx.save_for_backward(x, residual, weight)
        ctx.eps = eps
        if x.device.type == "cpu":
            return layer_norm_ref(x, weight, bias, eps=eps, residual=residual)
        return _fwd_cuda(x, weight, bias, eps, residual)

    @staticmethod
    def backward(ctx, g):
        x, residual, weight = ctx.saved_tensors
        dx, dres, dw, db = layer_norm_bwd_ref(x, weight, g, eps=ctx.eps, residual=residual)
        return dx, dres, dw, db, None


def layer_norm(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    *,
    eps: float = 1e-12,
    residual: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """LN(x [+ residual]) over the last axis; any leading shape;
    differentiable.

    CPU tensors take ``layer_norm_ref``. CUDA tensors launch the kernel and
    add one to ``layer_norm.launches``; anything the kernel does not take
    raises.
    """
    return _LayerNorm.apply(x, residual, weight, bias, eps)


#: kernel launches since the last reset (CPU calls do not count)
layer_norm.launches = 0
