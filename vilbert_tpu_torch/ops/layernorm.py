"""LayerNorm(x [+ residual]): plain PyTorch version and the Hopper kernel.

Counterpart of ``vilbert_tpu/ops/layernorm.py`` and of the TPU kernel
``vilbert_tpu/ops/pallas_layernorm.py::_ln_kernel``: TF-style LayerNorm
(eps inside the sqrt, 1e-12), fp32 statistics, the residual added in fp32,
weight and bias (fp32 or bf16) widened to fp32, output in x's dtype. The
kernel (``csrc/layernorm.cu``) is bound by device-memory bytes; its source
note says how it keeps to one read and one write of each element. It has two variants (``VARIANTS``),
both a row split over the warps of a block: "block", one row a block, and
"persistent", a grid the card holds at once striding over the rows;
``ln_variant`` picks one by row count. Each variant is built for fp32 and
for bf16 weight and bias (``--bf16_grads`` differentiates with respect to
bf16 copies of every parameter, LayerNorm's included); the kernel widens
them in registers, so the wrapper casts nothing.

``layer_norm`` is the entry point, differentiable through an
``autograd.Function``. Its forward runs ``layer_norm_ref`` on a CPU tensor
and launches the variant ``ln_variant`` picks on a CUDA tensor (or
raises). Its backward is ``layer_norm_bwd_ref`` on both: the JAX package's
backward (``pallas_layernorm.py::_ln_bwd``) is XLA, not a Pallas kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from vilbert_tpu_torch.ops import _build

#: the kernel keeps a row in registers: H a multiple of 32 lanes x 4 elements
KERNEL_H_MULTIPLE = 128
KERNEL_MAX_H = 2048
#: the kernel's variants: one row a block, and a resident grid striding
#: over the rows
VARIANTS = ("block", "persistent")
#: "persistent" takes more than PERSISTENT_MIN_ROWS rows and at most
#: PERSISTENT_MAX_ROWS[dtype], "block" the rest. Measured on an H100 80GB
#: HBM3 at 700 W (scripts/ab_kernels.py --kernel layer_norm, PERF.md): the
#: two tie up to 1,024 rows; "persistent" is faster from 2,048 rows (by up
#: to 22% at 9,472 x 1,024 bf16) to 12,928 (bf16) and 6,144 (fp32); "block"
#: from 14,592 (bf16) and 8,192 (fp32), by up to 6% at 103,424 x 1,024
PERSISTENT_MIN_ROWS = 1024
PERSISTENT_MAX_ROWS = {torch.bfloat16: 14_000, torch.float32: 7_000}


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


def ln_variant(rows: int, h: int, dtype: torch.dtype) -> str:
    """The kernel's variant for ``rows`` rows of ``h`` elements of
    ``dtype``: "persistent" between PERSISTENT_MIN_ROWS and
    PERSISTENT_MAX_ROWS, "block" outside (at every H of the paths)."""
    if PERSISTENT_MIN_ROWS < rows <= PERSISTENT_MAX_ROWS[dtype]:
        return "persistent"
    return "block"


def kernel_rows(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    residual: Optional[torch.Tensor],
) -> int:
    """Validate the kernel's operands; return the number of rows.

    Raises ValueError for anything the kernel does not take: x and residual
    of one shape and one dtype (float32 or bfloat16), contiguous and 16-byte
    aligned; weight and bias of one dtype (float32 or bfloat16), contiguous,
    of length H; H a multiple of 128 and at most 2048.
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
        if t.dtype != weight.dtype or t.dtype not in _build.DTYPE_CODES or tuple(t.shape) != (h,):
            raise ValueError(f"{name} must be float32 or bfloat16 [{h}], of the weight's dtype; "
                             f"got {t.dtype} {tuple(t.shape)}")
        operands.append((name, t))
    for name, t in operands:
        if not t.is_contiguous():
            raise ValueError(f"layer_norm kernel needs a contiguous {name}")
        if t.data_ptr() % 16:
            raise ValueError(f"layer_norm kernel needs {name} 16-byte aligned")
    return x.numel() // h


def _check_devices(x, weight, bias, residual) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm runs on cpu or cuda, got {x.device}")
    for name, t in (("weight", weight), ("bias", bias), ("residual", residual)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")


def _fwd_cuda(x, weight, bias, eps, residual, variant=None):
    """Launch ``variant`` (``ln_variant``'s pick when None) and count it, and
    on ``launches_bf16_weight`` when the weight and bias are bf16."""
    rows = kernel_rows(x, weight, bias, residual)
    h = x.shape[-1]
    variant = variant or ln_variant(rows, h, x.dtype)
    if variant not in VARIANTS:
        raise ValueError(f"layer_norm kernel variant must be one of {VARIANTS}, got {variant!r}")
    out = torch.empty_like(x)
    fn = getattr(_build.load_library(), f"vt_layer_norm_fwd_{variant}")
    with torch.cuda.device(x.device):
        err = fn(
            x.data_ptr(),
            residual.data_ptr() if residual is not None else None,
            weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
            _build.DTYPE_CODES[x.dtype], _build.DTYPE_CODES[weight.dtype], rows, h, eps,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, f"layer_norm kernel ({variant})")
    layer_norm.launches += 1
    name = f"launches_{variant}"
    setattr(layer_norm, name, getattr(layer_norm, name) + 1)
    if weight.dtype == torch.bfloat16:
        layer_norm.launches_bf16_weight += 1
    return out


class _LayerNorm(torch.autograd.Function):
    """K4 forward (the plain version on the CPU), ``_ln_bwd`` backward."""

    @staticmethod
    def forward(ctx, x, residual, weight, bias, eps):
        ctx.save_for_backward(x, residual, weight)
        ctx.eps = eps
        if x.device.type == "cpu":
            return layer_norm_ref(x, weight, bias, eps=eps, residual=residual)
        _check_devices(x, weight, bias, residual)
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

    CPU tensors take ``layer_norm_ref``. CUDA tensors launch the variant
    ``ln_variant`` picks and add one to ``layer_norm.launches``, to
    ``layer_norm.launches_<variant>`` and, with bf16 weight and bias, to
    ``layer_norm.launches_bf16_weight``; anything the kernel does not take
    raises.
    """
    return _LayerNorm.apply(x, residual, weight, bias, eps)


def layer_norm_kernel(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    *,
    variant: str,
    eps: float = 1e-12,
    residual: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One launch of the named variant (one of ``VARIANTS``) on CUDA
    tensors, bypassing ``ln_variant``: for checking and timing each variant
    on the card. Counts like ``layer_norm``; not differentiable."""
    _check_devices(x, weight, bias, residual)
    return _fwd_cuda(x, weight, bias, eps, residual, variant)


#: kernel launches since the last reset, in all, by variant and of the
#: bf16-weight instantiation (CPU calls do not count)
layer_norm.launches = 0
for _variant in VARIANTS:
    setattr(layer_norm, f"launches_{_variant}", 0)
del _variant
layer_norm.launches_bf16_weight = 0
