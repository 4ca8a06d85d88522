"""The rational gelu: plain PyTorch versions and the Hopper kernels.

gelu(x) = 0.5 x (1 + erf(x / sqrt 2)) with erf from a short P3/Q3 rational,
computed in fp32 and returned in x's dtype, with a rational custom
derivative: the forward and the custom JVP of
``vilbert_tpu/models/layers.py::gelu_rational``, which XLA fuses into one
pass. ``gelu_rational_ref`` and ``gelu_rational_bwd_ref`` are that
arithmetic as a chain of eager PyTorch operations (about 22 launches
forward and 20 backward on the card, each over an fp32 copy); the kernels
(``csrc/gelu.cu``) compute the same chain, rounded after every operation as
the eager kernels round, in one pass each, and are bit-equal to it.

``gelu_rational`` is the entry point, differentiable through an
``autograd.Function`` that saves only x. A CPU tensor takes the plain chain
forward and backward; a CUDA tensor launches the forward kernel, and its
backward the backward kernel (or raises).
"""

from __future__ import annotations

from typing import Optional

import torch

from vilbert_tpu_torch.ops import _build

# Minimax rational erf(z) ~ z P(z^2) / Q(z^2) on |z| <= 3.2: the coefficients
# of vilbert_tpu.models.layers (max abs error 9.7e-6; erf(3.2) rounds to 1.0
# in bf16, so the clamp is exact at bf16 precision).
_ERF_P = (1.1283621227654328, 0.15780611964408517,
          0.043127602475218844, 0.0007360894735171213)
_ERF_Q = (1.0, 0.47307127867236537,
          0.09602493287758253, 0.009191308867243501)
ERF_CLAMP = 3.2
SQRT_HALF = 0.7071067811865476

# gelu'(x) ~ 0.5 + x DP(x^2) / DQ(x^2) on |x| <= 5: the custom derivative of
# vilbert_tpu.models.layers.gelu_rational (max abs err 5.0e-4)
_DGELU_P = (0.7986929677932244, -0.03807846651247695,
            0.015090213881573151, 0.00019122776191594145)
_DGELU_Q = (1.0, 0.2926936920714664,
            0.03245537653061185, 0.006019591148099333)
DGELU_CLAMP = 5.0


def _horner(coeffs, u: torch.Tensor) -> torch.Tensor:
    acc = coeffs[-1]
    for c in coeffs[-2::-1]:
        acc = acc * u + c
    return acc


def gelu_rational_ref(x: torch.Tensor) -> torch.Tensor:
    """The forward as a chain of PyTorch operations in fp32, returned in
    x's dtype."""
    x32 = x.float()
    z = torch.clamp(x32 * SQRT_HALF, -ERF_CLAMP, ERF_CLAMP)
    u = z * z
    erf = z * _horner(_ERF_P, u) / _horner(_ERF_Q, u)
    return (0.5 * x32 * (1.0 + erf)).to(x.dtype)


def gelu_rational_bwd_ref(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """dx for the cotangent dy: the rational derivative in fp32, rounded to
    x's dtype, times dy, rounded again, as JAX rounds it."""
    s = torch.clamp(x.float(), -DGELU_CLAMP, DGELU_CLAMP)
    u = s * s
    dgelu = 0.5 + s * _horner(_DGELU_P, u) / _horner(_DGELU_Q, u)
    return (dgelu.to(x.dtype) * dy).to(x.dtype)


def kernel_numel(x: torch.Tensor, dy: Optional[torch.Tensor] = None) -> int:
    """Validate the kernels' operands; return the number of elements.

    Raises ValueError for anything the kernels do not take: x float32 or
    bfloat16, dy (the backward's) of x's shape and dtype, both contiguous
    and 16-byte aligned."""
    operands = {"x": x}
    if dy is not None:
        if dy.shape != x.shape or dy.dtype != x.dtype:
            raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} does not match "
                             f"x {tuple(x.shape)} {x.dtype}")
        operands["dy"] = dy
    _build.check_elementwise("gelu_rational", **operands)
    return x.numel()


def _check_devices(x: torch.Tensor, dy: Optional[torch.Tensor] = None) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"gelu_rational runs on cpu or cuda, got {x.device}")
    if dy is not None and dy.device != x.device:
        raise ValueError(f"dy on {dy.device}, x on {x.device}")


def _launch(entry: str, x: torch.Tensor, dy: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One launch of ``entry`` over x (and dy) into a new tensor like x."""
    n = kernel_numel(x, dy)
    out = torch.empty_like(x)
    inputs = (x,) if dy is None else (x, dy)
    with torch.cuda.device(x.device):
        err = getattr(_build.load_library(), entry)(
            *(t.data_ptr() for t in inputs), out.data_ptr(), _build.DTYPE_CODES[x.dtype], n,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, f"gelu_rational kernel ({entry})")
    return out


def _fwd_cuda(x: torch.Tensor) -> torch.Tensor:
    y = _launch("vt_gelu_rational_fwd", x)
    gelu_rational.launches += 1
    return y


def _bwd_cuda(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    dx = _launch("vt_gelu_rational_bwd", x, dy)
    gelu_rational.launches_bwd += 1
    return dx


def gelu_rational_bwd(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """dx of ``gelu_rational`` at x for the cotangent dy:
    ``gelu_rational_bwd_ref`` on CPU tensors; on CUDA tensors one launch of
    the backward kernel, counted on ``gelu_rational.launches_bwd``, or a
    ValueError."""
    if x.device.type == "cpu":
        return gelu_rational_bwd_ref(x, dy)
    _check_devices(x, dy)
    return _bwd_cuda(x, dy)


class _GeluRational(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        if x.device.type == "cpu":
            return gelu_rational_ref(x)
        _check_devices(x)
        return _fwd_cuda(x)

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
        # a cotangent's layout is its producer's: the kernel takes it dense
        return gelu_rational_bwd(x, dy.contiguous())


def gelu_rational(x: torch.Tensor) -> torch.Tensor:
    """gelu with erf from the short P3/Q3 rational above, in fp32, returned in
    x's dtype, with the rational custom derivative: the forward and the
    custom JVP of ``vilbert_tpu.models.layers.gelu_rational``.

    CPU tensors take the plain chain. CUDA tensors launch the forward
    kernel and add one to ``gelu_rational.launches``; their backward
    launches the backward kernel (``gelu_rational_bwd``). Anything the
    kernels do not take raises."""
    return _GeluRational.apply(x)


#: kernel launches since the last reset, forward and backward (CPU calls do
#: not count)
gelu_rational.launches = 0
gelu_rational.launches_bwd = 0
