"""Int8 matmuls for inference: dynamic and static-calibrated.

Counterpart of ``vilbert_tpu/ops/quant.py`` (``_quantize``,
``_quantize_act_static``, ``int8_dense``) with the same arithmetic, on the
port's ``[out, in]`` weights (JAX kernels are ``[in, out]``, so a
per-output-channel scale reduces over dim 1 here, over axis 0 there). The
JAX ``int8_head_proj`` and ``int8_merge_proj`` are ``int8_dense`` with the
heads split after or merged before; the port's attention sites are plain
``[out, in]`` ``Linear`` layers, so every site calls ``int8_dense``:

- **dynamic** (``ModelConfig.int8_matmul``): one per-tensor activation scale
  a call, per-output-channel weight scales,
  ``y = (q(x) q(W)^T : int32) * (s_x * s_w)``;
- **static** (``ModelConfig.int8_static``): per-input-channel activation
  scales from a calibration pass (``calibrating``), folded into the weight
  before it is quantized per output channel:
  ``y = (q(x / s_in) q(W * s_in)^T : int32) * s'_w``.

A scale is ``amax / 127 + 1e-8`` computed in the dtype of what it scales
(a bf16 activation's per-tensor scale is rounded to bf16, as ``jnp``
computes ``amax / 127.0`` on a bf16 array), then widened to fp32; values
are rounded half to even (``torch.round``, as ``jnp.round``) and clamped to
+-127. The weights stay fp32 parameters and are quantized on every call, as
the JAX package does in its graph: checkpoints do not change.

The int8 product is ``int_mm``: on a CUDA tensor ``torch._int_mm`` on the
int8 tensor cores (the JAX package computes this dot with
``lax.dot_general`` outside any Pallas kernel, so it is a library GEMM in
the port too), its operands padded with zeros to ``_int_mm``'s shape rules
(more than 16 rows, k and n multiples of 8; a zero row or column adds
nothing to an integer dot). ``int_mm.launches`` counts its calls and
``int_mm.launches_padded`` those that needed padding. Its plain version,
``int_mm_ref``, the CPU path and the card's oracle, is the same product in
float64: each term is at most 127^2 and a sum of fewer than 2^38 of them is
an integer below 2^53, so it is exact in any order. The quantization passes
are plain PyTorch, as the JAX package leaves them to XLA. Inference only:
nothing here has a gradient.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch
from torch import nn

QMAX = 127.0
EPS = 1e-8
#: torch._int_mm's rules on CUDA: more than 16 rows, k and n multiples of 8
INT_MM_MIN_ROWS = 17
INT_MM_MULTIPLE = 8


def quantize(x: torch.Tensor, dim: Optional[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 (``_quantize``): scale over ``dim`` (None: the whole
    tensor), kept as a size-1 dim; returns (q int8, scale fp32) with
    x ~ q * scale."""
    mag = x.abs()
    amax = mag.amax() if dim is None else mag.amax(dim=dim, keepdim=True)
    scale = (amax / QMAX + EPS).float()
    q = torch.clamp(torch.round(x.float() / scale), -QMAX, QMAX)
    return q.to(torch.int8), scale


def quantize_act_static(x: torch.Tensor, amax: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 activations with calibrated per-channel scales
    (``_quantize_act_static``): ``amax`` [in] is the fp32 abs-max of each
    input channel; values past it saturate at +-127."""
    scale = (amax / QMAX + EPS).float()
    q = torch.clamp(torch.round(x.float() / scale), -QMAX, QMAX)
    return q.to(torch.int8), scale


def _round_up(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def int_mm_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [m, k] int8 times b [n, k] int8 transposed -> int32 [m, n], exactly
    (in float64, see the module docstring)."""
    return (a.double() @ b.double().T).to(torch.int32)


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [m, k] int8 times b [n, k] int8 transposed -> int32 [m, n]. CPU
    tensors take ``int_mm_ref``; CUDA tensors launch ``torch._int_mm`` on
    operands zero-padded to its shape rules, or raise."""
    if a.dtype != torch.int8 or b.dtype != torch.int8 or a.dim() != 2 or b.dim() != 2 \
            or a.shape[1] != b.shape[1]:
        raise ValueError(f"int_mm takes int8 a [m, k] and b [n, k], got {a.dtype} "
                         f"{tuple(a.shape)} and {b.dtype} {tuple(b.shape)}")
    if a.device.type == "cpu":
        return int_mm_ref(a, b)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"int_mm runs on cpu or cuda, got {a.device} and {b.device}")
    (m, k), n = a.shape, b.shape[0]
    mp, kp, np_ = (max(m, INT_MM_MIN_ROWS), _round_up(k, INT_MM_MULTIPLE),
                   _round_up(n, INT_MM_MULTIPLE))
    padded = (mp, kp, np_) != (m, k, n)
    if padded:
        a_p, b_p = a.new_zeros(mp, kp), b.new_zeros(np_, kp)
        a_p[:m, :k], b_p[:n, :k] = a, b
        a, b = a_p, b_p
    # b^T as a column-major view: the int8 GEMM's "TN" layout
    y = torch._int_mm(a.contiguous(), b.contiguous().T)
    int_mm.launches += 1
    if padded:
        int_mm.launches_padded += 1
        y = y[:m, :n]
    return y


#: ``torch._int_mm`` launches since the last reset, and those whose
#: operands were padded (CPU calls do not count)
int_mm.launches = 0
int_mm.launches_padded = 0


def int8_dense(x: torch.Tensor, weight: torch.Tensor, out_dtype: torch.dtype,
               act_amax: Optional[torch.Tensor] = None, *, plain: bool = False
               ) -> torch.Tensor:
    """[..., in] x [out, in]^T with int8 arithmetic, returned in
    ``out_dtype`` (``int8_dense``; no bias: the caller adds it in the
    compute dtype). Dynamic with ``act_amax=None``; static with the
    calibrated [in] abs-max folded into the weight. ``plain`` takes the
    product from ``int_mm_ref`` (the plain version, on any device)."""
    if act_amax is None:
        xq, sx = quantize(x, None)
        wq, sw = quantize(weight, 1)  # [out, 1]
        rescale = sx * sw[:, 0]
    else:
        xq, s_in = quantize_act_static(x, act_amax)
        wq, sw = quantize(weight.float() * s_in[None, :], 1)
        rescale = sw[:, 0]
    y = (int_mm_ref if plain else int_mm)(xq.reshape(-1, x.shape[-1]), wq)
    return (y.float() * rescale).to(out_dtype).reshape(*x.shape[:-1], weight.shape[0])


def static_act_amax(site: nn.Module, x: torch.Tensor) -> Optional[torch.Tensor]:
    """A static-int8 site's activation range (``_int8_act_amax``). While
    ``calibrating``: fold x's per-channel abs-max into the site's fp32
    ``act_amax`` buffer and return None, so that the site computes with
    dynamic scales as it observes; otherwise the calibrated buffer. A site
    that was never calibrated (nor loaded with ``core.weights.load_quant``)
    raises, as a flax apply does for a ``quant`` variable it is not given."""
    if site.calibrating:
        with torch.no_grad():
            obs = x.detach().float().abs().reshape(-1, x.shape[-1]).amax(0)
            site.act_amax = torch.maximum(site.act_amax, obs)
        site.calibrated = True
        return None
    if not site.calibrated:
        raise ValueError(
            f"{type(site).__name__} [{site.act_amax.shape[0]} in]: an int8_static site needs "
            f"its act_amax; calibrate the model under ops.quant.calibrating(model) first")
    return site.act_amax


def static_sites(model: nn.Module) -> dict:
    """{module path: module} of ``model``'s static-int8 sites."""
    return {name: m for name, m in model.named_modules() if getattr(m, "int8", None) == "static"}


@contextlib.contextmanager
def calibrating(model: nn.Module):
    """Static calibration, the port's ``apply(..., mutable=["quant"])``:
    inside the context every static-int8 site of ``model`` accumulates the
    running per-channel abs-max of its input over the forwards run, and
    computes with dynamic scales while it observes. Calling it again goes
    on from the ranges already kept."""
    sites = static_sites(model).values()
    if not sites:
        raise ValueError("calibrating: the model has no int8_static site (cfg.int8_static)")
    for m in sites:
        m.calibrating = True
    try:
        yield model
    finally:
        for m in sites:
            m.calibrating = False
