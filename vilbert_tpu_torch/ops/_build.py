"""Build the port's CUDA kernels and bind them with ctypes.

Every ``vilbert_tpu_torch/csrc/*.cu`` compiles with ``nvcc`` for ``sm_90a``
(one ``nvcc`` per source, all started together) and links into ONE shared
library with a plain C interface. No source includes PyTorch's headers, so
the build takes seconds, not the minutes that
``torch.utils.cpp_extension.load`` spends. The library lands in
``build/vilbert_tpu_torch/`` at the root of the checkout, named by a hash of
the sources (``*.cu`` and the ``*.cuh`` they include) and flags: an edited
source builds a new library, an unchanged one loads the library built
before.

The build runs at first use (``load_library()``), never at import: the CPU
tests import every module of the package on machines without ``nvcc``.
Callers pass tensors' ``data_ptr()`` and
``torch.cuda.current_stream().cuda_stream`` as Python ints; every pointer and
the stream are declared ``c_void_p`` so that ctypes does not cut them to
32 bits. Each entry point returns a ``cudaError_t``; ``check`` raises on any
non-zero code.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "vilbert_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_U32 = ctypes.c_uint32  # a dropout seed may be >= 2^31
#: entry point -> argtypes (all return a cudaError_t as int)
_SIGNATURES = {
    # q, k, v, bias, out, dtype, batch, heads, head_dim, sq, sk,
    # q/k/v batch and row strides, bias batch stride, scale,
    # dropout seed, keep threshold, keep scale, probabilities (or null), stream
    "vt_attention_fwd": [_P] * 5 + [_I] * 6 + [_LL] * 7 + [_F, _U32, _U32, _F, _P, _P],
    # q, k, v, bias, g, dq, dk, dv, dtype, batch, heads, head_dim, sq, sk,
    # q/k/v/g batch and row strides, bias batch stride, scale,
    # dropout seed, keep threshold, keep scale, stream
    "vt_attention_bwd": [_P] * 8 + [_I] * 6 + [_LL] * 9 + [_F, _U32, _U32, _F, _P],
    # the tensor-core variants: the same without the dtype (bf16 only), and
    # the row log-sum-exps (or null) before the probabilities
    "vt_attention_fwd_tc": [_P] * 5 + [_I] * 5 + [_LL] * 7 + [_F, _U32, _U32, _F, _P, _P, _P],
    "vt_attention_fwd_long_tc": [_P] * 5 + [_I] * 5 + [_LL] * 7 + [_F, _U32, _U32, _F, _P, _P,
                                                                   _P],
    # the wgmma K1 (attention_fwd_wg.cu): the arguments of the two above
    "vt_attention_fwd_wg": [_P] * 5 + [_I] * 5 + [_LL] * 7 + [_F, _U32, _U32, _F, _P, _P, _P],
    "vt_attention_bwd_tc": [_P] * 8 + [_I] * 5 + [_LL] * 9 + [_F, _U32, _U32, _F, _P],
    # the long-sequence K2: vt_attention_bwd's arguments with the fp32
    # row-statistics workspace after dv
    "vt_attention_bwd_long": [_P] * 9 + [_I] * 6 + [_LL] * 9 + [_F, _U32, _U32, _F, _P],
    # ... and on the tensor cores: the same without the dtype (bf16 only)
    "vt_attention_bwd_long_tc": [_P] * 9 + [_I] * 5 + [_LL] * 9 + [_F, _U32, _U32, _F, _P],
    # the wgmma K2: q, k, v, bias, g, the forward's output and row
    # log-sum-exps, dq, dk, dv, its fp32 workspace, then as the one above
    "vt_attention_bwd_wg": [_P] * 11 + [_I] * 5 + [_LL] * 9 + [_F, _U32, _U32, _F, _P],
    # x, residual, weight, bias, out, dtype, weight dtype, rows, h, eps,
    # stream: one entry point a LayerNorm variant ("block", "persistent")
    "vt_layer_norm_fwd_block": [_P] * 5 + [_I] * 4 + [_F, _P],
    "vt_layer_norm_fwd_persistent": [_P] * 5 + [_I] * 4 + [_F, _P],
    # the rational gelu (gelu.cu): x, out, dtype, n, stream; and x, dy, dx,
    # dtype, n, stream
    "vt_gelu_rational_fwd": [_P] * 2 + [_I, _LL, _P],
    "vt_gelu_rational_bwd": [_P] * 3 + [_I, _LL, _P],
    # the hidden-state dropout (dropout.cu): x (or g), out, dtype, n, flat
    # offset, seed term, keep threshold, divisor, stream
    "vt_hidden_dropout_fwd": [_P] * 2 + [_I, _LL, _U32, _U32, _U32, _F, _P],
    "vt_hidden_dropout_bwd": [_P] * 2 + [_I, _LL, _U32, _U32, _U32, _F, _P],
}

#: dtype codes of the C entry points
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def check_elementwise(kernel: str, **operands: torch.Tensor) -> None:
    """Raise ValueError unless every operand is what the elementwise
    kernels (gelu.cu, dropout.cu) take: float32 or bfloat16, contiguous
    and 16-byte aligned."""
    for name, t in operands.items():
        if t.dtype not in DTYPE_CODES:
            raise ValueError(f"{kernel} kernels take float32 or bfloat16, got {name} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel} kernels need a contiguous {name}")
        if t.data_ptr() % 16:
            raise ValueError(f"{kernel} kernels need {name} 16-byte aligned")


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in /usr/local/cuda/bin): the "
            "CUDA kernels of vilbert_tpu_torch are built from source"
        )
    return path


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*CSRC_DIR.glob("*.cu"), *CSRC_DIR.glob("*.cuh")]):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libvilbert_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library of the same sources exists."""
    lib = library_path()
    if lib.exists():
        return lib
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    objs, procs = [], []
    for src in sorted(CSRC_DIR.glob("*.cu")):
        obj = tmp.with_name(f"{tmp.name}.{src.stem}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True)))
    try:
        for cmd, proc in procs:
            out, _ = proc.communicate()
            _check_nvcc(cmd, proc.returncode, out)
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        _check_nvcc(cmd, proc.returncode, proc.stdout)
        os.replace(tmp, lib)  # atomic: a concurrent build sees all or nothing
    finally:
        for _, proc in procs:  # a failed source stops the others
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        for path in (*objs, tmp):
            path.unlink(missing_ok=True)
    return lib


def _check_nvcc(cmd, returncode: int, output: str) -> None:
    if returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {returncode}:\n{' '.join(cmd)}\n{output}")


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernels' library, once per process."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.vt_error_string.argtypes = [ctypes.c_int]
    lib.vt_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if err != 0:
        msg = load_library().vt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
