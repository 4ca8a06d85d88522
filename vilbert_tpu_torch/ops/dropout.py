"""Counter-hash dropout masks of the JAX package, in PyTorch.

Counterpart of ``vilbert_tpu/ops/dropout.py`` (``hash_keep_mask`` and
``hash_dropout``, murmur3 variant: the hidden-state dropout sites, the
JAX package's default ``use_fast_dropout``) and of the mask inside the TPU
attention kernels, ``vilbert_tpu/ops/pallas_attention_train.py::_keep_mask``
(the attention-probability dropout). ``csrc/attention.cu`` and
``csrc/attention_bwd.cu`` compute the attention mask in-kernel;
``attention_keep_mask`` here is their plain twin.

torch on the CPU has no uint32 shift, so the uint32 arithmetic is emulated
in int64: every value stays in [0, 2^32), and every product by a 32-bit
constant is taken modulo 2^32 from the constant's two 16-bit halves, so no
intermediate leaves int64's range. Seeds are Python ints in [0, 2^32).
That chain (``hash_keep_mask``, ``hash_dropout_ref``) is the CPU path and
the plain twin of ``csrc/dropout.cu``, whose two kernels hash in uint32
registers: ``hash_dropout`` launches them on CUDA tensors, one pass
forward and one backward, and saves no mask.

``draw_seed`` takes one uint32 seed from an explicit CPU ``torch.Generator``:
a dropout site draws one per call, and the seed reaches the mask (or the
kernel) as a host scalar, so no device value is read back.

Data parallelism: the JAX step computes on the global batch, so its masks
are those of the global shape. The ranks of data row r of a mesh hold rows
r * B_local ... of it, so their hidden masks start at the flat index
``r * x.numel()`` (``offset``), and their attention tiles at
(b + r * B_local, h), a seed shift (``shard_seed``); with both, the data
rows' masks concatenated are the single process's on the concatenated
batch. The pairs of ``in_batch_pairs`` over data rows are rows
r * B_local * B ... of the global pairs, which the same offsets give.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence

import torch

from vilbert_tpu_torch.ops import _build

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B1     # row / flat-index multiplier
_SEED_MUL = 0x27D4EB2F
_COL_ADD, _COL_MUL = 0x7F4A7C15, 0x85EBCA77
#: the program-id stride of the Pallas kernels' tile seed
TILE_SEED_STRIDE = 7919


def keep_threshold(rate: float) -> int:
    """uint32 threshold of a keep mask, in Python double as the JAX package
    computes it: keep where hash >= threshold."""
    return min(int(rate * (2 ** 32)), 2 ** 32 - 1)


def draw_seed(generator: torch.Generator) -> int:
    """One uint32 seed from a CPU generator."""
    return int(torch.randint(0, 2 ** 32, (), generator=generator, dtype=torch.int64))


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32) and a constant c < 2^32."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _murmur_mix(x: torch.Tensor) -> torch.Tensor:
    """The murmur3 finalizer of ``dropout.py:29-35`` on int64-held uint32."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def hash_keep_mask(shape: Sequence[int], rate: float, seed: int,
                   device=None, offset: int = 0) -> torch.Tensor:
    """Boolean keep mask with P(keep) = 1 - rate, bit-exact with
    ``vilbert_tpu.ops.dropout.hash_keep_mask(shape, rate, seed)``: the hash
    of the flat element index and the seed. ``offset`` starts the flat
    index there (mod 2^32, as the JAX uint32 iota wraps): the block of a
    larger mask whose flat indices begin at ``offset``."""
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    if offset:
        idx = (idx + offset) & _M32
    x = _mul32(idx, _GOLDEN) ^ ((seed * _SEED_MUL) & _M32)
    return (_murmur_mix(x) >= keep_threshold(rate)).reshape(tuple(shape))


@functools.lru_cache(maxsize=None)
def _divisor(rate: float, dtype: torch.dtype) -> float:
    """1 - rate rounded to ``dtype`` as ``torch.full`` rounds it: the
    kernels' divisor."""
    return torch.full((), 1.0 - rate, dtype=dtype).item()


def hash_dropout_ref(x: torch.Tensor, rate: float, seed: int, offset: int = 0) -> torch.Tensor:
    """The plain version of ``hash_dropout``: the int64 mask, then kept
    elements DIVIDED by (1 - rate) in x's dtype, dropped ones 0.

    The divisor is a tensor on x's device: a CPU scalar would make a CUDA
    division multiply by its reciprocal, which rounds differently."""
    keep = hash_keep_mask(x.shape, rate, seed, device=x.device, offset=offset)
    divisor = torch.full((), 1.0 - rate, dtype=x.dtype, device=x.device)
    return torch.where(keep, x / divisor, 0.0)


def kernel_numel(x: torch.Tensor) -> int:
    """Validate an operand of the kernels (x forward, the cotangent
    backward); return its number of elements. Raises ValueError for
    anything they do not take: float32 or bfloat16, contiguous and 16-byte
    aligned."""
    _build.check_elementwise("hidden_dropout", x=x)
    return x.numel()


def _launch(entry: str, x: torch.Tensor, rate: float, seed: int, offset: int) -> torch.Tensor:
    """One launch of ``entry`` over x into a new tensor like x."""
    n = kernel_numel(x)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = getattr(_build.load_library(), entry)(
            x.data_ptr(), out.data_ptr(), _build.DTYPE_CODES[x.dtype], n, offset & _M32,
            (seed * _SEED_MUL) & _M32, keep_threshold(rate), _divisor(rate, x.dtype),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, f"hash_dropout kernel ({entry})")
    return out


def _fwd_cuda(x: torch.Tensor, rate: float, seed: int, offset: int = 0) -> torch.Tensor:
    y = _launch("vt_hidden_dropout_fwd", x, rate, seed, offset)
    hash_dropout.launches += 1
    return y


def _bwd_cuda(g: torch.Tensor, rate: float, seed: int, offset: int = 0) -> torch.Tensor:
    dx = _launch("vt_hidden_dropout_bwd", g, rate, seed, offset)
    hash_dropout.launches_bwd += 1
    return dx


class _HashDropout(torch.autograd.Function):
    """Saves no tensor: the backward recomputes the mask from (rate, seed,
    offset). Autograd's derivative of the plain version, where then div,
    gives kept g / divisor and +0 elsewhere: the plain version applied to g."""

    @staticmethod
    def forward(ctx, x, rate, seed, offset):
        ctx.mask = (rate, seed, offset)
        if x.device.type == "cpu":
            return hash_dropout_ref(x, rate, seed, offset)
        if x.device.type != "cuda":
            raise ValueError(f"hash_dropout runs on cpu or cuda, got {x.device}")
        # the mask is over the logical flat index, which a dense copy keeps
        return _fwd_cuda(x.contiguous(), rate, seed, offset)

    @staticmethod
    def backward(ctx, g):
        if g.device.type == "cpu":
            return hash_dropout_ref(g, *ctx.mask), None, None, None
        # a cotangent's layout is its producer's: the kernel takes it dense
        return _bwd_cuda(g.contiguous(), *ctx.mask), None, None, None


def hash_dropout(x: torch.Tensor, rate: float, seed: int, offset: int = 0) -> torch.Tensor:
    """``vilbert_tpu.ops.dropout.hash_dropout`` for one drawn seed: kept
    elements are DIVIDED by (1 - rate) in x's dtype, dropped ones are 0.
    ``offset``: the mask's first flat index (``hash_keep_mask``).

    CPU tensors take the plain version, forward and backward. CUDA tensors
    launch the forward kernel and add one to ``hash_dropout.launches``;
    their backward launches the backward kernel (``.launches_bwd``), which
    recomputes the mask: no mask is saved. Anything the kernels do not take
    raises."""
    if rate == 0.0:
        return x
    return _HashDropout.apply(x, rate, seed, offset)


#: kernel launches since the last reset, forward and backward (CPU calls do
#: not count)
hash_dropout.launches = 0
hash_dropout.launches_bwd = 0


def tile_keep_mask(sq: int, sk: int, rate: float, tile_seeds: torch.Tensor) -> torch.Tensor:
    """``pallas_attention_train._keep_mask((sq, sk), rate, seed)`` for each
    tile seed of ``tile_seeds`` (int64 in [0, 2^32), shape [N]) -> [N, sq, sk]:
    the hash of (row, col, seed), with row the query and col the key index."""
    dev = tile_seeds.device
    row = torch.arange(sq, dtype=torch.int64, device=dev)[:, None]
    col = torch.arange(sk, dtype=torch.int64, device=dev)[None, :]
    base = _mul32(row, _GOLDEN) ^ _mul32((col + _COL_ADD) & _M32, _COL_MUL)
    x = base[None] ^ _mul32(tile_seeds, _SEED_MUL)[:, None, None]
    return _murmur_mix(x) >= keep_threshold(rate)


def attention_keep_mask(batch: int, num_heads: int, sq: int, sk: int, rate: float,
                        seed: int, device=None) -> torch.Tensor:
    """The attention-probability keep mask [B, heads, Sq, Sk] of the Pallas
    kernels for one call seed: tile (b, h) uses the seed
    ``seed + (b * num_heads + h) * 7919`` mod 2^32, as the int32 wrap of
    ``_fwd_kernel:73`` gives it."""
    bh = torch.arange(batch * num_heads, dtype=torch.int64, device=device)
    tile_seeds = (seed + bh * TILE_SEED_STRIDE) & _M32
    return tile_keep_mask(sq, sk, rate, tile_seeds).reshape(batch, num_heads, sq, sk)


def shard_seed(seed: int, rank: int, batch: int, num_heads: int) -> int:
    """The attention call seed of rank ``rank`` holding ``batch`` rows a
    rank: tile (b, h) of its call then takes the seed of tile
    (b + rank * batch, h) of the call over the global batch."""
    return (seed + rank * batch * num_heads * TILE_SEED_STRIDE) & _M32
