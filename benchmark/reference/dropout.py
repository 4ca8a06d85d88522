"""Counter-hash dropout masks (murmur3 finalizer), as both sides take them.

A hidden-state mask is the hash of the flat element index and the call's
seed; an attention-probability mask is the hash of (query row, key column,
tile seed), with tile (b, h) seeded ``seed + (b * heads + h) * 7919`` mod
2^32. uint32 arithmetic is emulated in int64 (every value in [0, 2^32),
products by 32-bit constants taken from their 16-bit halves). Keep where
the hash is at or above ``rate * 2^32``.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B1
_SEED_MUL = 0x27D4EB2F
_COL_ADD, _COL_MUL = 0x7F4A7C15, 0x85EBCA77
_TILE_STRIDE = 7919


def keep_threshold(rate: float) -> int:
    return min(int(rate * (2 ** 32)), 2 ** 32 - 1)


def draw_seed(generator: torch.Generator) -> int:
    """One uint32 seed from a CPU generator."""
    return int(torch.randint(0, 2 ** 32, (), generator=generator, dtype=torch.int64))


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _mix(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def keep_mask(shape: Sequence[int], rate: float, seed: int, device=None,
              offset: int = 0) -> torch.Tensor:
    """Hidden-state keep mask of ``shape`` for one call's seed; ``offset``: the
    flat index of its first element in the call's whole tensor (a block of
    rows)."""
    idx = (torch.arange(math.prod(shape), dtype=torch.int64, device=device) + offset) & _M32
    x = _mul32(idx, _GOLDEN) ^ ((seed * _SEED_MUL) & _M32)
    return (_mix(x) >= keep_threshold(rate)).reshape(tuple(shape))


def attention_keep_mask(batch: int, heads: int, sq: int, sk: int, rate: float, seed: int,
                        device=None, row: int = 0) -> torch.Tensor:
    """[B, heads, Sq, Sk] keep mask of one attention call's seed; ``row``: the
    call's first batch row in its whole batch (a block of rows)."""
    tiles = (seed + (row * heads + torch.arange(batch * heads, dtype=torch.int64,
                                                device=device)) * _TILE_STRIDE) & _M32
    query = torch.arange(sq, dtype=torch.int64, device=device)[:, None]
    col = torch.arange(sk, dtype=torch.int64, device=device)[None, :]
    base = _mul32(query, _GOLDEN) ^ _mul32((col + _COL_ADD) & _M32, _COL_MUL)
    x = base[None] ^ _mul32(tiles, _SEED_MUL)[:, None, None]
    return (_mix(x) >= keep_threshold(rate)).reshape(batch, heads, sq, sk)
