"""Inputs and weights from ``--seed``, made by the benchmark and handed to
the program and to the reference alike.

Each use of the seed (weights, batches, dropout) takes a stream of its own,
a 63-bit number hashed from the seed and the use's name, so that any seed
the driver draws works. Weights are the initialisation of the reference
model (BERT's): every matrix and table ~ N(0, initializer_range), biases
0, LayerNorm scales 1. The normal draws are one call on the device, over
the parameters sorted by name, then cut into each parameter: the same
names and shapes give the same tensors on either side.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Iterable, Tuple

import torch


def stream(seed: int, use: str) -> int:
    digest = hashlib.sha256(f"{int(seed)}:{use}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2 ** 63 - 1)


def generator(seed: int, use: str, device="cpu") -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream(seed, use))


def init_kind(name: str, shape: Tuple[int, ...]) -> str:
    """"zeros", "ones" or "normal" for a parameter by its name and shape:
    biases 0, the other vectors (LayerNorm scales) 1, matrices and tables
    normal."""
    if name.endswith("bias"):
        return "zeros"
    if len(shape) == 1:
        return "ones"
    if len(shape) != 2:
        raise ValueError(f"{name} {shape}: no initialisation rule")
    return "normal"


@torch.no_grad()
def weights(named_shapes: Iterable[Tuple[str, Tuple[int, ...]]], seed: int, std: float,
            device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor on ``device``} for every (name, shape)."""
    shapes = dict(named_shapes)
    normal = sorted(n for n, s in shapes.items() if init_kind(n, s) == "normal")
    total = sum(torch.Size(shapes[n]).numel() for n in normal)
    flat = torch.randn(total, generator=generator(seed, "weights", device), device=device)
    flat.mul_(std)
    out, at = {}, 0
    for n in normal:
        size = torch.Size(shapes[n]).numel()
        out[n] = flat[at:at + size].view(shapes[n])
        at += size
    for n, s in shapes.items():
        kind = init_kind(n, s)
        if kind != "normal":
            out[n] = (torch.zeros if kind == "zeros" else torch.ones)(s, device=device)
    return out


@torch.no_grad()
def load_into(model: torch.nn.Module, tensors: Dict[str, torch.Tensor]) -> None:
    """Copy ``tensors`` into the model's parameters of the same names (each in
    its own dtype); every parameter must be given."""
    params = dict(model.named_parameters())
    missing = set(params) ^ set(tensors)
    if missing:
        raise KeyError(f"weights and model differ in {sorted(missing)[:5]}")
    for n, p in params.items():
        p.copy_(tensors[n])
