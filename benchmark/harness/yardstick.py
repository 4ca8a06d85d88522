"""Peaks, work counts and kernel classes: the arithmetic behind the metrics.

Peaks are NVIDIA's published figures for one H100 SXM (dense, no
sparsity): 989 TFLOP/s in bf16 on the tensor cores, 3.35 TB/s of HBM3.

A *site* is one kind of product a unit of work (a step, a batch) runs, with
how many times it runs there:

- ``matmul``: ``m x k`` by ``k x n``, 2 m n k operations forward;
- ``attention``: one attention call over ``batch`` rows of ``heads`` heads
  of width ``d``, ``sq`` queries by ``sk`` keys: 2 B h Sq Sk d operations
  for the scores and as many for the context, forward;
- ``layernorm``: ``rows`` by ``width`` (counted for bytes, not operations).

Model operations are the forward's, times 3 for a training step (the
backward's two products a forward product: no recomputation counted). A
site with ``"grad": False`` runs forward only (its output reaches no loss).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def matmul(name: str, m: int, n: int, k: int, count: int = 1) -> Dict:
    return {"kind": "matmul", "name": name, "m": m, "n": n, "k": k, "count": count}


def attention(name: str, batch: int, heads: int, d: int, sq: int, sk: int, count: int = 1) -> Dict:
    return {"kind": "attention", "name": name, "batch": batch, "heads": heads, "d": d,
            "sq": sq, "sk": sk, "count": count}


def layernorm(name: str, rows: int, width: int, count: int = 1) -> Dict:
    return {"kind": "layernorm", "name": name, "rows": rows, "width": width, "count": count}


def forward_flops(sites: Iterable[Dict]) -> float:
    total = 0.0
    for s in sites:
        if s["kind"] == "matmul":
            total += 2.0 * s["m"] * s["n"] * s["k"] * s["count"]
        elif s["kind"] == "attention":
            total += 4.0 * s["batch"] * s["heads"] * s["sq"] * s["sk"] * s["d"] * s["count"]
    return total


def _trained(site: Dict, train: bool) -> bool:
    return train and site.get("grad", True)


def model_flops(sites: Iterable[Dict], train: bool) -> float:
    return sum(forward_flops([s]) * (3.0 if _trained(s, train) else 1.0) for s in sites)


def attention_cost(batch: int, heads: int, d: int, sq: int, sk: int, elt: int = 2) -> Dict:
    """(bytes, operations) of one attention forward (K1: q, k, v and the
    fp32 [B, Sk] key bias in, the output out; scores and context) and one
    backward (K2: q, k, v, the output's cotangent and the bias in, dq, dk,
    dv out; the scores again, dP, dV, dQ, dK), each byte once."""
    width = heads * d
    q, kv, bias = elt * batch * sq * width, elt * batch * sk * width, 4 * batch * sk
    mnk = batch * heads * sq * sk * d
    return {"fwd": (2 * q + 2 * kv + bias, 4.0 * mnk), "bwd": (3 * q + 4 * kv + bias, 10.0 * mnk)}


def least_seconds(nbytes: float, flops: float) -> float:
    """The least time the chip could take: the larger of bytes over HBM
    bandwidth and operations over the bf16 peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_BF16_FLOPS)


def attention_least_seconds(sites: Iterable[Dict], train: bool) -> float:
    total = 0.0
    for s in sites:
        if s["kind"] != "attention":
            continue
        cost = attention_cost(s["batch"], s["heads"], s["d"], s["sq"], s["sk"])
        per_call = least_seconds(*cost["fwd"])
        if _trained(s, train):
            per_call += least_seconds(*cost["bwd"])
        total += per_call * s["count"]
    return total


# -- the encoders' sites ------------------------------------------------------


def _block(prefix: str, rows: int, batch: int, seq: int, width: int, heads: int, inner: int,
           layers: int) -> List[Dict]:
    return [
        matmul(f"{prefix}.qkvo", rows, width, width, 4 * layers),
        matmul(f"{prefix}.ffn", rows, inner, width, 2 * layers),
        attention(f"{prefix}.self", batch, heads, width // heads, seq, seq, layers),
        layernorm(f"{prefix}.ln", rows, width, 2 * layers),
    ]


def vilbert_sites(c, batch: int, t: int, r: int) -> List[Dict]:
    """The two-stream encoder over ``t`` text positions (the task token
    included) and ``r`` regions (the global row included), with both
    embeddings and both poolers."""
    h, vh, bi = c["hidden_size"], c["v_hidden_size"], c["bi_hidden_size"]
    nc, bh = len(c["v_biattention_id"]), c["bi_num_attention_heads"]
    bt, br = batch * t, batch * r
    return [
        matmul("image.embed", br, vh, c["v_feature_size"]),
        matmul("image.loc", br, vh, c.get("num_locs", 5)),
        layernorm("text.embed_ln", bt, h), layernorm("image.embed_ln", br, vh),
        *_block("text", bt, batch, t, h, c["num_attention_heads"], c["intermediate_size"],
                c["num_hidden_layers"]),
        *_block("image", br, batch, r, vh, c["v_num_attention_heads"], c["v_intermediate_size"],
                c["v_num_hidden_layers"]),
        matmul("co.image_qkv", br, bi, vh, 3 * nc), matmul("co.text_qkv", bt, bi, h, 3 * nc),
        attention("co.text_to_image", batch, bh, bi // bh, t, r, nc),
        attention("co.image_to_text", batch, bh, bi // bh, r, t, nc),
        matmul("co.image_out", br, vh, bi, nc), matmul("co.text_out", bt, h, bi, nc),
        matmul("co.image_ffn", br, c["v_intermediate_size"], vh, 2 * nc),
        matmul("co.text_ffn", bt, c["intermediate_size"], h, 2 * nc),
        layernorm("co.image_ln", br, vh, 2 * nc), layernorm("co.text_ln", bt, h, 2 * nc),
        matmul("pool.text", batch, bi, h), matmul("pool.image", batch, bi, vh),
    ]


def basebert_sites(c, batch: int, t: int, r: int) -> List[Dict]:
    """The single-stream encoder over t + r positions, its embeddings and pooler."""
    h, s = c["hidden_size"], t + r
    return [
        matmul("image.embed", batch * r, h, c["v_feature_size"]),
        matmul("image.loc", batch * r, h, c.get("num_locs", 5)),
        layernorm("text.embed_ln", batch * t, h), layernorm("image.embed_ln", batch * r, h),
        *_block("joint", batch * s, batch, s, h, c["num_attention_heads"],
                c["intermediate_size"], c["num_hidden_layers"]),
        matmul("pool", batch, h, h),
    ]


def encoder_sites(family: str, c, batch: int, t: int, r: int) -> List[Dict]:
    return {"vilbert": vilbert_sites, "basebert": basebert_sites}[family](c, batch, t, r)


# -- kernel classes, from kernel names ---------------------------------------

#: (class, substrings of the kernel name), first match wins
CLASSES = (
    ("port attention", ("attention_fwd", "attention_bwd")),
    ("port layernorm", ("layer_norm_fwd_kernel",)),
    ("int8 GEMMs", ("gemm_s8", "s8s8", "imma")),
    ("GEMMs", ("gemm", "xmma", "cutlass", "nvjet", "sm90_")),
    ("optimizer", ("multi_tensor", "foreach")),
    ("reductions", ("reduce",)),
    ("copies and casts", ("copy", "memcpy", "memset", "cast")),
    ("index, embedding, sort", ("index", "embedding", "sort", "gather", "scatter", "radix")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def kernel_class(name: str) -> str:
    low = name.lower()
    for label, keys in CLASSES:
        if any(k in low for k in keys):
            return label
    return "other"


def is_eager(name: str) -> bool:
    """Neither a kernel of the port (K1, K2, K4) nor a GEMM."""
    return kernel_class(name) not in ("port attention", "port layernorm", "int8 GEMMs", "GEMMs")


def optional_ratio(num: float, den: float) -> Optional[float]:
    return num / den if den > 0 else None
