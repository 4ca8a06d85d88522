#!/usr/bin/env python3
"""The fp32 attention backward (K2) against its plain version on rows whose
keys are all padded, over many random draws, on one card.

Run from the root of a checkout, on a machine with an NVIDIA GPU:

    python3 scripts/probe_k2_padded.py [--draws 100]

For each draw it builds ``chip_smoke.py``'s phase 3 operands (random
lengths, the last batch element's keys all padded) at Sq x Sk of 1 x 128
(h12 d64), 17 x 65 (h8 d128) and 128 x 128 (h12 d64), fp32, rates 0 and
0.1, runs ``attention_bwd`` (the kernel) and ``attention_bwd_ref``, and
prints: the worst error over 1e-4 x max|ref| with and without the padded
element, and how many checks fail ``chip_smoke._bwd_errors`` without and
with ``bias`` (the bound derived for padded elements: 2^-9 of their own
max|ref| on top).
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ((12, 64, 1, 128), (8, 128, 17, 65), (12, 64, 128, 128))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--draws", type=int, default=100)
    args = p.parse_args(argv)
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        print("probe_k2_padded: no CUDA device", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO,
                                                                             "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from vilbert_tpu_torch.ops.attention import attention_bwd, attention_bwd_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(123)
    worst = {"all": 0.0, "valid": 0.0, "padded/derived": 0.0}
    fails = {"old": 0, "derived": 0}
    checks = 0
    for _ in range(args.draws):
        for heads, d, sq, sk in SHAPES:
            q, k, v, cot, bias = smoke._attention_operands(g, 8, heads, d, sq, sk,
                                                           torch.float32)
            for rate in (0.0, 0.1):
                kw = dict(num_heads=heads, dropout_rate=rate,
                          seed=smoke.DROPOUT_SEED if rate else None)
                got = attention_bwd(q, k, v, bias, cot, **kw)
                want = attention_bwd_ref(q, k, v, bias, cot, **kw)
                checks += 1
                fails["old"] += not smoke._bwd_errors(got, want, "float32")[1]
                fails["derived"] += not smoke._bwd_errors(got, want, "float32", bias)[1]
                for a, b in zip(got, want):
                    bound = 1e-4 * float(b.abs().max())
                    diff = (a - b).abs()
                    worst["all"] = max(worst["all"], float(diff.max()) / bound)
                    worst["valid"] = max(worst["valid"], float(diff[:-1].max()) / bound)
                    derived = 2.0 ** -9 * float(b[-1].abs().max()) + bound
                    worst["padded/derived"] = max(worst["padded/derived"],
                                                  float(diff[-1].max()) / derived)
    print(smoke.card_line())
    print(f"fp32 K2, {checks} checks ({args.draws} draws x {len(SHAPES)} shapes x 2 rates): "
          f"worst error over 1e-4 x max|ref| "
          f"{worst['all']:.3f} (without the padded element {worst['valid']:.3f}); the padded "
          f"element's worst over the derived bound {worst['padded/derived']:.3f}; checks "
          f"failing the 1e-4 bound {fails['old']}, the derived bound {fails['derived']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
