#!/usr/bin/env python3
"""End-to-end A/B of two checkouts of the port on one card, in one call.

Run from the root of a checkout, on a machine with an NVIDIA GPU:

    mkdir -p build/parent && git archive <parent> | tar -x -C build/parent
    python3 scripts/ab_paths.py build/parent .

For each checkout, in the order A, B, B, A (``--rounds 1``: A, B), a
subprocess run from that checkout's root imports its ``chip_smoke.py`` and
drives phases 4-9 and 13-16 there, as ``chip_smoke.py`` does: the VQA
eval slice and its timing (phase 5: questions/s of the bf16 forward at
B=1024), the CC training slice and its timing (phase 7: samples/s of the
bf16 step at B=256), the flagship multi-task slice and its timing (phase
9: the twelve tasks' steps, samples/s, and two iterations through the host
loader), the single-stream baseline's VQA eval (phase 13: questions/s of
its bf16 forward at B=1024), its CC step (phase 14) and the NCE CC step
(phase 15: samples/s of each at B=256), and one iteration of the baseline
over its nine tasks (phase 16: their steps, samples/s). Each checkout
builds its own kernels. It prints each run's end-to-end lines and then, per metric, each
run's value and the two means. A failed check in a run fails the command.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys

#: metric -> pattern of the log lines that carry it, in chip_smoke.py's
#: own wording; a run's value is the mean over its lines
METRICS = {
    "VQA eval questions/s (phase 5)": r"(?<!baseline )forward B=\d+ T=\d+ R=\d+ bf16 kernels: "
                                      r".* = ([\d.]+) questions/s",
    "baseline VQA eval questions/s (phase 13)": r"baseline forward B=\d+ T=\d+ R=\d+ bf16 "
                                                r"kernels: .* = ([\d.]+) questions/s",
    "CC step samples/s (phase 7)": r"(?m)^  train step B=\d+ T=\d+ R=\d+ bf16 kernels: .* = "
                                   r"([\d.]+) samples/s",
    "baseline CC step samples/s (phase 14)": r"baseline train step B=\d+ T=\d+ R=\d+ bf16 "
                                             r"kernels: .* = ([\d.]+) samples/s",
    "NCE CC step samples/s (phase 15)": r"NCE train step B=\d+ T=\d+ R=\d+ bf16 kernels: "
                                        r".* = ([\d.]+) samples/s",
    "twelve-task steps samples/s (phase 9)": r"steps of the twelve tasks: .* = ([\d.]+) samples/s",
    "flagship iteration dataset samples/s (phase 9)": r"iteration \d+: .* = ([\d.]+) dataset "
                                                      r"samples/s",
    "baseline nine-task steps samples/s (phase 16)": r"baseline steps of the \d+ tasks: .* = "
                                                     r"([\d.]+) samples/s",
}

CHILD = r"""
import collections, sys, tempfile, torch
sys.path.insert(0, ".")
import chip_smoke as s
from vilbert_tpu_torch.ops import _build
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
_build.load_library()
card, checks, err = s.card_line(), s.Checks(), collections.defaultdict(float)
model, cfg, _ = s.phase_slice(checks)
s.phase_timing(checks, model, cfg, card, err)
del model
torch.cuda.empty_cache()
state, args, _ = s.phase_train(checks)
s.phase_train_timing(checks, state, args, card, err)
del state
torch.cuda.empty_cache()
s.phase_baseline_vqa(checks, card)
torch.cuda.empty_cache()
with tempfile.TemporaryDirectory() as tmp:
    trainer = s.phase_multitask(checks, tmp)[0]
    s.phase_multitask_timing(checks, trainer, card, err)
    del trainer
    torch.cuda.empty_cache()
    s.phase_baseline_multitask(checks, tmp, card)
    torch.cuda.empty_cache()
    s.phase_baseline_train(checks, tmp, card)
    torch.cuda.empty_cache()
    s.phase_nce(checks, tmp, card)
"""


def run(root: str) -> dict:
    """One run of CHILD from ``root``: metric -> value."""
    proc = subprocess.run([sys.executable, "-c", CHILD], cwd=root, capture_output=True,
                          text=True)
    if proc.returncode:
        raise SystemExit(f"{root}: exit {proc.returncode}\n{proc.stdout[-3000:]}"
                         f"\n{proc.stderr[-3000:]}")
    out = {}
    for name, pattern in METRICS.items():
        values = [float(m.group(1)) for m in re.finditer(pattern, proc.stdout)]
        if not values:
            raise SystemExit(f"{root}: no line for {name}\n{proc.stdout[-3000:]}")
        out[name] = sum(values) / len(values)
        for m in re.finditer(pattern, proc.stdout):
            line = proc.stdout[proc.stdout.rfind("\n", 0, m.start()) + 1:
                               proc.stdout.find("\n", m.end())]
            print(f"  [{root}] {line.strip()}", flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("a", help="checkout root of A (the parent)")
    p.add_argument("b", help="checkout root of B (the change)")
    p.add_argument("--rounds", type=int, default=2, choices=(1, 2),
                   help="2: A, B, B, A; 1: A, B")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("ab_paths: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    order = ["a", "b", "b", "a"] if args.rounds == 2 else ["a", "b"]
    results = {"a": [], "b": []}
    for which in order:
        root = os.path.abspath(getattr(args, which))
        print(f"{which.upper()}: {root}", flush=True)
        results[which].append(run(root))
    for name in METRICS:
        a = [r[name] for r in results["a"]]
        b = [r[name] for r in results["b"]]
        print(f"{name}: A {a} mean {sum(a) / len(a):.1f}; B {b} mean {sum(b) / len(b):.1f}; "
              f"B/A {sum(b) / len(b) / (sum(a) / len(a)):.4f} [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
