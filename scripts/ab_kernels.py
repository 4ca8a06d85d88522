#!/usr/bin/env python3
"""A/B of a change to the port's CUDA sources, on one card, in one process.

Run from the root of a checkout, on a machine with an NVIDIA GPU:

    python3 scripts/ab_kernels.py --file attention.cu \\
        --old "constexpr int kMaxWarps = 8;" --new "constexpr int kMaxWarps = 4;"

It builds the kernels of ``vilbert_tpu_torch/csrc`` as they are (A) and a
copy in which ``--old`` is replaced by ``--new`` in ``--file`` (B), prints
the registers, stack and spills that ``ptxas -v`` reports for each
tensor-core kernel of both, checks both against the plain PyTorch versions
at every shape below (the bf16 bound of chip_smoke.py), and times K1 and K2
of both at the VQA (B=1024), CC (B=256) and multi-task (past 128 keys)
attention shapes, alternated A, B, B, A, as device time
(``chip_smoke.device_ms``). With no ``--old`` it reports and times the tree
alone.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import shutil
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

#: (label, batch, heads, head_dim, Sq, Sk): the VQA and CC shapes, and the
#: multi-task's past 128 keys (chip_smoke.MT_ATTENTIONS, where K1 runs its
#: long tensor-core variant)
SHAPES = (
    ("VQA image self", 1024, 8, 128, 101, 101), ("VQA text->image", 1024, 8, 128, 23, 101),
    ("VQA image->text", 1024, 8, 128, 101, 23), ("VQA text self", 1024, 12, 64, 23, 23),
    ("CC image self", 256, 8, 128, 37, 37), ("CC text self", 256, 12, 64, 36, 36),
    ("Sq = Sk = 128", 64, 8, 128, 128, 128),
    ("Visual7w image self", 256, 8, 128, 200, 200), ("Visual7w text->image", 256, 8, 128, 21, 200),
    ("GuessWhatPointing text self", 64, 12, 64, 257, 257),
    ("GuessWhatPointing image self", 64, 8, 128, 306, 306),
    ("GuessWhatPointing text->image", 64, 8, 128, 257, 306),
    ("GuessWhatPointing image->text", 64, 8, 128, 306, 257),
)


def build(csrc: str, out_dir: str) -> tuple:
    """(library path, ptxas lines of the tensor-core kernels) of ``csrc``."""
    from vilbert_tpu_torch.ops import _build

    nvcc, objs, report = _build._nvcc(), [], []
    procs = []
    for src in sorted(f for f in os.listdir(csrc) if f.endswith(".cu")):
        obj = os.path.join(out_dir, src + ".o")
        objs.append(obj)
        cmd = [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", obj,
               os.path.join(csrc, src)]
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    for proc in procs:
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(out[-4000:])
        kernel = None
        for line in out.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                kernel = m.group(1) if "_tc_" in m.group(1) else None
            elif kernel and ("spill" in line or "Used" in line):
                name = re.search(r"attention_(fwd|bwd)_(\w*?)_?kernelILi(\d+)E(?:Li(\d+)E)?"
                                 r"(Lb[01])?", kernel)
                label = (f"{name.group(1)} {name.group(2)} d={name.group(3)}"
                         f"{f' KT={name.group(4)}' if name.group(4) else ''}"
                         f"{' drop' if name.group(5) == 'Lb1' else ''}" if name else kernel)
                report.append(f"{label}: {line.split(':', 1)[-1].strip()}")
    lib = os.path.join(out_dir, "lib.so")
    subprocess.run([nvcc, *_build.NVCC_FLAGS, "-shared", "-o", lib, *objs], check=True)
    return lib, report


def load(path: str) -> ctypes.CDLL:
    from vilbert_tpu_torch.ops import _build

    lib = ctypes.CDLL(path)
    for name, argtypes in _build._SIGNATURES.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    lib.vt_error_string.argtypes = [ctypes.c_int]
    lib.vt_error_string.restype = ctypes.c_char_p
    return lib


def main(argv=None) -> int:
    import torch

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--file", default="attention.cu", help="source of csrc/ to patch for B")
    p.add_argument("--old", default="", help="text of --file that B replaces")
    p.add_argument("--new", default="", help="what B puts in its place")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("ab_kernels: no CUDA device", file=sys.stderr)
        return 1

    import chip_smoke as smoke
    from vilbert_tpu_torch.ops import _build
    from vilbert_tpu_torch.ops import attention as A

    print(smoke.card_line(), flush=True)
    tmp = tempfile.mkdtemp(prefix="ab_kernels_")
    try:
        variants = {}
        sources = {"A": str(_build.CSRC_DIR)}
        if args.old:
            patched = os.path.join(tmp, "csrc_b")
            shutil.copytree(_build.CSRC_DIR, patched)
            path = os.path.join(patched, args.file)
            text = open(path).read()
            if text.count(args.old) != 1:
                raise SystemExit(f"--old occurs {text.count(args.old)} times in {args.file}")
            open(path, "w").write(text.replace(args.old, args.new))
            sources["B"] = patched
            print(f"B: {args.file}: {args.old!r} -> {args.new!r}")
        for name, csrc in sources.items():
            out_dir = os.path.join(tmp, name)
            os.makedirs(out_dir)
            lib_path, report = build(csrc, out_dir)
            variants[name] = load(lib_path)
            for line in report:
                print(f"  {name} ptxas {line}")

        def use(name):
            _build.load_library = lambda: variants[name]

        g = torch.Generator(device="cuda").manual_seed(0)
        fails = 0
        for label, B, heads, d, sq, sk in SHAPES:
            q, k, v, cot, bias = smoke._attention_operands(g, B, heads, d, sq, sk, torch.bfloat16)
            for rate in (0.0, 0.1):
                kw = dict(num_heads=heads, dropout_rate=rate, seed=7 if rate else None)
                want = A.attention_ref(q, k, v, bias, **kw)
                want_b = A.attention_bwd_ref(q, k, v, bias, cot, **kw)
                times = {}
                for name in (*variants, *reversed(variants)):  # A, B, B, A
                    use(name)
                    e, bound, ok = smoke._fwd_error(A.attention(q, k, v, bias, **kw), want,
                                                    "bfloat16")
                    eb, okb = smoke._bwd_errors(A.attention_bwd(q, k, v, bias, cot, **kw),
                                                want_b, "bfloat16")
                    fails += not (ok and okb)
                    t = smoke.device_ms({"fwd": lambda: A.attention(q, k, v, bias, **kw),
                                         "bwd": lambda: A.attention_bwd(q, k, v, bias, cot, **kw)})
                    times.setdefault(name, []).append(t)
                text = "; ".join(
                    f"{name} fwd {sum(t['fwd'] for t in ts) / len(ts):.4f} bwd "
                    f"{sum(t['bwd'] for t in ts) / len(ts):.4f}" for name, ts in times.items())
                print(f"{label} B={B} h={heads} d={d} {sq}x{sk} rate {rate}: device ms {text}",
                      flush=True)
        print("checks failed:", fails)
        return 1 if fails else 0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
