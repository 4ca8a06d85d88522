#!/usr/bin/env python3
"""A/B of a change to the port's CUDA sources, on one card, in one process.

Run from the root of a checkout, on a machine with an NVIDIA GPU:

    python3 scripts/ab_kernels.py --file attention.cu \\
        --old "constexpr int kMaxWarps = 8;" --new "constexpr int kMaxWarps = 4;"
    python3 scripts/ab_kernels.py --kernel layer_norm --baseline OLD/csrc
    python3 scripts/ab_kernels.py --kernel layer_norm --ln_weight bfloat16

It builds the kernels of ``vilbert_tpu_torch/csrc`` as they are (A) and a
copy in which ``--old`` is replaced by ``--new`` in ``--file`` (B), prints
the registers, stack and spills that ``ptxas -v`` reports for each
tensor-core kernel of both, checks both against the plain PyTorch versions
at every shape below (the bf16 bound of chip_smoke.py), and times K1 and K2
of both at the VQA (B=1024), CC (B=256) and multi-task (past 128 keys)
attention shapes, alternated A, B, B, A, as device time
(``chip_smoke.device_ms``). With no ``--old`` it reports and times the tree
alone. ``--baseline DIR`` builds A from another ``csrc`` directory (an
earlier checkout's) and B from the tree (or its patched copy).

``--kernel layer_norm`` does the same for K4 (``layernorm.cu`` alone):
ptxas lines of every instantiation, and at every shape of
``chip_smoke.ln_shapes`` and a sweep of row counts, each library's
variants (an earlier design's single ``vt_layer_norm_fwd`` counts as one)
checked against ``layer_norm_ref`` (fp32 1e-4, bf16 ``bf16_bound``) and
timed A, B, B, A; ``routed`` is the variant ``ln_variant`` picks.
``--ln_weight bfloat16`` times the bf16-weight instantiations (weight and
bias in bf16) in place of the fp32-weight ones. The libraries compared must
take the weight dtype argument of the entry points (from the bf16-weight
K4 on).
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


#: (H, dtype, residual) of the layer_norm sweep over LN_SWEEP_ROWS: where
#: the variants cross over
LN_SWEEP = ((768, "bfloat16", True), (1024, "bfloat16", True), (2048, "bfloat16", False),
            (768, "float32", False), (1024, "bfloat16", False))
LN_SWEEP_ROWS = (64, 128, 256, 512, 1024, 2048, 3072, 4096, 6144, 8192, 16384)


def build(csrc: str, out_dir: str, sources=None) -> tuple:
    """(library path, ptxas lines of the tensor-core kernels or, when
    ``sources`` names layernorm.cu alone, of the LayerNorm kernels) of
    ``csrc``."""
    from vilbert_tpu_torch.ops import _build

    nvcc, objs, report = _build._nvcc(), [], []
    procs = []
    for src in sources or sorted(f for f in os.listdir(csrc) if f.endswith(".cu")):
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
                kernel = m.group(1) if "_tc_" in m.group(1) or "layer_norm" in m.group(1) \
                    else None
            elif kernel and ("spill" in line or "Used" in line):
                # <x type, weight type (S0_: x's again), H, persistent>
                ln = re.search(r"layer_norm_fwd_kernelI(f|13__nv_bfloat16)"
                               r"(f|13__nv_bfloat16|S\d*_)Li(\d+)ELb([01])", kernel)
                if ln:  # the widths of the paths and of phase 3's edges
                    if int(ln.group(3)) in (128, 384, 768, 1024, 2048):
                        report.append(
                            f"layer_norm {'fp32' if ln.group(1) == 'f' else 'bf16'} "
                            f"weight {'fp32' if ln.group(2) == 'f' else 'bf16'} "
                            f"H={ln.group(3)} {('block', 'persistent')[int(ln.group(4))]}: "
                            f"{line.split(':', 1)[-1].strip()}")
                    continue
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
    """The library's entry points, typed; an earlier design's single
    ``vt_layer_norm_fwd`` too, where it has one."""
    from vilbert_tpu_torch.ops import _build

    lib = ctypes.CDLL(path)
    signatures = {**_build._SIGNATURES,
                  "vt_layer_norm_fwd": _build._SIGNATURES["vt_layer_norm_fwd_block"]}
    for name, argtypes in signatures.items():
        if hasattr(lib, name):
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
    lib.vt_error_string.argtypes = [ctypes.c_int]
    lib.vt_error_string.restype = ctypes.c_char_p
    return lib


def main(argv=None) -> int:
    import torch

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--file", default="attention.cu", help="source of csrc/ to patch for B")
    p.add_argument("--old", action="append", default=[],
                   help="text of --file that B replaces (again: C, D, ... with the next --new)")
    p.add_argument("--new", action="append", default=[], help="what B puts in its place")
    p.add_argument("--baseline", default="", help="a csrc directory to build A from")
    p.add_argument("--kernel", default="attention", choices=("attention", "layer_norm"))
    p.add_argument("--ln_weight", default="float32", choices=("float32", "bfloat16"),
                   help="dtype of K4's weight and bias in the layer_norm timings")
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
        sources = {"A": args.baseline or str(_build.CSRC_DIR)}
        if args.baseline:
            sources["B"] = str(_build.CSRC_DIR)
        if len(args.old) != len(args.new):
            raise SystemExit("give --old and --new in pairs")
        for old, new in zip(args.old, args.new):
            name = chr(ord("A") + len(sources))
            patched = os.path.join(tmp, f"csrc_{name}")
            shutil.copytree(_build.CSRC_DIR, patched)
            path = os.path.join(patched, args.file)
            text = open(path).read()
            if text.count(old) != 1:
                raise SystemExit(f"--old occurs {text.count(old)} times in {args.file}")
            open(path, "w").write(text.replace(old, new))
            sources[name] = patched
            print(f"{name}: {args.file}: {old!r} -> {new!r}")
        for name, csrc in sources.items():
            out_dir = os.path.join(tmp, name)
            os.makedirs(out_dir)
            lib_path, report = build(
                csrc, out_dir, ["layernorm.cu"] if args.kernel == "layer_norm" else None)
            variants[name] = load(lib_path)
            for line in report:
                print(f"  {name} ptxas {line}")
        if args.kernel == "layer_norm":
            return time_layer_norm(variants, smoke, getattr(torch, args.ln_weight))

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


def time_layer_norm(libs: dict, smoke, wdtype) -> int:
    """K4 of each library at chip_smoke's shapes and the sweep, with weight
    and bias in ``wdtype``: every variant checked and timed, the libraries
    alternated A, B, B, A."""
    import torch

    from vilbert_tpu_torch.ops import _build
    from vilbert_tpu_torch.ops.layernorm import VARIANTS, layer_norm_ref, ln_variant

    def entries(lib) -> dict:
        names = {v: f"vt_layer_norm_fwd_{v}" for v in VARIANTS}
        return {v: getattr(lib, n) for v, n in {"single": "vt_layer_norm_fwd", **names}.items()
                if hasattr(lib, n)}

    shapes = [(row["label"], *key) for key, row in smoke.ln_shapes().items()]
    shapes += [(f"sweep {rows}", rows, h, dtype, res) for h, dtype, res in LN_SWEEP
               for rows in LN_SWEEP_ROWS]
    g = torch.Generator(device="cuda").manual_seed(0)
    fails = 0
    for label, rows, h, dtype_name, with_res in shapes:
        dtype = getattr(torch, dtype_name)
        x = (2 * torch.randn(rows, h, generator=g, device="cuda") + 0.5).to(dtype)
        res = torch.randn(rows, h, generator=g, device="cuda").to(dtype) if with_res else None
        w = (1 + 0.1 * torch.randn(h, generator=g, device="cuda")).to(wdtype)
        b = (0.1 * torch.randn(h, generator=g, device="cuda")).to(wdtype)
        out = torch.empty_like(x)
        want = layer_norm_ref(x, w, b, residual=res).float()
        bound = 1e-4 if dtype == torch.float32 else smoke.bf16_bound(want)
        stream = torch.cuda.current_stream().cuda_stream

        def call(fn):
            return lambda: fn(x.data_ptr(), None if res is None else res.data_ptr(),
                              w.data_ptr(), b.data_ptr(), out.data_ptr(),
                              _build.DTYPE_CODES[dtype], _build.DTYPE_CODES[wdtype], rows, h,
                              1e-12, stream)

        times = {}
        for name in (*libs, *reversed(libs)):  # A, B, B, A
            fns = {f"{name} {v}": call(fn) for v, fn in entries(libs[name]).items()}
            for key, fn in fns.items():
                out.zero_()
                err = fn()
                torch.cuda.synchronize()
                e = float((out.float() - want).abs().max())
                if err or not e <= bound:
                    fails += 1
                    print(f"  FAIL {key} {label}: error code {err}, max|err| {e:.3e} > {bound:.3e}")
            for key, ms in smoke.device_ms(fns).items():
                times.setdefault(key, []).append(ms)
        text = ", ".join(f"{key} {sum(t) / len(t):.4f}" for key, t in times.items())
        print(f"layer_norm {label} rows={rows} H={h} {dtype_name} weight {str(wdtype)[6:]} "
              f"residual={with_res} routed {ln_variant(rows, h, dtype)}: device ms {text}",
              flush=True)
    print("checks failed:", fails)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
