#!/usr/bin/env python3
"""A/B of a change to the port's CUDA sources, on one card, in one process.

Run from the root of a checkout, on a machine with an NVIDIA GPU:

    python3 scripts/ab_kernels.py --file attention.cu \\
        --old "constexpr int kMaxWarps = 8;" --new "constexpr int kMaxWarps = 4;"
    python3 scripts/ab_kernels.py --kernel layer_norm --baseline OLD/csrc
    python3 scripts/ab_kernels.py --kernel layer_norm --ln_weight bfloat16
    python3 scripts/ab_kernels.py --kernel attention_bwd [--baseline OLD/csrc]

It builds the kernels of ``vilbert_tpu_torch/csrc`` as they are (A) and a
copy in which ``--old`` is replaced by ``--new`` in ``--file`` (B), prints
the registers, stack and spills that ``ptxas -v`` reports for each
tensor-core kernel of both, and (``--kernel attention``, the default) at
every K1 shape of the paths (``FWD_SHAPES``: PERF.md's kernel table, the
eval and retrieval forwards, and every training shape of ``BWD_SHAPES`` at
rates 0 and 0.1) and a sweep (``FWD_SWEEP``) checks each bf16 K1 variant
a library has (``tc`` at Sk <= 128, ``long_tc``, ``wg``) against
``attention_ref`` (the bf16 bound of chip_smoke.py) and times it, the
libraries alternated A, B, B, A, as device time
(``chip_smoke.device_ms``), beside SDPA's forward at rate 0 and the bound;
``routed`` is the variant ``fwd_variant`` picks. With no ``--old`` it
reports and times the tree alone. ``--baseline DIR`` builds A from another
``csrc`` directory (an earlier checkout's) and B from the tree (or its
patched copy).

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

``--kernel attention_bwd`` does it for K2's bf16 variants: it builds the K2
sources (``attention_bwd.cu``, ``attention_bwd_wg.cu`` where the csrc has
it, and ``attention.cu`` for the forward's output and row log-sum-exps
that ``wg`` reads, always taken from the tree's library), prints the ptxas
line of each K2 instantiation, and at every K2 shape of the paths
(``BWD_SHAPES``: PERF.md's kernel table and the two-stream multi-task's
steps at or under 128) and a sweep of lengths 16 to 1,024 (``BWD_SWEEP``)
checks each variant a library has (``tc`` at Sq, Sk <= 128, ``long_tc``,
``wg``) against ``attention_bwd_ref`` at rate 0 (bf16 bound) and times it,
libraries alternated A, B, B, A, beside SDPA's backward
(``scaled_dot_product_attention`` forward and ``autograd.grad``, less the
forward) and the bound; ``routed`` is the variant ``bwd_variant`` picks.
The device time of ``wg``'s two kernels (dq, dkdv) comes from
``torch.profiler`` at the shapes of ``BWD_SHAPES``.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import os
import re
import shutil
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

#: (label, batch, heads, head_dim, Sq, Sk) where the paths run K1 at rate 0
#: only: the VQA forward (B=1024), retrieval's (chunks of 500) and the
#: demo's (B=1), the baseline's VQA and retrieval forwards, and the cap
EVAL_SHAPES = (
    ("VQA text self", 1024, 12, 64, 23, 23), ("VQA image self", 1024, 8, 128, 101, 101),
    ("VQA text->image", 1024, 8, 128, 23, 101), ("VQA image->text", 1024, 8, 128, 101, 23),
    ("retrieval text self", 500, 12, 64, 30, 30), ("retrieval image self", 500, 8, 128, 101, 101),
    ("retrieval text->image", 500, 8, 128, 30, 101),
    ("retrieval image->text", 500, 8, 128, 101, 30),
    ("demo text self", 1, 12, 64, 30, 30), ("demo image self", 1, 8, 128, 37, 37),
    ("demo text->image", 1, 8, 128, 30, 37), ("demo image->text", 1, 8, 128, 37, 30),
    ("baseline VQA self", 1024, 12, 64, 124, 124),
    ("baseline retrieval self", 500, 12, 64, 131, 131),
    ("cap d64", 8, 12, 64, 1024, 1024), ("cap d128", 8, 8, 128, 1024, 1024),
)


#: (H, dtype, residual) of the layer_norm sweep over LN_SWEEP_ROWS: where
#: the variants cross over
LN_SWEEP = ((768, "bfloat16", True), (1024, "bfloat16", True), (2048, "bfloat16", False),
            (768, "float32", False), (1024, "bfloat16", False))
LN_SWEEP_ROWS = (64, 128, 256, 512, 1024, 2048, 3072, 4096, 6144, 8192, 16384)


#: (label, batch, heads, head_dim, Sq, Sk) where the paths run K2 in bf16:
#: PERF.md's kernel table (CC step, Visual7w, GuessWhatPointing, the
#: baseline's steps) and the two-stream multi-task's steps at or under 128
#: (VQA's four attentions, the text->image direction of every task at 101
#: regions, refcoco's image self and VisualEntailment's text self), at the
#: model's batch (retrieval x4 pairs, NLVR2 x2 images)
BWD_SHAPES = (
    ("CC text self", 256, 12, 64, 36, 36), ("CC image self", 256, 8, 128, 37, 37),
    ("CC text->image", 256, 8, 128, 36, 37), ("CC image->text", 256, 8, 128, 37, 36),
    ("VQA step text self", 128, 12, 64, 24, 24), ("VQA step image self", 128, 8, 128, 101, 101),
    ("VQA step text->image", 128, 8, 128, 24, 101),
    ("VQA step image->text", 128, 8, 128, 101, 24),
    ("GenomeQA, GQA step text->image", 128, 8, 128, 27, 101),
    ("RetrievalCOCO, Flickr30k step text->image", 512, 8, 128, 31, 101),
    ("refcoco, refcoco+, refcocog step text->image", 256, 8, 128, 21, 101),
    ("NLVR2 step text->image", 128, 8, 128, 41, 101),
    ("VisualEntailment step text->image", 256, 8, 128, 57, 101),
    ("refcoco step image self", 256, 8, 128, 101, 101),
    ("VisualEntailment step text self", 256, 12, 64, 57, 57),
    ("Visual7w image self", 256, 8, 128, 200, 200), ("Visual7w text->image", 256, 8, 128, 21, 200),
    ("Visual7w image->text", 256, 8, 128, 200, 21),
    ("GuessWhatPointing text self", 64, 12, 64, 257, 257),
    ("GuessWhatPointing image self", 64, 8, 128, 306, 306),
    ("GuessWhatPointing text->image", 64, 8, 128, 257, 306),
    ("GuessWhatPointing image->text", 64, 8, 128, 306, 257),
    ("baseline CC self", 256, 12, 64, 73, 73), ("baseline VQA step self", 128, 12, 64, 124, 124),
    ("baseline GenomeQA step self", 128, 12, 64, 127, 127),
    ("baseline refcoco step self", 256, 12, 64, 121, 121),
    ("baseline retrieval step self", 512, 12, 64, 131, 131),
    ("baseline Visual7w step self", 256, 12, 64, 220, 220),
    ("baseline GuessWhatPointing step self", 64, 12, 64, 562, 562),
)
#: lengths of the sweep (Sq = Sk), each at a batch of about 36,000 rows
BWD_SWEEP = (16, 32, 48, 64, 80, 96, 112, 128, 144, 192, 256, 384, 512, 768, 1024)
#: K1's shapes: the eval ones at rate 0, the training ones (every K2 shape)
#: at rates 0 and 0.1
FWD_SHAPES = tuple((*s, (0.0,)) for s in EVAL_SHAPES) + tuple((*s, (0.0, 0.1))
                                                             for s in BWD_SHAPES)
#: K1's sweep, each at a batch of about 36,000 query rows: Sq = Sk over
#: BWD_SWEEP, and few queries against many keys (Sq 16..64 x Sk 101, 200)
FWD_SWEEP = tuple((s, s) for s in BWD_SWEEP) + tuple(
    (sq, sk) for sk in (101, 200) for sq in (16, 32, 48, 64))


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
                kernel = m.group(1) if ("_tc_" in m.group(1) or "layer_norm" in m.group(1)
                                        or "_wg_" in m.group(1)) else None
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
                                 r"(Lb[01])?E?(Lb[01])?", kernel)
                if name and "attention_fwd_wg_kernel" in kernel:
                    # <D, warpgroups, exact branch, dropout>
                    label = (f"fwd wg d={name.group(3)} WG={name.group(4)} "
                             f"{'exact' if name.group(5) == 'Lb1' else 'online'}"
                             f"{' drop' if name.group(6) == 'Lb1' else ''}")
                else:
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
    if hasattr(lib, "vt_error_string"):  # layernorm.cu: not in a K2-only build
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
    p.add_argument("--kernel", default="attention",
                   choices=("attention", "layer_norm", "attention_bwd"))
    p.add_argument("--ln_weight", default="float32", choices=("float32", "bfloat16"),
                   help="dtype of K4's weight and bias in the layer_norm timings")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("ab_kernels: no CUDA device", file=sys.stderr)
        return 1

    import chip_smoke as smoke
    from vilbert_tpu_torch.ops import _build

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
            sources_of = {"layer_norm": ["layernorm.cu"],
                          "attention_bwd": [f for f in ("attention.cu", "attention_fwd_wg.cu",
                                                        "attention_bwd.cu", "attention_bwd_wg.cu")
                                            if os.path.exists(os.path.join(csrc, f))]}
            lib_path, report = build(csrc, out_dir, sources_of.get(args.kernel))
            variants[name] = load(lib_path)
            for line in report:
                if args.kernel != "attention_bwd" or line.startswith("bwd "):
                    print(f"  {name} ptxas {line}")
        if args.kernel == "layer_norm":
            return time_layer_norm(variants, smoke, getattr(torch, args.ln_weight))
        if args.kernel == "attention_bwd":
            return time_attention_bwd(variants, smoke)
        return time_attention_fwd(variants, smoke)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def time_attention_fwd(libs: dict, smoke) -> int:
    """K1's bf16 variants of each library at FWD_SHAPES and FWD_SWEEP:
    checked against the plain version and timed, libraries alternated A, B,
    B, A; SDPA's forward (rate 0) and the bound beside."""
    import torch

    from vilbert_tpu_torch.ops import _build
    from vilbert_tpu_torch.ops import attention as A

    def use(lib):
        _build.load_library = lambda: lib

    shapes = list(FWD_SHAPES)
    for sq, sk in FWD_SWEEP:
        shapes += [(f"sweep {sq}x{sk}", max(1, round(36000 / sq)), heads, d, sq, sk, (0.0,))
                   for heads, d in ((12, 64), (8, 128))]
    g = torch.Generator(device="cuda").manual_seed(0)
    fails = 0
    for label, B, heads, d, sq, sk, rates in shapes:
        q, k, v, _, bias = smoke._attention_operands(g, B, heads, d, sq, sk, torch.bfloat16)
        b_ms, b_by = smoke.bound(*smoke.attention_cost(B, heads, d, sq, sk)["fwd"],
                                 smoke.BF16_TC_FLOPS)
        sdpa = smoke.device_ms({"sdpa": smoke.library_attention_fns(
            q, k, v, bias, q, heads, d)["library"]}, 10)["sdpa"]
        for rate in rates:
            kw = dict(num_heads=heads, dropout_rate=rate, seed=smoke.DROPOUT_SEED if rate else None)
            want = A.attention_ref(q, k, v, bias, **kw)
            times = {}
            for name in (*libs, *reversed(libs)):  # A, B, B, A
                use(libs[name])
                fns = {}
                for variant in ("tc", "long_tc", "wg"):
                    if ((variant == "tc" and sk > A.TC_MAX_SEQ)
                            or not hasattr(libs[name], f"vt_attention_fwd_{variant}")):
                        continue
                    fns[f"{name} {variant}"] = functools.partial(
                        A.attention_kernel, q, k, v, bias, variant=variant, **kw)
                    e, bnd, ok = smoke._fwd_error(fns[f"{name} {variant}"](), want, "bfloat16")
                    if not ok:
                        fails += 1
                        print(f"  FAIL {name} {variant} {label} rate {rate}: max|err| {e:.3e} > "
                              f"{bnd:.3e}")
                for key, ms in smoke.device_ms(fns, 10).items():
                    times.setdefault(key, []).append(ms)
            text = ", ".join(f"{key} {sum(t) / len(t):.4f}" for key, t in times.items())
            print(f"attention_fwd {label} B={B} h={heads} d={d} {sq}x{sk} rate {rate} routed "
                  f"{A.fwd_variant(q.dtype, sq, sk, d)}: device ms {text}; SDPA {sdpa:.4f}; "
                  f"bound {b_ms:.4f} ({b_by})", flush=True)
    print("checks failed:", fails)
    return 1 if fails else 0


def time_attention_bwd(libs: dict, smoke) -> int:
    """K2's bf16 variants of each library at BWD_SHAPES and the BWD_SWEEP
    lengths: checked against the plain version at rate 0 and timed,
    libraries alternated A, B, B, A; SDPA's backward and the bound beside;
    wg's dq and dkdv kernels apart at BWD_SHAPES."""
    import torch

    from vilbert_tpu_torch.ops import _build
    from vilbert_tpu_torch.ops import attention as A

    tree = libs[list(libs)[-1]]  # the tree's library: K1 with row log-sum-exps

    def use(lib):
        _build.load_library = lambda: lib

    shapes = list(BWD_SHAPES)
    for s in BWD_SWEEP:
        shapes += [(f"sweep {s}", max(1, round(36000 / s)), heads, d, s, s)
                   for heads, d in ((12, 64), (8, 128))]
    g = torch.Generator(device="cuda").manual_seed(0)
    fails = 0
    for label, B, heads, d, sq, sk in shapes:
        q, k, v, cot, bias = smoke._attention_operands(g, B, heads, d, sq, sk, torch.bfloat16)
        kw = dict(num_heads=heads)
        use(tree)
        out, lse = A.attention_kernel(q, k, v, bias, variant=A.fwd_variant(q.dtype, sq, sk, d),
                                      return_lse=True, **kw)
        want = A.attention_bwd_ref(q, k, v, bias, cot, **kw)
        lib_fns = smoke.library_attention_fns(q, k, v, bias, cot, heads, d)
        sdpa = smoke.device_ms(lib_fns, 10)
        times = {}
        for name in (*libs, *reversed(libs)):  # A, B, B, A
            use(libs[name])
            fns = {}
            for variant in ("tc", "long_tc", "wg"):
                if ((variant == "tc" and max(sq, sk) > A.TC_MAX_SEQ)
                        or not hasattr(libs[name], f"vt_attention_bwd_{variant}")):
                    continue
                fns[f"{name} {variant}"] = functools.partial(
                    A.attention_bwd_kernel, q, k, v, bias, cot, variant=variant, out=out,
                    lse=lse, **kw)
                eb, okb = smoke._bwd_errors(fns[f"{name} {variant}"](), want, "bfloat16")
                if not okb:
                    fails += 1
                    print(f"  FAIL {name} {variant} {label}: max|err| {eb:.3e}")
            for key, ms in smoke.device_ms(fns, 10).items():
                times.setdefault(key, []).append(ms)
        b_ms, b_by = smoke.bound(*smoke.attention_cost(B, heads, d, sq, sk)["bwd"],
                                 smoke.BF16_TC_FLOPS)
        text = ", ".join(f"{key} {sum(t) / len(t):.4f}" for key, t in times.items())
        print(f"attention_bwd {label} B={B} h={heads} d={d} {sq}x{sk} routed "
              f"{A.bwd_variant(q.dtype, sq, sk, d)}: device ms {text}; SDPA bwd "
              f"{sdpa['library_fwd_bwd'] - sdpa['library']:.4f}; bound {b_ms:.4f} ({b_by})",
              flush=True)
        if not label.startswith("sweep") and hasattr(tree, "vt_attention_bwd_wg"):
            use(tree)
            split = wg_kernel_ms(functools.partial(
                A.attention_bwd_kernel, q, k, v, bias, cot, variant="wg", out=out, lse=lse, **kw))
            print(f"  wg kernels {label}: " + ", ".join(f"{k} {v:.4f}" for k, v in split.items()),
                  flush=True)
    print("checks failed:", fails)
    return 1 if fails else 0


def wg_kernel_ms(fn, iters: int = 10) -> dict:
    """Device ms per call of ``wg``'s two kernels (dq, dkdv) in ``fn``, by
    ``torch.profiler``."""
    import torch

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        dev = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        if "_wg_" in ev.key and dev:
            out["dq" if "_dq_" in ev.key else "dkdv"] = dev / 1e3 / iters
    return out


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
