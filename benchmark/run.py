#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once, on the machine it is started on.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the program (``vilbert_tpu_torch``)
and one NVIDIA GPU a chip the cell asks for. It sets the cell up from the
seed, measures for ``--seconds``, compares what the window produced with
the plain reference, and prints as the last line of standard output one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
end-to-end metrics untraced, the per-layer ones with ``--trace 1``),
``device``, with ``--trace 1`` a ``breakdown``, and last ``checks``: each
number compared beside its limit, which are also the last lines of
standard error.

It exits non-zero and prints no result where CUDA is missing or has fewer
devices than the cell asks for, where the program cannot be imported, and
where, once the window has closed, a module of JAX, flax or the JAX package
(``vilbert_tpu``, by its whole top-level name) is loaded in the process.
Build and kernel caches stay inside the checkout (``build/``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "vilbert_tpu")


def seconds_since_start() -> float:
    """How long this process has run (Linux: its start in /proc), so that
    set-up counts the interpreter's start-up too."""
    try:
        with open("/proc/self/stat", encoding="ascii") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime", encoding="ascii") as f:
            uptime = float(f.read().split()[0])
        return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


def forbidden_modules() -> list:
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None) -> int:
    started = time.perf_counter() - seconds_since_start()
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    build = os.path.join(ROOT, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["USE_FLAX"] = "0"
    sys.path[:0] = [BENCH_DIR, ROOT]

    import torch

    from harness import cell as cell_run
    from harness import spec

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA device(s); this machine has {n}",
              file=sys.stderr)
        return 2
    result = cell_run.run(cell, args.seed, args.seconds, bool(args.trace), started=started)
    found = forbidden_modules()
    if found:
        print(f"modules of {found} are loaded: the run measured the wrong program",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
