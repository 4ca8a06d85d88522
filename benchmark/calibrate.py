#!/usr/bin/env python3
"""Read the comparison's numbers over many seeds in one process: the sound
program's, the control's and the faults', from which a cell's limits are
set (steps 4 and 5 of how ``correct`` is decided, in PERF.md).

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--control_seeds 4,5,6] [--seconds 3] [--out chiprun_out/calibrate.jsonl]

Training cells: each seed's program runs the set-up's first steps (no
window: the comparison reads nothing of it), then the reference retraces
them. Each control seed reads the reference computed on float8 products
against the float32 reference, and the fault that leaves half of each
batch out (the reference on the first half of the rows). Evaluation
cells: each seed's program runs a window of ``--seconds``; the control is
the program's own int8 path (``int8_matmul``), over the same window.

Prints one JSON line a reading; on a machine with a GPU, as the runs do.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


def _seeds(text: str):
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--control_seeds", default="")
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out", default="")
    args = parser.parse_args(argv)
    sys.path[:0] = [BENCH_DIR, ROOT]

    from harness import cell as cell_run
    from harness import spec
    from harness.compare import training_gaps

    cell = spec.cell(args.workload)
    out = open(args.out, "a", encoding="utf-8") if args.out else None

    def emit(kind: str, seed: int, readings, t0: float) -> None:
        line = json.dumps({"cell": cell.name, "kind": kind, "seed": seed,
                           "seconds": round(time.perf_counter() - t0, 2), **readings})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    def driver(seed: int, **overrides):
        return cell.generator().Driver(cell_run.Context(cell, seed, args.device, overrides))

    for seed in _seeds(args.seeds):
        t0 = time.perf_counter()
        d = driver(seed)
        try:
            d.setup()
            if not d.train:
                d.run(args.seconds)
            emit("program", seed, d.readings(), t0)
        finally:
            d.close()
    for seed in _seeds(args.control_seeds):
        t0 = time.perf_counter()
        if cell.generator().Driver.train:
            d = driver(seed)
            want = d.reference_trajectory("fp32")
            cell_run.free_device_memory()
            emit("control_fp8", seed, training_gaps(d.reference_trajectory("fp8"), want), t0)
            cell_run.free_device_memory()
            t0 = time.perf_counter()
            half = d.reference_trajectory("fp32", half=True)
            emit("fault_half_batch", seed, training_gaps(half, want), t0)
            cell_run.free_device_memory()
        else:
            d = driver(seed, int8_matmul=True)
            try:
                d.setup()
                d.run(args.seconds)
                emit("control_int8", seed, d.readings(), t0)
            finally:
                d.close()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
