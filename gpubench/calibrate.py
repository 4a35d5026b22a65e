"""Readings that the limits of ``correct`` are set from (not run by the
benchmark's own runs).

    python3 gpubench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 4,5,6 --seconds 3 --out cal.jsonl

In one process: a short run of the program on each of ``--seeds`` (its
checks as a benchmark run computes them), then on each of
``--control-seeds`` the control, the reference in TF32 put in the
program's place, and for a training cell each planted fault of a step
(``kinds/train.control``). One JSON line each, on standard output and
appended to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from gpubench import harness  # noqa: E402

FAULTS = {"render": ("tf32",), "train": ("tf32", "half_batch", "double_grad")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    harness.set_cache_dirs()
    cell = harness.load_cell(args.workload)
    kind = cell.traffic["kind"]
    loop = harness.load_module(harness.BENCH_DIR / "kinds" / f"{kind}.py",
                                 f"gpubench_kind_{kind}")
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    seeds = [int(s) for s in args.seeds.split(",") if s]
    for seed in seeds:
        t = time.perf_counter()
        r = harness.run_cell(args.workload, seed, args.seconds, False, device=args.device)
        emit({"cell": args.workload, "seed": seed, "kind": "program", "units": r["attempted"],
              "seconds": time.perf_counter() - t,
              **{k: c["value"] for k, c in r["checks"].items()}})
    for seed in (int(s) for s in args.control_seeds.split(",") if s):
        t = time.perf_counter()
        got = loop.control(cell, seed, args.device, harness.WORK_DIR / cell.config["name"],
                             FAULTS[kind])
        for fault, values in got.items():
            emit({"cell": args.workload, "seed": seed, "kind": fault,
                  "seconds": time.perf_counter() - t, **values})
    if harness.forbidden_modules():
        print("JAX was loaded: " + ", ".join(harness.forbidden_modules()), file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
