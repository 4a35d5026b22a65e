"""Run one cell of the benchmark once and print its result.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit,
which the last lines of standard error repeat. It exits non-zero, and
prints no result, without a CUDA device for each chip the cell asks for,
or when JAX or the JAX package was loaded in this process.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from gpubench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    harness.set_cache_dirs()
    cell = harness.load_cell(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        harness.log(f"{args.workload} needs {cell.chips} CUDA device(s); found {n}")
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    loaded = harness.forbidden_modules()
    if loaded:
        harness.log("JAX or the JAX package was loaded in this process: " + ", ".join(loaded))
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
