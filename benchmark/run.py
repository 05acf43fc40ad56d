"""Run one cell of the benchmark of ``pmpu_tpu_torch`` on this machine's
CUDA card and print its result as one JSON line.

    python3 benchmark/run.py --workload probunet-3view-bf16.backlog \\
        --seed 12345 --seconds 30 --trace 0

``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics (``torch.profiler`` over the first ``trace_seconds`` of the
window). Every run compares what its window produced with the plain
reference (``benchmark/reference``): ``correct``, and each number compared
beside its limit, last on standard error and last in the line. Exits 2
without enough CUDA cards, 3 when a module of JAX or of the JAX package was
loaded; both print no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:1] = [str(ROOT)]  # the checkout, not this folder, holds the packages
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "benchmark" / ".cache" / "triton"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True, help="a cell's name in BENCHMARK.json")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark import core

    bench = core.Benchmark()
    chips = bench.cell(args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"run.py: {args.workload} needs {chips} CUDA card(s), this machine has {have}",
              file=sys.stderr)
        return 2
    out = core.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), T_START,
                        device="cuda", bench=bench)
    found = core.forbidden_modules(sys.modules)
    if found:
        print(f"run.py: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
