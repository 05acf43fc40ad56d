"""The readings that the limits of ``correct`` are set from: a cell's
comparison with the reference on many seeds, in one process, for the
program or for the control (the lower precision in its place: the
program's int8 path for a serving cell, the reference with float8
convolutions for the train cell).

    python3 benchmark/readings.py --workload probunet-3view-bf16.backlog \\
        --variant control --seeds 11,12,13 --seconds 3
    python3 benchmark/readings.py --workload probunet-3view-bf16.train \\
        --fault train_half_batch --seeds 11,12,13 --seconds 1

Prints one JSON line a seed (every number of the comparison, the
end-to-end metrics of that short window) and the largest and smallest of
each number. ``--set check_volumes=4`` or ``--set config.dtype=float32`` replaces a
value of the cell's workload or configuration file; ``--fault NAME`` plants
a fault of ``benchmark/faults.py`` in the program. Not run by ``run.py``:
the benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path[:1] = [str(Path(__file__).resolve().parent.parent)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--variant", choices=("program", "control"), default="program")
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--set", action="append", default=[], metavar="[config.]KEY=VALUE",
                    help="replace a value of the cell's workload (or configuration) file: "
                         "the float32 program as a witness, say")
    ap.add_argument("--fault", help="plant this fault of benchmark/faults.py in the program")
    args = ap.parse_args(argv)
    over = {"config": {}, "workload": {}}
    for item in args.set:
        key, value = item.split("=", 1)
        part, _, key = key.rpartition(".")
        try:
            value = json.loads(value)
        except json.JSONDecodeError:
            pass
        over[part or "workload"][key] = value

    from benchmark import core, faults

    if args.fault:
        faults.ALL[args.fault](setattr)
    numbers = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = core.run_cell(args.workload, seed, args.seconds, False, t0, variant=args.variant,
                            overrides=over, diagnose=True)
        row = {k: v["value"] for k, v in out["checks"].items()}
        row.update(out["not_compared"])
        for k, v in row.items():
            numbers.setdefault(k, []).append(v)
        print("READING", json.dumps({"workload": args.workload, "variant": args.variant,
                                     "set": args.set, "fault": args.fault, "seed": seed,
                                     "numbers": row,
                                     "correct": out["correct"], "metrics": out["metrics"],
                                     "window": out["window"], "device": out["device"],
                                     "seconds": time.perf_counter() - t0}), flush=True)
    print("SUMMARY", json.dumps({"workload": args.workload, "variant": args.variant,
                                 "min": {k: min(v) for k, v in numbers.items()},
                                 "max": {k: max(v) for k, v in numbers.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
