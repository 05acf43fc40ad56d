"""Small sizes of the cells for the CPU tests: the program in float32 (on
the CPU it then agrees with the reference to rounding), two-level U-Nets on
16³ cubes."""

import time

from benchmark import core

TINY = {"config": {"num_filters": [4, 8], "scan_shape": [10, 16, 16], "cube": 16,
                   "dtype": "float32"},
        "workload": {"volumes": 3, "warmup_volumes": 1, "check_volumes": 2, "batch": 8,
                     "trace_seconds": 0.3}}

CELLS = ("probunet-3view-bf16.backlog", "probunet-6view-bf16.backlog",
         "probunet-3view-bf16.train")


def run(cell, seed=20261018, seconds=0.5, trace=False, variant="program", overrides=None,
        diagnose=False):
    over = {k: dict(v) for k, v in TINY.items()}
    for k, v in (overrides or {}).items():
        over[k].update(v)
    return core.run_cell(cell, seed, seconds, trace, time.perf_counter(), device="cpu",
                         variant=variant, overrides=over, diagnose=diagnose)
