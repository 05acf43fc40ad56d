"""The control, the lower precision put in the program's place (the
program's int8 path for the serving cells, the reference with float8
convolutions for the train cell), comes out not correct.

On the card at the cells' own sizes (``card``: ``python -m pytest
benchmark/tests -m card`` there); on the CPU at a small size, where the
limits of the full-size cells do not apply, the control's numbers lie far
above the program's."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from bench_tiny import CELLS, run

BENCH = Path(__file__).resolve().parent.parent
SMALL = {"config": {"num_filters": [8, 16, 32], "scan_shape": [20, 32, 32], "cube": 32,
                    "dtype": "bfloat16"}}


@pytest.mark.parametrize("cell", ["probunet-3view-bf16.backlog", "probunet-6view-bf16.backlog"])
def test_control_reads_far_above_the_program_on_the_cpu(cell):
    prog = run(cell, seed=7, overrides=SMALL)
    ctl = run(cell, seed=7, overrides=SMALL, variant="control")
    (name,) = prog["checks"]
    assert ctl["checks"][name]["value"] > 3 * prog["checks"][name]["value"]


def test_train_control_reads_far_above_the_program_on_the_cpu():
    prog = run("probunet-3view-bf16.train", seed=7)
    ctl = run("probunet-3view-bf16.train", seed=7, variant="control")
    assert ctl["checks"]["bn_var_gap"]["value"] > 30 * prog["checks"]["bn_var_gap"]["value"]


def _readings(cell, variant, seeds, card):
    p = subprocess.run([sys.executable, str(BENCH / "readings.py"), "--workload", cell,
                        "--variant", variant, "--seeds", ",".join(map(str, seeds)),
                        "--seconds", "2"], capture_output=True, text=True, timeout=1800)
    assert p.returncode == 0, p.stderr[-4000:]
    return [json.loads(line.split(" ", 1)[1]) for line in p.stdout.splitlines()
            if line.startswith("READING ")]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_on_the_card(cell, card):
    rows = _readings(cell, "control", [4000000001, 4000000002, 4000000003], card)
    assert rows and not any(r["correct"] for r in rows), rows


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_run_is_correct_on_the_card(cell, card):
    p = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", cell, "--seed",
                        "4000000004", "--seconds", "3", "--trace", "0"],
                       capture_output=True, text=True, timeout=900, cwd=BENCH.parent)
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks" and out["correct"], out
