"""The harness with the chip's look skipped, at a small size on the CPU (the
program in float32, which agrees with the reference to rounding there): a
sound run of every cell comes out correct, and a run whose timed path is
broken underneath comes out not correct, once for each fault the cell can
have. The limits are the cells' own."""

import pytest

from bench_tiny import CELLS, run
from benchmark import faults

SERVING = [c for c in CELLS if not c.endswith(".train")]


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    out = run(cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("fault", sorted(faults.SERVING))
@pytest.mark.parametrize("cell", SERVING)
def test_a_broken_serving_path_is_not_correct(cell, fault, monkeypatch):
    faults.SERVING[fault](monkeypatch.setattr)
    out = run(cell)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("fault", sorted(faults.TRAIN))
def test_a_broken_train_step_is_not_correct(fault, monkeypatch):
    faults.TRAIN[fault](monkeypatch.setattr)
    out = run("probunet-3view-bf16.train")
    assert not out["correct"], out["checks"]


def test_the_half_batch_shows_in_the_sampled_batch(monkeypatch):
    """Half of each batch's rows replaced by the other half's: every
    replaced row of the checked steps differs from the reference's gather."""
    faults.train_half_batch(monkeypatch.setattr)
    out = run("probunet-3view-bf16.train")
    wl = out["window"]
    assert out["checks"]["batch_rows_off"]["value"] == 3 * 8 // 2, (out["checks"], wl)


def test_a_seed_makes_the_same_inputs():
    a, b = (run("probunet-3view-bf16.train", seed=5, diagnose=True) for _ in range(2))
    assert a["checks"] == b["checks"] and a["not_compared"] == b["not_compared"]
    assert a["checks"]["batch_rows_off"]["value"] == 0
