"""The serving stream's host-side spans on the CPU: under ``torch.profiler``
every dispatched volume carries one ``dispatch`` (holding ``upload`` with its
``encode`` and ``stage``, the model's spans and ``outputs``) and every fetch
one ``fetch_wait`` and one ``unpack``; ``pool_alloc`` marks each new buffer of
the host pool; a batched group is one ``dispatch``; and the labels are the
same bits with the profiler on and off."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pmpu_tpu_torch import make_task
from pmpu_tpu_torch.inference import engine

WIRES = ["uint8", "bfloat16"]
STREAM_SPANS = ("dispatch", "upload", "encode", "stage", "outputs", "fetch_wait", "unpack")
N_VOLUMES = 3


def _volumes(n, s=16):
    rng = np.random.default_rng(5)
    return [(rng.random((s, s, s)) + 0.5 * (np.arange(s) > s // 2)).astype(np.float32)
            for _ in range(n)]


def _evaluator(wire):
    task = make_task("probunet", num_filters=(4, 8), latent_dim=3, no_convs_fcomb=2,
                     device="cpu", seed=3)
    return engine.VolumeEvaluator(task, n_samples=2, eval_batch=16, input_dtype=wire,
                                  device="cpu")


def _spans(prof):
    """{name: [(start, end)]} of the profile's events, in µs."""
    out = {}
    for e in prof.events():
        out.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    return out


def _allocated(ev):
    return sum(ev._pool.allocated.values())


@pytest.fixture(scope="module", params=WIRES)
def stream(request):
    """A fresh evaluator's profiled stream of 3 volumes at depth 2, then the
    same stream unprofiled."""
    ev, vols = _evaluator(request.param), _volumes(N_VOLUMES)
    before = _allocated(ev)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = ev.predict_volumes_pipelined(iter(vols), seed=17, pipeline_depth=2)
    rise = _allocated(ev) - before
    off = ev.predict_volumes_pipelined(iter(vols), seed=17, pipeline_depth=2)
    return {"spans": _spans(prof), "on": on, "off": off, "rise": rise, "ev": ev}


def _assert_inside(spans, child, parent):
    outer = spans[parent]
    assert spans[child] and all(any(a <= s and t <= b for a, b in outer)
                                for s, t in spans[child]), (child, parent)


def test_each_volume_carries_one_of_each_span(stream):
    counts = {k: len(stream["spans"].get(k, ())) for k in STREAM_SPANS + ("model",)}
    assert counts == dict.fromkeys(STREAM_SPANS + ("model",), N_VOLUMES)


def test_spans_nest_in_time(stream):
    spans = stream["spans"]
    for child in ("encode", "stage"):
        _assert_inside(spans, child, "upload")
    for child in ("upload", "model", "outputs"):
        _assert_inside(spans, child, "dispatch")


def test_pool_alloc_marks_each_new_buffer(stream):
    assert stream["rise"] > 0
    assert len(stream["spans"].get("pool_alloc", ())) == stream["rise"]


def test_labels_are_the_same_bits_with_the_profiler_on_and_off(stream):
    assert len(stream["on"]) == len(stream["off"]) == N_VOLUMES
    for a, b in zip(stream["on"], stream["off"]):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_a_batched_group_is_one_dispatch(stream):
    ev, vols = stream["ev"], np.stack(_volumes(2))
    truths = (vols > 0.9).astype(np.int32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = ev.evaluate_volumes_batched(vols, truths, seed=4)
    spans = _spans(prof)
    counts = {k: len(spans.get(k, ())) for k in STREAM_SPANS}
    assert counts == dict.fromkeys(STREAM_SPANS, 1)  # the one fetch is the Dice table
    _assert_inside(spans, "upload", "dispatch")
    _assert_inside(spans, "outputs", "dispatch")
    assert got["dice"].shape == (2, 4, 2) and tuple(got["fused"].shape) == (2, 16, 16, 16, 3)
