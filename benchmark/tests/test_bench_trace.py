"""The reduction of a Chrome trace to what the per-layer metrics read, on a
small trace written by hand (times in µs)."""

import pytest

from benchmark import core
from benchmark.tracing import TraceReading, busy_intervals


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid, "args": args}


TRACE = {"traceEvents": [
    _x("bench_window", "user_annotation", 1000, 1000),
    _x("model", "user_annotation", 1100, 400),
    _x("model", "user_annotation", 1600, 300),
    _x("aten::copy_", "cpu_op", 1300, 100),
    _x("cudaLaunchKernel", "cuda_runtime", 1150, 5, correlation=1),
    _x("cudaLaunchKernel", "cuda_runtime", 1200, 5, correlation=3),
    _x("cudaLaunchKernel", "cuda_runtime", 1650, 5, correlation=2),
    _x("fcomb_mean_tc_kernel", "kernel", 1200, 100, tid=7, correlation=1),
    _x("void cudnn_conv_kernel", "kernel", 1400, 200, tid=7, correlation=3),
    _x("gather_normalize_kernel", "kernel", 1700, 50, tid=7, correlation=2),
    _x("before_the_window", "kernel", 900, 50, tid=7, correlation=9),
]}


def test_busy_idle_and_spans():
    r = TraceReading(TRACE)
    assert r.window_s == pytest.approx(1e-3)
    assert r.busy_s == pytest.approx(350e-6)
    assert r.span_counts == {"model": 2}
    assert r.span_device_s("model") == pytest.approx(350e-6)
    assert r.span_device_s("model", "fcomb_mean") == pytest.approx(100e-6)
    assert r.span_device_s("model", "gather_normalize") == pytest.approx(50e-6)
    ops = dict(r.breakdown()["device_ops"])
    assert ops["hand kernels: fcomb_mean_tc_kernel"] == pytest.approx(100e-6)
    assert ops["conv (cuDNN): void cudnn_conv_kernel"] == pytest.approx(200e-6)


def test_idle_gaps_are_named_by_the_innermost_host_event():
    gaps = dict(TraceReading(TRACE).idle_gaps())
    assert gaps["aten::copy_"] == pytest.approx(100e-6)       # 1300..1400
    assert gaps["model"] == pytest.approx(450e-6)             # 1000..1200, 1750..2000
    assert gaps["cudaLaunchKernel"] == pytest.approx(100e-6)  # 1600..1700
    assert sum(gaps.values()) == pytest.approx(650e-6)


def test_busy_intervals_merge_overlaps():
    ev = [{"ts": 0, "dur": 10}, {"ts": 5, "dur": 10}, {"ts": 20, "dur": 1}]
    assert busy_intervals(ev) == [[0.0, 15.0], [20.0, 21.0]]


def test_readers_on_the_trace():
    cfg = {"cube": 16, "views": 3, "num_filters": [64], "num_classes": 3, "prior_samples": 5,
           "no_convs_fcomb": 4, "input_channels": 1, "latent_dim": 6}
    r = core.Reading(TraceReading(TRACE), cfg, {"batch": 8}, {})
    b = core.Benchmark()
    assert b.reader("device_idle_pct.backlog").read(r) == pytest.approx(65.0)
    assert b.reader("model_ms_per_volume").read(r) == pytest.approx(0.175)
    assert b.reader("splat_back_ms_per_volume").read(r) is None
    assert b.reader("oblique_roofline_pct").read(r) is None
    assert 0 < b.reader("fcomb_roofline_pct").read(r) < 100


def test_a_trace_without_the_window_span_is_refused():
    with pytest.raises(ValueError):
        TraceReading({"traceEvents": TRACE["traceEvents"][1:]})
