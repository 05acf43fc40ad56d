"""The readers of the program's host-side spans and of the device operations
a volume or a step, on small traces written by hand (times in µs)."""

import pytest

from benchmark import core
from benchmark.tracing import TraceReading
from benchmark.tests.test_bench_trace import _x

CFG = {"cube": 16, "views": 3, "num_filters": [64], "num_classes": 3, "prior_samples": 5,
       "no_convs_fcomb": 4, "input_channels": 1, "latent_dim": 6}

WINDOW = _x("bench_window", "user_annotation", 1000, 1000)
DEVICE = [
    _x("void cudnn_conv_kernel", "kernel", 1200, 100, tid=7, correlation=1),
    _x("fcomb_mean_tc_kernel", "kernel", 1550, 50, tid=7, correlation=2),
    _x("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 1510, 5, tid=8, correlation=3),
    _x("Memset (Device)", "gpu_memset", 1800, 2, tid=7, correlation=4),
    _x("before_the_window", "kernel", 900, 50, tid=7, correlation=9),
]
STREAM = {"traceEvents": [
    WINDOW,
    _x("dispatch", "user_annotation", 900, 150),    # starts before the window
    _x("upload", "user_annotation", 900, 40),
    _x("dispatch", "user_annotation", 1100, 300),
    _x("upload", "user_annotation", 1100, 50),
    _x("encode", "user_annotation", 1100, 30),
    _x("stage", "user_annotation", 1130, 20),
    _x("model", "user_annotation", 1150, 200),
    _x("dispatch", "user_annotation", 1500, 200),
    _x("upload", "user_annotation", 1500, 60),
    _x("model", "user_annotation", 1560, 100),
    _x("fetch_wait", "user_annotation", 1750, 100),
    _x("dispatch", "user_annotation", 1500, 400, tid=2),  # another thread
    _x("upload", "user_annotation", 1500, 300, tid=2),
    *DEVICE,
]}
TRAIN = {"traceEvents": [
    WINDOW,
    _x("backward", "user_annotation", 1100, 300),
    _x("optimizer", "user_annotation", 1400, 50),
    _x("optimizer", "user_annotation", 900, 50),    # before the window
    *DEVICE,
]}
EMPTY = {"traceEvents": [WINDOW, *DEVICE]}


def _read(metric, trace):
    return core.Benchmark().reader(metric).read(
        core.Reading(TraceReading(trace), CFG, {"batch": 8}, {}))


@pytest.mark.parametrize("metric,want", [
    ("host_dispatch_ms_per_volume", (300 + 200) / 2 / 1e3),
    ("host_upload_ms_per_volume", (50 + 60) / 2 / 1e3),
    ("launches_per_volume", 4 / 2),
])
def test_stream_readers_on_the_trace(metric, want):
    """Host ms of the window thread's spans that start in the window ÷ the
    volumes (its ``dispatch`` spans); the window's 4 device operations ÷ 2."""
    assert _read(metric, STREAM) == pytest.approx(want)


def test_launches_per_step_on_the_trace():
    assert _read("launches_per_step", TRAIN) == pytest.approx(4.0)


@pytest.mark.parametrize("metric", ["host_dispatch_ms_per_volume", "host_upload_ms_per_volume",
                                    "launches_per_volume", "launches_per_step"])
@pytest.mark.parametrize("trace", [EMPTY, TRAIN, STREAM], ids=["no_span", "train", "stream"])
def test_none_without_the_span(metric, trace):
    """A reader reads nothing where its spans are missing: the parent's
    trace, the other traffic's."""
    wanted = TRAIN if metric == "launches_per_step" else STREAM
    if trace is wanted:
        assert _read(metric, trace) is not None
    else:
        assert _read(metric, trace) is None


def test_upload_needs_a_dispatch():
    """An ``upload`` without ``dispatch`` spans (the engine before them)
    gives no number."""
    trace = {"traceEvents": [e for e in STREAM["traceEvents"] if e["name"] != "dispatch"]}
    assert _read("host_upload_ms_per_volume", trace) is None


@pytest.mark.parametrize("base", ["host_dispatch_ms_per_volume", "host_upload_ms_per_volume",
                                  "launches_per_volume"])
def test_six_view_alias_reads_its_base(base):
    assert _read(base + ".6view", STREAM) == _read(base, STREAM)
