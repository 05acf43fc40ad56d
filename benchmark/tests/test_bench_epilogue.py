"""The conv epilogue's roofline share on small traces written by hand (times
in µs): its bytes from the configuration's shapes, its time from the kernel's
launches inside ``model`` spans, nothing where the program has no such
kernel (the parent of the change that added it)."""

import pytest

from benchmark import core
from benchmark.tracing import TraceReading, group_of

CFG = {"cube": 170, "views": 3, "num_filters": [64, 128, 256, 512, 1024], "dtype": "bfloat16",
       "no_convs_per_block": 2}
KERNEL = ("(anonymous namespace)::bias_bn_relu_kernel(uint4*, int, int, float const*, "
          "float const*, float const*, float const*, float const*, float)")


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid, "args": args}


def _trace(kernel_us, kernel=KERNEL):
    return {"traceEvents": [
        _x("bench_window", "user_annotation", 0, 100_000),
        _x("model", "user_annotation", 100, 40_000),
        _x("model", "user_annotation", 50_000, 40_000),
        _x("cudaLaunchKernel", "cuda_runtime", 200, 5, correlation=1),
        _x("cudaLaunchKernel", "cuda_runtime", 50_200, 5, correlation=2),
        _x("cudaLaunchKernel", "cuda_runtime", 95_000, 5, correlation=3),
        _x(kernel, "kernel", 300, kernel_us, tid=7, correlation=1),
        _x(kernel, "kernel", 50_300, kernel_us, tid=7, correlation=2),
        _x(kernel, "kernel", 95_100, 1000, tid=7, correlation=3),  # outside the model spans
    ]}


def _read(metric, trace, cfg=CFG):
    return core.Benchmark().reader(metric).read(core.Reading(TraceReading(trace), cfg, {}, {}))


def test_bytes_of_the_conv_outputs():
    """21.25 M conv-output elements a 170² slice: 18 backbone convs at floor
    sizes, 10 prior convs at ceil sizes."""
    m = core.metric_reader("epilogue_roofline_pct")
    assert m.conv_output_elements(170, CFG["num_filters"], 2) == 21_250_816
    assert m.conv_output_elements(8, [4, 8], 2) == 2 * 4 * 64 + 2 * 8 * 16 + 2 * 4 * 64 \
        + 2 * 4 * 64 + 2 * 8 * 16


@pytest.mark.parametrize("metric,views", [("epilogue_roofline_pct", 3),
                                          ("epilogue_roofline_pct.6view", 6)])
def test_share_of_the_bound(metric, views):
    """Two volumes in the spans; the launch outside them is not counted."""
    cfg = dict(CFG, views=views)
    least_s = 2 * 2 * 21_250_816 * views * 170 / 3.35e12  # a volume
    got = _read(metric, _trace(20_000), cfg)
    assert got == pytest.approx(100 * least_s / 20e-3)


def test_nothing_to_read_without_the_kernel():
    assert _read("epilogue_roofline_pct", _trace(20_000, kernel="void other_kernel")) is None


def test_the_kernel_is_grouped_with_the_passes_it_replaces():
    assert group_of(KERNEL) == "batchnorm/relu/add elementwise"
