"""The hpunet cell at a small size on the CPU: a sound run is correct, and
the control (the program's convs on float8 inputs and weights) and both
faults of ``hpunet_faults.py`` are not, under the cell's own limits; its
readers on a trace written by hand; its FLOPs from shapes at the published
widths."""

import time

import pytest

from benchmark import core, flops, flops_hpunet, hpunet_faults
from benchmark.tests.test_bench_trace import _x
from benchmark.tracing import TraceReading

CELL = "hpunet-3view-bf16.backlog"
# 4 levels on 18³ cubes (18, 9, 4, 2), 2 latent levels: the 8² map padded to 9²
TINY = {"config": {"channels_per_block": [4, 8, 8, 8], "down_channels_per_block": [2, 4, 4, 4],
                   "latent_dims": [1, 1], "scan_shape": [12, 18, 18], "cube": 18},
        "workload": {"volumes": 3, "warmup_volumes": 1, "check_volumes": 2,
                     "trace_seconds": 0.3}}


def run(dtype="float32", variant="program", fault=None, seed=20261018, trace=False):
    over = {k: dict(v) for k, v in TINY.items()}
    over["config"]["dtype"] = dtype
    over["workload"]["fault"] = fault
    return core.run_cell(CELL, seed, 0.5, trace, time.perf_counter(), device="cpu",
                         variant=variant, overrides=over)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a_sound_run_is_correct(dtype):
    out = run(dtype)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("fault", sorted(hpunet_faults.FAULTS))
def test_a_fault_is_not_correct(fault):
    out = run(fault=fault)
    assert not out["correct"], out["checks"]


def test_the_control_is_not_correct():
    out = run("bfloat16", variant="control")
    assert not out["correct"], out["checks"]


def test_the_traced_run_reads_the_host_side():
    """On the CPU the trace has no device operations: only the host's
    dispatch is read."""
    out = run(trace=True)
    assert out["correct"] and "host_dispatch_ms_per_volume.hpunet" in out["metrics"]


CFG = core.load_json(core.ROOT / "benchmark" / "configs" / "hpunet-3view-bf16.json")
STREAM = {"traceEvents": [
    _x("bench_window", "user_annotation", 1000, 1000),
    _x("dispatch", "user_annotation", 1050, 800),
    _x("model", "user_annotation", 1100, 700),
    _x("hpu_encoder", "user_annotation", 1110, 100),
    _x("hpu_latents", "user_annotation", 1220, 100),
    _x("hpu_stitch", "user_annotation", 1330, 400),
    _x("cudaLaunchKernel", "cuda_runtime", 1150, 5, correlation=1),
    _x("cudaLaunchKernel", "cuda_runtime", 1250, 5, correlation=2),
    _x("cudaLaunchKernel", "cuda_runtime", 1400, 5, correlation=3),
    _x("cudaLaunchKernel", "cuda_runtime", 1700, 5, correlation=4),
    _x("void cudnn_conv_kernel", "kernel", 1200, 40, tid=7, correlation=1),
    _x("randn_kernel", "kernel", 1300, 10, tid=7, correlation=2),
    _x("void cudnn_conv_kernel", "kernel", 1450, 200, tid=7, correlation=3),
    _x("mean_kernel", "kernel", 1750, 50, tid=7, correlation=4),
]}


def _read(metric, trace=STREAM):
    return core.Benchmark().reader(metric).read(
        core.Reading(TraceReading(trace), CFG, {}, {}))


@pytest.mark.parametrize("metric,want", [
    ("hpu_encoder_ms_per_volume", 0.040),
    ("hpu_latents_ms_per_volume", 0.010),
    ("hpu_stitch_ms_per_volume", 0.250),
    ("model_ms_per_volume.hpunet", 0.300),
    ("device_idle_pct.hpunet", 70.0),
    ("launches_per_volume.hpunet", 4.0),
    ("host_dispatch_ms_per_volume.hpunet", 0.800),
    ("mfu.hpunet", 100.0 * flops_hpunet.volume_flops(CFG) / 1e-3 / 989e12),
])
def test_readers_on_the_trace(metric, want):
    assert _read(metric) == pytest.approx(want)


@pytest.mark.parametrize("metric", ["hpu_encoder_ms_per_volume", "hpu_latents_ms_per_volume",
                                    "hpu_stitch_ms_per_volume"])
def test_span_readers_read_nothing_without_their_spans(metric):
    """The parent's program has no such spans: the reader reads nothing."""
    trace = {"traceEvents": [e for e in STREAM["traceEvents"]
                             if not e["name"].startswith("hpu_")]}
    assert _read(metric, trace) is None


# the stream's trace with one upload span and one gather-normalize launch in
# the model span (dispatch 1, model 1)
GATHER = {"traceEvents": STREAM["traceEvents"] + [
    _x("upload", "user_annotation", 1060, 30),
    _x("cudaLaunchKernel", "cuda_runtime", 1105, 2, correlation=5),
    _x("void gather_normalize_kernel", "kernel", 1160, 30, tid=7, correlation=5),
]}


@pytest.mark.parametrize("metric,want", [
    ("gather_roofline_pct.hpunet",
     100.0 * 8 * 510 * 170 ** 2 / flops.PEAKS["hbm_bytes"] / 30e-6),
    ("host_upload_ms_per_volume.hpunet", 0.030),
])
def test_shared_layer_readers_on_the_trace(metric, want):
    """The layers the hpunet cell shares with the probunet backlog: the
    gather-normalize kernel (510 planes of 170² a volume) and the upload."""
    assert _read(metric, GATHER) == pytest.approx(want)


def test_flops_at_the_published_widths():
    """At 170², residual blocks of two 3×3 convs to the down width and a 1×1
    to the level's: the encoder 1.378 GMAC a slice, the latent decoder 0.594
    and the stitching decoder 1.674 a draw; 5 draws, 510 slices: 12.98 TFLOP
    a volume, 89.2 % of it in the draws."""
    assert flops_hpunet.encoder_flops(CFG) / 2e9 == pytest.approx(1.37841, abs=1e-5)
    assert flops_hpunet.latent_flops(CFG) / 2e9 == pytest.approx(0.59425, abs=1e-5)
    assert flops_hpunet.stitch_flops(CFG) / 2e9 == pytest.approx(1.67439, abs=1e-5)
    assert flops_hpunet.volume_flops(CFG) / 1e12 == pytest.approx(12.97605, abs=1e-5)
    assert flops_hpunet.level_sizes(170, 8) == [170, 85, 42, 21, 10, 5, 2, 1]


def test_block_flops_are_the_published_blocks():
    """A block 24 → (12, 12) → 24 at 170²: two 3×3 convs to 12, a 1×1 to 24;
    from 48 channels, the 1×1 skip to 24 too."""
    h = 170 * 170
    same = 2 * h * (24 * 12 * 9 + 12 * 12 * 9 + 12 * 24)
    assert flops_hpunet.block_flops(170, 24, 24, 12, 3) == same
    assert flops_hpunet.block_flops(170, 48, 24, 12, 3) == same + 2 * h * (24 * 12 * 9 + 48 * 24)
