"""The HPU-Net's residual-block epilogue roofline on traces written by hand
(times in µs): its bytes from the configuration's shapes, its time from the
kernels' launches inside ``model`` spans, nothing where the program has no
such kernel (the parent of the change that added it)."""

import pytest

from benchmark import core
from benchmark.tests.test_bench_hpunet import STREAM, _read
from benchmark.tests.test_bench_trace import _x

CELL = "hpunet-3view-bf16.backlog"
CFG = core.load_json(core.ROOT / "benchmark" / "configs" / "hpunet-3view-bf16.json")
KERNELS = ("(anonymous namespace)::hpu_epilogue_bias_relu_kernel(uint4*, int, int, int, "
           "float const*)",
           "void (anonymous namespace)::hpu_epilogue_residual_relu_kernel<true, true>(uint4*, "
           "uint4 const*, uint4*, int, int, int, float const*, float const*)")
# the stream's trace (one ``model`` span) with a launch of each kernel in it
# and one after the window's model span
TRACE = {"traceEvents": STREAM["traceEvents"] + [
    _x("cudaLaunchKernel", "cuda_runtime", 1500, 2, correlation=11),
    _x("cudaLaunchKernel", "cuda_runtime", 1600, 2, correlation=12),
    _x("cudaLaunchKernel", "cuda_runtime", 1900, 2, correlation=13),
    _x(KERNELS[0], "kernel", 1660, 30, tid=7, correlation=11),
    _x(KERNELS[1], "kernel", 1700, 20, tid=7, correlation=12),
    _x(KERNELS[0], "kernel", 1950, 40, tid=7, correlation=13),
]}


def _reader():
    return core.metric_reader("hpu_epilogue_roofline_pct")


def test_bytes_of_a_volume_at_the_published_widths():
    """137.25 GB a 170³ volume: the encoder 22.88, the latent decoder 9.49,
    the stitching decoder 104.89 (510 slices, 5 draws)."""
    assert _reader().volume_bytes(CFG) / 1e9 == pytest.approx(137.25, abs=0.01)
    encoder = _reader().volume_bytes(dict(CFG, prior_samples=0))
    assert encoder / 1e9 == pytest.approx(22.88, abs=0.01)
    # without latent levels the stitching decoder has all 7 decoder levels: the same maps
    no_latents = _reader().volume_bytes(dict(CFG, latent_dims=[]))
    assert (no_latents - encoder) / 1e9 == pytest.approx(9.49 + 104.89, abs=0.01)


@pytest.mark.parametrize("blocks,convs,want", [(3, 3, 2 * 6 * 12 + 11 * 24),
                                               (1, 3, 2 * 2 * 12 + 3 * 24),
                                               (2, 1, 7 * 24)])
def test_elements_of_a_level(blocks, convs, want):
    """Per map pixel: 2 × d for each in-place epilogue, 3 × c for each
    residual (y, the skip, the sum), c more for the ReLU copy of all but
    the last block."""
    assert _reader().level_elements(1, 24, 12, blocks, convs) == want
    assert _reader().level_elements(5, 24, 12, blocks, convs) == 25 * want


def test_share_of_the_bound():
    """Both kernels' launches in the model span; the one outside is not
    counted."""
    got = _read("hpu_epilogue_roofline_pct", TRACE)
    assert got == pytest.approx(100 * 137.25123264e9 / 3.35e12 / 50e-6)


def test_nothing_to_read_without_the_kernels():
    assert _read("hpu_epilogue_roofline_pct") is None


def test_declared_for_the_hpunet_cell_only():
    bench = core.load_json(core.ROOT / "BENCHMARK.json")
    entry = next(m for m in bench["per_layer"] if m["name"] == "hpu_epilogue_roofline_pct")
    assert entry == {"name": "hpu_epilogue_roofline_pct", "unit": "%", "better": "higher",
                     "source": "device_trace", "layer": "kernels", "moves": "volumes_per_s",
                     "workloads": [CELL]}
