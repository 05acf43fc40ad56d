"""The conv epilogue kernel's share of its roofline, in %: the least time of
the volumes' epilogues ÷ the device time of the kernel's launches (names
holding ``bias_bn_relu``) in the traced window's ``model`` spans. The least
time is bytes at the memory bandwidth, counted from the configuration's
shapes alone: each element of every 3×3 conv output of the backbone and the
prior tower read once and written once, in the compute dtype, a slice times
the slices of a volume."""

from benchmark.flops import PEAKS, slices_per_volume

DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


def conv_output_elements(s: int, filters, convs_per_block: int) -> int:
    """Elements of the 3×3 conv outputs on one s×s slice: the backbone's
    DoubleConvs at floor sizes (2×2 max pools), encoder and decoder, and
    the prior tower's ``convs_per_block`` convs a level at ceil sizes (2×2
    ceil average pools)."""
    f = list(filters)
    floor, ceil = [s], [s]
    for _ in f[1:]:
        floor.append(floor[-1] // 2)
        ceil.append(-(-ceil[-1] // 2))
    backbone = sum(2 * c * h * h for c, h in zip(f, floor))
    backbone += sum(2 * c * h * h for c, h in zip(f[:-1], floor[:-1]))
    return backbone + sum(convs_per_block * c * h * h for c, h in zip(f, ceil))


def read(r):
    cfg = r.config
    spent = r.trace.span_device_s("model", "bias_bn_relu")
    n = r.trace.span_counts.get("model", 0)
    if not n or spent <= 0:
        return None
    elements = n * slices_per_volume(cfg) * conv_output_elements(
        cfg["cube"], cfg["num_filters"], cfg["no_convs_per_block"])
    least = 2 * DTYPE_BYTES[cfg["dtype"]] * elements / PEAKS["hbm_bytes"]
    return 100.0 * least / spent
