"""The fcomb mean-decode kernel's share of its roofline, in %: the least time
of the volumes' decodes (``flops.fcomb_flops`` at the bf16 peak, or
``flops.fcomb_bytes`` at the memory bandwidth, whichever is longer) ÷ the
device time of the kernel's launches in the traced window's ``model``
spans."""

from benchmark.flops import PEAKS, fcomb_bytes, fcomb_flops, least_seconds, slices_per_volume


def read(r):
    cfg = r.config
    spent = r.trace.span_device_s("model", "fcomb_mean")
    n = r.trace.span_counts.get("model", 0)
    if not n or spent <= 0:
        return None
    slices, hw, f0 = n * slices_per_volume(cfg), cfg["cube"] ** 2, cfg["num_filters"][0]
    least = least_seconds(
        fcomb_flops(slices, hw, f0, f0, cfg["num_classes"], cfg["prior_samples"],
                    cfg["no_convs_fcomb"]),
        fcomb_bytes(slices, hw, f0, cfg["num_classes"]), PEAKS["bf16_flops"])
    return 100.0 * least / spent
