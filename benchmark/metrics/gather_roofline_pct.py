"""The gather-normalize kernel's share of its roofline, in %: every plane of
the volumes' views read and written once in f32 (``flops.gather_bytes``) at
the memory bandwidth ÷ the device time of the kernel's launches in the
traced window's ``model`` spans."""

from benchmark.flops import PEAKS, gather_bytes, slices_per_volume


def read(r):
    cfg = r.config
    spent = r.trace.span_device_s("model", "gather_normalize")
    n = r.trace.span_counts.get("model", 0)
    if not n or spent <= 0:
        return None
    bytes_ = gather_bytes(n * slices_per_volume(cfg), cfg["cube"] ** 2)
    return 100.0 * bytes_ / PEAKS["hbm_bytes"] / spent
