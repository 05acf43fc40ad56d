"""The oblique-plane kernel's share of its roofline, in %: the volume read
once and its V·S planes written once (``flops.oblique_bytes``) at the memory
bandwidth, or their trilinear FLOPs at the f32 peak, whichever is longer, ÷
the device time of the kernel's launches in the traced window's
``oblique_slabs`` spans."""

from benchmark.flops import PEAKS, least_seconds, oblique_bytes, oblique_flops


def read(r):
    cfg = r.config
    spent = r.trace.span_device_s("oblique_slabs", "oblique_planes")
    n = r.trace.span_counts.get("oblique_slabs", 0)
    if not n or spent <= 0:
        return None
    s, v = cfg["cube"], cfg["views"]
    least = n * least_seconds(oblique_flops(s, v), oblique_bytes(s, v), PEAKS["f32_flops"])
    return 100.0 * least / spent
