"""The hpunet's whole volume's share of the card's bf16 peak, in %: the
model FLOPs of a volume from the configuration's shapes
(``flops_hpunet.volume_flops``: the encoder once a slice, the latent and
stitching decoders once a draw) × the volumes dispatched in the traced
window (its ``model`` spans) ÷ the window ÷ the peak."""

from benchmark.flops import PEAKS
from benchmark.flops_hpunet import volume_flops


def read(r):
    n = r.trace.span_counts.get("model", 0)
    if not n or not r.trace.device:
        return None
    return 100.0 * volume_flops(r.config) * n / r.trace.window_s / PEAKS["bf16_flops"]
