"""The whole train step's share of the card's bf16 peak, in %: the model
FLOPs of a step from the configuration's shapes and the batch
(``flops.train_step_flops``) × the steps in the traced window (its
``optimizer`` spans) ÷ the window ÷ the peak."""

from benchmark.flops import PEAKS, train_step_flops


def read(r):
    n = r.trace.span_counts.get("optimizer", 0)
    if not n or not r.trace.device:
        return None
    flops = train_step_flops(r.config, r.workload["batch"])
    return 100.0 * flops * n / r.trace.window_s / PEAKS["bf16_flops"]
