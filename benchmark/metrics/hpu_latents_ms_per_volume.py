"""Device ms a volume of the operations launched inside the program's
``hpu_latents`` spans (the hpunet's noise and its latent
levels, every draw at once) in the traced window: their
device time ÷ the ``model`` spans (one a volume)."""


def read(r):
    n = r.trace.span_counts.get("model", 0)
    spent = r.trace.span_device_s("hpu_latents")
    return 1e3 * spent / n if n and spent > 0 else None
