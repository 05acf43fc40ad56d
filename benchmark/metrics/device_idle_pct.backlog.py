"""The device's idle share of the traced window, in %: 100 × (1 − the union
of the device operations' intervals ÷ the window)."""


def read(r):
    if r.trace.window_s <= 0 or not r.trace.device:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
