"""Host ms a volume of the program's ``dispatch`` spans (a volume's enqueue:
the upload, the model's launches, the outputs and the starts of their copies
to the host) on the window's thread: the host durations of those that start
in the traced window, summed, ÷ their count."""


def read(r):
    t0, t1 = r.trace._t
    n = r.trace.span_counts.get("dispatch", 0)
    spent = sum(b - a for a, b, name in r.trace._host if name == "dispatch" and t0 <= a <= t1)
    return spent / 1e3 / n if n else None
