"""Host ms a volume of the program's ``upload`` spans (the conversion to the
wire dtype, ``encode``, and the pinned and asynchronous copies, ``stage``) on
the window's thread: the host durations of those that start in the traced
window, summed, ÷ the count of its ``dispatch`` spans (the volumes)."""


def read(r):
    t0, t1 = r.trace._t
    n = r.trace.span_counts.get("dispatch", 0)
    spent = sum(b - a for a, b, name in r.trace._host if name == "upload" and t0 <= a <= t1)
    return spent / 1e3 / n if n else None
