"""Device operations a volume (kernels, copies and memsets): those of the
traced window ÷ the program's ``dispatch`` spans in it. The window opens at
an item boundary with nothing in flight and closes with a synchronize, so
every operation of a volume dispatched inside it runs inside it."""


def read(r):
    n = r.trace.span_counts.get("dispatch", 0)
    return len(r.trace.device) / n if n and r.trace.device else None
