"""Device operations a train step (kernels, copies and memsets): those of the
traced window ÷ the program's ``optimizer`` spans in it (one a step). The
window opens at a step boundary with nothing in flight and closes with a
synchronize, so every operation of a step enqueued inside it runs inside it."""


def read(r):
    n = r.trace.span_counts.get("optimizer", 0)
    return len(r.trace.device) / n if n and r.trace.device else None
