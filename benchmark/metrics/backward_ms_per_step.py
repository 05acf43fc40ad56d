"""Device ms a step of the operations launched inside the program's
``backward`` span (the backward pass) in the traced window."""


def read(r):
    n = r.trace.span_counts.get("backward", 0)
    spent = r.trace.span_device_s("backward")
    return 1e3 * spent / n if n and spent > 0 else None
