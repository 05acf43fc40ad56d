"""Device ms a volume of the operations launched inside the program's ``model``
span (the backbone, the prior, the fcomb and the softmax) in the traced
window."""


def read(r):
    n = r.trace.span_counts.get("model", 0)
    spent = r.trace.span_device_s("model")
    return 1e3 * spent / n if n and spent > 0 else None
