"""Device ms a volume of the operations launched inside the program's
``splat_back`` span (the resample of each oblique view back to the grid) in
the traced window."""


def read(r):
    n = r.trace.span_counts.get("splat_back", 0)
    spent = r.trace.span_device_s("splat_back")
    return 1e3 * spent / n if n and spent > 0 else None
