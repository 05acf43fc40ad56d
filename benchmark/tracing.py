"""The traced run: ``torch.profiler`` over a part of the window, and the
arithmetic that turns its Chrome trace into what the per-layer metrics read.

The traced part is the benchmark's own span, ``bench_window``: it opens at
the first item boundary of the window and closes, after a device
synchronize, at the first boundary past ``trace_seconds``. Its device
operations are those that start inside it; the device is busy for the
union of their intervals (the arithmetic of the program's
``tools/trace_breakdown.py`` and ``tools/profile_volume.py``, copied so that
a later change to the program leaves the yardstick as it is). A device
operation belongs to a span of the window's thread when the host call that
launched it (the trace's ``correlation`` ids) lies inside that span in time,
on whatever thread: autograd launches the backward pass from a thread of
its own while the window's thread waits in ``backward``.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile
import time

WINDOW_SPAN = "bench_window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
TOP = 10

# (group, substrings of a device operation's lowercased name), first match wins
GROUPS = (
    ("hand kernels", ("fcomb_mean", "gather_normalize", "qchain_kernel", "oblique_planes")),
    ("copies", ("memcpy", "memset", "copy_kernel", "catarraybatchedcopy")),
    ("pools", ("pool",)),
    ("conv (cuDNN)", ("conv", "cudnn", "xmma", "gemm", "cutlass", "dgrad", "wgrad", "fprop",
                      "winograd", "implicit", "nchwtonhwc", "nhwctonchw")),
    ("batchnorm/relu/add elementwise", ("elementwise", "batch_norm", "relu", "threshold")),
)


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def busy_intervals(events) -> list:
    """The union of the events' [start, end) intervals, merged and sorted."""
    out = []
    for start, stop in sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], stop)
        else:
            out.append([start, stop])
    return out


class TraceReading:
    """What the per-layer metrics read of one Chrome trace (times in s)."""

    def __init__(self, trace: dict):
        events = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
        spans = [e for e in events if e.get("cat") == "user_annotation"
                 and e.get("name") == WINDOW_SPAN]
        if len(spans) != 1:
            raise ValueError(f"{len(spans)} {WINDOW_SPAN!r} spans in the trace")
        w = spans[0]
        t0, t1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
        self.window_s = (t1 - t0) / 1e6
        self.device = [e for e in events if e.get("cat") in DEVICE_CATS
                       and t0 <= float(e["ts"]) <= t1]
        self.intervals = busy_intervals(self.device)
        self.busy_s = sum(b - a for a, b in self.intervals) / 1e6
        launches = {e["args"]["correlation"]: e for e in events
                    if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
        # host spans of the window's thread, by name, sorted by start
        tid = w["tid"]
        notes = collections.defaultdict(list)
        for e in events:
            if (e.get("cat") == "user_annotation" and e["tid"] == tid and e is not w
                    and t0 <= float(e["ts"]) <= t1):
                notes[e["name"]].append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
        for v in notes.values():
            v.sort()
        self.span_counts = {k: len(v) for k, v in notes.items()}
        # device seconds by (span name, kernel name)
        self.by_span = collections.defaultdict(collections.Counter)
        for e in self.device:
            launch = launches.get(e.get("args", {}).get("correlation"))
            if launch is None:
                continue
            ts = float(launch["ts"])
            for name, iv in notes.items():
                j = bisect.bisect_right(iv, (ts, float("inf"))) - 1
                if j >= 0 and iv[j][0] <= ts <= iv[j][1]:
                    self.by_span[name][e["name"]] += float(e["dur"]) / 1e6
        self.kernels = collections.Counter()
        for e in self.device:
            self.kernels[e["name"]] += float(e["dur"]) / 1e6
        self._host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                            for e in events if e.get("cat") in HOST_CATS and e["tid"] == tid
                            and e is not w and float(e["ts"]) < t1
                            and float(e["ts"]) + float(e["dur"]) > t0)
        self._t = (t0, t1)

    def span_device_s(self, span: str, kernel: str = "") -> float:
        """Device seconds of the operations launched inside ``span``
        instances whose name holds ``kernel`` (all of them for "")."""
        return sum(s for k, s in self.by_span.get(span, {}).items() if kernel in k)

    def idle_gaps(self) -> list:
        """Idle seconds of the window by what the host was doing: each gap
        between busy intervals named by the innermost host event running at
        its middle (``idle`` where none was)."""
        t0, t1 = self._t
        edges = [t0] + [x for iv in self.intervals for x in iv] + [t1]
        gaps = sorted(((a + b) / 2, b - a) for a, b in zip(edges[::2], edges[1::2]) if b > a)
        out = collections.Counter()
        stack, i = [], 0
        for mid, length in gaps:
            while i < len(self._host) and self._host[i][0] <= mid:
                stack.append(self._host[i])
                i += 1
            stack = [h for h in stack if h[1] >= mid]
            inner = min(stack, key=lambda h: h[1] - h[0])[2] if stack else "idle"
            out[inner] += length / 1e6
        return out.most_common(TOP)

    def breakdown(self) -> dict:
        """The device operations with the most time, each named after its
        group (``GROUPS``) and itself, and the idle gaps by host activity."""
        return {"device_ops": [[f"{group_of(k)}: {k}", v]
                               for k, v in self.kernels.most_common(TOP)],
                "idle_gaps": [[k, v] for k, v in self.idle_gaps()]}


class Tracer:
    """Opens and closes the traced part of the window at item boundaries.
    Disabled, every call does nothing."""

    def __init__(self, enabled: bool, seconds: float, device):
        self.enabled, self.seconds, self.device = enabled, seconds, device
        self.prof = self.span = None
        self.t_start = None
        self.done = False

    def warm_up(self):
        """Start and stop the profiler once, so that its first start (CUPTI's
        set-up) falls into the set-up and not into the window."""
        if not self.enabled:
            return
        import torch

        with self._profile():
            torch.ones(8, device=self.device).sum()
            _sync(self.device)

    def _profile(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.device(self.device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts)

    def tick(self):
        """An item boundary of the window: the traced part starts at the
        first and ends at the first after ``seconds``."""
        if not self.enabled or self.done:
            return
        import torch

        if self.prof is None:
            self.prof = self._profile()
            self.prof.start()
            self.span = torch.autograd.profiler.record_function(WINDOW_SPAN)
            self.span.__enter__()
            self.t_start = time.perf_counter()
        elif time.perf_counter() - self.t_start >= self.seconds:
            self.stop()

    def stop(self):
        if self.prof is None or self.done:
            return
        _sync(self.device)
        self.span.__exit__(None, None, None)
        self.prof.stop()
        self.done = True

    def reading(self):
        """The :class:`TraceReading` of the traced part (None when disabled
        or never started). The Chrome trace goes through a temporary file,
        removed once read."""
        if self.prof is None:
            return None
        self.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                trace = json.load(f)
        finally:
            os.remove(path)
        return TraceReading(trace)


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
