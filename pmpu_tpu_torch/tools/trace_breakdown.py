"""Break a saved ``torch.profiler`` trace of the port down into device and
host time (counterpart of the JAX package's ``tools/trace_breakdown.py``).

    python3 -m pmpu_tpu_torch.tools.trace_breakdown runs/profile_volume/volume

Reads the Chrome trace (``trace.json``) that ``utils/profiling.py::trace``
writes under the directory given (``tools/profile_volume.py`` and
``tools/profile_train.py`` write one a profiled run under ``--trace-dir``;
with several below the directory, the newest) and prints:

  == device time per annotated span ==  device ms of the operations each
        ``record_function`` / ``scope`` span launched (a device operation is
        placed by the host launch that enqueued it, the trace's
        ``correlation`` ids; nested spans each count it), in place of XLA's
        modules;
  == top device op groups ==  device ms by ``profile_volume.group_of``;
  == top host events ==  host ms by event name (nested events each count);
  == device busy vs traced window ==  the union of the device operations'
        intervals against the window of the outermost annotation.

The window is the longest host annotation of the trace (``profiled_volume``
for profile_volume's traces, the step's for profile_train's); its device
operations are ``profile_volume.device_events``'s. A trace without device
operations (``--device cpu``) is refused: the tool says so and exits 1.
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import sys

from pmpu_tpu_torch.tools.profile_volume import DEVICE_CATS, busy_us, device_events, group_of

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
TOP = 12  # spans and host events printed
# not host time: the device operations, the profiler's device copies of the
# annotations, the annotations themselves (their own section) and the
# profiler's span of the whole trace
NOT_HOST = (*DEVICE_CATS, "gpu_user_annotation", "user_annotation", "Trace")


def find_trace(root: str) -> str:
    """``root`` itself when it is a file, else its newest ``trace.json``."""
    if os.path.isfile(root):
        return root
    paths = glob.glob(os.path.join(root, "**", "trace.json"), recursive=True)
    if not paths:
        raise FileNotFoundError(f"no trace.json under {root} (run tools/profile_volume.py "
                                "or tools/profile_train.py with --trace-dir first)")
    return max(paths, key=os.path.getmtime)


def breakdown(trace: dict) -> dict:
    """The tool's four sections as numbers: ``spans`` (name → [device ms,
    span count]), ``groups`` (group → device ms), ``host`` (name → host
    ms), and ``window``: the annotation, its ms, the device busy ms, the
    device operations and their idle share. Raises ValueError when the
    window holds no device operation."""
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    notes = [e for e in events if e.get("cat") == "user_annotation"]
    if not notes:
        raise ValueError("the trace has no host annotation (record_function span)")
    annotation = max(notes, key=lambda e: float(e["dur"]))["name"]
    dev, (_, window) = device_events(trace, annotation)
    if not dev:
        raise ValueError(f"no device operations inside {annotation!r}: a CPU trace "
                         "(--device cpu) has nothing to break down")
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    by_tid = collections.defaultdict(list)
    for e in notes:
        by_tid[e["tid"]].append(e)
    spans = collections.defaultdict(lambda: [0.0, 0])
    for e in notes:
        spans[e["name"]][1] += 1
    groups = collections.Counter()
    for e in dev:
        ms = float(e["dur"]) / 1e3
        groups[group_of(e["name"])] += ms
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is None:
            continue
        ts = float(launch["ts"])
        for span in by_tid[launch["tid"]]:
            if float(span["ts"]) <= ts <= float(span["ts"]) + float(span["dur"]):
                spans[span["name"]][0] += ms
    host = collections.Counter()
    for e in events:
        if e.get("cat") not in NOT_HOST:
            host[e["name"][:70]] += float(e["dur"]) / 1e3
    busy = busy_us(dev)
    return {"spans": dict(spans), "groups": dict(groups), "host": dict(host),
            "window": {"annotation": annotation, "window_ms": window / 1e3,
                       "busy_ms": busy / 1e3, "device_ops": len(dev),
                       "idle_share": 1.0 - busy / window if window > 0 else None}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace_dir", nargs="?", default=os.path.join("runs", "profile_volume"),
                    help="a --trace-dir of profile_volume/profile_train, or a trace.json")
    args = ap.parse_args(argv)
    path = find_trace(args.trace_dir)
    with open(path) as f:
        trace = json.load(f)
    try:
        b = breakdown(trace)
    except ValueError as e:
        print(f"trace_breakdown: {path}: {e}", file=sys.stderr)
        return 1
    print(f"trace {path}")
    print("== device time per annotated span ==")
    for name, (ms, n) in sorted(b["spans"].items(), key=lambda kv: -kv[1][0])[:TOP]:
        print(f"  {name[:52]:52s} x{n:<5d} {ms:9.3f} ms")
    print("\n== top device op groups ==")
    for name, ms in sorted(b["groups"].items(), key=lambda kv: -kv[1]):
        print(f"  {name[:60]:60s} {ms:9.3f} ms")
    print(f"  total device op time: {sum(b['groups'].values()):.3f} ms")
    print("\n== top host events ==")
    for name, ms in collections.Counter(b["host"]).most_common(TOP):
        print(f"  {name:70s} {ms:9.3f} ms")
    w = b["window"]
    print("\n== device busy vs traced window ==")
    print(f"  {w['annotation']}: window {w['window_ms']:.3f} ms, device busy "
          f"{w['busy_ms']:.3f} ms over {w['device_ops']} operations, idle share "
          f"{w['idle_share']:.4f}")
    print("BREAKDOWN", json.dumps({"trace": path, **b}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
