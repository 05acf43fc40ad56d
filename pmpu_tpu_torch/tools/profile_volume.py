"""Profile the flagship whole-volume inference of the port on the card
(counterpart of ``tools/profile_volume.py``).

    python3 -m pmpu_tpu_torch.tools.profile_volume [--trace-dir runs/profile_volume]

Builds the probabilistic U-Net at full width (filters 64..1024, latent 6,
3 classes, fcomb depth 4, bf16, 5 prior samples a slice, 3 views, the
uint8 wire, random weights from seed 0), warms it up on one seeded 128³
volume, then prints JSON lines:

  UNTRACED  wall seconds of ``evaluate_volume`` without the profiler
  ENQUEUE   host milliseconds of ``_dispatch_volume`` (everything enqueued,
            nothing waited for) and of the fetch after it, three times
  TRACED    wall seconds of ``evaluate_volume`` under ``torch.profiler``
  TOP       the device operations of the traced volume with the most time
  GROUPS    device milliseconds of the traced volume by group (cuDNN conv,
            BatchNorm/ReLU/add elementwise, pools, the hand kernels,
            copies, other), its device idle share, and the same for a
            pipelined stream of 4 volumes at depth 2

and writes the two Chrome traces (``volume/trace.json``,
``stream/trace.json`` under ``--trace-dir``). ``--device cpu`` runs the
same steps on the CPU at a small ``--cube`` and ``--filters`` (its trace
has no device operations: its groups are empty and its idle shares null).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

# (group, substrings of a device operation's lowercased name), first match
# wins; dtype casts and layout copies count as copies
GROUPS = (
    ("hand kernels", ("fcomb_mean", "gather_normalize", "qchain_kernel", "oblique_planes")),
    ("copies", ("memcpy", "memset", "copy_kernel", "catarraybatchedcopy")),
    ("pools", ("pool",)),
    ("conv (cuDNN)", ("conv", "cudnn", "xmma", "gemm", "cutlass", "dgrad", "wgrad", "fprop",
                      "winograd", "implicit", "nchwtonhwc", "nhwctonchw")),
    ("batchnorm/relu/add elementwise", ("elementwise", "batch_norm", "relu", "threshold")),
)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def device_events(trace: dict, annotation: str):
    """The device operations (kernels, copies, sets) of a Chrome trace that
    start inside the host annotation ``annotation``, and that annotation's
    (start, duration) in microseconds."""
    events = trace["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X" and e.get("name") == annotation
             and e.get("cat") == "user_annotation"]
    if len(spans) != 1:
        raise ValueError(f"{len(spans)} host annotations named {annotation!r} in the trace")
    t0, dur = float(spans[0]["ts"]), float(spans[0]["dur"])
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
           and t0 <= float(e["ts"]) <= t0 + dur]
    return dev, (t0, dur)


def busy_us(events) -> float:
    """Microseconds in which at least one of ``events`` runs (the union of
    their intervals)."""
    total, end = 0.0, -float("inf")
    for start, stop in sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events):
        if stop <= end:
            continue
        total += stop - max(start, end)
        end = stop
    return total


def summarize(trace: dict, annotation: str) -> dict:
    """Device milliseconds by group and by name, busy time and idle share
    of the annotated window."""
    events, (_, window) = device_events(trace, annotation)
    groups = {g: 0.0 for g, _ in GROUPS}
    groups["other"] = 0.0
    by_name = {}
    for e in events:
        ms = float(e["dur"]) / 1e3
        groups[group_of(e["name"])] += ms
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + ms
    busy = busy_us(events)
    return {"groups_ms": groups, "by_name_ms": by_name, "device_ops": len(events),
            "window_ms": window / 1e3, "busy_ms": busy / 1e3,
            # no device operations: a CPU run, which has no device to idle
            "idle_share": 1.0 - busy / window if events and window > 0 else None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cube", type=int, default=128)
    ap.add_argument("--filters", default="64,128,256,512,1024")
    ap.add_argument("--trace-dir", default=os.path.join("runs", "profile_volume"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import record_function

    from pmpu_tpu_torch.device import card_label, resolve_device
    from pmpu_tpu_torch.inference.engine import VolumeEvaluator
    from pmpu_tpu_torch.train.tasks import make_task
    from pmpu_tpu_torch.utils.profiling import trace

    device = resolve_device(args.device)
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    card = card_label(device)
    nf = tuple(int(x) for x in args.filters.split(","))
    task = make_task("probunet", num_filters=nf, latent_dim=6, n_classes=3, no_convs_fcomb=4,
                     dtype=torch.bfloat16, device=device, seed=0)
    ev = VolumeEvaluator(task, n_samples=5, eval_batch=0, input_dtype="uint8", device=device)
    s = args.cube
    rng = np.random.default_rng(0)
    vol = rng.random((s, s, s)).astype(np.float32)
    stream = [rng.random((s, s, s)).astype(np.float32) for _ in range(4)]

    ev.evaluate_volume(vol, seed=0)  # warm-up
    ev.predict_volumes_pipelined(stream[:2])
    sync()
    t0 = time.perf_counter()
    ev.evaluate_volume(vol, seed=1)
    print("UNTRACED", json.dumps({"wall_s": time.perf_counter() - t0, "device": card}))

    enqueue, fetch = [], []
    for i in range(3):
        sync()
        t0 = time.perf_counter()
        h = ev._dispatch_volume(vol, seed=2 + i)
        t1 = time.perf_counter()
        ev._fetch_seg(h)
        enqueue.append((t1 - t0) * 1e3)
        fetch.append((time.perf_counter() - t1) * 1e3)
    print("ENQUEUE", json.dumps({"host_enqueue_ms": enqueue, "fetch_wait_ms": fetch}))

    vol_dir = os.path.join(args.trace_dir, "volume")
    sync()
    with trace(vol_dir):
        with record_function("profiled_volume"):
            t0 = time.perf_counter()
            ev.evaluate_volume(vol, seed=5)
            traced = time.perf_counter() - t0
    print("TRACED", json.dumps({"wall_s": traced}))
    stream_dir = os.path.join(args.trace_dir, "stream")
    sync()
    with trace(stream_dir):
        with record_function("profiled_stream"):
            t0 = time.perf_counter()
            ev.predict_volumes_pipelined(stream, seed=6, pipeline_depth=2)
            stream_s = (time.perf_counter() - t0) / len(stream)

    with open(os.path.join(vol_dir, "trace.json")) as f:
        one = summarize(json.load(f), "profiled_volume")
    with open(os.path.join(stream_dir, "trace.json")) as f:
        many = summarize(json.load(f), "profiled_stream")
    top = sorted(one["by_name_ms"].items(), key=lambda kv: -kv[1])[:15]
    for name, ms in top:
        print("TOP", json.dumps({"ms": ms, "group": group_of(name), "name": name[:160]}))
    print("GROUPS", json.dumps({
        "device": card,
        "volume": {k: one[k] for k in ("groups_ms", "device_ops", "window_ms", "busy_ms",
                                       "idle_share")},
        "stream": {**{k: many[k] for k in ("groups_ms", "device_ops", "window_ms", "busy_ms",
                                           "idle_share")},
                   "volumes": len(stream), "pipeline_depth": 2, "traced_s_per_volume": stream_s},
    }))
    print("traces written to", vol_dir, "and", stream_dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
