"""Profile the flagship train step of the port on the card: where the step's
device time goes, by group.

    python3 -m pmpu_tpu_torch.tools.profile_train [--trace-dir runs/profile_train]

Builds the probabilistic U-Net at full width (filters 64..1024, latent 6,
3 classes, fcomb depth 4, bf16, random weights from seed 0) on the view
stacks of 2 seeded 128³ scans (as ``bench_torch.py``'s ``BENCH_MODE=train``
does) and, for each ``--steps`` entry ``batch:microbatches`` (default the
bench's batch 128 in one microbatch and the train CLI's batch 8 as 4 × 2),
warms the step up, then prints JSON lines:

  UNTRACED  wall ms a step without the profiler (the median of 5, each
            ended by a synchronize)
  ENQUEUE   host ms to enqueue one step (the step returns before the
            device is done), and the wait after it, three times
  TRACED    wall ms of one step under ``torch.profiler``
  GROUPS    device ms of the traced step by group, its busy and window
            ms, its device idle share, the number of device operations

Groups: the step's ``record_function`` scopes (``sample``, ``augment``,
``forward``, ``backward``, ``optimizer``, set by ``make_train_step``)
split by kind: cuDNN convolutions forward and backward, BatchNorm forward
(kernels launched inside each ``BatchNorm2d.forward``, which this tool
wraps in a ``batchnorm`` scope) and backward (kernels of the autograd
nodes whose sequence numbers were made inside those scopes), the other
forward and backward work (bias adds, ReLU, pools, casts, the loss), the
gather kernel, the optimizer (gradient division, clip, SGD), other. A
device operation is placed by the host launch that enqueued it (the
trace's ``correlation`` ids). Each traced step is written as a Chrome
trace under ``--trace-dir``. ``--device cpu`` runs the same steps on the
CPU at a small ``--cube`` and ``--filters`` (no device operations: empty
groups, a null idle share).
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import time

import numpy as np

from pmpu_tpu_torch.tools.profile_volume import DEVICE_CATS, GROUPS, busy_us

SCOPES = ("sample", "augment", "forward", "backward", "optimizer")
BN_SCOPE = "batchnorm"
CONV_KEYS = dict(GROUPS)["conv (cuDNN)"]
TRAIN_GROUPS = ("conv forward", "conv backward", "batchnorm forward", "batchnorm backward",
                "other forward", "other backward", "gather", "augment", "optimizer", "other")
_BACKWARD_NODE = "autograd::engine::evaluate_function"


def _spans(events, cat, names=None):
    return [e for e in events if e.get("ph") == "X" and e.get("cat") == cat
            and (names is None or e["name"] in names)]


def _inside(span, ts):
    return float(span["ts"]) <= ts <= float(span["ts"]) + float(span["dur"])


class _Spans:
    """Host spans that do not nest one another (of one thread, or
    sequential across threads): ``at(ts)`` is the one containing ``ts``, or
    None."""

    def __init__(self, spans):
        self.spans = sorted(spans, key=lambda e: float(e["ts"]))
        self.starts = [float(e["ts"]) for e in self.spans]

    def at(self, ts):
        i = bisect.bisect_right(self.starts, ts) - 1
        return self.spans[i] if i >= 0 and _inside(self.spans[i], ts) else None


def _by_thread(spans):
    out = {}
    for e in spans:
        out.setdefault(e["tid"], []).append(e)
    return {tid: _Spans(v) for tid, v in out.items()}


def train_groups(trace: dict, annotation: str) -> dict:
    """Device ms of the step inside the host annotation ``annotation`` by
    :data:`TRAIN_GROUPS`, with its busy and window ms, idle share, the count
    of device operations and of those whose launch was not found."""
    events = trace["traceEvents"]
    (window,) = _spans(events, "user_annotation", {annotation})
    t0, t1 = float(window["ts"]), float(window["ts"]) + float(window["dur"])
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
           and t0 <= float(e["ts"]) <= t1]
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    scopes = _Spans(_spans(events, "user_annotation", set(SCOPES)))
    bn_spans = _by_thread(_spans(events, "user_annotation", {BN_SCOPE}))
    ops = _spans(events, "cpu_op")
    # sequence numbers of the autograd nodes made inside a BatchNorm forward
    # (one forward thread: a sequence number names one node)
    bn_seq = {e["args"]["Sequence number"] for e in ops
              if "Sequence number" in e.get("args", {}) and e["tid"] in bn_spans
              and bn_spans[e["tid"]].at(float(e["ts"])) is not None}
    nodes = _by_thread([e for e in ops if e["name"].startswith(_BACKWARD_NODE)
                        and "Sequence number" in e.get("args", {})])
    groups = dict.fromkeys(TRAIN_GROUPS, 0.0)
    unplaced = 0
    for e in dev:
        ms = float(e["dur"]) / 1e3
        name = e["name"].lower()
        launch = launches.get(e.get("args", {}).get("correlation"))
        if "gather_normalize" in name:
            groups["gather"] += ms
            continue
        if launch is None:
            unplaced += 1
            groups["other"] += ms
            continue
        ts = float(launch["ts"])
        span = scopes.at(ts)
        scope = None if span is None else span["name"]
        conv = any(k in name for k in CONV_KEYS)
        tid = launch["tid"]
        if scope == "forward":
            in_bn = tid in bn_spans and bn_spans[tid].at(ts) is not None
            group = "conv forward" if conv else "batchnorm forward" if in_bn else "other forward"
        elif scope == "backward":
            node = nodes[tid].at(ts) if tid in nodes else None
            from_bn = node is not None and node["args"]["Sequence number"] in bn_seq
            group = ("conv backward" if conv else "batchnorm backward" if from_bn
                     else "other backward")
        elif scope in ("augment", "optimizer"):
            group = scope
        else:
            group = "other"
        groups[group] += ms
    busy = busy_us(dev)
    return {"groups_ms": groups, "device_ops": len(dev), "unplaced_ops": unplaced,
            "window_ms": (t1 - t0) / 1e3, "busy_ms": busy / 1e3,
            "idle_share": 1.0 - busy / (t1 - t0) if dev and t1 > t0 else None}


def _scope_batchnorm(net):
    """Wrap every BatchNorm2d.forward of ``net`` in a ``batchnorm`` scope."""
    from torch.profiler import record_function

    from pmpu_tpu_torch.models.unet import BatchNorm2d

    for m in net.modules():
        if isinstance(m, BatchNorm2d):
            def forward(x, _inner=m.forward):
                with record_function(BN_SCOPE):
                    return _inner(x)
            m.forward = forward


def run(argv=None) -> dict:
    """Profile as the module docstring says; returns each ``--steps``
    entry's numbers, keyed by the entry."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cube", type=int, default=128)
    ap.add_argument("--filters", default="64,128,256,512,1024")
    ap.add_argument("--steps", default="128:1,8:4",
                    help="batch:microbatches of each profiled step")
    ap.add_argument("--trace-dir", default=os.path.join("runs", "profile_train"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import record_function

    from pmpu_tpu_torch.data.index_map import build_index_map
    from pmpu_tpu_torch.data.sampler import sample_batch_vt
    from pmpu_tpu_torch.data.volumes import make_view_stacks
    from pmpu_tpu_torch.device import card_label, resolve_device
    from pmpu_tpu_torch.train.steps import create_train_state, make_train_step
    from pmpu_tpu_torch.train.tasks import make_task
    from pmpu_tpu_torch.utils.profiling import trace

    device = resolve_device(args.device)
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    card = card_label(device)
    s = args.cube
    rng = np.random.default_rng(0)
    imgs = rng.random((2, s, s, s)).astype(np.float32)
    lbls = rng.integers(0, 3, size=(2, s, s, s)).astype(np.int32)
    vt_i = torch.from_numpy(make_view_stacks(imgs)).to(device)
    vt_l = torch.from_numpy(make_view_stacks(lbls)).to(device)
    index = build_index_map(lbls, filter=False)
    nf = tuple(int(x) for x in args.filters.split(","))
    task = make_task("probunet", num_filters=nf, dtype=torch.bfloat16, device=device, seed=0,
                     train=True)
    _scope_batchnorm(task.net)
    state = create_train_state(task, seed=0)
    out = {}
    for spec in args.steps.split(","):
        batch, acc = (int(x) for x in spec.split(":"))
        step = make_train_step(task, acc_steps=acc, sampler=sample_batch_vt)
        triples = torch.from_numpy(index[rng.choice(len(index), batch)]).to(device)
        label = {"batch": batch, "microbatches": acc, "device": card}
        for _ in range(2):  # warm-up: cuDNN's algorithm search, the kernel builds
            step(state, vt_i, vt_l, triples, 1e-4)
        walls = []
        for _ in range(5):
            sync()
            t0 = time.perf_counter()
            step(state, vt_i, vt_l, triples, 1e-4)
            sync()
            walls.append((time.perf_counter() - t0) * 1e3)
        print("UNTRACED", json.dumps({**label, "wall_ms": float(np.median(walls)),
                                      "walls_ms": walls}))
        enqueue, wait = [], []
        for _ in range(3):
            sync()
            t0 = time.perf_counter()
            step(state, vt_i, vt_l, triples, 1e-4)
            t1 = time.perf_counter()
            sync()
            enqueue.append((t1 - t0) * 1e3)
            wait.append((time.perf_counter() - t1) * 1e3)
        print("ENQUEUE", json.dumps({**label, "host_enqueue_ms": enqueue, "wait_ms": wait}))
        tdir = os.path.join(args.trace_dir, f"b{batch}x{acc}")
        sync()
        with trace(tdir):
            with record_function("profiled_step"):
                t0 = time.perf_counter()
                step(state, vt_i, vt_l, triples, 1e-4)
                sync()
                traced = (time.perf_counter() - t0) * 1e3
        print("TRACED", json.dumps({**label, "wall_ms": traced}))
        with open(os.path.join(tdir, "trace.json")) as f:
            g = train_groups(json.load(f), "profiled_step")
        print("GROUPS", json.dumps({**label, **g}))
        out[spec] = {"wall_ms": float(np.median(walls)), "host_enqueue_ms": enqueue,
                     "traced_ms": traced, **g}
    print("traces written under", args.trace_dir)
    return out


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
