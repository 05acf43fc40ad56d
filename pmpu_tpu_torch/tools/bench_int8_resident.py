"""A/B of the int8 evaluation path on one device: int8-RESIDENT activations
(``models/quantized.py::_unet_int8_resident``: every encoder edge int8, the
decoder's concat split into two int8 halves) against the same calibrated
tree with its decoder up-half scales stripped, which takes the
non-resident path (one conv-chain launch a conv, float edges); counterpart
of the JAX package's ``tools/bench_int8_resident.py``, flag for flag, plus
``--device``.

    python3 -m pmpu_tpu_torch.tools.bench_int8_resident [--rounds 3] [--n 10] [--device cpu]

Both sides are the flagship evaluator (probunet 64..1024, latent 6, bf16,
``--samples`` prior draws, 128³, random weights from seed 0). A calibrates
itself on the volume; B loads A's scale file without its ``us`` entries
(what a calibration file of the older format holds). Each side's first
volume counts the conv-chain kernel's launches (``fused_qchain.launches``
and ``launches_by_form``; on the card both sides must launch it) and gives
the agreement of A and B (max |Δprob| of the fused volume, argmax
agreement); then ``--rounds`` interleaved rounds of ``--n`` chained
volumes (``_predict_volume`` on the uploaded volume) are timed with CUDA
events (the host clock on the CPU). Prints one line a round and side, and a
``RESULT`` JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from pmpu_tpu_torch.device import card_label, resolve_device
from pmpu_tpu_torch.inference.engine import VolumeEvaluator
from pmpu_tpu_torch.models import quantized as qz
from pmpu_tpu_torch.ops.cuda.qconv import fused_qchain
from pmpu_tpu_torch.train.tasks import make_task


def chain_counts() -> dict:
    """The conv-chain kernel's launch counts, in all and by launch form (read
    as differences: the counts belong to the caller, who may be counting a
    whole run)."""
    return {"all": fused_qchain.launches, **fused_qchain.launches_by_form}


def _ms_per_call(fn, n: int, device) -> float:
    """Milliseconds a call of ``fn`` over ``n`` chained calls: CUDA events
    on the card, the host clock on the CPU."""
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return 1e3 * (time.perf_counter() - t0) / n


def evaluators(task, vol, samples: int, device, workdir: str):
    """(A, B): A self-calibrated on ``vol`` (resident); B loading A's scale
    file without the up-half scales (not resident)."""
    nf = list(task.net.num_filters)
    ev_a = VolumeEvaluator(task, n_samples=samples, eval_batch=0, input_dtype="uint8",
                           quantize="int8", device=device)
    qv_a = ev_a._maybe_quantize(sample_vol=vol)
    if not qz._unet_tree_resident(qv_a["unet"], nf):
        raise RuntimeError("A: the calibrated int8 tree is not resident")
    d = qz.export_scales(qv_a, nf, probabilistic=True)
    d.pop("us")
    path = os.path.join(workdir, "scales_without_us.json")
    with open(path, "w") as f:
        json.dump(d, f)
    ev_b = VolumeEvaluator(task, n_samples=samples, eval_batch=0, input_dtype="uint8",
                           quantize="int8", calibration=path, device=device)
    qv_b = ev_b._maybe_quantize()
    if qz._unet_tree_resident(qv_b["unet"], nf):
        raise RuntimeError("B: the tree without up-half scales is resident")
    return ev_a, ev_b


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cube", type=int, default=128)
    ap.add_argument("--samples", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--n", type=int, default=10)
    ap.add_argument("--filters", default="64,128,256,512,1024")
    ap.add_argument("--device", default=None,
                    help="the device (default: the card; 'cpu' off the card)")
    return ap


def main(argv=None) -> dict:
    """Run the A/B; returns the RESULT dict (with ``fused``: each side's
    fused volume of the agreement check, a device tensor)."""
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    nf = tuple(int(x) for x in args.filters.split(","))
    # made outside inference mode: the int8 tree's cache reads the weights'
    # version counters, which inference tensors do not keep
    task = make_task("probunet", num_filters=nf, dtype=torch.bfloat16, device=device, seed=0)
    return _run(args, task, device)


@torch.inference_mode()
def _run(args, task, device) -> dict:
    nf = tuple(task.net.num_filters)
    s = args.cube
    vol = np.random.default_rng(0).random((s, s, s)).astype(np.float32)
    with tempfile.TemporaryDirectory(prefix="bench_int8_") as work:
        ev_a, ev_b = evaluators(task, vol, args.samples, device, work)
    up = ev_a._upload(vol)
    sides = (("resident", ev_a), ("fused", ev_b))
    fused, launches = {}, {}
    for name, ev in sides:
        t0 = time.perf_counter()
        before = chain_counts()
        fused[name] = ev._predict_volume(up, 7)[-1]
        launches[name] = {k: n - before[k] for k, n in chain_counts().items()}
        probe = float(fused[name][0, 0, 0, 0])
        print(f"{name}: first volume {time.perf_counter() - t0:.1f}s (probe {probe:.6f}), "
              f"conv-chain launches {launches[name]}", flush=True)
    if device.type == "cuda" and not all(n["all"] > 0 for n in launches.values()):
        raise RuntimeError(f"a side did not launch the conv-chain kernel: {launches}")
    a, b = fused["resident"], fused["fused"]
    max_dprob = float((a - b).abs().max())
    argmax = float((a.argmax(-1) == b.argmax(-1)).double().mean())
    print(f"agreement: max|dprob|={max_dprob:.3e} argmax={argmax * 100:.4f}%", flush=True)

    times = {name: [] for name, _ in sides}
    for r in range(args.rounds):
        for name, ev in sides:
            ev._predict_volume(up, 100 + r)  # one untimed volume before each side's round
            ms = _ms_per_call(lambda ev=ev: ev._predict_volume(up, 200 + r), args.n, device)
            times[name].append(ms)
            print(f"round {r} {name}: {ms:.2f} ms/volume", flush=True)
    fa, fb = min(times["resident"]), min(times["fused"])
    print(f"BEST resident={fa:.2f} ms  fused={fb:.2f} ms  speedup={fb / fa:.3f}x", flush=True)
    out = {"device": device.type, "card": card_label(device), "cube": s,
           "filters": list(nf), "samples": args.samples, "n": args.n, "rounds": args.rounds,
           "ms_per_volume": times, "best_ms": {"resident": fa, "fused": fb},
           "speedup": fb / fa, "max_abs_dprob": max_dprob, "argmax_agreement": argmax,
           "qchain_launches_per_volume": launches}
    print("RESULT", json.dumps(out), flush=True)
    return {**out, "fused": fused}


if __name__ == "__main__":
    main()
