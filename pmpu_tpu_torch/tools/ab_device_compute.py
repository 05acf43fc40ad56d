"""Interleaved A/B of chained device compute across engine configs
(counterpart of the JAX package's ``tools/ab_device_compute.py``): one
uploaded volume, ``--chain`` chained ``_predict_volume`` calls timed with
CUDA events, the configs in turns within each of ``--rounds`` rounds, so
that a load on the card hits every config alike and the deltas hold.

    python3 -m pmpu_tpu_torch.tools.ab_device_compute --cube 128 --configs fused,split
    python3 -m pmpu_tpu_torch.tools.ab_device_compute --configs fused,int8,int8-split
    python3 -m pmpu_tpu_torch.tools.ab_device_compute --device cpu --cube 16 \\
        --filters 4,8 --configs fused,split

Configs: ``fused`` (bf16 probunet), ``split`` (bf16 + the split-concat
decoder conv, ``split_decoder``), ``int8`` (BN-folded int8 convs on the
conv-chain kernel, self-calibrated on the volume), ``int8-split`` (both);
``NAME@ebN`` sets ``eval_batch`` N for that config. Every config runs the
same weights (seed 0). One ``RESULT {json}`` line a config at the end:
min and median s/volume of the chained compute and the argmax agreement
of its fused volume with the first config's. On the CPU (``--device
cpu``) the host clock times the chain and the line says so.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Interleaved A/B of device compute")
    ap.add_argument("--cube", type=int, default=256)
    ap.add_argument("--samples", type=int, default=5)
    ap.add_argument("--eval-batch", type=int, default=0, help="0 = engine auto plan")
    ap.add_argument("--filters", default="64,128,256,512,1024")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--chain", type=int, default=4, help="dispatches per timed round")
    ap.add_argument("--configs", default="fused,split")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda, or cpu for the kernels' plain versions")
    args = ap.parse_args(argv)

    import torch

    from pmpu_tpu_torch.device import resolve_device
    from pmpu_tpu_torch.inference.engine import VolumeEvaluator
    from pmpu_tpu_torch.train.tasks import make_task

    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    nf = tuple(int(x) for x in args.filters.split(","))
    s = args.cube
    vol = np.random.default_rng(0).random((s, s, s)).astype(np.float32)
    names = [c.strip() for c in args.configs.split(",") if c.strip()]
    print(f"device: {torch.cuda.get_device_name(device) if cuda else 'cpu'}", flush=True)

    # one set of weights: the split decoder has the fused one's parameters,
    # and int8 quantizes them
    base = make_task("probunet", num_filters=nf, dtype=torch.bfloat16, device=device, seed=0)
    evs, staged = {}, {}
    for name in names:
        cfg, _, ebs = name.partition("@eb")
        eb = int(ebs) if ebs else args.eval_batch
        task = base
        if "split" in cfg:
            task = make_task("probunet", num_filters=nf, dtype=torch.bfloat16,
                             device=device, split_decoder=True)
            task.net.load_state_dict(base.net.state_dict())
        evs[name] = VolumeEvaluator(task, n_samples=args.samples, eval_batch=eb,
                                    quantize="int8" if "int8" in cfg else None, device=device)
    with torch.inference_mode():
        for name, ev in evs.items():
            if ev.quantize:
                ev._maybe_quantize(sample_vol=vol)
            up = ev._upload(vol)
            t0 = time.perf_counter()
            seg = ev._predict_volume(up, 1)[-1].argmax(-1).cpu().numpy()  # warm
            print(f"{name}: warm in {time.perf_counter() - t0:.1f}s", flush=True)
            staged[name] = (up, seg)

        times = {n: [] for n in names}
        for rnd in range(args.rounds):
            for name in names:
                ev, (up, _) = evs[name], staged[name]
                if cuda:
                    torch.cuda.synchronize(device)
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                t0 = time.perf_counter()
                for i in range(args.chain):
                    ev._predict_volume(up, 100 + rnd * 10 + i)
                if cuda:
                    end.record()
                    end.synchronize()
                    dt = start.elapsed_time(end) / 1e3 / args.chain
                else:
                    dt = (time.perf_counter() - t0) / args.chain
                times[name].append(dt)
                print(f"round {rnd} {name}: {dt:.4f} s/volume", flush=True)

    seg0 = staged[names[0]][1]
    for name in names:
        agree = float((staged[name][1] == seg0).mean())
        print("RESULT", json.dumps({
            "config": name, "cube": s, "samples": args.samples,
            "device": str(device), "clock": "cuda events" if cuda else "host",
            "min_s": min(times[name]),
            "median_s": float(np.median(times[name])),
            "times": times[name],
            "argmax_agreement_vs_first": agree,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
