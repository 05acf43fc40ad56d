#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (``pmpu_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing at least one line; any failure exits non-zero:

1. device  — refuse to run without CUDA; print the card's name and power
             limit (nvidia-smi).
2. build   — compile both CUDA sources with nvcc for sm_90a (in parallel).
3. kernels — each kernel against its plain PyTorch version on the card:
             fcomb mean-decode at (N=16, 128², Cf=f0=64, latent 6, C=3,
             S=5) in f32 and bf16 plus two small odd cases; gather-normalize
             with repeated ids, an all-zero plane and labels (bit-exact).
4. parity  — the whole path (probunet, filters 8,16, 32³, mean_z, f32, TF32
             off) on the card against the same weights on the CPU.
5. full    — the main path at full width: probunet 64..1024, latent 6,
             3 classes, fcomb depth 4, bf16, 5 samples, 3 chunks of 128
             slices, one seeded 128³ volume on the uint8 wire, through
             ``make_task`` and ``VolumeEvaluator.evaluate_volume``; launch
             counts of the main path; timings; each kernel at the main
             path's shapes against its plain version.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. ``--json PATH`` also writes
all measurements to PATH.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# published dense peaks of one H100 SXM (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def require(cond, msg):
    if not cond:
        raise AssertionError(msg)


def event_ms(fn, reps, warmup=1):
    """Mean device milliseconds per call of ``fn`` over ``reps`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bf16_ulp(x: float) -> float:
    return 2.0 ** (np.floor(np.log2(max(abs(x), 1e-30))) - 7)


def fcomb_case(n, hw, f0, latent, c, s, ncf, dtype, seed):
    from pmpu_tpu_torch.models.initializers import initialize
    from pmpu_tpu_torch.models.prob_unet import Fcomb

    fcomb = initialize(Fcomb((f0,), latent, c, ncf), torch.Generator().manual_seed(seed))
    params = {k: v.detach().cuda() for k, v in fcomb.named_parameters()}
    g = torch.Generator(device="cuda").manual_seed(seed)
    feats = torch.relu(torch.randn((n, hw, hw, f0), generator=g, device="cuda")).to(dtype)
    zs = torch.randn((s, n, latent), generator=g, device="cuda")
    return feats, zs, params


def compare_fcomb(feats, zs, params, ncf, dtype, label):
    from pmpu_tpu_torch.ops.cuda.fcomb_mean import fcomb_mean_decode, fcomb_mean_decode_reference

    got = fcomb_mean_decode(feats, zs, params, ncf, dtype)
    want = fcomb_mean_decode_reference(feats, zs, params, ncf, dtype)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    scale = max(want.abs().max().item(), 1.0)
    if dtype == torch.float32:
        tol = 1e-5 * scale
        agree = 1.0
    else:
        tol = 4 * bf16_ulp(scale)
        agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item() if got.shape[-1] > 1 else 1.0
    print(f"  fcomb {label}: max_abs_err {err:.3g} (tol {tol:.3g}, scale {scale:.3g}), "
          f"argmax agreement {agree:.6f}")
    require(torch.isfinite(got).all().item(), f"fcomb {label}: non-finite output")
    require(err <= tol, f"fcomb {label}: error {err} above {tol}")
    require(agree >= 0.999, f"fcomb {label}: argmax agreement {agree} below 0.999")
    return err


def phase_kernels():
    from pmpu_tpu_torch.ops.cuda.slice_gather import (
        gather_normalize_planes,
        gather_normalize_planes_reference,
    )

    print("phase 3: kernels against their plain versions")
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        feats, zs, params = fcomb_case(16, 128, 64, 6, 3, 5, 4, dtype, seed=1)
        errs[str(dtype)] = compare_fcomb(feats, zs, params, 4, dtype, f"N=16 128² f0=64 {dtype}")
    for ncf, c, s, dtype in ((3, 1, 3, torch.float32), (2, 2, 4, torch.bfloat16),
                             (3, 1, 3, torch.bfloat16)):
        feats, zs, params = fcomb_case(3, 13, 8, 3, c, s, ncf, dtype, seed=2)
        compare_fcomb(feats, zs, params, ncf, dtype, f"f0=8 C={c} S={s} ncf={ncf} {dtype}")
    g = torch.Generator(device="cuda").manual_seed(3)
    img = torch.rand((40, 128, 128), generator=g, device="cuda") * 50
    img[7] = 0.0
    lbl = torch.randint(0, 3, (40, 128, 128), generator=g, device="cuda", dtype=torch.int32)
    ids = torch.randint(0, 40, (64,), generator=g, device="cuda")
    ids[0] = ids[5] = 7
    got_i, got_l = gather_normalize_planes(img, ids, lbl)
    want_i, want_l = gather_normalize_planes_reference(img, ids, lbl)
    torch.cuda.synchronize()
    require(torch.equal(got_i, want_i) and torch.equal(got_l, want_l),
            "gather-normalize: kernel differs from its plain version")
    require(got_i[0].abs().sum().item() == 0, "gather-normalize: zero plane not passed through")
    print("  gather-normalize: 64 of 40 planes (repeats, one all-zero, labels): bit-exact")
    return errs


def phase_parity():
    from pmpu_tpu_torch import VolumeEvaluator, make_task

    print("phase 4: whole path on the card vs the CPU (probunet 8,16, 32³, mean_z, f32)")
    rng = np.random.default_rng(4)
    vol = rng.random((32, 32, 32)).astype(np.float32)
    truth = (vol > 0.6).astype(np.int32) + (vol > 0.9)
    out = {}
    for device in ("cuda", "cpu"):
        task = make_task("probunet", num_filters=(8, 16), device=device, seed=5)
        out[device] = VolumeEvaluator(task, mean_z=True, device=device).evaluate_volume(vol, truth)
    gpu, cpu = out["cuda"], out["cpu"]
    diff = (gpu["fused"].cpu() - cpu["fused"]).abs().max().item()
    mism = int((gpu["argmax"] != cpu["argmax"]).sum())
    print(f"  fused max |diff| {diff:.3g}, argmax mismatches {mism}, dice equal "
          f"{np.array_equal(gpu['dice'], cpu['dice'])}")
    require(mism == 0, f"parity: {mism} argmax mismatches")
    require(diff <= 1e-4, f"parity: fused probabilities differ by {diff}")
    require(np.array_equal(gpu["dice"], cpu["dice"]), "parity: Dice tables differ")


def synthetic_volume(cube, seed):
    """A seeded image with two nested ellipsoids and its 3-class truth."""
    rng = np.random.default_rng(seed)
    ax = np.linspace(-1.0, 1.0, cube, dtype=np.float32)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    r1 = (x / 0.6) ** 2 + (y / 0.45) ** 2 + (z / 0.5) ** 2
    r2 = ((x - 0.1) / 0.25) ** 2 + (y / 0.2) ** 2 + ((z + 0.1) / 0.3) ** 2
    truth = np.where(r2 < 1, 2, np.where(r1 < 1, 1, 0)).astype(np.int32)
    img = 0.2 + 0.4 * (truth >= 1) + 0.3 * (truth == 2) + 0.1 * rng.standard_normal(x.shape)
    return np.clip(img, 0.0, None).astype(np.float32), truth


def stage_ms(ev, vol, truth):
    """Milliseconds between CUDA events around each stage of one volume,
    replaying ``evaluate_volume`` step by step."""
    from pmpu_tpu_torch.inference.engine import _pack2bit, _unpack2bit, chunk_generator, eval_chunk_plan
    from pmpu_tpu_torch.inference.fusion import fuse_mean, normalize_slabs, reassemble_views, view_slabs
    from pmpu_tpu_torch.ops.cuda.fcomb_mean import fcomb_mean_decode

    net = ev.task.net
    marks = []

    def mark(name):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        marks.append((name, e))

    with torch.inference_mode():
        torch.cuda.synchronize()
        mark("start")
        v = ev._upload(vol)
        mark("upload")
        slabs = normalize_slabs(view_slabs(v.float()))
        mark("slabs")
        b, nchunk = eval_chunk_plan(slabs.shape[0], *slabs.shape[1:], ev.eval_batch)
        logits = []
        for i in range(nchunk):
            out = net(slabs[i * b:(i + 1) * b, ..., None])
            eps = torch.randn((ev.n_samples,) + tuple(out.prior.loc.shape),
                              generator=chunk_generator(ev.device, 0, i), device=ev.device)
            zs = out.prior.loc[None] + out.prior.scale[None] * eps
            mark("backbone+prior")
            logits.append(fcomb_mean_decode(out.unet_features, zs, net.fcomb_params(),
                                             net.no_convs_fcomb, net.dtype))
            mark("fcomb")
        views = reassemble_views(torch.softmax(torch.cat(logits), dim=-1))
        fused = fuse_mean(views)
        mark("softmax+fuse")
        _unpack2bit(_pack2bit(torch.argmax(fused, dim=-1).to(torch.uint8)).cpu().numpy())
        mark("argmax+fetch")
        ev._dice_report(tuple(views) + (fused,), ev._upload_truth(truth)).cpu()
        mark("dice+fetch")
        torch.cuda.synchronize()
    totals = {}
    for (_, a), (name, b_) in zip(marks, marks[1:]):
        totals[name] = totals.get(name, 0.0) + a.elapsed_time(b_)
    return totals


def phase_full(card):
    from pmpu_tpu_torch import VolumeEvaluator, make_task
    from pmpu_tpu_torch.inference.fusion import view_slabs
    from pmpu_tpu_torch.ops.cuda.fcomb_mean import fcomb_mean_decode, fcomb_mean_decode_reference
    from pmpu_tpu_torch.ops.cuda.slice_gather import (
        gather_normalize_planes,
        gather_normalize_planes_reference,
    )

    print("phase 5: full width (probunet 64..1024, latent 6, C=3, ncf 4, bf16, 5 samples, "
          "128³ uint8 wire)")
    t0 = time.perf_counter()
    task = make_task("probunet", num_filters=(64, 128, 256, 512, 1024), latent_dim=6,
                     n_classes=3, no_convs_fcomb=4, dtype=torch.bfloat16, seed=0)
    vol, truth = synthetic_volume(128, seed=6)
    ev = VolumeEvaluator(task, n_samples=5, eval_batch=0, input_dtype="uint8")
    print(f"  model built in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    r = ev.evaluate_volume(vol, truth)
    torch.cuda.synchronize()
    print(f"  warm-up volume {time.perf_counter() - t0:.2f} s")

    fcomb_mean_decode.launches = 0
    gather_normalize_planes.launches = 0
    torch.cuda.reset_peak_memory_stats()
    r = ev.evaluate_volume(vol, truth)
    torch.cuda.synchronize()
    launches = {"fcomb_mean_decode": fcomb_mean_decode.launches,
                "gather_normalize_planes": gather_normalize_planes.launches}
    print(f"  launches in one volume: {launches}")
    require(all(n > 0 for n in launches.values()), f"a kernel was not on the main path: {launches}")

    fused = r["fused"]
    require(tuple(fused.shape) == (128, 128, 128, 3), f"fused shape {tuple(fused.shape)}")
    require(torch.isfinite(fused).all().item(), "fused probabilities not finite")
    sum_err = (fused.sum(-1) - 1).abs().max().item()
    require(sum_err <= 1e-4, f"probabilities sum to 1 within {sum_err}")
    require(r["argmax"].min() >= 0 and r["argmax"].max() < 3, "argmax out of [0,3)")
    require(r["dice"].shape == (4, 2) and np.isfinite(r["dice"]).all(), f"dice {r['dice']}")
    print(f"  checks: finite, probabilities sum to 1 within {sum_err:.2g}, argmax in [0,3), "
          f"dice (4,2) = {np.round(r['dice'], 4).tolist()}")

    walls, spans = [], []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        ev.evaluate_volume(vol, truth)  # argmax and dice come back to the host
        end.record()
        end.synchronize()
        walls.append(time.perf_counter() - t0)
        spans.append(start.elapsed_time(end))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    stages = stage_ms(ev, vol, truth)
    print(f"  [{card}] wall s/volume {walls} (min {min(walls):.4f}); CUDA-event span "
          f"ms/volume {[round(s, 3) for s in spans]}; peak allocated {peak_gb:.2f} GB")
    print(f"  [{card}] device ms by stage (one volume): "
          f"{ {k: round(v, 3) for k, v in stages.items()} }")

    # each kernel at the main path's shapes: the volume's (384,128,128) view
    # slab, and the first chunk's real UNet features
    with torch.inference_mode():
        slabs = view_slabs(torch.from_numpy(vol).cuda())
        ids = torch.arange(slabs.shape[0], device="cuda")
        got = gather_normalize_planes(slabs, ids)[0]
        want = gather_normalize_planes_reference(slabs, ids)[0]
        require(torch.equal(got, want), "gather-normalize differs at the main path's shape")
        gather_ms = event_ms(lambda: gather_normalize_planes(slabs, ids), 50)
        gather_plain_ms = event_ms(lambda: gather_normalize_planes_reference(slabs, ids), 20)
        gbytes = 2 * slabs.numel() * 4 + ids.numel() * 8
        gather_bound = max(gbytes / PEAK_HBM_BYTES, 2 * slabs.numel() / PEAK_F32_FLOPS) * 1e3

        out = task.net(got[:128, ..., None])
        g = torch.Generator(device="cuda").manual_seed(7)
        zs = out.prior.loc[None] + out.prior.scale[None] * torch.randn(
            (5,) + tuple(out.prior.loc.shape), generator=g, device="cuda")
        params = task.net.fcomb_params()
        feats = out.unet_features
        fcomb_err = compare_fcomb(feats, zs, params, 4, torch.bfloat16, "one real chunk N=128")
        fcomb_ms = event_ms(lambda: fcomb_mean_decode(feats, zs, params, 4, torch.bfloat16), 10)
        fcomb_plain_ms = event_ms(
            lambda: fcomb_mean_decode_reference(feats, zs, params, 4, torch.bfloat16), 3)
        n, h, w, cf = feats.shape
        f0, c, s = 64, 3, 5
        flops = 2.0 * n * h * w * (cf * f0 + s * (2 * f0 * f0 + f0 * c))
        nbytes = feats.numel() * 2 + n * h * w * c * 4 + zs.numel() * 4
        fcomb_bound = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3
    print(f"  [{card}] fcomb_mean_decode (N=128, 128², bf16, S=5): {fcomb_ms:.3f} ms/launch, "
          f"plain {fcomb_plain_ms:.3f} ms, bound {fcomb_bound:.4f} ms "
          f"({flops:.3g} FLOP, {nbytes / 1e6:.1f} MB), {launches['fcomb_mean_decode']} launches/volume")
    print(f"  [{card}] gather_normalize_planes (384 planes of 128²): {gather_ms:.4f} ms/launch, "
          f"plain {gather_plain_ms:.4f} ms, bound {gather_bound:.4f} ms ({gbytes / 1e6:.1f} MB), "
          f"{launches['gather_normalize_planes']} launches/volume")
    kernels = [
        {"name": "fcomb_mean_decode", "route": "cuda",
         "source": "pmpu_tpu_torch/ops/cuda/csrc/fcomb_mean.cu",
         "replaces": "pmpu_tpu/ops/pallas/fcomb_mean.py:76",
         "launches": launches["fcomb_mean_decode"], "max_abs_err": fcomb_err,
         "ms": fcomb_ms, "plain_ms": fcomb_plain_ms, "bound_ms": fcomb_bound,
         "bound_by": "operations" if flops / PEAK_BF16_FLOPS > nbytes / PEAK_HBM_BYTES else "bytes",
         "library_ms": None},
        {"name": "gather_normalize_planes", "route": "cuda",
         "source": "pmpu_tpu_torch/ops/cuda/csrc/slice_gather.cu",
         "replaces": "pmpu_tpu/ops/pallas/slice_gather.py:49",
         "launches": launches["gather_normalize_planes"],
         "max_abs_err": (got - want).abs().max().item(),
         "ms": gather_ms, "plain_ms": gather_plain_ms, "bound_ms": gather_bound,
         "bound_by": "bytes", "library_ms": None},
    ]
    summary = {"card": card, "wall_s_per_volume": walls, "event_ms_per_volume": spans,
               "stage_ms": stages, "peak_allocated_gb": peak_gb, "dice": r["dice"].tolist()}
    return kernels, summary


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--json", help="also write all measurements to this file")
    args = parser.parse_args()
    print("phase 1: device")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    sys.path.insert(0, ROOT)
    from pmpu_tpu_torch.ops.cuda import _build

    print("phase 2: build")
    t0 = time.perf_counter()
    built = _build.build()
    print(f"  built {sorted(built)} in {time.perf_counter() - t0:.1f} s "
          f"({ {k: round(v[0], 1) for k, v in built.items()} })")
    for name, (_, log) in built.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    errs = phase_kernels()
    phase_parity()
    kernels, summary = phase_full(card)
    summary["phase3_max_abs_err"] = errs
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump({"kernels": kernels, **summary}, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
