#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (``pmpu_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing at least one line; any failure exits non-zero:

1. device  — refuse to run without CUDA; print the card's name and power
             limit (nvidia-smi).
2. build   — compile the four CUDA sources with nvcc for sm_90a (in
             parallel).
3. kernels — each kernel against its plain PyTorch version on the card:
             fcomb mean-decode at (N=16, 128², Cf=f0=64, latent 6, C=3,
             S=5) in f32 and bf16 plus three small odd cases, then bf16 across
             the tensor-core route (f0 = 16, 32, 128; S = 1 and 8; N=5 at 37²;
             one NaN pixel, NaN at exactly that pixel in both versions) and
             f0 = 136 on the CUDA-core route, each printing its route;
             gather-normalize, bit-exact: 128² planes (in registers) with
             repeated ids, an all-zero plane, a NaN, zeros of both signs, ids
             out of range and labels; 768 planes of 128²; 13² and 256² (the
             general path);
             the int8 conv chain, bit-exact, in both launch forms (row
             stripes and the whole image), L = 1, 2, 3, 3×3 and 1×1,
             Cin = 1, odd H and W, f32/bf16/int8 in and out, split input;
             for its weight ring and staged epilogue K loops of 1, 2, 3, 9
             and 27 steps, couts 24, 40 and 72, cout 1024 at 8² with
             cin 512, the split input at 128 + 128, H = 13 with a ragged
             last stripe and H = 16 in stripes of 4, N = 1;
             the oblique-plane kernel, bit-exact, at S = 16, 17 and 33 with
             1, 5 and 6 views (the x-axis basis, a tilted one whose outer
             planes leave the cube, the golden-spiral views, the tilted one
             stretched 3x), and at S = 128 with the tilted view alone and
             with 6 views.
4. parity  — the whole path (probunet, filters 8,16, 32³, mean_z, f32, TF32
             off) on the card against the same weights on the CPU; then the
             same for the int8 path (``quantize="int8"``), the CPU run's
             scale file loaded on the card, and for the 6-view oblique path
             (``num_views=6``).
5. full    — the main path at full width: probunet 64..1024, latent 6,
             3 classes, fcomb depth 4, bf16, 5 samples, 3 chunks of 128
             slices, one seeded 128³ volume on the uint8 wire, through
             ``make_task`` and ``VolumeEvaluator.evaluate_volume``; launch
             counts of the main path (every fcomb launch on the tensor-core
             route, as in phases 6 and 7); timings; each kernel at the main
             path's shapes against its plain version, fcomb also on its f32
             (CUDA-core) route and with its TFLOP/s; each kernel's line gives
             its share of the bound.
6. int8    — the same volume and weights through the int8 path
             (``quantize="int8"``, self-calibrated, scale file in a
             temporary directory): calibration time, launch counts, a fresh
             evaluator reloading the file reproduces the fused volume bit for
             bit, timings beside phase 5's, int8-vs-bf16 argmax agreement;
             every conv-chain launch of one chunk replayed against the plain
             version (bit-exact) and timed beside its bound, with its stripe
             rows and blocks. The kernels line's conv-chain entry averages
             those launches.
7. oblique — the same model, weights and volume through the 6-view oblique
             path (``num_views=6``): launch counts (one oblique-plane launch
             a volume), probabilities summing to 1 where every view covers
             the voxel, timings and stage times; the kernel at 128³ × 6
             views against its plain version (bit-exact) and against
             ``grid_sample`` (the library call computing the same
             function); gather-normalize on the 768-plane oblique slab
             (bit-exact, timed); ``ged_volume`` with 4 draws, its value and
             time.

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
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# published dense peaks of one H100 SXM (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def require(cond, msg):
    if not cond:
        raise AssertionError(msg)


def event_ms(fn, reps, warmup=1, spin=True):
    """Mean device milliseconds per call of ``fn`` over ``reps`` calls. With
    ``spin``, a spin kernel of about 50 us a call runs first, so that the
    host queues the calls before the device reaches the start event: a
    kernel shorter than its launch's host time is timed back to back, not at
    the host's pace."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if spin:
        torch.cuda._sleep(reps * 100_000)
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


def reset_fcomb_counts():
    from pmpu_tpu_torch.ops.cuda.fcomb_mean import ROUTES, fcomb_mean_decode

    fcomb_mean_decode.launches = 0
    fcomb_mean_decode.launches_by_route = dict.fromkeys(ROUTES, 0)


def require_fcomb_route(n, where):
    """Every fcomb launch since the last reset (``n`` of them) took the
    tensor-core route."""
    from pmpu_tpu_torch.ops.cuda.fcomb_mean import fcomb_mean_decode

    by_route = dict(fcomb_mean_decode.launches_by_route)
    print(f"  fcomb launches by route in one {where} volume: {by_route}")
    require(by_route == {"tensor_core": n, "cuda_core": 0},
            f"{where}: fcomb launches by route {by_route}, not {n} on the tensor cores")


def compare_fcomb(feats, zs, params, ncf, dtype, label, nan_pixel=None):
    """The kernel against its plain version on the same inputs; with
    ``nan_pixel`` (an (n, y, x) index whose features hold a NaN) both must
    be NaN at exactly that pixel and agree everywhere else."""
    from pmpu_tpu_torch.ops.cuda.fcomb_mean import (
        fcomb_mean_decode,
        fcomb_mean_decode_reference,
        fcomb_route,
    )

    route = fcomb_route(feats.shape[-1], params["layers.0.weight"].shape[0],
                        params["last_layer.weight"].shape[0], dtype)
    before = fcomb_mean_decode.launches_by_route[route]
    got = fcomb_mean_decode(feats, zs, params, ncf, dtype)
    require(fcomb_mean_decode.launches_by_route[route] == before + 1,
            f"fcomb {label}: the launch did not take the {route} route")
    want = fcomb_mean_decode_reference(feats, zs, params, ncf, dtype)
    torch.cuda.synchronize()
    poisoned = torch.zeros(got.shape[:-1], dtype=torch.bool, device=got.device)
    if nan_pixel is not None:
        poisoned[nan_pixel] = True
        for name, x in (("kernel", got), ("plain version", want)):
            require(torch.equal(torch.isnan(x).all(-1), poisoned)
                    and torch.equal(torch.isnan(x).any(-1), poisoned),
                    f"fcomb {label}: the {name} is not NaN at exactly the poisoned pixel")
    got, want = got[~poisoned], want[~poisoned]
    err = (got - want).abs().max().item()
    scale = max(want.abs().max().item(), 1.0)
    if dtype == torch.float32:
        tol = 1e-5 * scale
        agree = 1.0
    else:
        tol = 4 * bf16_ulp(scale)
        agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item() if got.shape[-1] > 1 else 1.0
    print(f"  fcomb {label} [{route}]: max_abs_err {err:.3g} (tol {tol:.3g}, scale {scale:.3g}), "
          f"argmax agreement {agree:.6f}" + (", NaN at exactly the poisoned pixel"
                                             if nan_pixel is not None else ""))
    require(torch.isfinite(got).all().item(), f"fcomb {label}: non-finite output")
    require(err <= tol, f"fcomb {label}: error {err} above {tol}")
    require(agree >= 0.999, f"fcomb {label}: argmax agreement {agree} below 0.999")
    return err


def phase_kernels():
    print("phase 3: kernels against their plain versions")
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        feats, zs, params = fcomb_case(16, 128, 64, 6, 3, 5, 4, dtype, seed=1)
        errs[str(dtype)] = compare_fcomb(feats, zs, params, 4, dtype, f"N=16 128² f0=64 {dtype}")
    for ncf, c, s, dtype in ((3, 1, 3, torch.float32), (2, 2, 4, torch.bfloat16),
                             (3, 1, 3, torch.bfloat16)):
        feats, zs, params = fcomb_case(3, 13, 8, 3, c, s, ncf, dtype, seed=2)
        compare_fcomb(feats, zs, params, ncf, dtype, f"f0=8 C={c} S={s} ncf={ncf} {dtype}")
    # bf16: the tensor-core route across its range (f0 = Cf = 16, 32, 128),
    # S = 1 and 8, a ragged last tile (N=5, 37²), then f0 = 136, past the
    # range, on the CUDA-core route
    for n, hw, f0, s in ((4, 32, 16, 5), (4, 32, 32, 5), (4, 64, 128, 5), (4, 32, 64, 1),
                         (4, 32, 64, 8), (5, 37, 64, 5), (2, 16, 136, 5)):
        feats, zs, params = fcomb_case(n, hw, f0, 6, 3, s, 4, torch.bfloat16, seed=10 + f0 + s)
        compare_fcomb(feats, zs, params, 4, torch.bfloat16, f"N={n} {hw}² f0={f0} S={s} bf16")
    feats, zs, params = fcomb_case(2, 32, 64, 6, 3, 5, 4, torch.bfloat16, seed=4)
    feats[1, 5, 7, 3] = float("nan")
    compare_fcomb(feats, zs, params, 4, torch.bfloat16, "N=2 32² f0=64 one NaN pixel bf16",
                  nan_pixel=(1, 5, 7))
    g = torch.Generator(device="cuda").manual_seed(3)
    # (planes, side, ids, labels, offset): the fast path (128², a plane in
    # registers) with repeated ids, an all-zero plane, a NaN in a plane,
    # zeros of both signs and ids out of range; 768 planes; the fast path at
    # 64² and 8², most register slots padded; the general path at 13² (not a
    # multiple of 4 floats), 256² (too large for registers) and at 128² on
    # tensors that start one float into their storage (not 16-byte aligned)
    for p, side, n_ids, labels, offset in (
            (40, 128, 64, True, 0), (768, 128, 768, False, 0), (20, 64, 32, True, 0),
            (12, 8, 24, True, 0), (20, 13, 32, True, 0), (6, 256, 8, True, 0),
            (20, 128, 32, True, 1)):
        n = p * side * side
        img = (torch.rand(n + offset, generator=g, device="cuda") * 50)[offset:].view(p, side, side)
        lbl = (torch.randint(0, 3, (n + offset,), generator=g, device="cuda", dtype=torch.int32)
               [offset:].view(p, side, side) if labels else None)
        if n_ids == p:
            ids = torch.arange(p, device="cuda")
        else:
            img[2] = 0.0
            img[3, side // 2, 5] = float("nan")
            img[4, : side // 2] = -0.0  # zeros of both signs beside positive values
            img[5, 1] = 0.0
            ids = torch.randint(0, p, (n_ids,), generator=g, device="cuda")
            ids[:8] = torch.tensor([2, 3, p, 2, -1, 3, 4, 5])
        got = check_gather(img, ids, lbl, f"{len(ids)} of {p} planes of {side}²"
                           + ("" if n_ids == p else " (repeats, all-zero, NaN, ±0, ids out of range)")
                           + (", labels" if labels else "")
                           + (f", {offset} float into storage" if offset else ""))
        require(n_ids == p or got[0].abs().sum().item() == 0,
                "gather-normalize: zero plane not passed through")
    return errs


def bits_equal(got, want):
    """Equal bit for bit where ``want`` is a number, NaN where it is NaN."""
    nan = torch.isnan(want)
    return torch.equal(torch.isnan(got), nan) and torch.equal(
        got[~nan].view(torch.int32), want[~nan].view(torch.int32))


def check_gather(img, ids, lbl, label):
    """The gather kernel against its plain version (an id out of range gives
    a NaN plane and -1 labels), bit for bit; returns the kernel's planes."""
    from pmpu_tpu_torch.ops.cuda.slice_gather import (
        gather_normalize_planes,
        gather_normalize_planes_reference,
    )

    got_i, got_l = gather_normalize_planes(img, ids, lbl)
    ok = (ids >= 0) & (ids < img.shape[0])
    want_i = torch.full_like(got_i, float("nan"))
    want_i[ok], ref_l = gather_normalize_planes_reference(img, ids[ok], lbl)
    torch.cuda.synchronize()
    require(bits_equal(got_i, want_i), f"gather-normalize {label}: image differs from its plain "
                                       f"version")
    if lbl is not None:
        want_l = torch.full_like(got_l, -1)
        want_l[ok] = ref_l
        require(torch.equal(got_l, want_l), f"gather-normalize {label}: labels differ")
    print(f"  gather-normalize, {label}: bit-exact")
    return got_i


def phase_oblique_kernel():
    """The oblique-plane kernel against its plain version, bit for bit."""
    from pmpu_tpu_torch.data.sampler import view_basis
    from pmpu_tpu_torch.inference.fusion import make_view_bases
    from pmpu_tpu_torch.ops.cuda.oblique_gather import oblique_planes, oblique_planes_reference

    g = torch.Generator(device="cuda").manual_seed(9)
    tilted = view_basis([0.3, 0.5, 0.81])[None]
    bases = {"x-axis": view_basis([1.0, 0.0, 0.0])[None], "tilted": tilted,
             "5 views": make_view_bases(5), "6 views": make_view_bases(6),
             "stretched x3": 3 * tilted}  # not orthonormal: most points leave the cube
    cases = [(s, label) for s in (16, 17, 33) for label in bases]
    cases += [(128, "tilted"), (128, "6 views")]  # S = 128 with V = 1 and 6
    vols = {}
    for s, label in cases:
        if s not in vols:
            vols[s] = torch.rand((s, s, s), generator=g, device="cuda") + 0.5  # no voxel is 0
        vol, b = vols[s], torch.from_numpy(bases[label]).cuda()
        got = oblique_planes(vol, b)
        want = oblique_planes_reference(vol, b)
        torch.cuda.synchronize()
        require(got.shape == (b.shape[0] * s, s, s) and bits_equal(got, want),
                f"oblique S={s} {label}: kernel differs from its plain version "
                f"({int((got != want).sum())} of {got.numel()} values)")
        if label == "x-axis":
            require(torch.equal(got, vol), f"oblique S={s}: x-axis planes are not the slices")
        elif label == "tilted":
            require(bool((got[0] == 0).any()) and bool((got[0] != 0).any()),
                    f"oblique S={s}: the tilted outer plane does not leave the cube")
    print(f"  oblique planes: S = 16, 17 and 33 x {list(bases)}; S = 128 x tilted (V = 1) "
          f"and 6 views: bit-exact")


def _cuda_chain(seed, shapes, kernel=3):
    from pmpu_tpu_torch.ops.cuda.qconv import make_random_chain

    return [{k: v.cuda() for k, v in l.items()} for l in make_random_chain(seed, shapes, kernel)]


def phase_qconv():
    """The int8 conv-chain kernel against its plain version, bit for bit."""
    from pmpu_tpu_torch.ops.cuda.qconv import chain_reference, fused_qchain, launch_plan

    f32, bf16, s8 = torch.float32, torch.bfloat16, torch.int8
    g = torch.Generator(device="cuda").manual_seed(8)
    sc = {v: torch.tensor(v, device="cuda") for v in (0.021, 0.034, 0.05)}

    def rand_x(n, h, w, c, dtype):
        if dtype == s8:
            return torch.randint(-127, 128, (n, h, w, c), generator=g, device="cuda",
                                 dtype=torch.int8)
        return (torch.randn((n, h, w, c), generator=g, device="cuda") * 0.5).to(dtype)

    cases = [  # label, layers, (n, h, w), input dtype, output dtype, tile_h, extra
        ("L=2 3x3 8-16-16", _cuda_chain(1, [(8, 16), (16, 16)]), (4, 8, 8), f32, f32, None, {}),
        ("L=1 odd 5x7", _cuda_chain(2, [(4, 8)]), (4, 5, 7), f32, f32, None, {}),
        ("L=3 bf16 out", _cuda_chain(3, [(8, 8), (8, 4), (4, 4)]), (3, 6, 6), f32, bf16, None, {}),
        ("L=3 stripes of 3", _cuda_chain(4, [(4, 8), (8, 8), (8, 4)]), (3, 12, 12), f32, f32, 3, {}),
        ("Cin=1 stripes of 4", _cuda_chain(5, [(1, 8), (8, 8)]), (4, 16, 16), f32, bf16, 4, {}),
        ("1x1", _cuda_chain(6, [(8, 16)], 1), (4, 4, 4), f32, f32, None, {}),
        ("3x3 then 1x1, odd 9x13, bf16 in", _cuda_chain(7, [(16, 32)]) + _cuda_chain(8, [(32, 8)], 1),
         (2, 9, 13), bf16, f32, None, {}),
        ("int8 in/out, odd 9x11, stripes of 3", _cuda_chain(9, [(40, 24)]), (3, 9, 11), s8, s8, 3,
         {"x_scale": sc[0.021], "out_xs": sc[0.05]}),
        ("int8 in, L=2, whole image", _cuda_chain(10, [(64, 96), (96, 64)]), (2, 16, 16), s8, bf16,
         None, {"x_scale": sc[0.021]}),
        ("int8 in, L=2, stripes of 4", _cuda_chain(10, [(64, 96), (96, 64)]), (2, 16, 16), s8, bf16,
         4, {"x_scale": sc[0.021]}),
        ("no relu on the last layer", _cuda_chain(11, [(8, 8)], 1), (2, 5, 5), f32, f32, None,
         {"relu": False}),
    ]
    for split_out in (s8, f32):
        cases.append((f"split 24+40 -> 64 -> 32, {split_out}",
                      _cuda_chain(12, [(64, 64), (64, 32)]), (3, 10, 7), s8, split_out, None,
                      {"x_scale": sc[0.021], "x2": rand_x(3, 10, 7, 40, s8),
                       "x2_scale": sc[0.034], "out_xs": sc[0.05]}))
    # the weight ring and the staged epilogue: K loops of 1, 2 and 3 steps
    # (fewer than the ring's 4 stages) and of 9 and 27 (not multiples of 4);
    # couts 24, 40 and 72 (n-tiles not full) in every output dtype; cout 1024
    # at 8² (many n-tiles a round); the split input at 128 + 128; H = 13 in
    # stripes whose last one is ragged and H = 16 in stripes of 4; N = 1
    for cin, kernel in ((32, 1), (64, 1), (96, 1), (32, 3), (96, 3)):
        steps = (kernel * kernel) * (cin // 32)
        cases.append((f"K loop of {steps} steps", _cuda_chain(13 + cin, [(cin, 64)], kernel),
                      (2, 9, 11), s8, f32, None, {"x_scale": sc[0.021]}))
    for cout, out_dt in ((24, f32), (40, bf16), (72, s8), (24, s8), (40, f32)):
        cases.append((f"cout {cout} -> {out_dt}", _cuda_chain(14 + cout, [(48, cout), (cout, cout)]),
                      (2, 12, 10), f32, out_dt, None, {"out_xs": sc[0.05]}))
    cases.append(("8x8 512 -> 1024, N=2", _cuda_chain(15, [(512, 1024)]), (2, 8, 8), s8, bf16, None,
                  {"x_scale": sc[0.021]}))
    cases.append(("split 128+128 -> 64 -> 64", _cuda_chain(16, [(256, 64), (64, 64)]),
                  (2, 16, 128), s8, bf16, None,
                  {"x_scale": sc[0.021], "x2": rand_x(2, 16, 128, 128, s8), "x2_scale": sc[0.034]}))
    cases.append(("H=13, W=128, ragged last stripe", _cuda_chain(17, [(128, 64), (64, 64)]),
                  (2, 13, 128), s8, s8, None,
                  {"x_scale": sc[0.021], "x2": rand_x(2, 13, 128, 64, s8), "x2_scale": sc[0.034],
                   "out_xs": sc[0.05]}))
    cases.append(("H=16 in stripes of 4", _cuda_chain(18, [(64, 64), (64, 64)]), (2, 16, 16), s8,
                  f32, 4, {"x_scale": sc[0.021]}))
    cases.append(("N=1, 128x128", _cuda_chain(19, [(1, 64), (64, 64)]), (1, 128, 128), f32, s8,
                  None, {"out_xs": sc[0.05]}))
    for label, layers, (n, h, w), in_dt, out_dt, tile, extra in cases:
        cin = layers[0]["w"].shape[2] - (extra["x2"].shape[-1] if "x2" in extra else 0)
        x = rand_x(n, h, w, cin, in_dt)
        if label.startswith("H=13"):
            th = launch_plan(x, layers, out_dt, extra["x2"])[1]
            require(h % th != 0, f"qconv {label}: stripes of {th} rows leave no ragged stripe")
        got = fused_qchain(x, layers, out_dt, tile, **extra)
        want = chain_reference(x, layers, out_dt, **extra)
        torch.cuda.synchronize()
        require(got.dtype == out_dt and torch.equal(got, want),
                f"qconv {label}: kernel differs from its plain version "
                f"({int((got != want).sum())} of {got.numel()} values)")
    print(f"  int8 conv chain: {len(cases)} cases (stripes and whole image, L=1..3, 3x3 and "
          f"1x1, Cin=1, odd H and W, f32/bf16/int8 in and out, split input; K loops of 1 to "
          f"27 steps, couts 24/40/72, cout 1024 at 8², split 128+128, a ragged last stripe, "
          f"N=1): bit-exact")


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

    from pmpu_tpu_torch.ops.cuda.qconv import fused_qchain

    print("phase 4: int8 path on the card vs the CPU (same model, mean_z, f32, one scale file)")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "scales.json")
        for device in ("cpu", "cuda"):  # the CPU run calibrates and writes the file
            task = make_task("probunet", num_filters=(8, 16), device=device, seed=5)
            fused_qchain.launches = 0
            out[device] = VolumeEvaluator(task, mean_z=True, quantize="int8", calibration=path,
                                          device=device).evaluate_volume(vol, truth)
    gpu, cpu = out["cuda"], out["cpu"]
    diff = (gpu["fused"].cpu() - cpu["fused"]).abs().max().item()
    mism = int((gpu["argmax"] != cpu["argmax"]).sum())
    print(f"  fused max |diff| {diff:.3g}, argmax mismatches {mism}, dice equal "
          f"{np.array_equal(gpu['dice'], cpu['dice'])}, conv-chain launches {fused_qchain.launches}")
    require(fused_qchain.launches > 0, "int8 parity: the conv-chain kernel was not launched")
    require(mism == 0, f"int8 parity: {mism} argmax mismatches")
    require(np.array_equal(gpu["dice"], cpu["dice"]), "int8 parity: Dice tables differ")

    from pmpu_tpu_torch.ops.cuda.oblique_gather import oblique_planes

    print("phase 4: 6-view oblique path on the card vs the CPU (same model, mean_z, f32)")
    for device in ("cuda", "cpu"):
        task = make_task("probunet", num_filters=(8, 16), device=device, seed=5)
        oblique_planes.launches = 0
        out[device] = VolumeEvaluator(task, mean_z=True, num_views=6,
                                      device=device).evaluate_volume(vol, truth)
        if device == "cuda":
            require(oblique_planes.launches == 1,
                    f"6-view parity: {oblique_planes.launches} oblique-plane launches, not 1")
    gpu, cpu = out["cuda"], out["cpu"]
    diff = (gpu["fused"].cpu() - cpu["fused"]).abs().max().item()
    mismatch = gpu["argmax"] != cpu["argmax"]
    fused_cpu = cpu["fused"].numpy()
    top2 = np.sort(fused_cpu, axis=-1)[..., -2:]
    near_tie = (top2[..., 1] - top2[..., 0]) <= 1e-5
    unexplained = int((mismatch & ~near_tie).sum())
    dice_diff = float(np.abs(gpu["dice"] - cpu["dice"]).max())
    print(f"  fused max |diff| {diff:.3g}, argmax mismatches {int(mismatch.sum())} (voxels whose "
          f"top two CPU probabilities lie within 1e-5: {int(near_tie.sum())}, of them no view "
          f"covers {int((fused_cpu.sum(-1) == 0).sum())}; mismatches outside them: "
          f"{unexplained}), Dice max |diff| {dice_diff:.3g}, "
          f"Dice {np.round(gpu['dice'], 4).tolist()}")
    require(diff <= 1e-5, f"6-view parity: fused probabilities differ by {diff}")
    require(unexplained == 0, f"6-view parity: {unexplained} argmax mismatches at clear maxima")
    require(dice_diff <= 1e-4, f"6-view parity: Dice differs by {dice_diff}")


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
    replaying ``evaluate_volume`` step by step (the int8 backbone and prior
    when ``ev.quantize``; the oblique slab and the resample back to the grid
    when ``ev.num_views != 3``)."""
    from pmpu_tpu_torch.inference.engine import _pack2bit, _unpack2bit, chunk_generator, eval_chunk_plan
    from pmpu_tpu_torch.inference.fusion import (
        fuse_mean,
        normalize_slabs,
        oblique_slabs,
        reassemble_views,
        resample_view_to_grid,
        view_slabs,
    )
    from pmpu_tpu_torch.models.quantized import probunet_features_prior_int8
    from pmpu_tpu_torch.ops.cuda.fcomb_mean import fcomb_mean_decode

    net = ev.task.net

    def forward(x):
        if ev.quantize:
            return probunet_features_prior_int8(ev._qvars, x, net, dtype=net.dtype)
        out = net(x)
        return out.unet_features, out.prior.loc, out.prior.scale

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
        if ev.num_views == 3:
            slabs = normalize_slabs(view_slabs(v.float()))
            mark("slabs")
        else:
            slabs = normalize_slabs(oblique_slabs(v.float(), ev._bases))
            mark("oblique slabs")
        b, nchunk = eval_chunk_plan(slabs.shape[0], *slabs.shape[1:], ev.eval_batch)
        logits = []
        for i in range(nchunk):
            feats, loc, scale = forward(slabs[i * b:(i + 1) * b, ..., None])
            eps = torch.randn((ev.n_samples,) + tuple(loc.shape),
                              generator=chunk_generator(ev.device, 0, i), device=ev.device)
            zs = loc[None] + scale[None] * eps
            mark("backbone+prior")
            logits.append(fcomb_mean_decode(feats, zs, net.fcomb_params(),
                                             net.no_convs_fcomb, net.dtype))
            mark("fcomb")
        probs = torch.softmax(torch.cat(logits), dim=-1)
        if ev.num_views == 3:
            views = reassemble_views(probs)
            fused = fuse_mean(views)
            mark("softmax+fuse")
        else:
            mark("softmax")
            s = v.shape[0]
            views = [resample_view_to_grid(probs[i * s:(i + 1) * s], basis)
                     for i, basis in enumerate(ev._bases)]
            mark("splat back")
            fused = fuse_mean(views)
            mark("fuse")
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

    reset_fcomb_counts()
    gather_normalize_planes.launches = 0
    torch.cuda.reset_peak_memory_stats()
    r = ev.evaluate_volume(vol, truth)
    torch.cuda.synchronize()
    launches = {"fcomb_mean_decode": fcomb_mean_decode.launches,
                "gather_normalize_planes": gather_normalize_planes.launches}
    print(f"  launches in one volume: {launches}")
    require(all(n > 0 for n in launches.values()), f"a kernel was not on the main path: {launches}")
    require_fcomb_route(3, "3-view bf16")

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
        require(bits_equal(got, want), "gather-normalize differs at the main path's shape")
        gather_ms = event_ms(lambda: gather_normalize_planes(slabs, ids), 50)
        # the same timing without the spin kernel, to show what the spin changes
        gather_ms_no_spin = event_ms(lambda: gather_normalize_planes(slabs, ids), 50, spin=False)
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
        fcomb_ms = event_ms(lambda: fcomb_mean_decode(feats, zs, params, 4, torch.bfloat16), 20)
        fcomb_plain_ms = event_ms(
            lambda: fcomb_mean_decode_reference(feats, zs, params, 4, torch.bfloat16), 3)
        # the f32 route (CUDA cores) on the same chunk's features cast to f32
        feats32 = feats.float()
        compare_fcomb(feats32, zs, params, 4, torch.float32, "one real chunk N=128 as f32")
        fcomb_ms_f32 = event_ms(lambda: fcomb_mean_decode(feats32, zs, params, 4, torch.float32), 3)
        n, h, w, cf = feats.shape
        f0, c, s = 64, 3, 5
        flops = 2.0 * n * h * w * (cf * f0 + s * (2 * f0 * f0 + f0 * c))
        nbytes = feats.numel() * 2 + n * h * w * c * 4 + zs.numel() * 4
        fcomb_bound = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3
    print(f"  [{card}] fcomb_mean_decode (N=128, 128², bf16, S=5, tensor-core route): "
          f"{fcomb_ms:.4f} ms/launch ({flops / fcomb_ms / 1e9:.1f} TFLOP/s, "
          f"{100 * fcomb_bound / fcomb_ms:.1f} % of the bound), plain {fcomb_plain_ms:.3f} ms, "
          f"bound {fcomb_bound:.4f} ms ({flops:.3g} FLOP, {nbytes / 1e6:.1f} MB), "
          f"{launches['fcomb_mean_decode']} launches/volume; f32 (CUDA-core route) "
          f"{fcomb_ms_f32:.3f} ms/launch")
    print(f"  [{card}] gather_normalize_planes (384 planes of 128²): {gather_ms:.4f} ms/launch "
          f"({gather_ms_no_spin:.4f} without the spin kernel), plain {gather_plain_ms:.4f} ms, bound {gather_bound:.4f} ms ({gbytes / 1e6:.1f} MB), "
          f"{100 * gather_bound / gather_ms:.1f} % of the bound, "
          f"{launches['gather_normalize_planes']} launches/volume")
    kernels = [
        {"name": "fcomb_mean_decode", "route": "cuda",
         "source": "pmpu_tpu_torch/ops/cuda/csrc/fcomb_mean.cu",
         "replaces": "pmpu_tpu/ops/pallas/fcomb_mean.py:76",
         "launches": launches["fcomb_mean_decode"], "max_abs_err": fcomb_err,
         "ms": fcomb_ms, "plain_ms": fcomb_plain_ms, "bound_ms": fcomb_bound,
         "bound_by": "operations" if flops / PEAK_BF16_FLOPS > nbytes / PEAK_HBM_BYTES else "bytes",
         "library_ms": None, "kernel_route": "tensor_core", "ms_f32": fcomb_ms_f32},
        {"name": "gather_normalize_planes", "route": "cuda",
         "source": "pmpu_tpu_torch/ops/cuda/csrc/slice_gather.cu",
         "replaces": "pmpu_tpu/ops/pallas/slice_gather.py:49",
         "launches": launches["gather_normalize_planes"],
         "max_abs_err": (got - want).abs().max().item(),
         "ms": gather_ms, "plain_ms": gather_plain_ms, "bound_ms": gather_bound,
         "bound_by": "bytes", "library_ms": None, "ms_no_spin": gather_ms_no_spin},
    ]
    summary = {"card": card, "wall_s_per_volume": walls, "event_ms_per_volume": spans,
               "stage_ms": stages, "peak_allocated_gb": peak_gb, "dice": r["dice"].tolist()}
    return kernels, summary, (task, vol, truth, r)


def chain_cost(x, layers, kw, out):
    """(int8 operations, bytes each read or written once, stripe rows, H,
    blocks) of one conv-chain launch."""
    from pmpu_tpu_torch.ops.cuda.qconv import launch_plan

    n, h, w, _ = x.shape
    ops = sum(2.0 * n * h * w * l["w"].numel() for l in layers)
    x2 = kw.get("x2")
    nbytes = (x.numel() * x.element_size() + out.numel() * out.element_size()
              + sum(l["w"].numel() + 8 * l["w"].shape[-1] for l in layers)
              + (0 if x2 is None else x2.numel()))
    th = launch_plan(x, layers, out.dtype, x2)[1]
    return ops, nbytes, th, h, n * -(-h // th)


def phase_int8(card, task, vol, truth, r_bf16, bf16_summary):
    from pmpu_tpu_torch import VolumeEvaluator
    from pmpu_tpu_torch.inference.fusion import normalize_slabs, view_slabs
    from pmpu_tpu_torch.models import quantized as qz
    from pmpu_tpu_torch.ops.cuda.fcomb_mean import fcomb_mean_decode
    from pmpu_tpu_torch.ops.cuda.qconv import chain_reference, fused_qchain
    from pmpu_tpu_torch.ops.cuda.slice_gather import gather_normalize_planes

    print("phase 6: int8 path at full width (the same model and volume, quantize='int8', "
          "self-calibrated)")
    tmp = tempfile.TemporaryDirectory()  # removed at exit, also after a failure
    path = os.path.join(tmp.name, "scales.json")
    ev = VolumeEvaluator(task, n_samples=5, eval_batch=0, input_dtype="uint8",
                         quantize="int8", calibration=path)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        ev._maybe_quantize(sample_vol=vol)
    torch.cuda.synchronize()
    cal_s = time.perf_counter() - t0
    require(os.path.exists(path), "int8: the scale file was not written")
    print(f"  quantize + calibrate (48 slices) + write the scale file: {cal_s:.3f} s")
    t0 = time.perf_counter()
    ev.evaluate_volume(vol, truth)
    torch.cuda.synchronize()
    print(f"  warm-up volume {time.perf_counter() - t0:.2f} s")

    for k in (fused_qchain, gather_normalize_planes):
        k.launches = 0
    reset_fcomb_counts()
    r = ev.evaluate_volume(vol, truth)
    torch.cuda.synchronize()
    launches = {"fused_qchain": fused_qchain.launches,
                "fcomb_mean_decode": fcomb_mean_decode.launches,
                "gather_normalize_planes": gather_normalize_planes.launches}
    print(f"  launches in one int8 volume: {launches}")
    require(all(n > 0 for n in launches.values()), f"a kernel was not on the int8 path: {launches}")
    require_fcomb_route(3, "int8")
    fused = r["fused"]
    require(tuple(fused.shape) == (128, 128, 128, 3) and torch.isfinite(fused).all().item(),
            "int8: fused probabilities not finite or of the wrong shape")
    sum_err = (fused.sum(-1) - 1).abs().max().item()
    require(sum_err <= 1e-4, f"int8: probabilities sum to 1 within {sum_err}")
    require(r["dice"].shape == (4, 2) and np.isfinite(r["dice"]).all(), f"int8 dice {r['dice']}")
    agree = float(np.mean(r["argmax"] == r_bf16["argmax"]))
    print(f"  checks: finite, sum to 1 within {sum_err:.2g}; dice {np.round(r['dice'], 4).tolist()}"
          f"; argmax agreement with the bf16 path {agree:.6f}")

    ev2 = VolumeEvaluator(task, n_samples=5, eval_batch=0, input_dtype="uint8",
                          quantize="int8", calibration=path)
    r2 = ev2.evaluate_volume(vol, truth)
    require(torch.equal(r2["fused"], fused), "int8: the reloaded scale file gives another volume")
    print("  a fresh evaluator loading the scale file: fused volume bit-equal")

    walls, spans = [], []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        ev.evaluate_volume(vol, truth)
        end.record()
        end.synchronize()
        walls.append(time.perf_counter() - t0)
        spans.append(start.elapsed_time(end))
    stages = stage_ms(ev, vol, truth)
    print(f"  [{card}] int8 wall s/volume {walls} (min {min(walls):.4f}); CUDA-event span "
          f"ms/volume {[round(x, 3) for x in spans]}")
    print(f"  [{card}] bf16 wall s/volume {bf16_summary['wall_s_per_volume']} (min "
          f"{min(bf16_summary['wall_s_per_volume']):.4f}); CUDA-event span ms/volume "
          f"{[round(x, 3) for x in bf16_summary['event_ms_per_volume']]}")
    print(f"  [{card}] int8 device ms by stage: { {k: round(v, 3) for k, v in stages.items()} }")
    print(f"  [{card}] bf16 device ms by stage: "
          f"{ {k: round(v, 3) for k, v in bf16_summary['stage_ms'].items()} }")

    # every conv-chain launch of the first chunk, on its real inputs
    calls, orig = [], qz.fused_qchain

    def record(x, layers, out_dtype, **kw):
        out = orig(x, layers, out_dtype, **kw)
        calls.append((x, layers, out_dtype, kw, out))
        return out

    qz.fused_qchain = record
    try:
        with torch.inference_mode():
            slabs = normalize_slabs(view_slabs(ev._upload(vol).float()))
            qz.probunet_features_prior_int8(ev._qvars, slabs[:128, ..., None], task.net,
                                            dtype=task.net.dtype)
    finally:
        qz.fused_qchain = orig
    rows, max_err = [], 0.0
    with torch.inference_mode():
        for x, layers, out_dtype, kw, out in calls:
            want = chain_reference(x, layers, out_dtype, **kw)
            torch.cuda.synchronize()
            require(torch.equal(out, want), f"int8: a main-path chain launch ({tuple(x.shape)}) "
                                            f"differs from its plain version")
            max_err = max(max_err, (out.float() - want.float()).abs().max().item())
            ms = event_ms(lambda: orig(x, layers, out_dtype, **kw), 10)
            plain = event_ms(lambda: chain_reference(x, layers, out_dtype, **kw), 2)
            ops, nbytes, th, h, blocks = chain_cost(x, layers, kw, out)
            bound = max(ops / PEAK_INT8_OPS, nbytes / PEAK_HBM_BYTES) * 1e3
            rows.append({"input": list(x.shape), "x2": kw.get("x2") is not None,
                         "chans": [list(l["w"].shape[2:]) for l in layers],
                         "out": str(out_dtype), "stripe_rows": th, "blocks": blocks,
                         "whole_image": th >= h,
                         "ms": ms, "plain_ms": plain, "bound_ms": bound, "ops": ops,
                         "bytes": nbytes, "tops": ops / ms / 1e9})
    for row in rows:
        form = ("whole image" if row["whole_image"] else f"stripes of {row['stripe_rows']}") + \
            f", {row['blocks']} blocks"
        print(f"  [{card}] chain {row['input']}{' +split' if row['x2'] else ''} {row['chans']} "
              f"-> {row['out']}, {form}: "
              f"{row['ms']:.3f} ms ({row['tops']:.1f} TOP/s), plain {row['plain_ms']:.2f} ms, bound "
              f"{row['bound_ms']:.4f} ms ({row['ops']:.3g} ops, {row['bytes'] / 1e6:.1f} MB)")
    for row in sorted(rows, key=lambda r_: (r_["ops"], r_["ms"]), reverse=True)[:2]:
        print(f"  [{card}] largest chain {row['input']} {row['chans']}: {row['ms']:.3f} ms/launch, "
              f"bound {row['bound_ms']:.4f} ms")
    # yardstick: the float path's bf16 conv+BN+ReLU pair at the two largest
    # chains' shapes (the 128² and 64² decoder DoubleConvs)
    yard = {}
    with torch.inference_mode():
        for i in (3, 2):
            dc = task.net.unet.up_blocks[i].conv
            cin = dc.double_conv[0].in_channels
            hw = 128 >> (3 - i)
            xf = torch.randn((128, cin, hw, hw), device="cuda", dtype=torch.bfloat16).contiguous(
                memory_format=torch.channels_last)
            yard[f"up{i} {hw}^2 {cin}->{cin // 2}->{cin // 2}"] = event_ms(lambda: dc(xf), 10)
    print(f"  [{card}] yardstick, bf16 cuDNN DoubleConv (conv+BN+ReLU x2) ms: "
          f"{ {k: round(v, 3) for k, v in yard.items()} }")
    tmp.cleanup()
    n_rows = len(rows)
    ops_t = sum(r_["ops"] for r_ in rows) / PEAK_INT8_OPS
    bytes_t = sum(r_["bytes"] for r_ in rows) / PEAK_HBM_BYTES
    kernel = {"name": "fused_qchain", "route": "cuda",
              "source": "pmpu_tpu_torch/ops/cuda/csrc/qconv.cu",
              "replaces": "pmpu_tpu/ops/pallas/qconv.py:151",
              "launches": launches["fused_qchain"], "max_abs_err": max_err,
              "ms": sum(r_["ms"] for r_ in rows) / n_rows,
              "plain_ms": sum(r_["plain_ms"] for r_ in rows) / n_rows,
              "bound_ms": sum(r_["bound_ms"] for r_ in rows) / n_rows,
              "bound_by": "operations" if ops_t > bytes_t else "bytes", "library_ms": None}
    summary = {"calibration_s": cal_s, "launches": launches, "wall_s_per_volume": walls,
               "event_ms_per_volume": spans, "stage_ms": stages, "dice": r["dice"].tolist(),
               "argmax_agreement_with_bf16": agree, "chains": rows, "yardstick_bf16_ms": yard}
    return kernel, summary


def covered(bases, s):
    """(S,S,S) bool: voxels that every view's planes cover, so that each
    view's resample weights sum to 1 there (the resample of ones)."""
    from pmpu_tpu_torch.inference.fusion import resample_view_to_grid

    ones = torch.ones((s, s, s, 1), device=bases.device)
    cover = torch.stack([resample_view_to_grid(ones, b)[..., 0] for b in bases])
    return (cover >= 1 - 1e-5).all(0)


def oblique_cost(s, v):
    """(f32 operations, bytes) of one oblique-plane launch: per output 18
    for the coordinates, 6 for the fractions and their complements, 16 for
    the corner weights and 16 for the weighted sum; the volume read once,
    the slab and the bases."""
    outputs = v * s**3
    return 56.0 * outputs, 4.0 * (outputs + s**3 + 9 * v)


def phase_oblique(card, task, vol, truth):
    import torch.nn.functional as F

    from pmpu_tpu_torch import VolumeEvaluator
    from pmpu_tpu_torch.data.sampler import plane_grid
    from pmpu_tpu_torch.ops.cuda.fcomb_mean import fcomb_mean_decode
    from pmpu_tpu_torch.ops.cuda.oblique_gather import oblique_planes, oblique_planes_reference
    from pmpu_tpu_torch.ops.cuda.slice_gather import (
        gather_normalize_planes,
        gather_normalize_planes_reference,
    )

    print("phase 7: 6-view oblique path at full width (the same model and volume, num_views=6)")
    ev = VolumeEvaluator(task, n_samples=5, eval_batch=0, num_views=6, input_dtype="uint8")
    t0 = time.perf_counter()
    ev.evaluate_volume(vol, truth)
    torch.cuda.synchronize()
    print(f"  warm-up volume {time.perf_counter() - t0:.2f} s")

    kernels = {"oblique_planes": oblique_planes, "gather_normalize_planes": gather_normalize_planes,
               "fcomb_mean_decode": fcomb_mean_decode}
    for k in kernels.values():
        k.launches = 0
    reset_fcomb_counts()
    r = ev.evaluate_volume(vol, truth)
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in kernels.items()}
    print(f"  launches in one 6-view volume: {launches}")
    require(launches["oblique_planes"] == 1 and all(n > 0 for n in launches.values()),
            f"6-view path: launches {launches}")
    require_fcomb_route(6, "6-view")

    fused = r["fused"]
    s = fused.shape[0]
    require(tuple(fused.shape) == (128, 128, 128, 3), f"6-view fused shape {tuple(fused.shape)}")
    require(torch.isfinite(fused).all().item(), "6-view fused probabilities not finite")
    inside = covered(ev._bases, s)
    sum_err = (fused.sum(-1) - 1)[inside].abs().max().item()
    require(sum_err <= 1e-4, f"6-view: probabilities sum to 1 within {sum_err} where covered")
    require(r["argmax"].min() >= 0 and r["argmax"].max() < 3, "6-view argmax out of [0,3)")
    require(r["dice"].shape == (7, 2) and np.isfinite(r["dice"]).all(), f"6-view dice {r['dice']}")
    print(f"  checks: finite, probabilities sum to 1 within {sum_err:.2g} on the "
          f"{inside.float().mean().item():.4f} of voxels that all views cover, argmax in [0,3), "
          f"dice (7,2) = {np.round(r['dice'], 4).tolist()}")

    walls, spans = [], []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        ev.evaluate_volume(vol, truth)
        end.record()
        end.synchronize()
        walls.append(time.perf_counter() - t0)
        spans.append(start.elapsed_time(end))
    stages = stage_ms(ev, vol, truth)
    print(f"  [{card}] 6-view wall s/volume {walls} (min {min(walls):.4f}); CUDA-event span "
          f"ms/volume {[round(x, 3) for x in spans]}")
    print(f"  [{card}] 6-view device ms by stage: { {k: round(v, 3) for k, v in stages.items()} }")

    # the kernel on the main path's input: the uint8-wire volume as f32
    with torch.inference_mode():
        v = ev._upload(vol).float()
        got = oblique_planes(v, ev._bases)
        want = oblique_planes_reference(v, ev._bases)
        torch.cuda.synchronize()
        require(torch.equal(got, want), "oblique planes differ from the plain version at 128³ x 6 "
                                        f"({int((got != want).sum())} values)")
        ms = event_ms(lambda: oblique_planes(v, ev._bases), 50)
        plain_ms = event_ms(lambda: oblique_planes_reference(v, ev._bases), 2)
        # the same function as one library call: grid_sample on voxel
        # coordinates normalized for align_corners=True, (z, y, x) order
        g = plane_grid(s, "cuda")
        uu, vv = torch.meshgrid(g, g, indexing="ij")
        c = (s - 1) / 2.0
        coords = torch.cat([torch.stack([c + uu[..., None] * b[0] + vv[..., None] * b[1]
                                         + off * b[2] for off in g]) for b in ev._bases])
        grid = (coords.flip(-1) * (2.0 / (s - 1)) - 1.0)[None]
        inp = v[None, None]

        def library():
            return F.grid_sample(inp, grid, mode="bilinear", padding_mode="zeros",
                                 align_corners=True)

        lib_err = (library()[0, 0] - got).abs().max().item()
        lib_ms = event_ms(library, 20)
    flops, nbytes = oblique_cost(s, ev._bases.shape[0])
    bound = max(flops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3
    print(f"  [{card}] oblique_planes (128³, 6 views, 768 planes): {ms:.4f} ms/launch, plain "
          f"{plain_ms:.2f} ms, grid_sample {lib_ms:.4f} ms (max |diff| {lib_err:.2g}), bound "
          f"{bound:.4f} ms ({flops:.3g} FLOP, {nbytes / 1e6:.1f} MB), "
          f"{100 * bound / ms:.1f} % of the bound, {launches['oblique_planes']} launch/volume")

    # gather-normalize on the 6-view path's input: the (768,128,128) slab
    with torch.inference_mode():
        ids = torch.arange(got.shape[0], device="cuda")
        g_got = gather_normalize_planes(got, ids)[0]
        require(bits_equal(g_got, gather_normalize_planes_reference(got, ids)[0]),
                "gather-normalize differs on the 768-plane oblique slab")
        g_ms = event_ms(lambda: gather_normalize_planes(got, ids), 50)
    g_bytes = 2 * got.numel() * 4 + ids.numel() * 8
    g_bound = max(g_bytes / PEAK_HBM_BYTES, 2 * got.numel() / PEAK_F32_FLOPS) * 1e3
    print(f"  [{card}] gather_normalize_planes (768 planes of 128², the oblique slab): "
          f"{g_ms:.4f} ms/launch, bound {g_bound:.4f} ms ({g_bytes / 1e6:.1f} MB), "
          f"{100 * g_bound / g_ms:.1f} % of the bound, "
          f"{launches['gather_normalize_planes']} launch/volume")

    oblique_planes.launches = 0
    ged_s = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ged = ev.ged_volume(vol, truth, n_ged_samples=4)
        ged_s.append(time.perf_counter() - t0)
    require(np.isfinite(ged) and -1.0 <= ged <= 2.0, f"GED {ged} outside [-1, 2]")
    require(oblique_planes.launches == 2, f"GED: {oblique_planes.launches} oblique launches in 2 runs")
    require(ev.n_samples == 5, "GED changed the evaluator's n_samples")
    print(f"  [{card}] ged_volume, 4 draws, 6 views: {ged:.6f}; s per call {ged_s} "
          f"(one oblique-plane launch a call)")
    kernel = {"name": "oblique_planes", "route": "cuda",
              "source": "pmpu_tpu_torch/ops/cuda/csrc/oblique_gather.cu",
              "replaces": "pmpu_tpu/ops/pallas/oblique_gather.py:87",
              "launches": launches["oblique_planes"],
              "max_abs_err": (got - want).abs().max().item(),
              "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
              "bound_by": "operations" if flops / PEAK_F32_FLOPS > nbytes / PEAK_HBM_BYTES
              else "bytes",
              "library_ms": lib_ms}
    summary = {"launches": launches, "wall_s_per_volume": walls, "event_ms_per_volume": spans,
               "stage_ms": stages, "dice": r["dice"].tolist(), "sum_err_covered": sum_err,
               "covered_share": inside.float().mean().item(), "grid_sample_max_abs_diff": lib_err,
               "ged": ged, "ged_s": ged_s, "gather_768": {"ms": g_ms, "bound_ms": g_bound}}
    return kernel, summary


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
    phase_qconv()
    phase_oblique_kernel()
    phase_parity()
    kernels, summary, (task, vol, truth, r_bf16) = phase_full(card)
    summary["phase3_max_abs_err"] = errs
    kernel, summary["int8"] = phase_int8(card, task, vol, truth, r_bf16, summary)
    kernels.append(kernel)
    kernel, summary["oblique"] = phase_oblique(card, task, vol, truth)
    kernels.append(kernel)
    gather = next(k for k in kernels if k["name"] == "gather_normalize_planes")
    gather.update({f"{k}_768": v for k, v in summary["oblique"]["gather_768"].items()})
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
