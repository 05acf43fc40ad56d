#!/usr/bin/env python
"""Benchmark of the PyTorch/H100 port: whole-volume multi-view inference,
or with BENCH_MODE=train the train step.

    python3 bench_torch.py
    BENCH_MODE=train python3 bench_torch.py

The port's counterpart of ``bench.py``'s ``bench_infer``: the flagship
probabilistic U-Net (filters 64..1024, latent 6, 5 prior samples a slice,
bf16, 128³ volumes on the uint8 wire, random weights from seed 0) through
``pmpu_tpu_torch``, on one CUDA card. It prints ONE JSON line with
``bench_infer``'s keys:

  value / min_s / median_s / repeat_times_s
                    wall seconds of ``evaluate_volume`` (argmax fetched to
                    the host) over BENCH_REPEATS distinct volumes after a
                    warm-up volume; value is the minimum
  vs_baseline       baselines/reference_cpu.json's seconds a volume over
                    min_s, when its cube, samples and filters match
  device_compute_s_per_volume / device_mfu
                    CUDA events around BENCH_DEVICE_REPEATS chained
                    ``_predict_volume`` calls on one uploaded volume
  stream_s_per_volume / stream_round_times_s / stream_volumes /
  stream_vs_baseline / stream_mfu
                    ``predict_volumes_pipelined`` (depth 2) over
                    BENCH_STREAM distinct volumes, seconds a volume, the
                    minimum over BENCH_STREAM_ROUNDS rounds
  flops_per_volume  matmul and convolution FLOPs of one ``_predict_volume``
                    (``FlopCounterMode``), the hand kernels counted
                    analytically (fcomb's factored chain; on the int8 path
                    each conv-chain launch's 2·N·H·W·taps·Cin·Cout), since
                    the counter cannot see into them
  achieved_tflops / peak_tflops / mfu
                    flops_per_volume / min_s; the peak is 989 (H100 bf16
                    dense) when the card's name says H100, else null;
                    BENCH_PEAK_TFLOPS overrides
  device            the card's name and power limit (nvidia-smi)
  bf16 / eval_batch / quantize / input_dtype
                    the configuration

BENCH_MODE=train is the counterpart of ``bench.py``'s ``bench_train``: the
same model (bf16 compute, f32 parameters) trained from seed 0 on 2 seeded
128³ scans with random labels, as (3,2,S,S,S) view stacks with every slice
in the index (no filter); BENCH_TRAIN_BATCH (128) slices a step at
``acc_steps`` 1, gathered by the gather-normalize kernel (one launch a
step), the same rows every step. One line with ``bench.py``'s train keys:

  metric / value / unit / vs_baseline
                    ``bench.py``'s train line: value is slices/s
  train_slices_per_sec_per_chip / train_sec_per_step
                    host clock around BENCH_TRAIN_STEPS (10) steps after
                    two warm-up steps, ended by a synchronize
  train_vs_baseline baselines/reference_cpu_train.json's slices/s (the
                    reference's step on the CPU) against it, when its cube
                    and filters match
  train_flops_per_step / train_achieved_tflops / train_mfu
                    convolution and matmul FLOPs of one step, forward and
                    backward (``FlopCounterMode``; elementwise work is not
                    counted), over the step time and the bf16 peak
  train_max_memory_bytes
                    ``torch.cuda.max_memory_allocated`` over the timed steps
                    (null on the CPU)

Knobs, with bench.py's names and defaults: BENCH_CUBE (128), BENCH_SAMPLES
(5), BENCH_EVAL_BATCH (0 = auto), BENCH_REPEATS (8), BENCH_BF16 (1),
BENCH_FILTERS (64,128,256,512,1024), BENCH_QUANTIZE (int8 | unset),
BENCH_INPUT_DTYPE (uint8), BENCH_DEVICE_REPEATS (10), BENCH_STREAM (8),
BENCH_STREAM_ROUNDS (2), BENCH_PEAK_TFLOPS, BENCH_MODE (infer | train),
BENCH_TRAIN_BATCH (128), BENCH_TRAIN_STEPS (10). BENCH_DEVICE=cpu runs the
kernels' plain versions on the CPU (for tests; its times are CPU times);
the default is the card, and without one the bench raises.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

CUBE = int(os.environ.get("BENCH_CUBE", "128"))
SAMPLES = int(os.environ.get("BENCH_SAMPLES", "5"))
EVAL_BATCH = int(os.environ.get("BENCH_EVAL_BATCH", "0"))  # 0 = auto
REPEATS = int(os.environ.get("BENCH_REPEATS", "8"))
BF16 = os.environ.get("BENCH_BF16", "1") == "1"
MODE = os.environ.get("BENCH_MODE", "infer")
QUANTIZE = os.environ.get("BENCH_QUANTIZE") or None  # int8 | unset
INPUT_DTYPE = os.environ.get("BENCH_INPUT_DTYPE") or "uint8"
FILTERS = tuple(
    int(x) for x in os.environ.get("BENCH_FILTERS", "64,128,256,512,1024").split(",")
)
DEVICE = os.environ.get("BENCH_DEVICE", "cuda")
PEAK_H100_BF16_TFLOPS = 989.0  # dense, NVIDIA data sheet (SXM)


def _peak_tflops(device):
    env = os.environ.get("BENCH_PEAK_TFLOPS")
    if env:
        return float(env)
    import torch

    if device.type == "cuda" and "H100" in torch.cuda.get_device_name(device):
        return PEAK_H100_BF16_TFLOPS
    return None


def _load_baseline(name: str):
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "baselines", name)
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return None


def fcomb_flops(n, hw, cf, f0, c, s, ncf) -> float:
    """FLOPs of one fcomb mean-decode launch: the feature half of the first
    layer once a pixel, then per sample the ncf - 2 hidden layers and the
    head (the z half of the first layer is a per-slice bias)."""
    return 2.0 * n * hw * (cf * f0 + s * ((ncf - 2) * f0 * f0 + f0 * c))


def count_flops(ev, up, seed: int) -> float:
    """Matmul and convolution FLOPs of one ``_predict_volume`` on the
    uploaded volume ``up``: ``FlopCounterMode``'s count with whatever it saw
    inside the hand kernels' wrappers (their plain versions, on the CPU)
    replaced by the kernels' analytic counts, so that the count is the same
    on either device."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from pmpu_tpu_torch.inference import engine
    from pmpu_tpu_torch.models import quantized as qz

    mode = FlopCounterMode(display=False)
    seen_inside, analytic = [0], [0.0]
    fcomb_orig, chain_orig = engine.fcomb_mean_decode, qz.fused_qchain

    def fcomb(feats, zs, params, ncf=4, dtype=None):
        before = mode.get_total_flops()
        out = fcomb_orig(feats, zs, params, ncf, dtype)
        seen_inside[0] += mode.get_total_flops() - before
        n, h, w, cf = feats.shape
        analytic[0] += fcomb_flops(n, h * w, cf, params["layers.0.weight"].shape[0],
                                   params["last_layer.weight"].shape[0], zs.shape[0], ncf)
        return out

    def chain(x, layers, *args, **kw):
        before = mode.get_total_flops()
        out = chain_orig(x, layers, *args, **kw)
        seen_inside[0] += mode.get_total_flops() - before
        n, h, w, _ = x.shape
        analytic[0] += sum(2.0 * n * h * w * layer["w"].numel() for layer in layers)
        return out

    engine.fcomb_mean_decode, qz.fused_qchain = fcomb, chain
    try:
        with torch.inference_mode(), mode:
            ev._predict_volume(up, seed)
    finally:
        engine.fcomb_mean_decode, qz.fused_qchain = fcomb_orig, chain_orig
    return float(mode.get_total_flops() - seen_inside[0] + analytic[0])


def bench_infer() -> dict:
    import torch

    from pmpu_tpu_torch.device import card_label, resolve_device
    from pmpu_tpu_torch.inference.engine import VolumeEvaluator
    from pmpu_tpu_torch.train.tasks import make_task

    device = resolve_device(DEVICE)
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    task = make_task("probunet", num_filters=FILTERS, dtype=torch.bfloat16 if BF16 else None,
                     device=device, seed=0)
    s = CUBE
    rng = np.random.default_rng(0)
    ev = VolumeEvaluator(task, n_samples=SAMPLES, eval_batch=EVAL_BATCH, quantize=QUANTIZE,
                         input_dtype=INPUT_DTYPE, device=device)
    vols = [rng.random((s, s, s)).astype(np.float32) for _ in range(REPEATS)]

    ev.evaluate_volume(vols[0], seed=99)  # warm-up (and int8 calibration)
    with torch.inference_mode():
        up = ev._upload(vols[0])
    flops = count_flops(ev, up, 99)

    times = []
    for i, v in enumerate(vols):
        sync()
        t0 = time.perf_counter()
        ev.evaluate_volume(v, seed=i)  # the argmax comes back to the host
        times.append(time.perf_counter() - t0)
    sec_min = float(np.min(times))
    sec_med = float(np.median(times))

    # device compute: chained calls on one uploaded volume, timed between
    # CUDA events (on the CPU, which runs each op to its end, the host clock)
    n_dev = int(os.environ.get("BENCH_DEVICE_REPEATS", "10"))
    with torch.inference_mode():
        ev._predict_volume(up, 1000)
        sync()
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        for i in range(n_dev):
            ev._predict_volume(up, 1001 + i)
        if cuda:
            end.record()
            end.synchronize()
            dev_s = start.elapsed_time(end) / 1e3 / n_dev
        else:
            dev_s = (time.perf_counter() - t0) / n_dev

    # the pipelined stream of distinct volumes: volume i+1 dispatched
    # before volume i is fetched
    stream_n = int(os.environ.get("BENCH_STREAM", "8"))
    stream_vols = [rng.random((s, s, s)).astype(np.float32) for _ in range(stream_n)]
    stream_rounds = []
    for rnd in range(int(os.environ.get("BENCH_STREAM_ROUNDS", "2"))):
        sync()
        t0 = time.perf_counter()
        outs = ev.predict_volumes_pipelined(stream_vols, seed=rnd)
        stream_rounds.append((time.perf_counter() - t0) / stream_n)
        if len(outs) != stream_n or outs[-1].shape != (s, s, s):
            raise RuntimeError(f"stream returned {len(outs)} volumes of {outs[-1].shape}")
    stream_s = float(np.min(stream_rounds))

    vs_baseline = None
    base = _load_baseline("reference_cpu.json")
    if (
        base
        and base.get("cube") == s
        and base.get("samples_per_slice") == SAMPLES
        and list(FILTERS) == base.get("num_filters")
    ):
        vs_baseline = base["sec_per_volume_extrapolated"] / sec_min

    peak = _peak_tflops(device)
    achieved = flops / sec_min / 1e12
    return {
        "metric": f"sec/volume multi-view inference ({s}^3, probunet, {SAMPLES} samples)",
        "value": sec_min,
        "unit": "s",
        "vs_baseline": vs_baseline,
        "min_s": sec_min,
        "median_s": sec_med,
        "repeat_times_s": times,
        "device_compute_s_per_volume": dev_s,
        "device_mfu": flops / dev_s / 1e12 / peak if peak else None,
        "stream_s_per_volume": stream_s,
        "stream_round_times_s": stream_rounds,
        "stream_volumes": stream_n,
        "stream_vs_baseline": (
            base["sec_per_volume_extrapolated"] / stream_s if vs_baseline else None
        ),
        "stream_mfu": flops / stream_s / 1e12 / peak if peak else None,
        "flops_per_volume": flops,
        "achieved_tflops": achieved,
        "peak_tflops": peak,
        "mfu": achieved / peak if peak else None,
        "device": card_label(device),
        "bf16": BF16,
        "eval_batch": EVAL_BATCH,
        "quantize": QUANTIZE,
        "input_dtype": INPUT_DTYPE,
    }


def bench_train() -> dict:
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from pmpu_tpu_torch.data.index_map import build_index_map
    from pmpu_tpu_torch.data.sampler import sample_batch_vt
    from pmpu_tpu_torch.data.volumes import make_view_stacks
    from pmpu_tpu_torch.device import card_label, resolve_device
    from pmpu_tpu_torch.train.steps import create_train_state, make_train_step
    from pmpu_tpu_torch.train.tasks import make_task

    device = resolve_device(DEVICE)
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    s = CUBE
    batch = int(os.environ.get("BENCH_TRAIN_BATCH", "128"))
    n_steps = int(os.environ.get("BENCH_TRAIN_STEPS", "10"))
    rng = np.random.default_rng(0)
    imgs = rng.random((2, s, s, s)).astype(np.float32)
    lbls = rng.integers(0, 3, size=(2, s, s, s)).astype(np.int32)
    vt_i = torch.from_numpy(make_view_stacks(imgs)).to(device)
    vt_l = torch.from_numpy(make_view_stacks(lbls)).to(device)
    index = build_index_map(lbls, filter=False)
    task = make_task("probunet", num_filters=FILTERS, dtype=torch.bfloat16 if BF16 else None,
                     device=device, seed=0, train=True)
    state = create_train_state(task, seed=0)
    step = make_train_step(task, acc_steps=1, sampler=sample_batch_vt)
    triples = torch.from_numpy(index[np.arange(batch) % len(index)]).to(device)

    mode = FlopCounterMode(display=False)
    with mode:  # the first warm-up step, counted
        step(state, vt_i, vt_l, triples, 1e-4)
    flops = float(mode.get_total_flops())
    step(state, vt_i, vt_l, triples, 1e-4)
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    for _ in range(n_steps):
        state, metrics = step(state, vt_i, vt_l, triples, 1e-4)
    sync()
    sec = (time.perf_counter() - t0) / n_steps
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise RuntimeError(f"bench train: loss {loss} after {n_steps + 2} steps")
    slices_per_sec = batch / sec

    vs = None
    base = _load_baseline("reference_cpu_train.json")
    if base and base.get("cube") == s and list(FILTERS) == base.get("num_filters"):
        vs = slices_per_sec / base["slices_per_sec"]
    peak = _peak_tflops(device)
    tflops = flops / sec / 1e12
    return {
        "metric": f"train slices/sec/chip ({s}^2 slices, probunet, batch {batch}, bf16={BF16})",
        "value": slices_per_sec,
        "unit": "slices/s",
        "vs_baseline": vs,
        "train_slices_per_sec_per_chip": slices_per_sec,
        "train_batch": batch,
        "train_vs_baseline": vs,
        "train_flops_per_step": flops,
        "train_achieved_tflops": tflops,
        "train_mfu": tflops / peak if peak else None,
        "train_sec_per_step": sec,
        "train_steps": n_steps,
        "train_loss": loss,
        "train_max_memory_bytes": torch.cuda.max_memory_allocated(device) if cuda else None,
        "device": card_label(device),
        "bf16": BF16,
    }


def main() -> int:
    if MODE not in ("infer", "train"):
        print(f"bench_torch.py: unknown BENCH_MODE={MODE!r} (expected 'infer' or 'train')",
              file=sys.stderr)
        return 2
    print(json.dumps(bench_train() if MODE == "train" else bench_infer()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
