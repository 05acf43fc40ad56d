#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (``pmpu_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing at least one line; any failure exits non-zero:

1. device  — refuse to run without CUDA; print the card's name and power
             limit (nvidia-smi).
2. build   — compile the CUDA sources with nvcc for sm_90a (in
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
4. parity  — the whole path (probunet, filters 8,16, 32³, mean_z, f32) on
             the card against the same weights on the CPU, with cuDNN's TF32
             left at PyTorch's default (on): the port's f32 convolutions turn
             it off themselves; the same run with that guard patched out
             prints the mismatch TF32 would cause; then the same for the
             int8 path (``quantize="int8"``), the CPU run's scale file loaded
             on the card, and for the 6-view oblique path (``num_views=6``).
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
             rows and blocks. The kernels line has two conv-chain entries, one
             per TPU function: the row-stripe launches and the whole-image
             ones, each averaged over that form's launches of the chunk.
7. oblique — the same model, weights and volume through the 6-view oblique
             path (``num_views=6``): launch counts (one oblique-plane launch
             a volume), probabilities summing to 1 where every view covers
             the voxel, timings and stage times; the kernel at 128³ × 6
             views against its plain version (bit-exact) and against
             ``grid_sample`` (the library call computing the same
             function); gather-normalize on the 768-plane oblique slab
             (bit-exact, timed); ``ged_volume`` with 4 draws, its value and
             time.
8. stream  — the same model and weights through the serving path:
             ``predict_volumes_pipelined`` over 8 distinct seeded 128³ volumes
             at depth 0 and depth 2, with and without the uint16 entropy:
             launch counts of the depth-2 stream, depth 2 bit-equal to depth
             0, each argmax equal to ``evaluate_volume`` with the volume's
             derived seed, the card's entropy within 1 LSB of the plain f32
             formula on the same fused volume, the pinned pool settled at
             depth + 1 buffers a shape; seconds a volume of the stream at
             each depth beside ``evaluate_volume``'s wall, the device compute
             and the host enqueue time of one volume; 4 volumes of the 6-view
             path at depths 0 and 2, bit-equal, timed. Then two subprocesses
             run ``python -m pmpu_tpu_torch.predict`` in directory mode, on the
             card and with ``--device cpu`` (3 seeded NIfTI scans of
             different shapes, a U-Net 8,16 in f32 from a reference
             ``state_dict`` written with ``torch.save``; nothing turns TF32
             off in the subprocesses but the port's own guard):
             segmentations byte-equal, source shapes and affines kept,
             entropy within 1 LSB. Meanwhile ``bench_torch.py`` runs as
             ``__main__`` in this process at a reduced count; its JSON line
             must carry every key.
9. eval    — the same model, written as a ``state_dict`` with ``torch.save``,
             and 3 seeded scans with labels (128³, 128×120×112, 112×128×124)
             through the store evaluation: in-process ``evaluate_store`` on
             ``VolumeStore.from_dirs`` (launch counts, seconds a volume at
             depth 2, exports), ``evaluate_store_batched`` with 2 volumes a
             group (report within 1e-3 of the sequential one, argmax
             agreement), ``torch.cuda.max_memory_allocated`` of
             ``evaluate_volumes_batched`` at V = 1 and 2 beside
             ``batched_hbm_estimate`` (within 30 %), one volume with
             ``split_decoder`` against the concatenating decoder (argmax
             agreement, ``backbone+prior`` ms of both); then ``python -m
             pmpu_tpu_torch.eval --bf16 --save-uncertainty --ged 2`` on the
             card as a subprocess (its report equal to the in-process one
             within 1e-6, its exports byte-equal, cropped to the source
             shapes with the source affines), and with ``--mmap-store`` and
             ``--eval-mode batched`` (the same reports).
10. train  — the training path: the gather kernel at training shapes (2
             view stacks of 128³, 768 planes; batches of 2, 8 and 128 with
             labels, bit-exact; timed at 128 beside its bound); the
             full-width bf16 train loss's μ/log σ head weight, bias and
             input gradients (f32 convs in a bf16 step) against float64 on
             the CPU from the same captured head inputs, weights and output
             gradients, within 1e-5 of the largest, and the same with the
             backward guard patched out; the
             full-width bf16 train step at batch 8 (4 microbatches of 2, the
             CLI's rule) and 32 (one), gather launches counted from 0 around
             the timed steps (one a microbatch), ms a step, slices/s, peak
             allocated, every loss finite; ``bench_torch.py`` with
             ``BENCH_MODE=train`` in-process at 4 steps (every key); then
             ``python -m pmpu_tpu_torch.train`` as a subprocess (full width,
             bf16, batch 2, 1 epoch, 3 scans labeled in a central 11³ block:
             99 slices) writing its epoch checkpoint and ``probunet_model.pt``,
             the checkpoint read by ``load_for_inference`` and one volume
             evaluated from it; beside the subprocess, f32 train steps of
             probunet 8,16 at 32² (2 at ``acc_steps`` 1, 1 at 4, injected eps)
             on the card against the CPU: losses within 1e-5 relative, the
             first step's gradients within 1e-5 relative L2, every parameter
             and BatchNorm buffer within 1e-5 + 1e-5·|cpu|; the same with the
             train step's backward guard patched out prints what TF32 would
             change.

11. train, the rest — (a) the oblique view-stack precompute at full width
             (4 labeled 128³ scans, 6 golden-spiral views): one
             oblique-plane launch a scan, the image stacks bit-equal to the
             plain version on the card, the label stacks and nonempty table
             equal to the CPU's, ms of the precompute and of one launch
             beside its bound, the ``--no-view-stacks`` nonempty table on
             the card equal to the CPU's, its ms; (b) the full-width 6-view bf16 probunet step
             at batch 8 (4 × 2) and 32 on the gather kernel (its first
             microbatch's gather bit-equal to the plain version on the
             6-view stacks; ms a step, slices/s, gather launches a step,
             peak allocated); (c)
             ``--stream`` on the 3 views at batch 32: every batch of
             ``PrefetchPipeline`` + ``sample_rows`` bit-equal to the resident
             gather's on the f32 and the bf16/uint8 wires, ms a step of both
             paths; (d) ``--augment --elastic-alpha 4``: the card's batch
             within 1e-5 of the CPU's with the same injected draws, masks
             equal, ms a step with and without; (e) ``--remat`` at batch 32:
             loss and gradients of one step bit-equal to the plain step's
             (cuDNN's deterministic algorithms), peak allocated of both; (g)
             ``tools/profile_train.py`` at batch 128 (device ms by group, idle
             share); (f) the train CLI as subprocesses: 6 views, ``--augment``,
             2 epochs with ``--rss-limit-mb 1`` (one re-exec, both epochs,
             the checkpoints, the model evaluated on 6 views), and
             ``--stream``; beside them f32 6-view train steps of probunet
             8,16 at 32² on the card against the CPU: 8 seeded plans of one
             step of a microbatch of 2, each held as in phase 10 (loss,
             gradients and state within 1e-5) and each outside 1e-5 with
             the backward guard patched out; and how many of 8 seeded plans
             of phase 10's shape (7 microbatch passes) stay within 1e-5 on
             the 6-view and the 3-view data (printed, not checked: a ReLU
             input within rounding of 0 flips a pixel's gradient).
12. serve   — the serving daemon on phase 9's full-width probunet (the
             phase 5 weights written with ``torch.save``): (a) in-process
             ``serve.main([... "--once"])`` on 8 seeded 128³ volumes, bf16,
             as 8 ``.nii`` (twice) and as 6 ``.nii`` + 2 ``.nii.gz``; then a
             watch daemon as a process of its own, its first two batches of 8
             (with CUDA's lazy module loading and with it eager): every
             segmentation bit-equal to in-process ``predict_volumes_pipelined``
             with the daemon's first batch seed, the kernels' counts set to 0
             just before and read just after each run (a volume: gather 1,
             fcomb 3 on the tensor cores), the log's s/volume beside the
             in-process stream's (and a fresh evaluator's), the seconds from
             the first scan to the last export written, split into the loads
             and the writer's drain; (b) the same on 2 volumes with ``--quantize int8
             --calibration`` (the in-process engine's scale file) and with
             ``--num-views 6``: bit-equal, counts equal to the in-process
             engine's and each kernel of the path launched; (c) a watch-mode
             daemon as a subprocess with ``--rss-limit-mb 1``: a corrupt file
             quarantined, an oversize one rejected, a stalled upload
             quarantined and healed, a re-exec after each batch serving again
             on the card (outputs bit-equal), SIGINT rc 0; (d) beside it
             ``python -m pmpu_tpu_torch.tools.soak_serve`` at full width (32
             volumes of 128³, a fault every 8: its verdict and MB/volume
             slope); (e) ``uncertainty_maps`` (16 draws) and ``sample_grid``
             on one 128² slice at full width in f32, card against CPU within
             1e-5 (the grid's logits: 1e-5 of their scale), with their
             times; (f) the full-width bf16 train step at batch 8 (4 × 2)
             with ``--nan-checks`` against one without: bit-equal under
             cuDNN's deterministic algorithms, ms a step of each and of each
             half of the checks alone (the hooks, anomaly mode). The kernels
             line gives each kernel's ``serve_launches_per_volume`` by path.
13. train, multi-device — ``parallel/`` on ``torch.distributed`` at full
             width (probunet 64..1024, latent 6, 4 seeded 128³ scans):
             (a) a world of 1 under NCCL in this process: the
             ``--data-parallel`` step (bf16, batch 32 = 4 × 8, view stacks)
             and the ``--sharded-volumes`` step (bf16, batch 16, the plain
             stack) each bit-equal to ``make_train_step`` on the same rows,
             eps and state copy (cuDNN's deterministic algorithms); ms a step
             of each beside the plain step (plain, world, world, plain); the
             kernels' launches a step counted from 0 around the timed steps
             (gather 4 and 0); (b) a world of 2 processes sharing the card
             under gloo (asked for by name; NCCL refuses two ranks on one
             device): the sharded step, 2 scans a rank, bit-equal to the two
             shard steps averaged in this process; the f32 data-parallel
             step at batch 8 against the one-process step (relative: loss,
             gradients, update): probunet 8,16 at 32² in one microbatch
             pass within 1e-5, full width in 1 and 4 passes within 3 times
             the one-process step's own f32 floor (its BatchNorm moments
             summed in float64); the ranks' states equal; each kernel's
             launches a step on each rank; gloo's ms a step, labelled as
             not a multi-card speed; then ``train_net`` with
             ``--data-parallel --num-views 6`` in that world (the loop's
             branch of more than one rank: the 6-view precompute on each
             rank, validation split over the ranks): equal histories, rank
             0's checkpoints, each kernel's launches on each rank; (c)
             beside (b), ``python -m torch.distributed.run
             --standalone --nproc-per-node 1 -m pmpu_tpu_torch.train`` with
             ``--data-parallel --num-views 6`` and with
             ``--sharded-volumes`` (1 epoch, batch 8, 4 scans labeled in a
             central 11³ block), each checkpoint evaluated by
             ``python -m pmpu_tpu_torch.eval``; (d) with 2 cards or more,
             (b) under NCCL across two cards and the CLIs with
             ``--nproc-per-node 2``, else one line saying why not. (c)'s
             worlds of 1 run the one-device steps, as JAX does on one
             device. The kernels line gives each kernel's
             ``train_dp_launches_per_step`` per rank (a, b) and
             ``train_dp_loop_world2_launches`` (b's ``train_net``).

14. eval, multi-device — the slice-parallel evaluator and the last tools:
             (a) a world of 2 processes sharing the card under gloo (NCCL
             refuses two ranks on one device), phase 9's model (probunet
             64..1024, bf16, 5 samples) and 3 labeled scans:
             ``evaluate_store`` at depth 2 (3 chunks of 128 split 2/1), with
             ``quantize="int8"`` (this process's scale file) and with 6 views
             on 2 scans, ``evaluate_store_batched`` at V = 2, ``ged_volume``
             with 4 draws; every report, GED value, argmax and entropy export
             bit-equal to this process's one-process runs under cuDNN's
             deterministic algorithms; each kernel's launches a volume on each
             rank (the chunk kernels summing to one process's count, the
             gather and the oblique planes whole on each rank); s/volume of
             each side, each timed with nothing else on the card, labelled
             as not a multi-card speed; (b) ``python -m
             torch.distributed.run --nproc-per-node 1 -m pmpu_tpu_torch.eval
             --data-parallel`` (its report within 1e-6 of phase 9's
             in-process one) and ``pmpu_tpu_torch.eval.main`` in (a)'s world
             (rank 0's report and GED line equal, ``predictions/`` and the
             uncertainty maps written once, byte-equal); (c) the train CLI
             with ``--rss-limit-mb 1 -e 2`` under torchrun on the card (NCCL,
             one re-exec into a fresh rendezvous, both epochs, rank 0's
             checkpoints, the model evaluated) and in a CPU world of 2 (each
             rank re-executed once, equal losses); (d) ``tools.
             compare_with_reference`` weight parity at full width in f32 on
             one 128³ volume (argmax agreement ≥ 99.9 %), its ``--train
             --task landmark`` at filters 16,32, cube 32, 10 epochs of the
             converged protocol (batch 4, lr 0.02, patience 10: PASS),
             and ``tools.soak_stream_train`` for 1 minute at full width with
             ``--rss-limit-mb 1`` (re-execs, SIGTERM: rc 0 and
             ``INTERRUPTED.pth``; its creep in MB/min); (e) with 2 cards, (a)
             under NCCL across them and the eval CLI with
             ``--nproc-per-node 2``, else one line saying why not. The
             kernels line gives each kernel's ``eval_dp_launches_per_volume``
             by path, per rank.
15. tensor parallel — ``parallel/tensor.py``, the state channel-sharded
             over the mesh's model axis, on the dryrun's data (2 seeded 16³
             scans, 16 rows, lr 1e-4, ``__graft_entry__.py:64-176``): (a) a
             1x2 mesh of 2 gloo ranks sharing the card, the dryrun's legs
             (probunet 8,16 at min_channels 16 and 2 microbatches; full
             width at min_channels 64) and the full-width leg on the
             view-stack sampler (the gather kernel), each one f32 step from
             seed-0 weights against this process's one-process step with
             the same eps (the dryrun's bounds: loss rtol 1e-4, parameters
             rtol 1e-3 and atol 1e-4; the max |Δ| printed; the clip at 0.1
             holds that step's update within 1e-5, so the backward is held
             by the gathered gradients before the clip, all under cuDNN's
             deterministic algorithms: each tensor's max |Δ| over its max and
             the relative L2 of all within ``TP_GRAD_BOUNDS``, or at full
             width within 3 times the one-process step's f32 floor, its
             control with BatchNorm moments summed in float64), each rank's
             parameter bytes beside the whole model's, ms a step on each
             side (labelled as ranks sharing one card, not a multi-card
             speed), each kernel's launches a step on each rank; (b) the
             full-width leg on a 2x2 mesh of 4 gloo ranks; (c) in (a)'s
             world, ``VolumeEvaluator`` on the 1x2 mesh with phase 9's model
             on 2 scans: ``evaluate_store`` (3 views), int8 and 6 views, each
             bit-equal to one process on both ranks, each kernel's launches a
             volume on each rank; (d) with 2 cards, (a) under NCCL across
             them, else one line saying why not. The kernels line gives each
             kernel's ``tp_launches_per_step`` by leg and
             ``tp_eval_launches_per_volume`` by path, per rank.

16. the remaining tools — ``pmpu_tpu_torch/tools/`` at full width, each
             through its ``main`` (the kernels' counts set to 0 just before
             and read just after each in-process tool): (a)
             ``measure_baseline --full`` at 128³ (the reference's algorithm:
             384 batch-1 slices, 5 forwards of the 3 towers each, the
             probabilities to the host, PyTorch's default TF32), then
             ``--slices 6`` (the extrapolation beside it) and ``--mode
             train``; the reference's s/volume over phase 5's wall s/volume
             of the port; (b) ``profile_volume``, then ``trace_breakdown`` on
             its volume trace (its device op groups within 1 % of
             profile_volume's GROUPS total); (c) ``bench_int8_resident`` (2
             rounds of 5 volumes; both sides launch the conv-chain kernel in
             both forms; agreement and ms of each side); (d) ``bench_stream``
             (batch 32, 2 rounds of 10 steps; the wires' losses bit-equal in
             its check); then (e) ``demo_mmap_ramcap`` at 4 x 128³ on the
             card (the uncapped children's VmData, the in-RAM run's peak at
             least 0.8 of the pool above the mmap run's, the cap, the mmap
             run lives and the in-RAM run dies; the card's machine holds
             only ``brk`` to RLIMIT_DATA, so there the tool kills a child
             past the cap itself), (g) ``repro_client_staging_leak 30 128
             float32`` (creep below 1 MB/iter) and (h)
             ``run_6view_probunet.sh`` at full width with ``CUBE=64
             EPOCHS=1`` (its Dice lines; the eval CLI in this process on its
             checkpoint repeats its report within 1e-6 and launches the
             oblique planes, fcomb and the gather) as processes of their own,
             while (f) ``debug_probunet_drift`` runs 40 steps here (max
             relative drift within 1e-4, one gather launch a step). The
             kernels line gives each kernel's ``tools_launches`` by tool.
17. epilogue — the bias + BatchNorm + ReLU epilogue kernel
             (``ops/cuda/bias_bn_relu``) against the three ATen passes it
             replaces (its plain version), bit for bit, at every 3×3 conv
             output shape of a 3-view chunk (51 slices) and a 6-view chunk
             (68) of 170² slices: C 64..1024 at 170, 85, 42/43, 21/22, 10/11,
             with NaN, ±inf, ±0, subnormals, a zero variance and a zero and a
             negative scale among the values; each timed (over buffers of
             200 MB or more, so from device memory) beside its bound (2 × 2
             bytes an element at 3.35 TB/s), its plain version and each of
             the three passes; then two 170³ volumes of the full-width bf16
             probunet (BatchNorm statistics seeded) through
             ``predict_volumes_pipelined`` at 3 and 6 views, with the route
             open and closed (``unet._fused`` patched): labels bit-equal, 28
             epilogue launches a chunk.
18. hpu epilogue — the HPU-Net's residual-block epilogue kernels
             (``ops/cuda/hpu_epilogue``) against ATen's passes they replace
             (their plain versions), bit for bit, at the stitching decoder's
             level-0 shapes (255 = 5 draws × 51 slices of 170², C 12 and 24):
             bias + ReLU in place, and the residual with both skip kinds,
             with and without the ReLU copy; NaN, ±inf, ±0 (−0 + −0 into the
             ReLU), subnormals among the values; each timed (from device
             memory) beside its bound and ATen's passes, and the host's
             microseconds a call of each wrapper beside ATen's bias add; then
             a 170³ volume of the full-width bf16 HPU-Net (3 views, 5 draws)
             through ``predict_volumes_pipelined`` with the route open and
             closed (``hprob_unet._fused`` patched): labels and entropy
             bit-equal, 90 + 45 launches a chunk, wall s each.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. ``--json PATH`` also writes
all measurements to PATH.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import json
import logging
import os
import re
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
START = time.perf_counter()

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


def epilogue_shapes(cube, filters) -> dict:
    """{(C, H): how many} of the 3×3 conv outputs of one cube² slice that
    the epilogue takes: the backbone at floor sizes (2×2 max pools), encoder
    and decoder, and the prior tower at ceil sizes (2×2 ceil average
    pools); 28 at five levels."""
    floor, ceil = [cube], [cube]
    for _ in filters[1:]:
        floor.append(floor[-1] // 2)
        ceil.append(-(-ceil[-1] // 2))
    shapes = {}
    for c, h in [*zip(filters, floor), *zip(filters[:-1], floor[:-1]), *zip(filters, ceil)]:
        shapes[(c, h)] = shapes.get((c, h), 0) + 2
    return shapes


def epilogue_case(n, c, h, seed):
    """A conv output (n,c,h,h) bf16 channels_last with NaN, ±inf, ±0 and
    subnormals among its values, and its conv bias and BatchNorm tensors
    (among them a zero variance, a zero and a negative scale)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    y = (2 * torch.randn((n, h, h, c), generator=g, device="cuda")).to(torch.bfloat16)
    special = torch.tensor([float("nan"), float("inf"), -float("inf"), 0.0, -0.0, 1e-39, -1e-39,
                            -1e-41], device="cuda").to(torch.bfloat16)
    y.view(-1)[: special.numel()] = special
    y = y.permute(0, 3, 1, 2)

    def vec(scale, offset=0.0):
        return offset + scale * torch.randn(c, generator=g, device="cuda")

    var = vec(0.1, 1.0).abs()
    var[0] = 0.0
    weight = vec(0.1, 1.0)
    weight[1], weight[2] = 0.0, -0.5
    return y, (vec(0.05), vec(0.1), var, weight, vec(0.1), 1e-5)


def seed_batchnorm(net, seed):
    """Every BatchNorm of ``net`` away from (1, 0, 0, 1), seeded."""
    from pmpu_tpu_torch.models.unet import BatchNorm2d

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, BatchNorm2d):
                c = m.weight.shape[0]
                m.weight.copy_(1 + 0.1 * torch.randn(c, generator=g))
                m.bias.copy_(0.1 * torch.randn(c, generator=g))
                m.running_mean.copy_(0.1 * torch.randn(c, generator=g))
                m.running_var.copy_((1 + 0.1 * torch.randn(c, generator=g)).abs())


def phase_epilogue(card):
    """Phase 17: the bias + BatchNorm + ReLU epilogue kernel against the
    three ATen passes it replaces, at every conv shape of the serving chunks
    of 170² slices, and whole 170³ volumes through the serving stream with
    the route open and closed."""
    from pmpu_tpu_torch import VolumeEvaluator, make_task
    from pmpu_tpu_torch.inference.engine import eval_chunk_plan
    from pmpu_tpu_torch.models import unet
    from pmpu_tpu_torch.ops.cuda.bias_bn_relu import bias_bn_relu_, bias_bn_relu_reference

    print("phase 17: the conv epilogue (bias + BatchNorm + ReLU) against the three ATen passes")
    cube = 170
    shapes = epilogue_shapes(cube, FULL_WIDTH)
    require(sum(shapes.values()) == 28, f"epilogue shapes {shapes}")
    out = {"cases": []}
    bad = []
    for views in (3, 6):
        n = eval_chunk_plan(views * cube, cube, cube, 0)[0]
        for (c, h), count in sorted(shapes.items()):
            y, args = epilogue_case(n, c, h, seed=n * c + h)
            got = bias_bn_relu_(y.clone(), *args)
            want = bias_bn_relu_reference(y.clone(), *args)
            torch.cuda.synchronize()
            off = got.view(torch.int16) != want.view(torch.int16)
            same = not bool(off.any())
            if not same:
                diff = off.nonzero()[:4].tolist()
                bad.append(f"N={n} C={c} H={h}: {int(off.sum())} of {got.numel()} differ, "
                           f"e.g. at {diff}: y "
                           f"{[float(y[tuple(i)]) for i in diff]}, kernel "
                           f"{[float(got[tuple(i)]) for i in diff]}, ATen "
                           f"{[float(want[tuple(i)]) for i in diff]}, channel params "
                           f"{[[float(a[i[1]]) for a in args[:5]] for i in diff]}")
            # timed over rotating buffers of 200 MB or more, so that each
            # call reads its activation from device memory, not from L2
            bufs = [y.clone() for _ in range(max(1, -(-200_000_000 // (2 * y.numel()))))]
            it = iter(range(1 << 30))

            def nxt():
                return bufs[next(it) % len(bufs)]

            bias, mean, var, weight, shift, eps = args
            ms = {"kernel": event_ms(lambda: bias_bn_relu_(nxt(), *args), 20),
                  "plain": event_ms(lambda: bias_bn_relu_reference(nxt(), *args), 20),
                  "bias_add": event_ms(lambda: nxt().add_(bias.to(torch.bfloat16)[:, None, None]),
                                       20),
                  "batch_norm": event_ms(lambda: torch.nn.functional.batch_norm(
                      nxt(), mean, var, weight, shift, False, 0.0, eps), 20),
                  "relu": event_ms(lambda: torch.relu(nxt()), 20)}
            bound = 2 * 2 * y.numel() / PEAK_HBM_BYTES * 1e3
            case = {"views": views, "n": n, "c": c, "h": h, "convs_a_slice": count,
                    "bit_equal": same, "bound_ms": bound, **{f"{k}_ms": v for k, v in ms.items()}}
            out["cases"].append(case)
            passes = ms["bias_add"] + ms["batch_norm"] + ms["relu"]
            print(f"  [{card}] {views} views, N={n} C={c} {h}²: bit-equal {same}; kernel "
                  f"{ms['kernel']:.4f} ms, bound {bound:.4f} ms "
                  f"({100 * bound / ms['kernel']:.1f} %), "
                  f"plain {ms['plain']:.4f} ms, the three passes {passes:.4f} ms "
                  f"({ms['bias_add']:.4f} + {ms['batch_norm']:.4f} + {ms['relu']:.4f})")
            del y, got, want, off, bufs
    require(not bad, "epilogue kernel differs from the three ATen passes:\n" + "\n".join(bad))
    for views in (3, 6):
        cases = [k for k in out["cases"] if k["views"] == views]
        per_slice = {f: sum(k[f] * k["convs_a_slice"] for k in cases) / cases[0]["n"]
                     for f in ("kernel_ms", "bound_ms", "plain_ms")}
        vol = out[f"{views}view_ms_a_volume"] = {f: v * views * cube
                                                 for f, v in per_slice.items()}
        print(f"  [{card}] {views} views, ms a 170³ volume (28 convs a slice, weighted): "
              f"kernel {vol['kernel_ms']:.2f}, bound {vol['bound_ms']:.2f}, "
              f"plain {vol['plain_ms']:.2f}")

    # whole volumes: the route open, then closed (the three modules)
    task = make_task("probunet", num_filters=FULL_WIDTH, latent_dim=6, n_classes=3,
                     no_convs_fcomb=4, dtype=torch.bfloat16, seed=0)
    seed_batchnorm(task.net, 17)
    vols = [synthetic_volume(cube, seed=s)[0] for s in (170, 171)]
    out["volumes"] = {}
    for views in (3, 6):
        ev = VolumeEvaluator(task, n_samples=5, num_views=views, input_dtype="uint8")
        ev.predict_volumes_pipelined(vols[:1])
        bias_bn_relu_.launches = 0
        fused = ev.predict_volumes_pipelined(vols, seed=3)
        launches = bias_bn_relu_.launches / len(vols)
        route = unet._fused
        unet._fused = lambda *a: False
        try:
            eager = ev.predict_volumes_pipelined(vols, seed=3)
        finally:
            unet._fused = route
        require(bias_bn_relu_.launches == launches * len(vols), "the closed route launched")
        chunks = eval_chunk_plan(views * cube, cube, cube, 0)[1]
        equal = all(np.array_equal(a, b) for a, b in zip(fused, eager))
        print(f"  [{card}] {views} views, 2 volumes of 170³ through predict_volumes_pipelined: "
              f"labels bit-equal to the three modules {equal}; {launches:g} epilogue launches a "
              f"volume (28 × {chunks} chunks = {28 * chunks})")
        require(equal, f"{views} views: labels differ from the three modules'")
        require(launches == 28 * chunks, f"{views} views: {launches} epilogue launches a volume")
        out["volumes"][f"{views}view"] = {"bit_equal": equal, "launches_per_volume": launches}
        del ev
    del task
    torch.cuda.empty_cache()
    return out


def hpu_epilogue_case(n, c, h, seed):
    """Two (n,c,h,h) bf16 channels_last activations (a conv's output and a
    skip) with NaN, ±inf, ±0 and subnormals among their first values, and two
    (c,) f32 biases with a −0 (so −0 + −0 reaches the ReLU)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    special = torch.tensor([float("nan"), -0.0, float("inf"), -float("inf"), -0.0, 0.0, 1e-39,
                            -1e-39, -1e-41], device="cuda").to(torch.bfloat16)
    acts = []
    for _ in range(2):
        a = (2 * torch.randn((n, h, h, c), generator=g, device="cuda")).to(torch.bfloat16)
        a.view(-1)[: special.numel()] = special
        a.view(-1)[c: c + special.numel()] = special
        acts.append(a.permute(0, 3, 1, 2))
    biases = []
    for _ in range(2):
        b = 0.05 * torch.randn(c, generator=g, device="cuda")
        b[1] = -0.0
        biases.append(b)
    return acts, biases


def host_us(fn, calls=2000):
    """Host microseconds a call of ``fn`` (tiny tensors: the device keeps up,
    so the loop runs at the host's pace), after a warm-up."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * host / calls


def phase_hpu_epilogue(card):
    """Phase 18: the HPU-Net's residual-block epilogue kernels against
    ATen's passes at the stitching decoder's level-0 shapes, their host
    cost a call, and a 170³ volume through the serving stream with the
    route open and closed."""
    from pmpu_tpu_torch import VolumeEvaluator, make_task
    from pmpu_tpu_torch.inference.engine import eval_chunk_plan
    from pmpu_tpu_torch.inference.fusion import normalize_slabs
    from pmpu_tpu_torch.models import hprob_unet
    from pmpu_tpu_torch.models.unet import Conv2d
    from pmpu_tpu_torch.ops.cuda import hpu_epilogue as ep

    bf16 = torch.bfloat16
    print("phase 18: the HPU-Net's residual-block epilogues against ATen's passes")
    n, h = 5 * 51, 170
    out = {"cases": [], "host_us": {}}
    bad = []
    modes = [("bias_relu", None, False)] + [("residual", skip, relu) for skip in ("x", "conv")
                                            for relu in (False, True)]
    for c in (12, 24):
        (y, s), (b, sb) = hpu_epilogue_case(n, c, h, seed=c)
        for mode, skip, relu in modes:
            if mode == "bias_relu":
                fns, args, reads_writes = (ep.bias_relu_, ep.bias_relu_reference), (b,), 2
            else:
                fns = (ep.residual_, ep.residual_reference)
                args = (b, s, sb if skip == "conv" else None, relu)
                reads_writes = 3 + relu
            results = [fn(y.clone(), *args) for fn in fns]
            got, want = ([r] if mode == "bias_relu" else [t for t in r if t is not None]
                         for r in results)
            torch.cuda.synchronize()
            same = True
            for k, (a, w) in enumerate(zip(got, want)):
                if not (a.shape == w.shape and a.is_contiguous(memory_format=torch.channels_last)):
                    bad.append(f"{mode} C={c} skip={skip} relu={relu}: output {k} "
                               f"{tuple(a.shape)} strides {a.stride()}")
                    same = False
                    continue
                off = a.view(torch.int16) != w.contiguous(
                    memory_format=torch.channels_last).view(torch.int16)
                if bool(off.any()):
                    same = False
                    idx = off.nonzero()[:4].tolist()
                    bad.append(f"{mode} C={c} skip={skip} relu={relu}: output {k}: "
                               f"{int(off.sum())} of {a.numel()} differ, e.g. at {idx}: y "
                               f"{[float(y[tuple(i)]) for i in idx]}, s "
                               f"{[float(s[tuple(i)]) for i in idx]}, kernel "
                               f"{[float(a[tuple(i)]) for i in idx]}, ATen "
                               f"{[float(w[tuple(i)]) for i in idx]}")
            del results, got, want
            # each call writes a fresh y copy's worth: time over two rotating
            # buffers (each over 170 MB, far above L2), so reads come from
            # device memory
            bufs = [y.clone(), y.clone()]
            it = iter(range(1 << 30))

            def nxt():
                return bufs[next(it) % 2]

            ms = {name: event_ms(lambda fn=fn: fn(nxt(), *args), 20)
                  for name, fn in zip(("kernel", "aten"), fns)}
            bound = reads_writes * 2 * y.numel() / PEAK_HBM_BYTES * 1e3
            case = {"mode": mode, "skip": skip, "relu_copy": relu, "n": n, "c": c, "h": h,
                    "bit_equal": same, "bound_ms": bound,
                    **{f"{k}_ms": v for k, v in ms.items()}}
            out["cases"].append(case)
            print(f"  [{card}] {mode} N={n} C={c} {h}²"
                  f"{'' if skip is None else f', skip {skip}, relu copy {relu}'}: bit-equal "
                  f"{same}; kernel {ms['kernel']:.4f} ms, bound {bound:.4f} ms "
                  f"({100 * bound / ms['kernel']:.1f} %), ATen's passes {ms['aten']:.4f} ms")
            del bufs
        del y, s
    require(not bad, "hpu epilogue differs from ATen's passes:\n" + "\n".join(bad))

    # the host's cost a call, at a tiny shape, beside the ATen pass each replaces
    (y, s), (b, sb) = hpu_epilogue_case(2, 24, 4, seed=5)
    b16 = b.to(bf16)[:, None, None]
    out["host_us"] = {
        "bias_relu_": host_us(lambda: ep.bias_relu_(y, b)),
        "residual_ (skip conv, relu copy)": host_us(lambda: ep.residual_(y, b, s, sb, True)),
        "aten add_ (a bias add)": host_us(lambda: y.add_(b16)),
        "aten bias cast": host_us(lambda: b.to(bf16)),
        "aten relu": host_us(lambda: torch.relu(y)),
    }
    print(f"  [{card}] host us a call: "
          + ", ".join(f"{k} {v:.2f}" for k, v in out["host_us"].items()))
    del y, s

    # whole 170³ volumes through the serving stream, the route open and closed
    cube = 170
    task = make_task("hpunet", dtype=bf16, seed=0)
    g = torch.Generator().manual_seed(18)
    with torch.no_grad():  # biases well away from 0, so their bf16 rounding counts
        for m in task.net.modules():
            if isinstance(m, Conv2d) and m.bias is not None:
                m.bias.copy_(0.05 * torch.randn(m.bias.shape, generator=g))
    vol = synthetic_volume(cube, seed=180)[0]
    # the class head balanced on 4 planes of each view through the middle
    # half, max-normalized as served (each class's median logit 0, their
    # spread 1), so that every class has voxels
    with torch.no_grad():
        v, idx = torch.from_numpy(vol).cuda(), torch.linspace(cube // 4, 3 * cube // 4, 4).long()
        planes = normalize_slabs(torch.cat([v[idx], v[:, idx].transpose(0, 1),
                                            v[:, :, idx].permute(2, 0, 1)]))
        logits = task.net(planes[..., None]).flatten(0, -2)
        m = logits.median(dim=0).values
        k = 1 / (logits - m).std(dim=0).mean()
        task.net.logits.weight.mul_(k)
        task.net.logits.bias.sub_(m).mul_(k)
        del v, planes, logits
    ev = VolumeEvaluator(task, n_samples=5, num_views=3, input_dtype="uint8")
    chunks = eval_chunk_plan(3 * cube, cube, cube, 0)[1]

    def served():
        t0 = time.perf_counter()
        (labels, entropy), = ev.predict_volumes_pipelined([vol], seed=3, want_entropy=True)
        return labels, entropy, time.perf_counter() - t0

    served()
    ep.bias_relu_.launches = ep.residual_.launches = 0
    fused = served()
    launches = (ep.bias_relu_.launches, ep.residual_.launches)
    route = hprob_unet._fused
    hprob_unet._fused = lambda *a: False
    try:
        served()
        eager = served()
    finally:
        hprob_unet._fused = route
    closed = (ep.bias_relu_.launches, ep.residual_.launches)
    equal = all(np.array_equal(a, b) for a, b in zip(fused[:2], eager[:2]))
    classes = np.bincount(fused[0].astype(np.int64).ravel(), minlength=3).tolist()
    want = (90 * chunks, 45 * chunks)
    print(f"  [{card}] a 170³ volume (3 views, {chunks} chunks of 5 draws) through "
          f"predict_volumes_pipelined: labels and entropy bit-equal to ResBlock.forward {equal} "
          f"(voxels a class {classes}); epilogue launches a volume bias_relu_ {launches[0]}, "
          f"residual_ {launches[1]} (want {want[0]} + {want[1]}); wall s a volume: route open "
          f"{fused[2]:.3f}, closed {eager[2]:.3f}")
    require(closed == launches, f"the closed route launched: {launches} -> {closed}")
    require(equal, "the routed HPU-Net's labels or entropy differ from ResBlock.forward's")
    require(launches == want, f"epilogue launches a volume {launches}, not {want}")
    out["volume"] = {"bit_equal": equal, "launches": list(launches), "classes": classes,
                     "fused_s": fused[2], "eager_s": eager[2]}
    del ev, task
    torch.cuda.empty_cache()
    return out


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

    import contextlib

    from pmpu_tpu_torch.models import unet

    print("phase 4: whole path on the card vs the CPU (probunet 8,16, 32³, mean_z, f32, "
          f"cuDNN allow_tf32={torch.backends.cudnn.allow_tf32})")
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
    # the fault the guard repairs: the same card run with unet.py's guard
    # patched out, so that its f32 convolutions take cuDNN's TF32 default
    guard = unet.exact_f32_if
    unet.exact_f32_if = lambda dtype: contextlib.nullcontext()
    try:
        task = make_task("probunet", num_filters=(8, 16), device="cuda", seed=5)
        tf32 = VolumeEvaluator(task, mean_z=True, device="cuda").evaluate_volume(vol, truth)
    finally:
        unet.exact_f32_if = guard
    tf32_diff = (tf32["fused"].cpu() - cpu["fused"]).abs().max().item()
    tf32_mism = int((tf32["argmax"] != cpu["argmax"]).sum())
    print(f"  with the guard patched out (TF32 convolutions): fused max |diff| {tf32_diff:.3g}, "
          f"argmax mismatches {tf32_mism}, dice max |diff| "
          f"{float(np.abs(tf32['dice'] - cpu['dice']).max()):.3g}")
    require(mism == 0, f"parity: {mism} argmax mismatches")
    require(diff <= 1e-4, f"parity: fused probabilities differ by {diff}")
    require(np.array_equal(gpu["dice"], cpu["dice"]), "parity: Dice tables differ")
    parity = {"fused_max_abs_diff": diff, "tf32_fused_max_abs_diff": tf32_diff,
              "tf32_argmax_mismatches": tf32_mism}

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
    return parity


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
    fused_qchain.launches_by_form = dict.fromkeys(fused_qchain.launches_by_form, 0)
    reset_fcomb_counts()
    r = ev.evaluate_volume(vol, truth)
    torch.cuda.synchronize()
    launches = {"fused_qchain": fused_qchain.launches,
                "fused_qchain_stripes": fused_qchain.launches_by_form["stripes"],
                "fused_qchain_whole_image": fused_qchain.launches_by_form["whole_image"],
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
    # one kernels entry per TPU function: the row-stripe launches
    # (_fused_qchain_tiled) and the whole-image ones (_fused_qchain)
    kernels = []
    for whole, name, line, count in (
            (False, "fused_qchain", 151, "fused_qchain_stripes"),
            (True, "fused_qchain_whole_image", 216, "fused_qchain_whole_image")):
        form = [r_ for r_ in rows if r_["whole_image"] == whole]
        require(form, f"int8: no {count} launch among the first chunk's chains")
        n_form = len(form)
        ops_t = sum(r_["ops"] for r_ in form) / PEAK_INT8_OPS
        bytes_t = sum(r_["bytes"] for r_ in form) / PEAK_HBM_BYTES
        kernels.append({"name": name, "route": "cuda",
                        "source": "pmpu_tpu_torch/ops/cuda/csrc/qconv.cu",
                        "replaces": f"pmpu_tpu/ops/pallas/qconv.py:{line}",
                        "launches": launches[count], "max_abs_err": max_err,
                        "ms": sum(r_["ms"] for r_ in form) / n_form,
                        "plain_ms": sum(r_["plain_ms"] for r_ in form) / n_form,
                        "bound_ms": sum(r_["bound_ms"] for r_ in form) / n_form,
                        "bound_by": "operations" if ops_t > bytes_t else "bytes",
                        "library_ms": None, "first_chunk_launches": n_form})
    print(f"  [{card}] conv chain, mean of the first chunk's {len(rows)} launches: "
          f"{sum(r_['ms'] for r_ in rows) / len(rows):.4f} ms, plain "
          f"{sum(r_['plain_ms'] for r_ in rows) / len(rows):.3f} ms, bound "
          f"{sum(r_['bound_ms'] for r_ in rows) / len(rows):.4f} ms; stripes "
          f"{kernels[0]['ms']:.4f} ms ({kernels[0]['first_chunk_launches']} launches), whole "
          f"image {kernels[1]['ms']:.4f} ms ({kernels[1]['first_chunk_launches']} launches)")
    summary = {"calibration_s": cal_s, "launches": launches, "wall_s_per_volume": walls,
               "event_ms_per_volume": spans, "stage_ms": stages, "dice": r["dice"].tolist(),
               "argmax_agreement_with_bf16": agree, "chains": rows, "yardstick_bf16_ms": yard}
    return kernels, summary


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


STREAM_SEED = 7
BENCH_KEYS = (
    "metric", "value", "unit", "vs_baseline", "min_s", "median_s", "repeat_times_s",
    "device_compute_s_per_volume", "device_mfu", "stream_s_per_volume", "stream_round_times_s",
    "stream_volumes", "stream_vs_baseline", "stream_mfu", "flops_per_volume", "achieved_tflops",
    "peak_tflops", "mfu", "device", "bf16", "eval_batch", "quantize", "input_dtype",
)


def plain_entropy_u16(p: torch.Tensor, n_classes: int) -> torch.Tensor:
    """The uint16 entropy's formula in plain f32 on the CPU, as int32."""
    scale = float(np.log(n_classes))
    ent = -(p * torch.log(p + 1e-12)).sum(-1)
    return torch.round(ent.clamp(0.0, scale) * (65535.0 / scale)).to(torch.int32)


def entropy_lsb(ent: np.ndarray, n_classes: int = 3) -> np.ndarray:
    """A fetched (dequantized f32) entropy back in uint16 steps, as int64."""
    return np.rint(ent.astype(np.float64) * (65535.0 / np.log(n_classes))).astype(np.int64)


def write_scans(directory):
    """Three seeded NIfTI scans of different shapes and affines (common
    cube 24); returns {name: (shape, affine)}."""
    from pmpu_tpu_torch.data import nifti

    rng = np.random.default_rng(8)
    scans = {}
    for i, shape in enumerate(((20, 24, 18), (24, 17, 22), (23, 21, 24))):
        affine = np.diag([0.9 + 0.2 * i, 1.1, 1.5 - 0.25 * i, 1.0])
        affine[:3, 3] = (-10.0 * i, 3.5, 20.0)
        img = rng.random(shape).astype(np.float32)
        img[4:14, 5:15, 3:13] += 0.6
        name = f"scan{i}.nii"
        nifti.save(os.path.join(directory, name), img, affine)
        scans[name] = (shape, nifti.read_header(os.path.join(directory, name)).affine)
    return scans


def run_all(procs, timeout):
    """Wait for every (name, Popen); raise with the stderr of any that
    failed. Each is killed if it is still running when this returns."""
    try:
        for name, proc in procs.items():
            _, err = proc.communicate(timeout=timeout)
            require(proc.returncode == 0, f"{name} exited {proc.returncode}:\n{err[-4000:]}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def run_bench(env) -> str:
    """``bench_torch.py`` run as ``__main__`` in this process (its kernels
    are built and loaded already) with ``env`` set; returns its one line."""
    import contextlib
    import io
    import runpy

    saved = {k: os.environ.get(k) for k in env}
    out = io.StringIO()
    os.environ.update(env)
    try:
        with contextlib.redirect_stdout(out):
            runpy.run_path(os.path.join(ROOT, "bench_torch.py"), run_name="__main__")
    except SystemExit as e:
        require(e.code in (0, None), f"bench_torch.py exited {e.code}")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    lines = out.getvalue().strip().splitlines()
    require(len(lines) == 1, f"bench_torch.py printed {len(lines)} lines: {out.getvalue()!r}")
    return lines[0]


def phase_stream(card, task):
    from pmpu_tpu_torch import VolumeEvaluator
    from pmpu_tpu_torch.data import nifti
    from pmpu_tpu_torch.inference.engine import derive_seed, eval_chunk_plan
    from pmpu_tpu_torch.ops.cuda.fcomb_mean import fcomb_mean_decode
    from pmpu_tpu_torch.ops.cuda.slice_gather import gather_normalize_planes

    print("phase 8: stream (the same model, 8 distinct 128³ volumes through "
          "predict_volumes_pipelined at depths 0 and 2; the predict CLI; bench_torch.py)")
    n_vol = 8
    ev = VolumeEvaluator(task, n_samples=5, eval_batch=0, input_dtype="uint8")
    vols = [synthetic_volume(128, seed=20 + i)[0] for i in range(n_vol)]
    ev.predict_volumes_pipelined(vols[:3], pipeline_depth=2, want_entropy=True)  # warm-up
    runs, stream_s, launches = {}, {}, None
    for want_entropy in (True, False):
        for depth in (0, 2):
            main_path = depth == 2 and not want_entropy
            if main_path:
                reset_fcomb_counts()
                gather_normalize_planes.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs[want_entropy, depth] = ev.predict_volumes_pipelined(
                vols, seed=STREAM_SEED, pipeline_depth=depth, want_entropy=want_entropy)
            stream_s[f"depth {depth}" + (", entropy" if want_entropy else "")] = \
                (time.perf_counter() - t0) / n_vol
            if main_path:
                launches = {"fcomb_mean_decode": fcomb_mean_decode.launches,
                            "gather_normalize_planes": gather_normalize_planes.launches}
    cube = vols[0].shape[0]
    chunks = eval_chunk_plan(3 * cube, cube, cube, ev.eval_batch)[1]  # fcomb launches a volume
    print(f"  launches in the depth-2 stream of {n_vol} volumes: {launches}")
    require(launches == {"fcomb_mean_decode": chunks * n_vol, "gather_normalize_planes": n_vol},
            f"stream: launches {launches}")
    require_fcomb_route(chunks * n_vol, f"{n_vol}-volume stream's")
    for want_entropy in (True, False):
        for i, (a, b) in enumerate(zip(runs[want_entropy, 0], runs[want_entropy, 2])):
            for part_a, part_b in zip(*((x if want_entropy else (x,)) for x in (a, b))):
                require(part_a.dtype == np.float32 and np.array_equal(part_a, part_b),
                        f"stream: volume {i} differs between depth 0 and depth 2"
                        + (" (entropy on)" if want_entropy else ""))
    for i in range(n_vol):
        require(np.array_equal(runs[True, 0][i][0], runs[False, 0][i]),
                f"stream: volume {i}'s argmax depends on want_entropy")
    slots = {f"{list(k[0])} {k[1]}": n for k, n in ev._pool.allocated.items()}
    require(all(n <= 3 for n in slots.values()) and 3 in slots.values(),
            f"stream: the pinned pool did not settle at depth + 1 = 3 buffers a shape: {slots}")
    print(f"  depth 2 equals depth 0 bit for bit (argmax and entropy, {n_vol} volumes); "
          f"pinned buffers by shape: {slots}")

    walls = []
    for i in range(n_vol):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = ev.evaluate_volume(vols[i], seed=derive_seed(STREAM_SEED, i), return_views=False)
        walls.append(time.perf_counter() - t0)
        require(np.array_equal(r["argmax"], runs[False, 2][i]),
                f"stream: volume {i} differs from evaluate_volume with its seed")
        if i == 0:
            with torch.inference_mode():
                got = ev._entropy(r["fused"]).cpu().to(torch.int32)
            want = plain_entropy_u16(r["fused"].cpu(), 3)
            lsb = (got - want).abs().max().item()
            require(lsb <= 1, f"stream: the card's uint16 entropy is {lsb} LSB off the formula")
            ent = runs[True, 2][0][1]
            deq_lsb = int(np.abs(entropy_lsb(ent) - want.numpy()).max())
            require(deq_lsb <= 1, f"stream: the fetched entropy is {deq_lsb} LSB off the formula")
            require(0.0 <= ent.min() and ent.max() <= np.log(3) + 1e-6, "entropy out of [0, ln 3]")
    print(f"  each stream argmax equals evaluate_volume(seed=derive_seed({STREAM_SEED}, i)); "
          f"the card's uint16 entropy within {lsb} LSB of the plain f32 formula, the fetched "
          f"one within {deq_lsb} LSB")

    with torch.inference_mode():
        up = ev._upload(vols[0])
        ev._predict_volume(up, 1)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(3):
            ev._predict_volume(up, 2 + i)
        end.record()
        end.synchronize()
    device_ms = start.elapsed_time(end) / 3
    enqueue_ms = []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h = ev._dispatch_volume(vols[i], seed=i)
        enqueue_ms.append((time.perf_counter() - t0) * 1e3)
        ev._fetch_seg(h)
    # the 6-view oblique path through the stream: about 1,000 small launches
    # a volume (the resample back to the grid) ahead of the fetch
    ev6 = VolumeEvaluator(task, n_samples=5, eval_batch=0, num_views=6, input_dtype="uint8")
    ev6.predict_volumes_pipelined(vols[:2], pipeline_depth=2)  # warm-up
    six, six_s = {}, {}
    for depth in (0, 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        six[depth] = ev6.predict_volumes_pipelined(vols[:4], seed=STREAM_SEED, pipeline_depth=depth)
        six_s[f"depth {depth}"] = (time.perf_counter() - t0) / 4
    require(all(np.array_equal(a, b) for a, b in zip(six[0], six[2])),
            "stream: a 6-view volume differs between depth 0 and depth 2")
    print(f"  [{card}] 6-view stream s/volume {six_s} (4 volumes; depth 2 equals depth 0)")
    print(f"  [{card}] stream s/volume {stream_s}; evaluate_volume wall s/volume {walls} "
          f"(min {min(walls):.4f}); device compute {device_ms:.3f} ms/volume (CUDA events, "
          f"3 chained _predict_volume); host enqueue of one volume {enqueue_ms} ms")

    # the predict CLI in directory mode, on the card and on the CPU, from a
    # reference torch state_dict; bench_torch.py at a reduced count, beside
    # them (its numbers here are not kept)
    from pmpu_tpu_torch import make_task

    tmp = tempfile.TemporaryDirectory()
    try:
        d = tmp.name
        os.makedirs(os.path.join(d, "in"))
        scans = write_scans(os.path.join(d, "in"))
        unet = make_task("unet", n_classes=3, num_filters=(8, 16), device="cpu", seed=3)
        torch.save(unet.net.state_dict(), os.path.join(d, "unet.pt"))
        procs = {}
        for dev in ("cuda", "cpu"):
            cmd = [sys.executable, "-m", "pmpu_tpu_torch.predict", "-m", "unet",
                   "-f", os.path.join(d, "unet.pt"), "--n-classes", "3", "--num-filters", "8,16",
                   "-i", os.path.join(d, "in"), "-o", os.path.join(d, f"seg_{dev}"),
                   "--uncertainty", os.path.join(d, f"ent_{dev}"), "--device", dev]
            procs[f"predict --device {dev}"] = subprocess.Popen(
                cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        t0 = time.perf_counter()
        try:
            line = run_bench({"BENCH_REPEATS": "2", "BENCH_STREAM": "4",
                              "BENCH_STREAM_ROUNDS": "1", "BENCH_DEVICE_REPEATS": "2"})
        finally:
            run_all(procs, timeout=600)
        sub_s = time.perf_counter() - t0
        ent_err = 0
        for name, (shape, affine) in scans.items():
            seg = {dev: os.path.join(d, f"seg_{dev}", name) for dev in ("cuda", "cpu")}
            with open(seg["cuda"], "rb") as f, open(seg["cpu"], "rb") as g:
                require(f.read() == g.read(), f"predict CLI: {name} differs between card and CPU")
            hdr = nifti.read_header(seg["cuda"])
            require(hdr.shape == shape and np.array_equal(hdr.affine, affine),
                    f"predict CLI: {name} has shape {hdr.shape} and affine {hdr.affine}, "
                    f"not the source's {shape}")
            labels = nifti.load(seg["cuda"])
            require(set(np.unique(labels)) <= {0.0, 1.0, 2.0}, f"predict CLI: {name} labels")
            ents = [entropy_lsb(nifti.load(os.path.join(d, f"ent_{dev}", name)))
                    for dev in ("cuda", "cpu")]
            ent_err = max(ent_err, int(np.abs(ents[0] - ents[1]).max()))
        require(ent_err <= 1, f"predict CLI: entropy differs by {ent_err} LSB between card and CPU")
    finally:
        tmp.cleanup()
    print(f"  predict CLI (U-Net 8,16, f32, reference state_dict, 3 scans, cube 24): "
          f"segmentations byte-equal on the card and the CPU, source shapes and affines kept, "
          f"entropy within {ent_err} LSB; subprocesses {sub_s:.1f} s")
    bench = json.loads(line)
    missing = [k for k in BENCH_KEYS if k not in bench]
    require(not missing, f"bench_torch.py: keys missing from its line: {missing}")
    require(bench["stream_volumes"] == 4 and len(bench["repeat_times_s"]) == 2,
            f"bench_torch.py: {line}")
    print(f"  bench_torch.py (BENCH_REPEATS=2, BENCH_STREAM=4, BENCH_STREAM_ROUNDS=1, "
          f"BENCH_DEVICE_REPEATS=2, beside the CLI): {line}")
    return {"stream_s_per_volume": stream_s, "six_view_stream_s_per_volume": six_s,
            "evaluate_wall_s_per_volume": walls,
            "device_ms_per_volume": device_ms, "host_enqueue_ms": enqueue_ms,
            "launches": launches, "pinned_buffers": slots, "entropy_lsb": lsb,
            "fetched_entropy_lsb": deq_lsb, "cli_entropy_lsb": ent_err, "bench_line": bench}


EVAL_SEED = 9
EVAL_SHAPES = ((128, 128, 128), (128, 120, 112), (112, 128, 124))
REPORT_LINE = r"^(view \d+ dice|avg volume): mean=\[(.*)\], std=\[(.*)\]$"


def write_labeled_scans(directory):
    """A ``{images,labels}`` tree of seeded scans of ``EVAL_SHAPES`` (the
    nested ellipsoids of ``synthetic_volume`` cropped to each shape) with
    their own affines; returns {name: (shape, affine)}."""
    from pmpu_tpu_torch.data import nifti

    scans = {}
    for i, shape in enumerate(EVAL_SHAPES):
        img, truth = synthetic_volume(128, seed=40 + i)
        crop = tuple(slice(0, n) for n in shape)
        affine = np.diag([1.0, 0.9 + 0.1 * i, 1.2, 1.0])
        affine[:3, 3] = (-64.0, 10.0 * i, -30.0)
        name = f"case{i}.nii"
        nifti.save(os.path.join(directory, "images", name), img[crop], affine)
        nifti.save(os.path.join(directory, "labels", name), truth[crop].astype(np.float32), affine)
        scans[name] = (shape, nifti.read_header(os.path.join(directory, "images", name)).affine)
    return scans


def report_lines(report) -> dict:
    """The eval CLI's report numbers {label: (mean, std)} from a report."""
    rows = {f"view {v + 1} dice": a for v, a in enumerate(report["per_view"])}
    rows["avg volume"] = report["fused"]
    return {k: (a.mean(axis=0), a.std(axis=0)) for k, a in rows.items()}


def parse_report(stdout) -> dict:
    import re

    out = {}
    for line in stdout.splitlines():
        m = re.match(REPORT_LINE, line.strip())
        if m:
            out[m.group(1)] = tuple(np.array(g.split(), np.float64) for g in m.group(2, 3))
    return out


def report_diff(a: dict, b: dict) -> float:
    require(sorted(a) == sorted(b), f"report lines differ: {sorted(a)} vs {sorted(b)}")
    return max(float(np.abs(np.asarray(x, np.float64) - np.asarray(y, np.float64)).max())
               for k in a for x, y in zip(a[k], b[k]))


def argmax_agreement(dir_a, dir_b, names) -> float:
    from pmpu_tpu_torch.data import nifti

    same = total = 0
    for n in names:
        a, b = nifti.load(os.path.join(dir_a, n)), nifti.load(os.path.join(dir_b, n))
        require(a.shape == b.shape, f"{n}: shapes {a.shape} and {b.shape}")
        same += int((a == b).sum())
        total += a.size
    return same / total


def phase_eval(card, task):
    from pmpu_tpu_torch import VolumeEvaluator, make_task
    from pmpu_tpu_torch.data import native, nifti
    from pmpu_tpu_torch.data.volumes import VolumeStore
    from pmpu_tpu_torch.ops.cuda.fcomb_mean import fcomb_mean_decode
    from pmpu_tpu_torch.ops.cuda.slice_gather import gather_normalize_planes

    print("phase 9: eval (the same model as a state_dict; 3 seeded scans with labels through "
          "evaluate_store, the batched path, split_decoder and python -m pmpu_tpu_torch.eval)")
    tmp = tempfile.TemporaryDirectory()
    try:
        d = tmp.name
        data = os.path.join(d, "data")
        scans = write_labeled_scans(data)
        names = sorted(scans)
        ckpt = os.path.join(d, "probunet.pt")
        torch.save(task.net.state_dict(), ckpt)
        t0 = time.perf_counter()
        store = VolumeStore.from_dirs(os.path.join(data, "images"), os.path.join(data, "labels"))
        load_s = time.perf_counter() - t0
        require(store.cube == max(map(max, EVAL_SHAPES)) and store.ids == names,
                f"store: {store.ids}, cube {store.cube}")
        print(f"  store of {len(store)} scans (cube {store.cube}) loaded in {load_s:.2f} s, "
              f"native loader {native.available()}")

        ev = VolumeEvaluator(task, n_samples=5, eval_batch=0)  # the eval CLI's settings
        ev.evaluate_store(store, seed=EVAL_SEED)  # warm-up
        reset_fcomb_counts()
        gather_normalize_planes.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        seq = ev.evaluate_store(store, seed=EVAL_SEED, save_dir=os.path.join(d, "inproc"),
                                uncertainty_dir=os.path.join(d, "inproc_unc"))
        seq_s = (time.perf_counter() - t0) / len(store)
        launches = {"fcomb_mean_decode": fcomb_mean_decode.launches,
                    "gather_normalize_planes": gather_normalize_planes.launches}
        print(f"  launches in evaluate_store of {len(store)} volumes: {launches}")
        require(launches == {"fcomb_mean_decode": 3 * len(store),
                             "gather_normalize_planes": len(store)},
                f"eval: launches {launches}")
        require_fcomb_route(3 * len(store), f"{len(store)}-volume store's")
        require(seq["fused"].shape == (3, 2) and np.isfinite(seq["fused"]).all(),
                f"eval: fused report {seq['fused']}")

        t0 = time.perf_counter()
        bat = ev.evaluate_store_batched(store, seed=EVAL_SEED, save_dir=os.path.join(d, "batched"),
                                        volumes_per_batch=2)
        bat_s = (time.perf_counter() - t0) / len(store)
        bat_diff = report_diff(report_lines(bat), report_lines(seq))
        bat_agree = argmax_agreement(os.path.join(d, "batched"), os.path.join(d, "inproc"), names)
        print(f"  sequential fused Dice {np.round(seq['fused'], 5).tolist()}; batched "
              f"{np.round(bat['fused'], 5).tolist()}; report max |diff| {bat_diff:.3g}, "
              f"argmax agreement {100 * bat_agree:.4f} %")
        require(bat_diff <= 1e-3, f"eval: batched report differs by {bat_diff}")
        require(bat_agree >= 0.999, f"eval: batched argmax agreement {bat_agree}")

        peaks = {}
        for v in (1, 2):
            imgs = np.stack([store.images[i] for i in range(v)])
            truths = np.stack([store.labels[i] for i in range(v)])
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            ev.evaluate_volumes_batched(imgs, truths, seed=EVAL_SEED)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            peaks[v] = {"max_memory_allocated": peak, "resident_before": base,
                        "peak_above_resident": peak - base,
                        "batched_hbm_estimate": ev.batched_hbm_estimate(store.cube, v)}
        from pmpu_tpu_torch.inference.engine import BATCHED_ACTIVATION_COEF, eval_chunk_plan

        # the coefficient that would make batched_hbm_estimate's form hit each
        # measured peak: per volume b·s²·f0·2·coef + s³·4·(3 + 2·4·3)
        s_ = store.cube
        unit = eval_chunk_plan(3 * s_, s_, s_, 0)[0] * s_ * s_ * task.net.num_filters[0] * 2
        vol_term = s_**3 * 4 * (3 + 2 * 4 * 3)
        for v, p in peaks.items():
            ratio = p["batched_hbm_estimate"] / p["peak_above_resident"]
            p["estimate_over_measured"] = ratio
            p["fitted_coef"] = (p["peak_above_resident"] / v - vol_term) / unit
            print(f"  [{card}] V={v}: max_memory_allocated {p['max_memory_allocated'] / 2**30:.3f} "
                  f"GiB, {p['peak_above_resident'] / 2**30:.3f} GiB above the "
                  f"{p['resident_before'] / 2**30:.3f} GiB resident; batched_hbm_estimate "
                  f"{p['batched_hbm_estimate'] / 2**30:.3f} GiB ({ratio:.3f} of the measured; "
                  f"coefficient {BATCHED_ACTIVATION_COEF}, the measured peak fits "
                  f"{p['fitted_coef']:.2f})")

        net = task.net
        split_task = make_task("probunet", num_filters=net.num_filters, latent_dim=net.latent_dim,
                               n_classes=task.n_classes, no_convs_fcomb=net.no_convs_fcomb,
                               dtype=net.dtype, split_decoder=True, seed=1)
        split_task.net.load_state_dict(task.net.state_dict(), strict=True)
        ev_split = VolumeEvaluator(split_task, n_samples=5, eval_batch=0)
        vol, truth = store.images[0], store.labels[0]
        ev_split.evaluate_volume(vol, truth)  # warm-up
        a = ev.evaluate_volume(vol, truth, seed=3, return_views=False)
        b = ev_split.evaluate_volume(vol, truth, seed=3, return_views=False)
        split_diff = (a["fused"] - b["fused"]).abs().max().item()
        split_agree = float((a["argmax"] == b["argmax"]).mean())
        split_ms = {name: stage_ms(e, vol, truth)["backbone+prior"]
                    for name, e in (("concat", ev), ("split", ev_split), ("concat again", ev),
                                    ("split again", ev_split))}
        print(f"  [{card}] split_decoder, one {store.cube}³ volume: fused max |diff| {split_diff:.3g}, "
              f"argmax agreement {100 * split_agree:.4f} %; backbone+prior ms "
              f"{ {k: round(v, 3) for k, v in split_ms.items()} }")
        require(split_agree >= 0.999, f"eval: split_decoder argmax agreement {split_agree}")
        del split_task, ev_split

        # the CLI: alone for its wall, then the mmap and batched runs together
        env = {**os.environ, "PYTHONPATH": os.pathsep.join(
            [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
        base_cmd = [sys.executable, "-m", "pmpu_tpu_torch.eval", "-m", "probunet", "-f", ckpt,
                    "-d", data, "--bf16", "--seed", str(EVAL_SEED), "--num-filters",
                    ",".join(map(str, net.num_filters)), "--latent-dim", str(net.latent_dim)]
        runs = {"sequential": ["--save-uncertainty", "unc", "--ged", "2"],
                "mmap": ["--mmap-store", os.path.join(d, "pool")],
                "batched": ["--eval-mode", "batched", "--eval-volumes-batch", "2"]}
        outs, walls = {}, {}

        def start(name):
            cwd = os.path.join(d, f"cli_{name}")
            os.makedirs(cwd)
            return subprocess.Popen(base_cmd + runs[name], cwd=cwd, env=env,
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

        for group in (("sequential",), ("mmap", "batched")):
            t0 = time.perf_counter()
            procs = {name: start(name) for name in group}
            try:
                for name, proc in procs.items():
                    outs[name], err = proc.communicate(timeout=300)
                    walls[name] = time.perf_counter() - t0
                    require(proc.returncode == 0, f"eval CLI {name} exited {proc.returncode}:\n"
                            f"{err[-4000:]}")
            finally:
                for proc in procs.values():
                    if proc.poll() is None:
                        proc.kill()
                        proc.wait()
        want = report_lines(seq)
        cli_diff = {name: report_diff(parse_report(out), want) for name, out in outs.items()}
        seq_dir = os.path.join(d, "cli_sequential")
        for name, (shape, affine) in scans.items():
            path = os.path.join(seq_dir, "predictions", name)
            with open(path, "rb") as f, open(os.path.join(d, "inproc", name), "rb") as g:
                require(f.read() == g.read(), f"eval CLI: {name} differs from the in-process export")
            hdr = nifti.read_header(path)
            require(hdr.shape == shape and np.allclose(hdr.affine, affine),
                    f"eval CLI: {name} has shape {hdr.shape}, not the source's {shape}")
            ent = nifti.load(os.path.join(seq_dir, "unc", name))
            require(ent.shape == shape and 0.0 <= ent.min() and ent.max() <= np.log(3) + 1e-6,
                    f"eval CLI: {name} entropy map")
        ged = [ln for ln in outs["sequential"].splitlines() if ln.startswith("GED^2 (2 samples)")]
        cli_agree = argmax_agreement(os.path.join(d, "cli_batched", "predictions"),
                                     os.path.join(seq_dir, "predictions"), names)
        print(f"  eval CLI on the card: report max |diff| against in-process evaluate_store "
              f"{cli_diff}; exports byte-equal, source shapes and affines kept; {ged}; batched "
              f"CLI argmax agreement {100 * cli_agree:.4f} %")
        require(cli_diff["sequential"] <= 1e-6 and cli_diff["mmap"] <= 1e-6,
                f"eval CLI: reports differ from in-process evaluate_store: {cli_diff}")
        require(cli_diff["batched"] <= 1e-3 and cli_agree >= 0.999,
                f"eval CLI: batched report {cli_diff['batched']}, agreement {cli_agree}")
        require(len(ged) == 1, "eval CLI: no GED line")
        for v, p in peaks.items():
            require(0.7 <= p["estimate_over_measured"] <= 1.3,
                    f"eval: batched_hbm_estimate at V={v} is "
                    f"{p['estimate_over_measured']:.3f} of the measured peak")
        print(f"  [{card}] s/volume: evaluate_store depth 2 {seq_s:.4f}, evaluate_store_batched "
              f"(2 a group) {bat_s:.4f}; CLI wall {walls['sequential']:.1f} s alone for "
              f"{len(store)} volumes with 2 GED draws each (process start included); "
              f"--mmap-store and batched CLIs together {walls}")
    finally:
        tmp.cleanup()
    return {"launches": launches, "evaluate_store_s_per_volume": seq_s,
            "batched_s_per_volume": bat_s, "batched_report_diff": bat_diff,
            "batched_argmax_agreement": bat_agree, "peaks": peaks,
            "split_fused_max_abs_diff": split_diff, "split_argmax_agreement": split_agree,
            "split_backbone_prior_ms": split_ms, "cli_report_diff": cli_diff,
            "cli_wall_s": walls, "store_load_s": load_s, "ged_line": ged,
            "report": want}


def labeled_scans(n, cube, seed, block=None):
    """n seeded scans of ``synthetic_volume`` as (N,S,S,S) f32 images and
    int32 labels; with ``block`` = (lo, hi) only the labels inside the
    central cube [lo, hi)³ are kept."""
    pairs = [synthetic_volume(cube, seed + i) for i in range(n)]
    img, lbl = np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])
    if block is not None:
        keep = np.zeros_like(lbl)
        keep[:, block[0]:block[1], block[0]:block[1], block[0]:block[1]] = 1
        lbl = lbl * keep
    return img, lbl


def gather_train_cost(b, s):
    """(bound ms, bytes) of one training gather: B image and label planes
    read once and written once, the ids read; 2 f32 operations a pixel."""
    nbytes = 16 * b * s * s + 8 * b
    return max(nbytes / PEAK_HBM_BYTES, 2 * b * s * s / PEAK_F32_FLOPS) * 1e3, nbytes


TRAIN_PARITY = ((1, 2, (0.05, 0.02)), (4, 8, (0.05,)))  # (acc_steps, batch, lr a step)
ONE_STEP = ((1, 2, (0.05,)),)  # one step of one microbatch of 2


def parity_plans(index, shape, n, seed):
    """n seeded plans of ``shape`` over the rows of ``index``: per
    configuration, per step, (rows, the eps of each microbatch)."""
    g = torch.Generator().manual_seed(seed)
    rng = np.random.default_rng(seed)
    return [[[(torch.from_numpy(index[rng.choice(len(index), batch, replace=False)]),
               [torch.randn((batch // acc, 6), generator=g) for _ in range(acc)])
              for _ in lrs] for acc, batch, lrs in shape] for _ in range(n)]


def train_parity_runs(device, data, plan, shape=TRAIN_PARITY):
    """The f32 probunet 8,16 train steps of ``plan`` (of ``shape``) on
    ``device`` from seed 5: per configuration (losses, pre-clip gradients
    of the first step as one f32 vector, the state_dict after its steps)."""
    from pmpu_tpu_torch.data.sampler import sample_batch_vt
    from pmpu_tpu_torch.train import steps
    from pmpu_tpu_torch.train.tasks import make_task

    vt_i, vt_l = (t.to(device) for t in data)
    out = []
    clip = torch.nn.utils.clip_grad_value_
    for (acc, _, lrs), runs in zip(shape, plan):
        task = make_task("probunet", num_filters=(8, 16), device=device, seed=5, train=True)
        state = steps.create_train_state(task, seed=0)
        step = steps.make_train_step(task, acc_steps=acc, sampler=sample_batch_vt)
        grads, losses = [], []

        def spy(params, value):
            if not grads:
                grads.append(torch.cat([p.grad.reshape(-1).cpu() for p in params
                                        if p.grad is not None]))
            return clip(params, value)

        torch.nn.utils.clip_grad_value_ = spy
        try:
            for lr, (rows, eps) in zip(lrs, runs):
                _, m = step(state, vt_i, vt_l, rows.to(device), lr, eps)
                losses.append(float(m["loss"]))
        finally:
            torch.nn.utils.clip_grad_value_ = clip
        out.append((losses, grads[0], {k: v.cpu() for k, v in task.net.state_dict().items()}))
    return out


def train_parity_diff(got, want):
    """Max relative loss difference, relative L2 difference of the first
    step's gradients, and max |diff| − 1e-5·|want| over the state_dicts
    (≤ 1e-5 passes the stated tolerance)."""
    loss = max(abs(a - b) / abs(b) for (g, _, _), (w, _, _) in zip(got, want)
               for a, b in zip(g, w))
    grad = max(float((g - w).norm() / w.norm()) for (_, g, _), (_, w, _) in zip(got, want))
    state = max(float(((sg[k] - sw[k]).abs() - 1e-5 * sw[k].abs()).max())
                for (_, _, sg), (_, _, sw) in zip(got, want) for k in sw)
    return loss, grad, state


def head_grad_error(task, vt_i, vt_l, rows, generator):
    """One train loss of ``task`` on the card, backward through
    ``steps.backward``: the largest |difference| between the μ/log σ head
    convs' weight, bias and input gradients and the same gradients in
    float64 on the CPU from the heads' captured inputs, weights and output
    gradients, over the largest |float64 gradient| of each (both heads)."""
    from pmpu_tpu_torch.data.sampler import sample_batch_vt
    from pmpu_tpu_torch.train import steps

    heads = [task.net.prior.conv_layer, task.net.posterior.conv_layer]
    seen = {}

    def capture(mod, inputs, output):
        seen[mod] = {"x": inputs[0].detach()}
        inputs[0].register_hook(lambda g: seen[mod].__setitem__("dx", g.detach()))
        output.register_hook(lambda g: seen[mod].__setitem__("g", g.detach()))

    hooks = [h.register_forward_hook(capture) for h in heads]
    try:
        task.net.zero_grad(set_to_none=True)
        img, msk = sample_batch_vt(vt_i, vt_l, rows)
        loss, _ = task.train_loss(img, msk, generator)
        steps.backward(loss)
    finally:
        for h in hooks:
            h.remove()
    err = 0.0
    for h in heads:
        x, g = (seen[h][k].double().cpu()[:, :, 0, 0] for k in "xg")  # (N,Cin), (N,Cout)
        w = h.weight.detach().double().cpu()[:, :, 0, 0]  # (Cout,Cin)
        for got, ref in ((h.weight.grad[:, :, 0, 0], g.T @ x), (h.bias.grad, g.sum(0)),
                         (seen[h]["dx"][:, :, 0, 0], g @ w)):
            err = max(err, float((got.double().cpu() - ref).abs().max() / ref.abs().max()))
    task.net.zero_grad(set_to_none=True)
    return err


def phase_train(card):
    import contextlib

    from pmpu_tpu_torch import VolumeEvaluator
    from pmpu_tpu_torch.config import Config
    from pmpu_tpu_torch.data import nifti
    from pmpu_tpu_torch.data.index_map import build_index_map
    from pmpu_tpu_torch.data.sampler import sample_batch_vt
    from pmpu_tpu_torch.data.volumes import make_view_stacks
    from pmpu_tpu_torch.ops.cuda.slice_gather import (
        flat_plane_index,
        gather_normalize_planes,
        gather_normalize_planes_reference,
    )
    from pmpu_tpu_torch.train import steps
    from pmpu_tpu_torch.train.checkpoint import load_for_inference
    from pmpu_tpu_torch.train.loop import acc_steps_for
    from pmpu_tpu_torch.train.tasks import make_task

    out = {}
    # (a) the gather kernel at training shapes: 2 view stacks of 128³ (768 planes)
    print("phase 10: training")
    s = 128
    img, lbl = labeled_scans(2, s, seed=60)
    vt_i = torch.from_numpy(make_view_stacks(img)).cuda()
    vt_l = torch.from_numpy(make_view_stacks(lbl)).cuda()
    planes_i, planes_l = vt_i.view(-1, s, s), vt_l.view(-1, s, s)
    index = build_index_map(lbl, filter=True)
    rng = np.random.default_rng(61)
    for b in (2, 8, 128):
        rows = torch.from_numpy(index[rng.choice(len(index), b, replace=False)]).cuda()
        ids = flat_plane_index(rows.long(), 2, s)
        check_gather(planes_i, ids, planes_l, f"a training batch of {b} of 768 planes of 128² "
                                              "(2 view stacks), labels")
    g_ms = event_ms(lambda: gather_normalize_planes(planes_i, ids, planes_l), 50)
    g_plain = event_ms(lambda: gather_normalize_planes_reference(planes_i, ids, planes_l), 20)
    g_bound, g_bytes = gather_train_cost(128, s)
    print(f"  [{card}] gather_normalize_planes, training batch of 128 of 768 planes with labels: "
          f"{g_ms:.4f} ms/launch, plain {g_plain:.4f} ms, bound {g_bound:.4f} ms "
          f"({g_bytes / 1e6:.1f} MB), {100 * g_bound / g_ms:.1f} % of the bound")
    out["gather_b128"] = {"ms": g_ms, "plain_ms": g_plain, "bound_ms": g_bound}

    # (c) the full-width bf16 step: the CLI's rule at batch 8 (4 microbatches
    # of 2), then batch 32 in one
    task = make_task("probunet", dtype=torch.bfloat16, device="cuda", seed=0, train=True)
    state = steps.create_train_state(task, seed=0)
    rows = torch.from_numpy(index[rng.choice(len(index), 2, replace=False)]).cuda()
    head_err = head_grad_error(task, vt_i, vt_l, rows, state.generator)
    guard = steps.exact_f32
    steps.exact_f32 = contextlib.nullcontext
    try:
        head_tf32 = head_grad_error(task, vt_i, vt_l, rows, state.generator)
    finally:
        steps.exact_f32 = guard
    print(f"  [{card}] full-width bf16 train loss, μ/log σ head weight, bias and input "
          f"gradients (f32 convs) against "
          f"float64 on the CPU: max |diff| / max |grad| {head_err:.3g} (allowed 1e-5); with "
          f"the backward guard patched out (cuDNN allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}) {head_tf32:.3g}")
    require(head_err <= 1e-5, f"train: bf16 step head gradients off by {head_err} (relative)")
    out["head_grad"] = {"rel_err": head_err, "tf32_rel_err": head_tf32}
    full = {}
    for batch, acc, n_steps in ((8, acc_steps_for(8), 8), (32, 1, 6)):
        step = steps.make_train_step(task, acc_steps=acc, sampler=sample_batch_vt)
        batches = [torch.from_numpy(index[rng.choice(len(index), batch, replace=False)]).cuda()
                   for _ in range(n_steps + 2)]
        for rows in batches[:2]:  # warm-up
            step(state, vt_i, vt_l, rows, 1e-3)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        gather_normalize_planes.launches = 0
        t0 = time.perf_counter()
        losses = [step(state, vt_i, vt_l, rows, 1e-3)[1]["loss"] for rows in batches[2:]]
        torch.cuda.synchronize()
        sec = (time.perf_counter() - t0) / n_steps
        launches = gather_normalize_planes.launches
        losses = [float(x) for x in losses]
        peak = torch.cuda.max_memory_allocated()
        print(f"  [{card}] full-width bf16 step, batch {batch} ({acc} x {batch // acc}): "
              f"{1e3 * sec:.1f} ms/step, {batch / sec:.1f} slices/s, gather launches "
              f"{launches} in {n_steps} steps, peak allocated {peak / 2**30:.2f} GiB, "
              f"losses {losses[0]:.1f} … {losses[-1]:.1f}")
        require(launches == n_steps * acc,
                f"train: {launches} gather launches in {n_steps} steps of {acc} microbatches")
        require(all(np.isfinite(losses)), f"train: a loss is not finite: {losses}")
        full[batch] = {"acc_steps": acc, "ms_per_step": 1e3 * sec, "slices_per_s": batch / sec,
                       "gather_launches_per_step": launches / n_steps, "peak_bytes": peak,
                       "losses": losses}
    out["full"] = full
    del task, state, step, vt_i, vt_l, planes_i, planes_l
    torch.cuda.empty_cache()

    # (e) bench_torch.py BENCH_MODE=train at a reduced step count
    line = json.loads(run_bench({"BENCH_MODE": "train", "BENCH_TRAIN_STEPS": "4"}))
    keys = {"metric", "value", "unit", "vs_baseline", "train_slices_per_sec_per_chip",
            "train_batch", "train_vs_baseline", "train_flops_per_step",
            "train_achieved_tflops", "train_mfu"}
    require(keys <= set(line), f"bench train: missing keys {keys - set(line)}")
    require(line["train_batch"] == 128 and line["value"] > 0, f"bench train: {line}")
    print(f"  bench_torch.py BENCH_MODE=train (4 steps): {json.dumps(line)}")
    out["bench"] = line
    torch.cuda.empty_cache()

    # (d) the train CLI as a subprocess (full width, bf16, batch 2, 1 epoch,
    # 3 scans labeled in a central block of 11³: 99 slices), meanwhile (b)
    tmp = tempfile.TemporaryDirectory()
    try:
        d = tmp.name
        cimg, clbl = labeled_scans(3, s, seed=70, block=(59, 70))
        for i in range(3):
            nifti.save(os.path.join(d, "DATA", "images", f"scan{i}.nii"), cimg[i])
            nifti.save(os.path.join(d, "DATA", "labels", f"scan{i}.nii"),
                       clbl[i].astype(np.float32))
        env = {**os.environ, "PYTHONPATH": os.pathsep.join(
            [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
        cmd = [sys.executable, "-m", "pmpu_tpu_torch.train", "-m", "probunet", "-d", "DATA",
               "--bf16", "-b", "2", "-e", "1", "--checkpoint-dir", "ck"]
        t_cli = time.perf_counter()
        proc = subprocess.Popen(cmd, cwd=d, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        try:
            # (b) f32 train steps, the card against the CPU, injected eps
            p_img, p_lbl = labeled_scans(2, 32, seed=62)
            data = (torch.from_numpy(make_view_stacks(p_img)),
                    torch.from_numpy(make_view_stacks(p_lbl)))
            p_index = build_index_map(p_lbl)
            g = torch.Generator().manual_seed(63)
            prng = np.random.default_rng(64)
            plan = [[(torch.from_numpy(p_index[prng.choice(len(p_index), batch, replace=False)]),
                      [torch.randn((batch // acc, 6), generator=g) for _ in range(acc)])
                     for _ in lrs] for acc, batch, lrs in TRAIN_PARITY]
            cpu = train_parity_runs("cpu", data, plan)
            gpu = train_parity_runs("cuda", data, plan)
            loss_d, grad_d, state_d = train_parity_diff(gpu, cpu)
            guard = steps.exact_f32
            steps.exact_f32 = contextlib.nullcontext
            try:
                tf32 = train_parity_diff(train_parity_runs("cuda", data, plan), cpu)
            finally:
                steps.exact_f32 = guard
            print(f"  f32 train steps, card vs CPU (probunet 8,16, 32², 2 steps at acc 1, 1 at "
                  f"acc 4, cuDNN allow_tf32={torch.backends.cudnn.allow_tf32}): loss max rel "
                  f"diff {loss_d:.3g}, first-step gradients rel L2 {grad_d:.3g}, state excess "
                  f"over 1e-5 + 1e-5·|cpu| {state_d:.3g}")
            print(f"  with the backward guard patched out (TF32 backward convolutions): loss "
                  f"{tf32[0]:.3g}, gradients rel L2 {tf32[1]:.3g}, state excess {tf32[2]:.3g}")
            require(loss_d <= 1e-5, f"train parity: loss differs by {loss_d} (relative)")
            require(grad_d <= 1e-5, f"train parity: gradients differ by {grad_d} (relative L2)")
            require(state_d <= 1e-5, "train parity: a parameter or BatchNorm buffer differs by "
                                     f"more than 1e-5 + 1e-5·|cpu| (excess {state_d})")
            out["parity"] = {"loss_rel": loss_d, "grad_rel_l2": grad_d, "state_excess": state_d,
                             "tf32_loss_rel": tf32[0], "tf32_grad_rel_l2": tf32[1],
                             "tf32_state_excess": tf32[2]}
            stdout, err = proc.communicate(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        cli_s = time.perf_counter() - t_cli
        require(proc.returncode == 0, f"train CLI exited {proc.returncode}:\n{err[-4000:]}")
        written = sorted(os.listdir(os.path.join(d, "ck")))
        require(written == ["probunet_checkpoint0.pt", "probunet_model.pt"],
                f"train CLI wrote {written}")
        steps_line = [ln for ln in err.splitlines() if "epoch 1/1 done" in ln]
        task, _ = load_for_inference(os.path.join(d, "ck", "probunet_checkpoint0.pt"), Config(),
                                     device="cuda")
        r = VolumeEvaluator(task, device="cuda").evaluate_volume(cimg[0], clbl[0])
        require(bool(torch.isfinite(r["fused"]).all()) and r["argmax"].shape == (s, s, s),
                "train CLI: the checkpoint's evaluation is not finite")
        print(f"  train CLI (subprocess, 1 epoch, batch 2, bf16): {cli_s:.1f} s of wall with "
              f"the parity check beside it; {written}; {steps_line[-1:] or err[-300:]}; "
              f"evaluate_volume from its checkpoint: Dice {np.round(r['dice'], 4).tolist()}")
        out["cli_s"] = cli_s
    finally:
        tmp.cleanup()
    return out


def grads_of_step(step, state, args):
    """Run ``step(state, *args)``; return its loss and its pre-clip
    gradients as one f32 vector (in parameter order)."""
    seen = []
    clip = torch.nn.utils.clip_grad_value_

    def spy(params, value):
        seen.append(torch.cat([p.grad.reshape(-1).float() for p in params
                               if p.grad is not None]))
        return clip(params, value)

    torch.nn.utils.clip_grad_value_ = spy
    try:
        _, m = step(state, *args)
    finally:
        torch.nn.utils.clip_grad_value_ = clip
    return float(m["loss"]), seen[0]


def time_steps(step, state, batches, warmup=2):
    """Host ms a step over ``batches`` (tuples of step arguments after the
    state) after ``warmup`` of them, ended by a synchronize; the peak
    allocated bytes of the timed steps; the losses."""
    for args in batches[:warmup]:
        step(state, *args)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = [step(state, *args)[1]["loss"] for args in batches[warmup:]]
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / (len(batches) - warmup)
    return ms, torch.cuda.max_memory_allocated(), [float(x) for x in losses]


def phase_train_rest(card):
    """Phase 11: k-view oblique training, --stream, --augment, --remat, the
    RSS re-exec and profile_train (see the module docstring)."""
    from pmpu_tpu_torch import VolumeEvaluator
    from pmpu_tpu_torch.config import Config
    from pmpu_tpu_torch.data import nifti
    from pmpu_tpu_torch.data.augment import AugmentConfig, augment_batch, draw_augment
    from pmpu_tpu_torch.data.index_map import build_index_map, build_index_map_from_table
    from pmpu_tpu_torch.data.pipeline import PrefetchPipeline
    from pmpu_tpu_torch.data.sampler import (
        fibonacci_views,
        make_oblique_view_stacks,
        oblique_label_planes,
        oblique_nonempty_table,
        sample_batch_vt,
        sample_rows,
        view_basis,
    )
    from pmpu_tpu_torch.data.volumes import VolumeStore, make_view_stacks
    from pmpu_tpu_torch.ops.cuda.oblique_gather import oblique_planes, oblique_planes_reference
    from pmpu_tpu_torch.ops.cuda.slice_gather import flat_plane_index, gather_normalize_planes
    from pmpu_tpu_torch.tools import profile_train
    from pmpu_tpu_torch.train import steps
    from pmpu_tpu_torch.train.checkpoint import load_for_inference
    from pmpu_tpu_torch.train.loop import acc_steps_for
    from pmpu_tpu_torch.train.tasks import make_task

    import contextlib

    print("phase 11: training, the rest")
    out = {}
    # (a) the oblique view-stack precompute at full width: 4 scans of 128³, 6 views
    s, v, n = 128, 6, 4
    img, lbl = labeled_scans(n, s, seed=80)
    bases_np = np.stack([view_basis(a) for a in fibonacci_views(v)])
    bases = torch.from_numpy(bases_np).cuda()
    make_oblique_view_stacks(img[:1], lbl[:1], bases, device="cuda")  # warm-up
    torch.cuda.synchronize()
    oblique_planes.launches = 0
    t0 = time.perf_counter()
    vt_i, vt_l, table = make_oblique_view_stacks(img, lbl, bases, device="cuda")
    torch.cuda.synchronize()
    pre_ms = 1e3 * (time.perf_counter() - t0)
    pre_launches = oblique_planes.launches
    require(pre_launches == n, f"view stacks: {pre_launches} oblique launches for {n} scans")
    for i in range(n):
        want = oblique_planes_reference(torch.from_numpy(img[i]).cuda(), bases)
        require(bits_equal(vt_i[:, i].reshape(v * s, s, s), want),
                f"view stacks: scan {i}'s image planes differ from the plain version")
    t0 = time.perf_counter()
    cpu_l = torch.stack([oblique_label_planes(torch.from_numpy(lbl[i]), bases_np)
                         for i in range(n)], dim=1)
    host_ms = 1e3 * (time.perf_counter() - t0)
    require(torch.equal(vt_l.cpu(), cpu_l), "view stacks: label planes differ from the CPU's")
    cpu_table = (cpu_l.amax(dim=(3, 4)) > 0).permute(1, 0, 2).numpy()
    require(np.array_equal(table, cpu_table), "view stacks: nonempty table differs from the CPU's")
    # the --no-view-stacks table, computed where the uploaded labels lie
    lbl_d = torch.from_numpy(lbl).cuda()
    oblique_nonempty_table(lbl_d[:1], bases)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nv_table = oblique_nonempty_table(lbl_d, bases)
    table_ms = 1e3 * (time.perf_counter() - t0)
    require(np.array_equal(nv_table, cpu_table),
            "--no-view-stacks: the nonempty table differs from the CPU's")
    del lbl_d
    vol0 = torch.from_numpy(img[0]).cuda()
    k_ms = event_ms(lambda: oblique_planes(vol0, bases), 20)
    flops, nbytes = oblique_cost(s, v)
    k_bound = max(flops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3
    print(f"  [{card}] oblique view stacks, {n} scans of 128³ x {v} views: {pre_ms:.1f} ms "
          f"(uploads, label planes, nonempty table included), {pre_launches} oblique_planes "
          f"launches (one a scan), image planes bit-equal to the plain version on the card, "
          f"label planes and table equal to the CPU's; kernel {k_ms:.4f} ms/launch, bound "
          f"{k_bound:.4f} ms, {100 * k_bound / k_ms:.1f} % of the bound; the --no-view-stacks "
          f"nonempty table on the card {table_ms:.1f} ms (equal to the CPU's), the same label "
          f"planes on the host {host_ms:.1f} ms")
    out["view_stacks"] = {"ms": pre_ms, "launches": pre_launches, "scans": n, "kernel_ms": k_ms,
                          "bound_ms": k_bound, "nonempty_planes": int(table.sum()),
                          "table_ms": table_ms, "host_label_planes_ms": host_ms}

    # (b) 6-view full-width bf16 training at batch 8 (4 x 2) and 32
    index = build_index_map_from_table(table, filter=True)
    rng = np.random.default_rng(81)

    def rows(b):
        return torch.from_numpy(index[rng.choice(len(index), b, replace=False)]).cuda()

    task = make_task("probunet", dtype=torch.bfloat16, device="cuda", seed=0, train=True)
    state = steps.create_train_state(task, seed=0)
    full = {}
    planes_i, planes_l = vt_i.view(-1, s, s), vt_l.view(-1, s, s)
    for batch, acc, n_steps in ((8, acc_steps_for(8), 6), (32, 1, 6)):
        step = steps.make_train_step(task, acc_steps=acc, sampler=sample_batch_vt)
        batches = [(vt_i, vt_l, rows(batch), 1e-3) for _ in range(n_steps + 2)]
        # the kernel on this path's stacks: the first microbatch of the first step
        micro_rows = batches[0][2][:batch // acc]
        check_gather(planes_i, flat_plane_index(micro_rows.long(), n, s), planes_l,
                     f"6-view stacks ({v * n * s} planes), a microbatch of {batch // acc}")
        step(state, *batches[0])
        gather_normalize_planes.launches = 0
        ms, peak, losses = time_steps(step, state, batches[1:], warmup=1)
        launches = gather_normalize_planes.launches
        require(launches == (n_steps + 1) * acc,
                f"6-view train: {launches} gather launches in {n_steps + 1} steps of {acc}")
        require(all(np.isfinite(losses)), f"6-view train: a loss is not finite: {losses}")
        print(f"  [{card}] 6-view full-width bf16 step, batch {batch} ({acc} x {batch // acc}): "
              f"{ms:.1f} ms/step, {1e3 * batch / ms:.1f} slices/s, gather launches "
              f"{launches / (n_steps + 1):g} a step, peak allocated {peak / 2**30:.2f} GiB")
        full[batch] = {"acc_steps": acc, "ms_per_step": ms, "slices_per_s": 1e3 * batch / ms,
                       "gather_launches_per_step": launches / (n_steps + 1), "peak_bytes": peak}
    out["oblique_steps"] = full
    del vt_i, vt_l, planes_i, planes_l, step
    torch.cuda.empty_cache()

    # (c) --stream against the resident path, 3 views, batch 32
    s_img, s_lbl = labeled_scans(2, s, seed=82)
    store = VolumeStore.from_arrays(s_img, s_lbl)
    r_i = torch.from_numpy(make_view_stacks(s_img)).cuda()
    r_l = torch.from_numpy(make_view_stacks(s_lbl)).cuda()
    s_index = build_index_map(s_lbl, filter=True)
    sels = [s_index[rng.choice(len(s_index), 32, replace=False)] for _ in range(8)]
    row_ids = torch.arange(32, device="cuda")[:, None].expand(32, 3)
    wires = {}
    for name, idt, mdt in (("f32", torch.float32, torch.int32),
                           ("bf16/uint8", torch.bfloat16, torch.uint8)):
        pipe = PrefetchPipeline(store, image_dtype=idt, mask_dtype=mdt, device="cuda")
        for sel, (im, mk) in zip(sels, pipe.iterate(sels)):
            require(im.dtype == idt and mk.dtype == mdt, f"stream {name}: wire dtypes")
            got_i, got_l = sample_rows(im, mk, row_ids)
            want_i, want_l = sample_batch_vt(r_i, r_l, torch.from_numpy(sel).cuda())
            require(bits_equal(got_i, want_i.to(idt).float()) and torch.equal(got_l, want_l),
                    f"stream {name}: a batch differs from the resident sampler's")
        wires[name] = sum(pipe.pool.allocated.values())
    step_r = steps.make_train_step(task, sampler=sample_batch_vt)
    step_s = steps.make_train_step(task, sampler=sample_rows)
    res_ms, _, _ = time_steps(step_r, state,
                              [(r_i, r_l, torch.from_numpy(x).cuda(), 1e-3) for x in sels])
    stream = PrefetchPipeline(store, image_dtype=torch.bfloat16, mask_dtype=torch.uint8,
                              device="cuda").iterate(sels)
    step_s(state, *next(stream), row_ids, 1e-3)  # warm-up: the producer starts
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for im, mk in stream:
        step_s(state, im, mk, row_ids, 1e-3)
    torch.cuda.synchronize()
    str_ms = 1e3 * (time.perf_counter() - t0) / (len(sels) - 1)
    print(f"  [{card}] --stream, 3 views, batch 32: batches bit-equal to the resident "
          f"sampler's on the f32 and bf16/uint8 wires (pinned buffers made: {wires}); "
          f"{str_ms:.1f} ms/step streamed on the bf16/uint8 wire ({len(sels) - 1} steps after "
          f"one) against {res_ms:.1f} resident ({len(sels) - 2} after two)")
    out["stream"] = {"ms_per_step": str_ms, "resident_ms_per_step": res_ms}

    # (d) --augment --elastic-alpha 4: the card's batch against the CPU's,
    # the draws injected; the step time with and without
    aug = AugmentConfig(elastic_alpha=4.0)
    b_i, b_l = sample_batch_vt(r_i, r_l, torch.from_numpy(sels[0]).cuda())
    draws = draw_augment(b_i.shape, aug, torch.Generator().manual_seed(83))
    g_i, g_l = augment_batch(b_i, b_l, None, aug, {k: t.cuda() for k, t in draws.items()})
    c_i, c_l = augment_batch(b_i.cpu(), b_l.cpu(), None, aug, draws)
    aug_err = (g_i.cpu() - c_i).abs().max().item()
    require(aug_err <= 1e-5 and torch.equal(g_l.cpu(), c_l),
            f"augment: the card's batch differs from the CPU's by {aug_err} (allowed 1e-5)")
    step_a = steps.make_train_step(task, sampler=sample_batch_vt, augment=aug)
    aug_ms, _, _ = time_steps(step_a, state,
                              [(r_i, r_l, torch.from_numpy(x).cuda(), 1e-3) for x in sels])
    print(f"  [{card}] --augment --elastic-alpha 4, batch 32: card vs CPU max |diff| "
          f"{aug_err:.3g} (allowed 1e-5), masks equal; {aug_ms:.1f} ms/step against "
          f"{res_ms:.1f} without")
    out["augment"] = {"max_abs_err": aug_err, "ms_per_step": aug_ms, "plain_ms_per_step": res_ms}

    # (e) --remat, batch 32: one step's gradients against the plain step's
    # (cuDNN's deterministic algorithms, so that two runs can agree bit for
    # bit), and the peak allocated memory of each
    init = {k: t.clone() for k, t in task.net.state_dict().items()}
    rrows = torch.from_numpy(sels[1]).cuda()
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    remat = {}
    try:
        for flag in (False, True):
            task.net.load_state_dict(init)
            task.net.zero_grad(set_to_none=True)
            st = steps.create_train_state(task, seed=0)
            step = steps.make_train_step(task, sampler=sample_batch_vt, remat=flag)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            loss, grad = grads_of_step(step, st, (r_i, r_l, rrows, 1e-3))
            remat[flag] = (loss, grad, torch.cuda.max_memory_allocated())
    finally:
        torch.backends.cudnn.deterministic = det
    (l0, g0, p0), (l1, g1, p1) = remat[False], remat[True]
    g_diff = float((g1 - g0).norm() / g0.norm())
    print(f"  [{card}] --remat, batch 32: loss {l1!r} vs {l0!r}, gradients "
          f"{'bit-equal' if torch.equal(g0, g1) else f'rel L2 {g_diff:.3g}'}; peak allocated "
          f"{p1 / 2**30:.2f} GiB with remat, {p0 / 2**30:.2f} GiB without")
    require(l0 == l1 and torch.equal(g0, g1), f"remat: the step differs (gradients rel L2 {g_diff})")
    out["remat"] = {"peak_bytes": p1, "plain_peak_bytes": p0, "grad_rel_l2": g_diff}
    del task, state, st, step, step_r, step_s, step_a, r_i, r_l, init
    torch.cuda.empty_cache()

    # (g) profile_train, batch 128 in one microbatch
    tmp = tempfile.TemporaryDirectory()
    try:
        prof = profile_train.run(["--steps", "128:1", "--trace-dir", tmp.name])["128:1"]
    finally:
        tmp.cleanup()
    print(f"  [{card}] profile_train, batch 128: wall {prof['wall_ms']:.1f} ms, traced "
          f"{prof['traced_ms']:.1f}, host enqueue {min(prof['host_enqueue_ms']):.1f} ms, idle "
          f"{prof['idle_share']:.3f}, groups (ms) "
          f"{ {k: round(x, 2) for k, x in prof['groups_ms'].items()} }, "
          f"{prof['unplaced_ops']} of {prof['device_ops']} device operations unplaced")
    require(prof["device_ops"] > 0, "profile_train: the trace has no device operations")
    out["profile_train"] = prof
    torch.cuda.empty_cache()

    # (f) the train CLI as subprocesses: 6 views, --augment, 2 epochs, with a
    # 1 MB RSS limit (one re-exec), and --stream on the 3 views; meanwhile
    # (b') f32 6-view steps at small depth, the card against the CPU
    tmp = tempfile.TemporaryDirectory()
    try:
        d = tmp.name
        cimg, clbl = labeled_scans(3, 32, seed=84, block=(10, 22))
        for i in range(3):
            nifti.save(os.path.join(d, "DATA", "images", f"scan{i}.nii"), cimg[i])
            nifti.save(os.path.join(d, "DATA", "labels", f"scan{i}.nii"),
                       clbl[i].astype(np.float32))
        env = {**os.environ, "PYTHONPATH": os.pathsep.join(
            [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
        base = [sys.executable, "-m", "pmpu_tpu_torch.train", "-m", "probunet", "-d", "DATA",
                "--bf16", "-b", "16"]
        cmds = {"oblique": base + ["--num-views", "6", "--augment", "--elastic-alpha", "4",
                                   "-e", "2", "--rss-limit-mb", "1", "--checkpoint-dir", "ck6"],
                "stream": base + ["--stream", "-e", "1", "--checkpoint-dir", "cks"]}
        t_cli = time.perf_counter()
        procs = {k: subprocess.Popen(c, cwd=d, env=env, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True) for k, c in cmds.items()}
        try:
            p_img, p_lbl = labeled_scans(2, 32, seed=85)
            p_vi, p_vl, p_table = make_oblique_view_stacks(p_img, p_lbl, bases_np)
            p_index = build_index_map_from_table(p_table, filter=True)
            data6 = (p_vi, p_vl)
            diffs, ctrl = [], []
            for plan in parity_plans(p_index, ONE_STEP, 8, seed=86):
                cpu = train_parity_runs("cpu", data6, plan, ONE_STEP)
                diffs.append(train_parity_diff(
                    train_parity_runs("cuda", data6, plan, ONE_STEP), cpu))
                guard = steps.exact_f32
                steps.exact_f32 = contextlib.nullcontext
                try:
                    ctrl.append(train_parity_diff(
                        train_parity_runs("cuda", data6, plan, ONE_STEP), cpu))
                finally:
                    steps.exact_f32 = guard
            worst = [max(d[i] for d in diffs) for i in range(3)]
            ctrl_min = min(max(c) for c in ctrl)
            # what phase 10's plan shape (2 steps at acc 1, 1 at acc 4: 7
            # microbatch passes) gives on seeded plans of both data
            q_img, q_lbl = labeled_scans(2, 32, seed=62)
            data3 = (torch.from_numpy(make_view_stacks(q_img)),
                     torch.from_numpy(make_view_stacks(q_lbl)))
            within = {}
            for name, data, idx in (("6-view", data6, p_index),
                                    ("3-view", data3, build_index_map(q_lbl))):
                within[name] = sum(
                    max(train_parity_diff(train_parity_runs("cuda", data, plan),
                                          train_parity_runs("cpu", data, plan))) <= 1e-5
                    for plan in parity_plans(idx, TRAIN_PARITY, 8, seed=88))
            print(f"  [{card}] f32 6-view train step, card vs CPU (probunet 8,16, 32², one "
                  f"step of a microbatch of 2, 8 seeded plans): worst loss rel diff {worst[0]:.3g}, "
                  f"gradients rel L2 {worst[1]:.3g}, state excess over 1e-5 + 1e-5·|cpu| "
                  f"{worst[2]:.3g} (each allowed 1e-5); with the backward guard patched out "
                  f"(TF32 backward convolutions) the smallest plan's largest {ctrl_min:.3g}")
            print(f"  [{card}] phase 10's plan shape (7 microbatch passes) on 8 seeded plans, "
                  f"card vs CPU within 1e-5: {within['6-view']} of 8 on 6 views, {within['3-view']} of "
                  f"8 on 3 views (a ReLU input within rounding of 0 flips a pixel's gradient)")
            require(max(worst) <= 1e-5, "6-view train parity outside its tolerance of 1e-5")
            require(ctrl_min > 1e-5, "6-view train parity: the TF32 control passed the "
                                     "tolerance, so the check cannot see that fault")
            out["oblique_parity"] = {"loss_rel": worst[0], "grad_rel_l2": worst[1],
                                     "state_excess": worst[2], "plans": len(diffs),
                                     "tf32_min_of_max": ctrl_min,
                                     "tf32": ctrl, "phase10_shape_within": within}
            logs = {}
            for k, proc in procs.items():
                _, logs[k] = proc.communicate(timeout=600)
                require(proc.returncode == 0, f"train CLI {k} exited {proc.returncode}:\n"
                                              f"{logs[k][-4000:]}")
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        cli_s = time.perf_counter() - t_cli
        written = sorted(os.listdir(os.path.join(d, "ck6")))
        require(written == ["probunet_checkpoint0.pt", "probunet_checkpoint1.pt",
                            "probunet_model.pt", "probunet_rss_resume.pt"],
                f"train CLI, 6 views: wrote {written}")
        execs = logs["oblique"].count("re-exec for bounded RSS")
        require(execs == 1 and "epoch 2/2 done" in logs["oblique"],
                f"train CLI, 6 views: {execs} re-execs:\n{logs['oblique'][-3000:]}")
        require("probunet_model.pt" in os.listdir(os.path.join(d, "cks")),
                "train CLI, --stream: no probunet_model.pt")
        task, _ = load_for_inference(os.path.join(d, "ck6", "probunet_model.pt"), Config(),
                                     device="cuda")
        r = VolumeEvaluator(task, num_views=6, device="cuda").evaluate_volume(cimg[0], clbl[0])
        require(bool(torch.isfinite(r["fused"]).all()) and r["argmax"].shape == (32, 32, 32),
                "train CLI: the 6-view checkpoint's evaluation is not finite")
        print(f"  train CLI (subprocesses, beside the parity check): 6 views --augment -e 2 "
              f"--rss-limit-mb 1: one re-exec, {written}; --stream: exit 0; {cli_s:.1f} s of "
              f"wall; the 6-view model evaluated on 6 views: Dice "
              f"{np.round(r['dice'], 4).tolist()}")
        out["cli_s"] = cli_s
    finally:
        tmp.cleanup()
    return out


SERVE_SEED = 11
FULL_WIDTH = (64, 128, 256, 512, 1024)


class LogRecords(logging.Handler):
    """The root logger's records at INFO and above while attached (an
    in-process ``serve.main``'s log lines)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.records = []

    def emit(self, record):
        self.records.append(record)

    def __enter__(self):
        root = logging.getLogger()
        self._level = root.level
        root.addHandler(self)
        root.setLevel(logging.INFO)
        return self

    def __exit__(self, *exc):
        root = logging.getLogger()
        root.removeHandler(self)
        root.setLevel(self._level)

    def starting(self, prefix):
        return [r for r in self.records if r.msg.startswith(prefix)]


SERVE_KERNELS = ("fcomb_mean_decode", "gather_normalize_planes", "fused_qchain_stripes",
                 "fused_qchain_whole_image", "oblique_planes")


def reset_kernel_counts():
    from pmpu_tpu_torch.ops.cuda.oblique_gather import oblique_planes
    from pmpu_tpu_torch.ops.cuda.qconv import fused_qchain
    from pmpu_tpu_torch.ops.cuda.slice_gather import gather_normalize_planes

    reset_fcomb_counts()
    gather_normalize_planes.launches = 0
    fused_qchain.launches = 0
    fused_qchain.launches_by_form = dict.fromkeys(fused_qchain.launches_by_form, 0)
    oblique_planes.launches = 0


def kernel_counts() -> dict:
    from pmpu_tpu_torch.ops.cuda.fcomb_mean import fcomb_mean_decode
    from pmpu_tpu_torch.ops.cuda.oblique_gather import oblique_planes
    from pmpu_tpu_torch.ops.cuda.qconv import fused_qchain
    from pmpu_tpu_torch.ops.cuda.slice_gather import gather_normalize_planes

    return {"fcomb_mean_decode": fcomb_mean_decode.launches,
            "gather_normalize_planes": gather_normalize_planes.launches,
            "fused_qchain_stripes": fused_qchain.launches_by_form["stripes"],
            "fused_qchain_whole_image": fused_qchain.launches_by_form["whole_image"],
            "oblique_planes": oblique_planes.launches}


def serve_once(ckpt, watch, out, n_vol, extra=()):
    """``serve.main([... "--once"])`` in this process on the full-width
    bf16 probunet checkpoint; the kernels' counts are set to 0 just before
    and read just after. Returns (kernel launches, the served records' (n,
    seconds), and seconds: from the first scan to the last export written,
    of start-up, from the first scan to the first batch's dispatch (header
    preflight and loads), from the last batch's log line to the end (the
    writer draining))."""
    from pmpu_tpu_torch import serve

    argv = ["-m", "probunet", "-f", ckpt, "--bf16", "--watch", watch, "--out", out,
            "--cube", "128", "--once", "--seed", str(SERVE_SEED), "--device", "cuda", *extra]
    torch.cuda.synchronize()
    reset_kernel_counts()
    with LogRecords() as logs:
        t0 = time.time()
        rc = serve.main(argv)
        t_end = time.time()  # main returns once the writer has drained
    counts = kernel_counts()
    require(rc == 0, f"serve --once {' '.join(extra)} exited {rc}")
    scans = logs.starting("serving ")
    served = [(r.args[0], r.args[1]) for r in logs.starting("served ")]
    require(scans and sum(n for n, _ in served) == n_vol,
            f"serve --once {' '.join(extra)}: served {served}, not {n_vol} volumes")
    require(not any(r.levelno >= logging.ERROR for r in logs.records),
            f"serve --once: {[r.getMessage() for r in logs.records if r.levelno >= 40]}")
    last = logs.starting("served ")
    times = {"wall_s": t_end - scans[0].created, "startup_s": scans[0].created - t0,
             "load_s": last[0].created - last[0].args[1] - scans[0].created,
             "drain_s": t_end - last[-1].created}
    return counts, served, times


def serve_outputs_equal(out, names, want):
    """Every served segmentation equals the in-process engine's argmax."""
    from pmpu_tpu_torch.data import nifti

    for n, w in zip(names, want):
        got = nifti.load(os.path.join(out, n))
        require(got.shape == w.shape and np.array_equal(got, w),
                f"serve: {n} differs from the in-process engine "
                f"({float(np.mean(got != w)) if got.shape == w.shape else got.shape})")


class WatchDaemon:
    """``python -m pmpu_tpu_torch.serve`` in watch mode, its output read by
    a thread."""

    def __init__(self, args, env=None):
        import threading

        self.proc = subprocess.Popen([sys.executable, "-m", "pmpu_tpu_torch.serve", *args],
                                     cwd=ROOT, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True,
                                     env={**os.environ, **(env or {})})
        self.lines = []
        self.reader = threading.Thread(
            target=lambda: self.lines.extend(iter(self.proc.stdout.readline, "")), daemon=True)
        self.reader.start()

    def log(self) -> str:
        return "".join(self.lines)

    def wait_for(self, needle, count=1, timeout=300):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.log().count(needle) >= count:
                return
            require(self.proc.poll() is None,
                    f"serve daemon exited {self.proc.returncode}:\n{self.log()[-4000:]}")
            time.sleep(0.1)
        raise AssertionError(f"serve daemon: no {needle!r} (x{count}) in "
                             f"{timeout} s:\n{self.log()[-4000:]}")

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.reader.join(timeout=10)


def fresh_process_batches(ckpt, src, d, want, want_b2, loading):
    """A watch-mode daemon as a process of its own (``CUDA_MODULE_LOADING``
    = ``loading``) given the 8 volumes of ``src`` as one batch, then again
    under new names as a second: s/volume of each batch from its log lines,
    both batches' outputs bit-equal to the in-process engine's (the second
    with the seed ``derive_seed(seed, 8)``), and the seconds from the start
    to the daemon's first scan."""
    import shutil

    names = sorted(os.listdir(src))
    watch, stage = os.path.join(d, "watch"), os.path.join(d, "stage")
    os.makedirs(watch)
    os.makedirs(stage)

    def drop(prefix):  # renamed in: whole files, one scan
        for n in names:
            shutil.copy(os.path.join(src, n), os.path.join(stage, prefix + n))
        for n in names:
            os.rename(os.path.join(stage, prefix + n), os.path.join(watch, prefix + n))

    t0 = time.perf_counter()
    dm = WatchDaemon(["-m", "probunet", "-f", ckpt, "--bf16", "--watch", watch, "--out",
                      os.path.join(d, "out"), "--cube", "128", "--poll", "0.2",
                      "--seed", str(SERVE_SEED)], env={"CUDA_MODULE_LOADING": loading})
    try:
        dm.wait_for("INFO: serving ")
        startup_s = time.perf_counter() - t0
        drop("a")
        dm.wait_for(f"{len(names)} total)")
        drop("b")
        dm.wait_for(f"{2 * len(names)} total)")
        dm.proc.send_signal(signal.SIGINT)
        rc = dm.proc.wait(timeout=120)
    finally:
        dm.stop()
    require(rc == 0, f"serve daemon ({loading}): SIGINT gave rc {rc}:\n{dm.log()[-3000:]}")
    batches = [[], []]
    for ln in dm.log().splitlines():
        if "INFO: served " in ln:  # "served N volumes in Xs (... s/volume, T total)"
            n, dt = int(ln.split()[2]), float(ln.split(" in ")[1].split("s")[0])
            total = int(ln.rsplit(", ", 1)[1].split()[0])
            batches[total > len(names)].append((n, dt))
    for prefix, w in (("a", want), ("b", want_b2)):
        serve_outputs_equal(os.path.join(d, "out"), [prefix + n for n in names], w)
    return {"batch_s_per_volume": [sum(t for _, t in b) / sum(n for n, _ in b) for b in batches],
            "batches": batches, "startup_s": startup_s}


def phase_serve(card, state_dict):
    """Phase 12: the serving daemon (see the module docstring)."""
    from pmpu_tpu_torch import VolumeEvaluator, make_task
    from pmpu_tpu_torch.data import nifti
    from pmpu_tpu_torch.inference import uncertainty
    from pmpu_tpu_torch.inference.engine import derive_seed
    from pmpu_tpu_torch.train import steps
    from pmpu_tpu_torch.data.index_map import build_index_map
    from pmpu_tpu_torch.data.sampler import sample_batch_vt
    from pmpu_tpu_torch.data.volumes import make_view_stacks
    from pmpu_tpu_torch.utils.profiling import enable_nan_checks

    print("phase 12: serve (python -m pmpu_tpu_torch.serve on phase 9's full-width probunet "
          "written as a checkpoint; the soak harness; uncertainty maps; --nan-checks)")
    out = {}
    tmp = tempfile.TemporaryDirectory()
    soak = None
    try:
        d = tmp.name
        ckpt = os.path.join(d, "probunet.pt")
        torch.save(state_dict, ckpt)
        task = make_task("probunet", num_filters=FULL_WIDTH, n_classes=3, dtype=torch.bfloat16,
                         seed=0)
        task.net.load_state_dict(state_dict)
        vols = [synthetic_volume(128, seed=60 + i)[0] for i in range(8)]
        seed0 = derive_seed(SERVE_SEED, 0)  # the seed of a daemon's first batch

        # (a) --once on 8 volumes: 8 .nii, then 6 .nii + 2 .nii.gz
        ev = VolumeEvaluator(task, n_samples=5, eval_batch=0)  # the daemon's settings
        ev.predict_volumes_pipelined(vols[:2], pipeline_depth=2)  # warm-up
        stream_s = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = ev.predict_volumes_pipelined(vols, seed=seed0, pipeline_depth=2)
            stream_s.append((time.perf_counter() - t0) / len(vols))
        want_v1 = ev.predict_volumes_pipelined(vols[1:2], seed=seed0)[0]  # (c)'s re-exec
        # a fresh model and evaluator in this process, as each daemon makes:
        # its first stream against its second
        fresh_task = make_task("probunet", num_filters=FULL_WIDTH, n_classes=3,
                               dtype=torch.bfloat16, seed=1)
        fresh_task.net.load_state_dict(state_dict)
        fresh = VolumeEvaluator(fresh_task, n_samples=5, eval_batch=0)
        fresh_s = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            require(all(np.array_equal(a, b) for a, b in zip(
                fresh.predict_volumes_pipelined(vols, seed=seed0, pipeline_depth=2), want)),
                "a fresh evaluator's stream differs")
            fresh_s.append((time.perf_counter() - t0) / len(vols))
        del fresh, fresh_task
        runs = {}
        gz = [".nii"] * 6 + [".nii.gz"] * 2
        for kind, suffixes, src in (("8 .nii", [".nii"] * 8, "nii"),
                                    ("6 .nii + 2 .nii.gz", gz, "gz"),
                                    ("8 .nii again", [".nii"] * 8, "nii")):
            watch, dst = os.path.join(d, f"in_{src}"), os.path.join(d, f"out_{len(runs)}")
            names = [f"v{i}{sfx}" for i, sfx in enumerate(suffixes)]
            if not os.path.isdir(watch):
                for n, v in zip(names, vols):
                    nifti.save(os.path.join(watch, n), v)
            counts, served, times = serve_once(ckpt, watch, dst, len(vols))
            serve_outputs_equal(dst, names, want)
            per_vol = {k: c / len(vols) for k, c in counts.items()}
            require(per_vol["fcomb_mean_decode"] == 3 and per_vol["gather_normalize_planes"] == 1,
                    f"serve ({kind}): launches a volume {per_vol}")
            require_fcomb_route(3 * len(vols), f"served {kind} batch's")
            runs[kind] = {"launches": counts, "served": served,
                          "served_s_per_volume": sum(s for _, s in served) / len(vols), **times}
        # the daemon as a process of its own, as a user starts it, in watch
        # mode: its first two batches of 8, with CUDA's lazy module loading
        # (the default) and with CUDA_MODULE_LOADING=EAGER
        want_b2 = ev.predict_volumes_pipelined(vols, seed=derive_seed(SERVE_SEED, len(vols)))
        for loading in ("LAZY", "EAGER"):
            runs[f"a process of its own, {loading}"] = fresh_process_batches(
                ckpt, os.path.join(d, "in_nii"), os.path.join(d, f"proc_{loading}"), want,
                want_b2, loading)
        print(f"  served 8 volumes three times, each segmentation bit-equal to in-process "
              f"predict_volumes_pipelined(seed=derive_seed({SERVE_SEED}, 0)); launches a "
              f"volume: fcomb 3, gather 1")
        for kind, r in runs.items():
            if "batch_s_per_volume" in r:
                print(f"  [{card}] serve ({kind}): its first two batches of 8 "
                      f"{[round(x, 4) for x in r['batch_s_per_volume']]} s/volume (the log's "
                      f"lines, bit-equal to the in-process engine), start-up "
                      f"{r['startup_s']:.1f} s")
                continue
            print(f"  [{card}] serve --once ({kind}): served {r['served_s_per_volume']:.4f} "
                  f"s/volume (the log's line); first scan to last write {r['wall_s']:.3f} s = "
                  f"preflight and loads {r['load_s']:.3f} + served + writer drain "
                  f"{r['drain_s']:.3f}; start-up {r['startup_s']:.2f} s")
        print(f"  [{card}] in-process predict_volumes_pipelined, the same 8 volumes and "
              f"settings: {[round(s, 4) for s in stream_s]} s/volume; a fresh model and "
              f"evaluator, its first and second stream: {[round(s, 4) for s in fresh_s]}")
        out["once"] = runs
        out["in_process_stream_s_per_volume"] = stream_s
        out["fresh_evaluator_stream_s_per_volume"] = fresh_s

        # (b) int8 (a scale file written by the in-process engine) and 6 views
        launches_pv = {"3 views": {k: c / len(vols)
                                   for k, c in runs["8 .nii"]["launches"].items()}}
        for label, extra, kw in (
                ("int8", ["--quantize", "int8", "--calibration", os.path.join(d, "scales.json")],
                 {"quantize": "int8", "calibration": os.path.join(d, "scales.json")}),
                ("6 views", ["--num-views", "6"], {"num_views": 6})):
            evk = VolumeEvaluator(task, n_samples=5, eval_batch=0, **kw)
            evk.predict_volumes_pipelined(vols[:1])  # calibrates and writes the scale file (int8)
            reset_kernel_counts()
            wantk = evk.predict_volumes_pipelined(vols[:2], seed=seed0)
            inproc = kernel_counts()
            tag = label.replace(" ", "")
            watch, dst = os.path.join(d, f"in_{tag}"), os.path.join(d, f"out_{tag}")
            for i in range(2):
                nifti.save(os.path.join(watch, f"v{i}.nii"), vols[i])
            counts, served, times = serve_once(ckpt, watch, dst, 2, extra)
            serve_outputs_equal(dst, ["v0.nii", "v1.nii"], wantk)
            require(counts == inproc, f"serve {label}: launches {counts}, in-process {inproc}")
            path_kernels = (("fused_qchain_stripes", "fused_qchain_whole_image")
                            if label == "int8" else ("oblique_planes",))
            require(all(counts[k] > 0 for k in path_kernels + SERVE_KERNELS[:2]),
                    f"serve {label}: a kernel of the path was not launched: {counts}")
            launches_pv[label] = {k: c / 2 for k, c in counts.items()}
            out[label] = {"launches": counts, "served": served, **times}
            print(f"  [{card}] serve --once {' '.join(extra[:2])} on 2 volumes: bit-equal to the "
                  f"in-process engine; launches a volume "
                  f"{ {k: v for k, v in launches_pv[label].items() if v} }; served "
                  f"{sum(s for _, s in served) / 2:.4f} s/volume")
            del evk
        out["launches_per_volume"] = launches_pv

        # (d) the soak harness at full width, in the background while (c) runs
        soak_log = os.path.join(d, "soak_rss.log")
        soak = subprocess.Popen(
            [sys.executable, "-m", "pmpu_tpu_torch.tools.soak_serve", "--volumes", "32",
             "--cube", "128", "--filters", ",".join(map(str, FULL_WIDTH)), "--fault-every", "8",
             "--poll", "0.2", "--warmup", "8", "--timeout", "120", "--first-timeout", "300",
             "--workdir", os.path.join(d, "soak"), "--rss-log", soak_log,
             "--serve-arg=--bf16"],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        t_soak = time.perf_counter()

        # (c) a watch-mode daemon on the card: corrupt and oversize files, a
        # stalled upload, a re-exec after every batch (--rss-limit-mb 1), SIGINT
        watch, dst = os.path.join(d, "watch"), os.path.join(d, "out_watch")
        os.makedirs(watch)
        t0 = time.perf_counter()
        dm = WatchDaemon(["-m", "probunet", "-f", ckpt, "--bf16", "--watch", watch, "--out", dst,
                          "--cube", "128", "--poll", "0.2", "--rss-limit-mb", "1",
                          "--seed", str(SERVE_SEED)])
        try:
            dm.wait_for("INFO: serving ")
            with open(os.path.join(watch, "bad.nii"), "wb") as f:
                f.write(np.random.default_rng(0).bytes(2048))
            nifti.save(os.path.join(watch, "big.nii"), np.zeros((136, 136, 136), np.float32))
            nifti.save(os.path.join(watch, "v0.nii"), vols[0])
            dm.wait_for("served 1 volumes in")
            dm.wait_for("skipping 1 already-served")  # the re-executed daemon
            dm.wait_for("quarantining bad.nii after 3 failed loads")
            nifti.save(os.path.join(d, "v1_full.nii"), vols[1])
            with open(os.path.join(d, "v1_full.nii"), "rb") as f:
                blob = f.read()
            with open(os.path.join(watch, "v1.nii"), "wb") as f:  # an upload that stalls
                f.write(blob[:len(blob) // 2])
                f.flush()
                dm.wait_for("quarantining v1.nii after 3 failed loads")
                f.write(blob[len(blob) // 2:])
            dm.wait_for("v1.nii grew after quarantine; re-inspecting")
            dm.wait_for("served 1 volumes in", count=2)
            dm.wait_for("skipping 2 already-served")
            dm.proc.send_signal(signal.SIGINT)
            rc = dm.proc.wait(timeout=120)
        finally:
            dm.stop()
        watch_s = time.perf_counter() - t0
        log = dm.log()
        require(rc == 0 and "interrupted" in log,
                f"serve daemon: SIGINT gave rc {rc}:\n{log[-3000:]}")
        require("big.nii shape (136, 136, 136) exceeds cube 128; rejected" in log,
                f"serve daemon: no oversize reject:\n{log[-3000:]}")
        reexecs = log.count("re-exec: ")
        require(reexecs >= 2 and "-m pmpu_tpu_torch.serve -m probunet" in log,
                f"serve daemon: {reexecs} re-execs")
        require(log.count("(poll 0.2s, cuda)") == reexecs + 1,
                "serve daemon: a (re-executed) daemon did not run on the card")
        serve_outputs_equal(dst, ["v0.nii", "v1.nii"], [want[0], want_v1])
        print(f"  [{card}] watch-mode daemon (subprocess): corrupt file quarantined, oversize "
              f"rejected, stalled upload quarantined then healed, {reexecs} re-execs (each "
              f"serving on the card again, outputs bit-equal to the in-process engine), SIGINT "
              f"rc 0; {watch_s:.1f} s")
        out["watch"] = {"reexecs": reexecs, "s": watch_s}

        soak_out, soak_err = soak.communicate(timeout=900)
        soak_s = time.perf_counter() - t_soak
        require(soak.returncode == 0, f"soak exited {soak.returncode}:\n{soak_out[-2000:]}\n"
                f"{soak_err[-3000:]}")
        verdict = json.loads(soak_out.strip().splitlines()[-1])
        require(verdict["ok"] and verdict["served"] == 32 and verdict["rejects_logged"] >= 1
                and verdict["self_heals_logged"] >= 1, f"soak verdict {verdict}")
        print(f"  [{card}] soak (32 full-width 128³ volumes, a fault every 8, beside the watch "
              f"daemon): {json.dumps(verdict)}; {soak_s:.1f} s")
        out["soak"] = verdict
        with open(soak_log) as f:
            out["soak"]["rss_log"] = f.read().split("\n")

        # (e) uncertainty maps and the latent grid at full width in f32, card vs CPU
        img = synthetic_volume(128, seed=6)[0][64]
        img = img / img.max()
        eps = torch.randn((16, 1, 6), generator=torch.Generator().manual_seed(5))
        res, ms = {}, {}
        for dev in ("cuda", "cpu"):
            t32 = make_task("probunet", num_filters=FULL_WIDTH, n_classes=3, device=dev, seed=0)
            uncertainty.uncertainty_maps(t32, img, 16, eps=eps)  # warm-up
            times = {}
            for name, fn in (("uncertainty_maps", lambda: uncertainty.uncertainty_maps(
                                  t32, img, 16, eps=eps)),
                             ("sample_grid", lambda: uncertainty.sample_grid(t32, img, 3, 40.0))):
                if dev == "cuda":
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                res[dev, name] = fn()  # ends with the copy to the host
                times[name] = 1e3 * (time.perf_counter() - t0)
            ms[dev] = times
            del t32
        unc_err = max(float(np.abs(a - b).max()) for a, b in zip(
            res["cuda", "uncertainty_maps"], res["cpu", "uncertainty_maps"]))
        g_card, g_cpu = res["cuda", "sample_grid"][0], res["cpu", "sample_grid"][0]
        grid_err = float(np.abs(g_card - g_cpu).max())
        grid_scale = float(np.abs(g_cpu).max())
        print(f"  [{card}] uncertainty_maps (16 draws, 128², f32, full width): card vs CPU max "
              f"|diff| {unc_err:.3g} (allowed 1e-5); sample_grid (9 latents): {grid_err:.3g} of "
              f"logits up to {grid_scale:.3g} (allowed 1e-5 of max(1, that)); ms on the card "
              f"{ {k: round(v, 2) for k, v in ms['cuda'].items()} }, on the CPU "
              f"{ {k: round(v, 1) for k, v in ms['cpu'].items()} }")
        require(unc_err <= 1e-5, f"uncertainty_maps: card vs CPU {unc_err}")
        require(grid_err <= 1e-5 * max(1.0, grid_scale), f"sample_grid: card vs CPU {grid_err}")
        out["uncertainty"] = {"maps_max_abs_err": unc_err, "grid_max_abs_err": grid_err,
                              "grid_logit_scale": grid_scale, "ms": ms}
    finally:
        if soak is not None and soak.poll() is None:
            soak.kill()
            soak.wait()
        tmp.cleanup()

    # (f) one full-width bf16 train step (batch 8 = 4 x 2) with --nan-checks
    # against one without: bit-equal under cuDNN's deterministic algorithms;
    # ms a step of each with the default algorithms
    img, lbl = labeled_scans(2, 128, seed=90)
    vt_i = torch.from_numpy(make_view_stacks(img)).cuda()
    vt_l = torch.from_numpy(make_view_stacks(lbl)).cuda()
    index = build_index_map(lbl)
    rng = np.random.default_rng(3)
    batches = [(vt_i, vt_l, torch.from_numpy(index[rng.choice(len(index), 8, replace=False)])
                .cuda(), 1e-3) for _ in range(3)]
    task = make_task("probunet", num_filters=FULL_WIDTH, n_classes=3, dtype=torch.bfloat16,
                     seed=0, train=True)
    init = {k: t.clone() for k, t in task.net.state_dict().items()}
    step = steps.make_train_step(task, acc_steps=4, sampler=sample_batch_vt)
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs = {}
    try:
        for flag in (False, True):
            task.net.load_state_dict(init)
            task.net.zero_grad(set_to_none=True)
            st = steps.create_train_state(task, seed=0)
            enable_nan_checks(flag)
            try:
                runs[flag] = grads_of_step(step, st, batches[0])
            finally:
                enable_nan_checks(False)
    finally:
        torch.backends.cudnn.deterministic = det
    (l0, g0), (l1, g1) = runs[False], runs[True]
    require(l0 == l1 and torch.equal(g0, g1), "--nan-checks changes the train step")
    # ms a step: off, on, and each half of it alone (the forward hooks;
    # anomaly mode on the backward), in turns
    step_ms = {}
    for mode in ("off", "on", "hooks only", "anomaly only", "off"):
        st = steps.create_train_state(task, seed=0)
        enable_nan_checks(mode in ("on", "hooks only"))
        torch.autograd.set_detect_anomaly(mode in ("on", "anomaly only"))
        try:
            step_ms.setdefault(mode, []).append(time_steps(step, st, batches[:3], warmup=1)[0])
        finally:
            enable_nan_checks(False)
    print(f"  [{card}] --nan-checks, full-width bf16 step at batch 8 (4 x 2): loss and "
          f"gradients bit-equal with and without (deterministic cuDNN); ms a step "
          f"{ {k: [round(x, 1) for x in v] for k, v in step_ms.items()} } (overhead "
          f"{min(step_ms['on']) - min(step_ms['off']):.1f} ms)")
    out["nan_checks"] = {"ms_per_step": step_ms}
    return out


DIST_SEED = 90
DIST_KEYS = ("RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def dist_data(cube, n=4):
    """Phase 13's 4 seeded labeled scans, their view stacks and index."""
    from pmpu_tpu_torch.data.index_map import build_index_map
    from pmpu_tpu_torch.data.volumes import make_view_stacks

    img, lbl = labeled_scans(n, cube, seed=DIST_SEED)
    return img, lbl, make_view_stacks(img), make_view_stacks(lbl), build_index_map(lbl)


def dist_plan(index, batch, acc, seed, latent=6):
    """(rows (batch, 3) int64, eps (acc, batch // acc, latent) f32) on the CPU."""
    rng = np.random.default_rng(seed)
    g = torch.Generator().manual_seed(seed)
    rows = torch.from_numpy(index[rng.choice(len(index), batch, replace=False)]).long()
    return rows, torch.randn((acc, batch // acc, latent), generator=g)


def shard_plan(index, n_vols, per_shard, seed, latent=6):
    """``--sharded-volumes`` rows of 2 shards of ``n_vols // 2`` scans each
    (``ShardedTripleBatcher``, scan ids local to the shard) and each
    shard's eps: [(rows (per_shard, 3), eps (1, per_shard, latent))] by shard."""
    from pmpu_tpu_torch.parallel import ShardedTripleBatcher

    batch = next(ShardedTripleBatcher(index, n_vols, 2).epoch_batches(
        per_shard, np.random.default_rng(seed)))
    g = torch.Generator().manual_seed(seed)
    return [(torch.from_numpy(batch[r * per_shard:(r + 1) * per_shard]).long(),
             torch.randn((1, per_shard, latent), generator=g)) for r in range(2)]


def state_vector(net) -> torch.Tensor:
    return torch.cat([t.detach().float().reshape(-1).cpu() for t in net.state_dict().values()])


def rel_l2(got, want) -> float:
    return float((got.double() - want.double()).norm() / want.double().norm())


SMALL_CUBE = 32
# phase 13 (b): the full-width f32 data-parallel step of 2 ranks may be off
# the one-process step by this many times the one-process step's own f32
# floor (its control: BatchNorm moments summed in float64), in gradients and
# in the update (on an H100 80GB HBM3 at 700 W the readings were 1.34 and
# 0.97 at 1 pass, 1.79 and 0.23 at 4; PERF.md section 6)
FULL_WIDTH_F32_FLOORS = 3.0


def f32_plans(width, cube):
    """Phase 13 (b)'s f32 data-parallel plans: (key, width, cube, acc_steps,
    seed) of a batch of 8: at full width 1 and 4 microbatch passes, and 4
    one-pass plans of probunet 8,16 at 32² (where f32 rounding moves no
    ReLU or variance enough to pass 1e-5; at full width it does, see the
    f64 control)."""
    return ([("dp1", width, cube, 1, DIST_SEED + 3), ("dp4", width, cube, 4, DIST_SEED + 6)]
            + [(f"small{k}", (8, 16), SMALL_CUBE, 1, DIST_SEED + 10 + k) for k in range(4)])


@contextlib.contextmanager
def f64_batchnorm_moments():
    """Train-mode BatchNorm with its E[x] and E[x²] summed in float64, then
    rounded to f32 (a control: the one-process step's own sensitivity to
    the rounding of its moments)."""
    from pmpu_tpu_torch.models.unet import BatchNorm2d

    orig = BatchNorm2d.forward

    def forward(self, x):
        if not self.training:
            return orig(self, x)
        x32 = x.float()
        x64 = x32.double()
        mean = x64.mean(dim=(0, 2, 3)).float()
        var = torch.clamp((x64 * x64).mean(dim=(0, 2, 3)).float() - mean * mean, min=0.0)
        with torch.no_grad():
            for buf, stat in ((self.running_mean, mean), (self.running_var, var)):
                buf.copy_(self.momentum * buf + (1 - self.momentum) * stat)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x32 - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(x.dtype)

    BatchNorm2d.forward = forward
    try:
        yield
    finally:
        BatchNorm2d.forward = orig


def f32_agreement(got, want) -> dict:
    """Relative loss, gradient L2 and update L2 (the state minus its init)
    of a step against another from the same init."""
    return {"loss_rel": abs(got["loss"] - want["loss"]) / abs(want["loss"]),
            "grad_rel_l2": rel_l2(got["grads"], want["grads"]),
            "update_rel_l2": rel_l2(got["state"] - want["init"], want["state"] - want["init"])}


def worst_tensors(got, want, names, n=5) -> dict:
    """The ``n`` tensors of two flat gradient vectors (``names``: (name,
    numel) in order) furthest apart, as max |diff| / max |want|."""
    errs = {}
    for (name, k), g, w in zip(names, got.split([k for _, k in names]),
                               want.split([k for _, k in names])):
        errs[name] = float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))
    return dict(sorted(errs.items(), key=lambda kv: -kv[1])[:n])


class PairMean:
    """``make_train_step``'s ``parallel`` for the reference of a host-local
    step of 2 shards in one process: ``reduce`` records this shard's
    gradients, BatchNorm buffers and metrics as ``flat`` (the layout of
    ``parallel.sharding``'s all-reduce, without the flag), or with ``pair``
    (the two shards' ``flat``) puts ``(pair[0] + pair[1]) / 2`` in place."""

    def __init__(self, pair=None):
        self.pair, self.flat = pair, None

    def take(self, x):
        return x

    def share(self, micro):
        return None

    def context(self, net, share):
        import contextlib

        return contextlib.nullcontext()

    def reduce(self, state, metrics, stop):
        parts = [p.grad for p in state.params if p.grad is not None] + list(state.net.buffers())
        keys = sorted(metrics)
        flat = torch.cat([t.reshape(-1).float() for t in parts]
                         + [torch.stack([metrics[k].float() for k in keys])])
        if self.pair is None:
            self.flat = flat.clone()
            return metrics
        flat = (self.pair[0] + self.pair[1]) / 2
        with torch.no_grad():
            for t, v in zip(parts, flat.split([t.numel() for t in parts] + [len(keys)])):
                t.copy_(v.view_as(t))
        return dict(zip(keys, flat[-len(keys):]))


def dist_worker(out_dir, backend, cube, width, dev_type="cuda"):
    """One rank of phase 13 (b) (gloo, both ranks on cuda:0) or (d) (NCCL,
    rank r on cuda:r): the sharded bf16 step on this rank's 2 scans, and the
    f32 data-parallel step over 1 and 4 microbatch passes, each checked step
    from seed-0 weights and timed after, with each kernel's launches a timed
    step; then ``train_net --data-parallel --num-views 6`` (1 epoch, batch 8
    = 4 x 2, bf16) in this world, its history and kernel launches. Rank 0
    saves states and gradients, every rank a digest of its states.
    ``dev_type`` ``"cpu"``: the rehearsal without a card (gloo, not timed)."""
    import hashlib

    import torch.distributed as dist

    from pmpu_tpu_torch.config import Config
    from pmpu_tpu_torch.data.sampler import sample_batch_vt
    from pmpu_tpu_torch.data.volumes import VolumeStore
    from pmpu_tpu_torch.parallel import make_dp_train_step, make_hostlocal_dp_train_step, make_mesh
    from pmpu_tpu_torch.train import steps
    from pmpu_tpu_torch.train.loop import train_net
    from pmpu_tpu_torch.train.tasks import make_task

    rank, size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    cuda = dev_type == "cuda"
    dev = torch.device("cuda", rank if backend == "nccl" else 0) if cuda else torch.device("cpu")
    if cuda:
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{os.environ['MASTER_PORT']}",
                            rank=rank, world_size=size)
    # this process's settings as main() sets them for the reference steps
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    def timed(step, state, batches, out):
        """``out["ms"]`` a step of ``batches`` (None on the CPU) and
        ``out["launches_per_step"]`` of each kernel."""
        reset_kernel_counts()
        if cuda:
            out["ms"] = time_steps(step, state, batches)[0]
        else:
            out["ms"] = None
            for b in batches:
                step(state, *b)
        out["launches_per_step"] = {k: v / len(batches) for k, v in kernel_counts().items()}

    try:
        img, lbl, vt_i, vt_l, index = dist_data(cube)
        out = {"backend": dist.get_backend()}
        # the sharded step: this rank's 2 scans, bf16
        task = make_task("probunet", num_filters=width, dtype=torch.bfloat16, device=dev,
                         seed=0, train=True)
        state = steps.create_train_state(task, seed=0)
        rows, eps = shard_plan(index, 4, 8, DIST_SEED + 1)[rank]
        mine = slice(2 * rank, 2 * rank + 2)
        args = (torch.from_numpy(img[mine]).to(dev), torch.from_numpy(lbl[mine]).to(dev),
                rows.to(dev), 1e-3, eps.to(dev))
        step = make_hostlocal_dp_train_step(task, make_mesh())
        _, m = step(state, *args)
        out["sharded"] = {"loss": float(m["loss"]), "state": state_vector(task.net)}
        timed(step, state, [args] * 4, out["sharded"])
        del task, state, step
        # the data-parallel step, f32: full width (1 and 4 microbatch passes) and
        # probunet 8,16 at 32² (4 one-pass plans)
        data = {cube: dist_data(cube)}
        data.setdefault(SMALL_CUBE, dist_data(SMALL_CUBE))
        for key, w, cb, acc, seed in f32_plans(width, cube):
            task = make_task("probunet", num_filters=w, device=dev, seed=0, train=True)
            state = steps.create_train_state(task, seed=0)
            vt = (torch.from_numpy(data[cb][2]).to(dev), torch.from_numpy(data[cb][3]).to(dev))
            rows, eps = dist_plan(data[cb][4], 8, acc, seed)
            step = make_dp_train_step(task, make_mesh(), acc_steps=acc, sampler=sample_batch_vt)
            loss, grads = grads_of_step(step, state, (*vt, rows.to(dev), 1e-3, eps.to(dev)))
            out[key] = {"loss": loss, "grads": grads.cpu(), "state": state_vector(task.net)}
            if not key.startswith("small"):
                timed(step, state, [(*vt, rows.to(dev), 1e-3)] * 4, out[key])
            del task, state, step
        # the loop's data-parallel branch in this world: the 6-view stacks
        # precomputed on each rank, the validation steps split over the ranks
        cimg, clbl = labeled_scans(4, cube, seed=DIST_SEED + 7,
                                   block=(cube // 2 - 5, cube // 2 + 6))
        # 30 % validation: 2 steps at the card's size, one on each rank
        cfg = Config(net="probunet", num_filters=tuple(width), epochs=1, batchsize=8, val=30.0,
                     train_views=(0,), num_views=6, data_parallel=True, bf16=cuda,
                     checkpoint_dir=os.path.join(out_dir, "ck"),
                     logdir=os.path.join(out_dir, "tb"))
        reset_kernel_counts()
        t0 = time.perf_counter()
        _, _, history = train_net(cfg, VolumeStore.from_arrays(cimg, clbl), device=dev)
        sync = torch.cuda.synchronize if cuda else (lambda: None)
        sync()
        out["loop"] = {"history": {k: history[k] for k in ("train_loss", "val_loss", "val_dice")},
                       "launches": kernel_counts(), "s": time.perf_counter() - t0}
        stepped = [k for k in out if isinstance(out[k], dict) and "state" in out[k]]
        for key in stepped:
            out[key]["digest"] = hashlib.sha1(out[key]["state"].numpy().tobytes()).hexdigest()
        if rank:
            for key in stepped:
                out[key].pop("state")
                out[key].pop("grads", None)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def dp_step_costs(task, step, state, args) -> dict:
    """What the data-parallel step adds to the plain one, on the card: the
    host ms of one ``all_reduce`` of a BatchNorm's moments (2 × 512 f32)
    and of the autograd node that carries it, the BatchNorms a microbatch
    passes, and the host time by op of one step (``torch.profiler``, CPU
    activity, the 8 ops of most self time)."""
    import torch.distributed as dist

    from pmpu_tpu_torch.models.unet import BatchNorm2d
    from pmpu_tpu_torch.parallel.sharding import BatchShare

    x = torch.zeros(2, 512, device="cuda")
    share = BatchShare(1, 1)
    out = {"batchnorms": sum(isinstance(m, BatchNorm2d) for m in task.net.modules())}
    for name, fn in (("all_reduce", lambda: dist.all_reduce(x)),
                     ("moments_node", lambda: share.batch_moments(
                         x.view(2, 512, 1, 1).requires_grad_(False), dim=(0, 2, 3)))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        host = (time.perf_counter() - t0) / 200
        torch.cuda.synchronize()
        out[f"{name}_host_ms"] = 1e3 * host
        out[f"{name}_ms"] = 1e3 * (time.perf_counter() - t0) / 200
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step(state, *args)
        torch.cuda.synchronize()
    top = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:8]
    out["host_ms_by_op"] = {e.key: round(e.self_cpu_time_total / 1e3, 2) for e in top}
    out["host_calls_by_op"] = {e.key: e.count for e in top}
    print(f"  (a) data-parallel step's added costs: {out['batchnorms']} BatchNorms a "
          f"microbatch; one all_reduce of 2 × 512 f32 {out['all_reduce_host_ms']:.4f} ms of host "
          f"({out['all_reduce_ms']:.4f} ms to the end), the moments node "
          f"{out['moments_node_host_ms']:.4f} ms; host ms by op of one step (profiler): "
          f"{out['host_ms_by_op']} (calls {out['host_calls_by_op']})")
    return out


def phase_train_dist(card, dev="cuda", cube=128, width=None):
    """Phase 13: multi-device training (see the module docstring). ``dev``
    ``"cpu"`` (gloo everywhere, a small ``cube`` and ``width``) rehearses
    it without a card."""
    import contextlib

    import torch.distributed as dist

    from pmpu_tpu_torch.data import nifti
    from pmpu_tpu_torch.data.sampler import sample_batch, sample_batch_vt
    from pmpu_tpu_torch.parallel import (
        init_distributed,
        make_dp_train_step,
        make_hostlocal_dp_train_step,
        make_mesh,
        spawn_world,
    )
    from pmpu_tpu_torch.parallel.mesh import free_port
    from pmpu_tpu_torch.train import steps
    from pmpu_tpu_torch.train.tasks import make_task

    width = FULL_WIDTH if width is None else width
    cuda = dev == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    print("phase 13: multi-device training")
    out = {}
    img, lbl, vt_i, vt_l, index = dist_data(cube)
    vt = (torch.from_numpy(vt_i).to(dev), torch.from_numpy(vt_l).to(dev))
    plain = (torch.from_numpy(img).to(dev), torch.from_numpy(lbl).to(dev))

    # (a) a world of 1 (NCCL on the card)
    saved = {k: os.environ.get(k) for k in DIST_KEYS}
    os.environ.update(RANK="0", LOCAL_RANK="0", WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(free_port()))
    try:
        init_distributed(dev)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    backend = dist.get_backend()
    require(backend == ("nccl" if cuda else "gloo"), f"phase 13: world of 1 on {backend}")
    a = {}
    try:
        dtype = torch.bfloat16
        tasks = [make_task("probunet", num_filters=width, dtype=dtype, device=dev, seed=0,
                           train=True) for _ in range(2)]
        mesh = make_mesh()
        paths = {
            "data_parallel": (4, 32, sample_batch_vt, vt,
                              lambda t: make_dp_train_step(t, mesh, acc_steps=4,
                                                           sampler=sample_batch_vt)),
            "sharded_volumes": (1, 16, sample_batch, plain,
                                lambda t: make_hostlocal_dp_train_step(t, mesh)),
        }
        det = torch.backends.cudnn.deterministic
        for path, (acc, batch, sampler, data, make) in paths.items():
            states = [steps.create_train_state(t, seed=0) for t in tasks]
            tasks[1].net.load_state_dict(tasks[0].net.state_dict())  # the state copy
            dist_step = make(tasks[0])
            plain_step = steps.make_train_step(tasks[1], acc_steps=acc, sampler=sampler)
            rows, eps = dist_plan(index, batch, acc, DIST_SEED + batch)
            args = (*data, rows.to(dev), 1e-3, eps.to(dev))
            torch.backends.cudnn.deterministic = True
            try:
                got = grads_of_step(dist_step, states[0], args)
                want = grads_of_step(plain_step, states[1], args)
            finally:
                torch.backends.cudnn.deterministic = det
            same = (got[0] == want[0] and torch.equal(got[1], want[1])
                    and torch.equal(state_vector(tasks[0].net), state_vector(tasks[1].net)))
            require(same, f"phase 13 (a) {path}: the world-of-1 step is not bit-equal to the "
                          f"plain step (loss {got[0]} vs {want[0]}, gradients rel L2 "
                          f"{rel_l2(got[1], want[1]):.3g})")
            batches = [(*data, dist_plan(index, batch, acc, 1000 + i)[0].to(dev), 1e-3)
                       for i in range(8)]
            times = {}
            for name, step, state in (("plain", plain_step, states[1]),
                                      ("world1", dist_step, states[0]),
                                      ("world1_again", dist_step, states[0]),
                                      ("plain_again", plain_step, states[1])):
                reset_kernel_counts()
                if cuda:
                    times[name] = time_steps(step, state, batches)[0]
                else:
                    for b in batches:
                        step(state, *b)
                counts = kernel_counts()
                if name.startswith("world1"):
                    a.setdefault(path, {})["launches_per_step"] = {
                        k: v / len(batches) for k, v in counts.items()}
            if path == "data_parallel" and cuda:
                a[path].update(dp_step_costs(tasks[0], dist_step, states[0], batches[0]))
            launches = a[path]["launches_per_step"]
            want_gather = acc if cuda and sampler is sample_batch_vt else 0
            require(launches["gather_normalize_planes"] == want_gather
                    and sum(launches.values()) == want_gather,
                    f"phase 13 (a) {path}: launches a step {launches}, want gather {want_gather}")
            a[path].update(acc_steps=acc, batch=batch, ms=times, loss=got[0])
            print(f"  [{card}] (a) {path} step in a world of 1 ({backend}), probunet "
                  f"{','.join(map(str, width))} bf16 at {cube}², "
                  f"batch {batch} ({acc} x {batch // acc}): bit-equal to the plain step "
                  f"(loss {got[0]:.3f}, cuDNN deterministic); ms a step "
                  f"{ {k: round(v, 2) for k, v in times.items()} }; launches a step "
                  f"{ {k: v for k, v in launches.items() if v} or 'none' }")
        del tasks, states, dist_step, plain_step
    finally:
        dist.destroy_process_group()
    out["a"] = a
    if cuda:
        torch.cuda.empty_cache()

    # (c) the train CLI under torchrun (a world of 1; of 2 on 2 cards), with (b)
    # and (d) beside it
    tmp = tempfile.TemporaryDirectory()
    try:
        d = tmp.name
        cimg, clbl = labeled_scans(4, cube, seed=DIST_SEED + 7,
                                   block=(cube // 2 - 5, cube // 2 + 6))
        for i in range(4):
            nifti.save(os.path.join(d, "DATA", "images", f"scan{i}.nii"), cimg[i])
            nifti.save(os.path.join(d, "DATA", "labels", f"scan{i}.nii"),
                       clbl[i].astype(np.float32))
        env = {k: v for k, v in os.environ.items() if k not in DIST_KEYS}
        env["PYTHONPATH"] = os.pathsep.join([ROOT] + [p for p in [env.get("PYTHONPATH")] if p])
        n_cards = torch.cuda.device_count() if cuda else 0
        base = ["-m", "pmpu_tpu_torch.train", "-m", "probunet", "-d", "DATA", "--num-filters",
                ",".join(map(str, width)), "-b", "8", "-e", "1", "--train-views", "0",
                "--device", dev, *(["--bf16"] if cuda else [])]
        clis = {f"{name} x{n}": (n, [*flags, "--checkpoint-dir", f"ck_{name}_{n}"])
                for name, flags in (("data_parallel", ["--data-parallel", "--num-views", "6"]),
                                    ("sharded_volumes", ["--sharded-volumes"]))
                for n in ((1, 2) if n_cards >= 2 else (1,))}
        t_cli = time.perf_counter()
        procs = {name: subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
             str(n), *base, *flags], cwd=d, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for name, (n, flags) in clis.items()}
        worlds = {"b": "gloo", **({"d": "nccl"} if n_cards >= 2 else {})}
        pool = concurrent.futures.ThreadPoolExecutor(1)

        def run_worlds():
            res = {}
            for part, wb in worlds.items():
                wdir = os.path.join(d, f"world_{part}")
                os.makedirs(wdir)
                t0 = time.perf_counter()
                spawn_world(dist_worker, 2, (wdir, wb, cube, width, dev))
                res[part] = {"wall_s": time.perf_counter() - t0, "ranks": [
                    torch.load(os.path.join(wdir, f"rank{r}.pt"), weights_only=False)
                    for r in range(2)], "written": sorted(os.listdir(os.path.join(wdir, "ck")))}
            return res

        evals = {}
        try:
            pending = pool.submit(run_worlds)
            if n_cards < 2:
                print(f"  (d) not run: {n_cards} CUDA device(s) here; (b)'s checks under NCCL "
                      "across two cards and the CLI with --nproc-per-node 2 need 2")
            # the references in this process while (b) runs: the two shard steps
            # averaged, and the f32 one-process data-parallel steps
            task = make_task("probunet", num_filters=width, dtype=torch.bfloat16, device=dev,
                             seed=0, train=True)
            init_sd = {k: v.clone() for k, v in task.net.state_dict().items()}
            shard_args = [(torch.from_numpy(img[2 * r:2 * r + 2]).to(dev),
                           torch.from_numpy(lbl[2 * r:2 * r + 2]).to(dev), rows.to(dev), 1e-3,
                           eps.to(dev))
                          for r, (rows, eps) in enumerate(shard_plan(index, 4, 8, DIST_SEED + 1))]
            pair = []
            torch.backends.cudnn.deterministic = True
            try:
                # each shard's step from the seed-0 state records its buffer; then
                # the seed-0 state takes their mean on shard 1's rows
                for args, par in zip(shard_args + shard_args[1:],
                                     [PairMean(), PairMean(), PairMean(pair)]):
                    task.net.load_state_dict(init_sd)
                    state = steps.create_train_state(task, seed=0)
                    steps.make_train_step(task, parallel=par)(state, *args)
                    if par.pair is None:
                        pair.append(par.flat)
                ref_sharded = state_vector(task.net)
            finally:
                torch.backends.cudnn.deterministic = det
            del task, state, init_sd, pair
            # the one-process f32 steps of the same plans (cuDNN's deterministic
            # algorithms, as the ranks), and the control: the full-width step with
            # its BatchNorm moments rounded from float64
            f32 = {}
            small = dist_data(SMALL_CUBE)
            torch.backends.cudnn.deterministic = True
            try:
                for key, w, cb, acc, seed in f32_plans(width, cube) + [
                        ("f64_moments", width, cube, 1, DIST_SEED + 3)]:
                    task = make_task("probunet", num_filters=w, device=dev, seed=0, train=True)
                    init = state_vector(task.net)
                    state = steps.create_train_state(task, seed=0)
                    d_vt = vt if cb == cube else tuple(torch.from_numpy(x).to(dev)
                                                       for x in small[2:4])
                    rows, eps = dist_plan(index if cb == cube else small[4], 8, acc, seed)
                    with (f64_batchnorm_moments() if key == "f64_moments"
                          else contextlib.nullcontext()):
                        loss, grads = grads_of_step(
                            steps.make_train_step(task, acc_steps=acc, sampler=sample_batch_vt),
                            state, (*d_vt, rows.to(dev), 1e-3, eps.to(dev)))
                    names = {p: n for n, p in task.net.named_parameters()}
                    f32[key] = {"loss": loss, "grads": grads.cpu(), "state": state_vector(task.net),
                                "init": init, "names": [(names[p], p.numel())
                                                        for p in state.params
                                                        if p.grad is not None]}
                    del task, state
            finally:
                torch.backends.cudnn.deterministic = det
            run_all(procs, timeout=600)
            cli_s = time.perf_counter() - t_cli
            for name, (n, flags) in clis.items():
                ck = flags[-1]
                written = sorted(os.listdir(os.path.join(d, ck)))
                require(written == ["probunet_checkpoint0.pt", "probunet_model.pt"],
                        f"(c) {name}: the CLI wrote {written}")
                if n == 1:
                    evals[name] = subprocess.Popen(
                        [sys.executable, "-m", "pmpu_tpu_torch.eval", "-m", "probunet", "-d",
                         "DATA", "-f", os.path.join(ck, "probunet_model.pt"), "--eval-samples",
                         "2", "--device", dev, *(["--bf16"] if cuda else [])],
                        cwd=d, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                        text=True)
            b = pending.result(timeout=900)
            for part, res in b.items():
                r0, r1 = res.pop("ranks")
                for key in ("sharded", "dp1", "dp4"):
                    require(r0[key]["digest"] == r1[key]["digest"],
                            f"phase 13 ({part}) {key}: the ranks' states differ")
                require(torch.equal(r0["sharded"]["state"], ref_sharded),
                        f"phase 13 ({part}): the sharded step is not bit-equal to the two "
                        "shard steps averaged in one process (rel L2 "
                        f"{rel_l2(r0['sharded']['state'], ref_sharded):.3g})")
                # each rank's f32 step against the one-process step; the control
                # against the one-process step too
                pairs = {k: (r0[k], want) for k, want in f32.items() if k in r0}
                pairs["f64_moments"] = (f32["f64_moments"], f32["dp1"])
                agree = {k: f32_agreement(got, want) for k, (got, want) in pairs.items()}
                worst = {k: worst_tensors(got["grads"], want["grads"], want["names"], 3)
                         for k, (got, want) in pairs.items() if not k.startswith("small")}
                small = {k: v for k, v in agree.items() if k.startswith("small")}
                require(all(max(v.values()) <= 1e-5 for v in small.values()),
                        f"phase 13 ({part}): an f32 data-parallel step of probunet 8,16 at "
                        f"{SMALL_CUBE}² (1 pass) is off the one-process step by more than 1e-5: "
                        f"{small}")
                # full width: within a few times the f32 floor of the one-process
                # step (its control with f64-summed BatchNorm moments)
                floor = agree["f64_moments"]
                full = {k: {m: agree[k][m] / floor[m] for m in ("grad_rel_l2", "update_rel_l2")}
                        for k in ("dp1", "dp4")}
                require(all(x <= FULL_WIDTH_F32_FLOORS for v in full.values() for x in v.values()),
                        f"phase 13 ({part}): a full-width f32 data-parallel step is off the "
                        f"one-process step by more than {FULL_WIDTH_F32_FLOORS} x the control "
                        f"{floor}: 1 pass {agree['dp1']}, 4 passes {agree['dp4']}")
                # each kernel's launches a timed step on each rank
                launches = {k: [r[k]["launches_per_step"] for r in (r0, r1)]
                            for k in ("sharded", "dp1", "dp4")}
                for key, acc in (("sharded", 0), ("dp1", 1), ("dp4", 4)):
                    want = {n: float(acc if cuda and n == "gather_normalize_planes" else 0)
                            for n in launches[key][0]}
                    require(launches[key] == [want, want],
                            f"phase 13 ({part}) {key}: launches a step on each rank "
                            f"{launches[key]}, want {want}")
                ms = {k: [r[k]["ms"] for r in (r0, r1)] for k in ("sharded", "dp1", "dp4")}
                # the loop's data-parallel branch in this world
                loop = [r["loop"] for r in (r0, r1)]
                hist = loop[0]["history"]
                require(hist == loop[1]["history"] and len(hist["train_loss"]) == 1
                        and np.isfinite([*hist["train_loss"], *hist["val_loss"]]).all(),
                        f"phase 13 ({part}) train_net --data-parallel: histories "
                        f"{[x['history'] for x in loop]}")
                require(res["written"] == ["probunet_checkpoint0.pt", "probunet_model.pt"],
                        f"phase 13 ({part}) train_net --data-parallel wrote {res['written']}")
                loop_launches = [x["launches"] for x in loop]
                require(all(c["oblique_planes"] == (4 if cuda else 0)
                            and (c["gather_normalize_planes"] > 0) == cuda
                            and sum(c.values()) == c["oblique_planes"]
                            + c["gather_normalize_planes"] for c in loop_launches),
                        f"phase 13 ({part}) train_net --data-parallel: launches on each rank "
                        f"{loop_launches}, want oblique 4 (one a scan) and gather > 0")
                res.update(agreement=agree, f32_floor_multiples=full, launches_per_step=launches,
                           ms=ms, loop={"history": hist, "launches": loop_launches,
                                        "s": [x["s"] for x in loop]})
                label = ("gloo through the host, both ranks on cuda:0: not a multi-card speed"
                         if part == "b" else "NCCL, 2 cards")
                print(f"  [{card}] ({part}) a world of 2 ({r0['backend']}): the sharded bf16 "
                      f"step (2 scans a rank, batch 16) bit-equal to the two shard steps "
                      f"averaged in one process, the ranks' states equal; the f32 data-parallel "
                      f"step at batch 8 against one process (relative loss, gradients L2, "
                      f"update L2): probunet 8,16 at {SMALL_CUBE}², 4 one-pass plans, each "
                      f"within 1e-5: {small}; full width: 1 pass {agree['dp1']}, 4 passes "
                      f"{agree['dp4']}, beside the one-process full-width step against itself "
                      f"with its BatchNorm moments rounded from float64 (the floor of f32 "
                      f"there): {agree['f64_moments']}, multiples of that floor (checked <= "
                      f"{FULL_WIDTH_F32_FLOORS}): {full}; the tensors furthest off (max |diff| "
                      f"/ max |grad|): {worst}; gather launches a step on each rank (sharded, "
                      f"1 pass, 4 passes) "
                      f"{[[c['gather_normalize_planes'] for c in v] for v in launches.values()]}; "
                      f"ms a step ({label}): {ms}; {res['wall_s']:.1f} s of wall")
                print(f"  [{card}] ({part}) train_net --data-parallel --num-views 6 in this "
                      f"world (1 epoch, batch 8 = 4 x 2, bf16): the ranks' histories equal "
                      f"{hist}, rank 0 wrote {res['written']}, launches on each rank "
                      f"(6-view precompute, train and its share of validation) {loop_launches}, "
                      f"{[round(x['s'], 1) for x in loop]} s")
            out["b"] = b
            reports = {}
            for name, proc in evals.items():
                stdout, err = proc.communicate(timeout=600)
                require(proc.returncode == 0,
                        f"(c) eval of {name}: exited {proc.returncode}:\n{err[-4000:]}")
                reports[name] = parse_report(stdout)
                require(reports[name] and all(np.isfinite(np.concatenate(v)).all()
                                              for v in reports[name].values()),
                        f"(c) eval of {name}: no finite report:\n{stdout[-2000:]}")
        finally:
            pool.shutdown(wait=True)
            for proc in [*procs.values(), *evals.values()]:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        avg = {k: [float(np.round(x, 4)) for x in r.get("avg volume", ([np.nan],))[0]]
               for k, r in reports.items()}
        print(f"  (c) the train CLI under torch.distributed.run --standalone "
              f"({', '.join(clis)}; 1 epoch, batch 8, --data-parallel on 6 views): "
              f"{cli_s:.1f} s beside (b); each checkpoint written by rank 0 alone, those of the "
              f"worlds of 1 evaluated by the eval CLI (avg volume Dice): {avg}")
        out["c"] = {"cli_s": cli_s, "avg_dice": avg}
    finally:
        tmp.cleanup()
    return out


EVAL_DIST_PATHS = ("store", "int8", "views6", "batched", "ged")
# the kernels that run on every rank's share of the chunks (summed over the
# ranks, one process's count) and those that every rank runs whole
SPLIT_KERNELS = ("fcomb_mean_decode", "fused_qchain_stripes", "fused_qchain_whole_image")
WHOLE_KERNELS = ("gather_normalize_planes", "oblique_planes")


def eval_dist_runs(task, store, out_dir, scales, mesh, dev, paths=EVAL_DIST_PATHS) -> dict:
    """Phase 14 (a)'s runs of one side, the in-process one (``mesh`` None)
    or a rank of the world: ``evaluate_store`` at depth 2 on the 3 scans,
    with ``quantize="int8"`` (the scale file ``scales``) and with 6 views on
    the first 2, ``evaluate_store_batched`` at V = 2, ``ged_volume`` with 4
    draws (those of ``paths``; phase 15 (c) runs the first three); exports
    and entropy maps under ``out_dir/{path}`` (rank 0 alone writes). Each
    path: its value, s a volume and each kernel's launches a volume, counted
    from 0."""
    from pmpu_tpu_torch import VolumeEvaluator
    from pmpu_tpu_torch.data.volumes import VolumeStore

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    two = VolumeStore.from_arrays(np.stack([store.images[i] for i in range(2)]),
                                  np.stack([store.labels[i] for i in range(2)]))
    evs = {"store": VolumeEvaluator(task, n_samples=5, device=dev, mesh=mesh),
           "int8": VolumeEvaluator(task, n_samples=5, quantize="int8", calibration=scales,
                                   device=dev, mesh=mesh),
           "views6": VolumeEvaluator(task, n_samples=5, num_views=6, device=dev, mesh=mesh)}
    for ev in evs.values():  # cuDNN's and the kernels' first calls, the int8 tree
        ev.evaluate_volume(store.images[0], seed=1, return_views=False)
    evs["batched"] = evs["ged"] = evs["store"]
    res = {}
    for path in paths:
        ev = evs[path]
        dirs = [os.path.join(out_dir, path, k) for k in ("pred", "unc")]
        reset_kernel_counts()
        sync()
        t0 = time.perf_counter()
        if path == "ged":
            value, n = ev.ged_volume(store.images[0], store.labels[0], 4, seed=EVAL_SEED), 1
        elif path == "batched":
            value = ev.evaluate_store_batched(store, EVAL_SEED, *dirs, volumes_per_batch=2)
            n = len(store)
        else:
            s = store if path == "store" else two
            value, n = ev.evaluate_store(s, EVAL_SEED, *dirs), len(s)
        sync()
        secs = time.perf_counter() - t0
        res[path] = {"value": value, "s_per_volume": secs / n,
                     "launches_per_volume": {k: c / n for k, c in kernel_counts().items()}}
    return res


def eval_dist_worker(out_dir, backend, data, ckpt, scales, width, cli_argv, dev_type="cuda"):
    """One rank of phase 14 (a) and (b): gloo, both ranks on cuda:0 (or
    NCCL, rank r on cuda:r; or the CPU rehearsal): :func:`eval_dist_runs`
    with a mesh of the world under cuDNN's deterministic algorithms, then
    ``pmpu_tpu_torch.eval.main(cli_argv)`` in this world (cuDNN's default,
    as the CLI runs), its stdout and launches. Writes ``rank{r}.pt``."""
    import io

    import torch.distributed as dist

    from pmpu_tpu_torch import make_task
    from pmpu_tpu_torch.data.volumes import VolumeStore
    from pmpu_tpu_torch.eval import main as eval_main
    from pmpu_tpu_torch.parallel import make_mesh

    rank, size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    cuda = dev_type == "cuda"
    dev = torch.device("cuda", rank if backend == "nccl" else 0) if cuda else torch.device("cpu")
    if cuda:
        torch.cuda.set_device(dev)
        os.environ["LOCAL_RANK"] = str(dev.index)  # the eval CLI binds cuda:{LOCAL_RANK}
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{os.environ['MASTER_PORT']}",
                            rank=rank, world_size=size)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        task = make_task("probunet", num_filters=width, dtype=torch.bfloat16 if cuda else None,
                         device=dev, seed=0)
        task.net.load_state_dict(torch.load(ckpt, map_location=dev))
        store = VolumeStore.from_dirs(os.path.join(data, "images"), os.path.join(data, "labels"))
        torch.backends.cudnn.deterministic = True
        t0 = time.perf_counter()
        runs = eval_dist_runs(task, store, os.path.join(out_dir, "a"), scales, make_mesh(), dev)
        out = {"backend": dist.get_backend(), "a": runs, "a_wall_s": time.perf_counter() - t0}
        del task
        torch.backends.cudnn.deterministic = False
        cwd = os.path.join(out_dir, "cli")
        os.makedirs(cwd, exist_ok=True)
        here = os.getcwd()
        os.chdir(cwd)
        buf = io.StringIO()
        reset_kernel_counts()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                rc = eval_main(cli_argv)
        finally:
            os.chdir(here)
        out["cli"] = {"rc": rc, "stdout": buf.getvalue(), "launches": kernel_counts(),
                      "s": time.perf_counter() - t0}
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def same_value(a, b) -> bool:
    """Bit-equality of two reports (dicts of arrays) or two GED floats."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_value(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(same_value(x, y) for x, y in zip(a, b))
    return np.array_equal(np.asarray(a), np.asarray(b))


def tree_bytes(d) -> dict:
    """{relative path: bytes} of every file under ``d``."""
    out = {}
    for root, _, files in os.walk(d):
        for f in files:
            p = os.path.join(root, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, d)] = fh.read()
    return out


def epoch_lines(log: str) -> dict:
    """{epoch: {rank: (train loss, val loss)}} of the train loop's epoch lines."""
    import re

    out = {}
    for m in re.finditer(r"epoch (\d+)/\d+ done \(.*; train loss (\S+), val loss (\S+); "
                         r"rank (\d+) of \d+\)", log):
        out.setdefault(int(m[1]), {})[int(m[4])] = (m[2], m[3])
    return out


def phase_eval_dist(card, state_dict, phase9_report=None, dev="cuda", width=None):
    """Phase 14: evaluation and tools over ranks (see the module docstring).
    ``state_dict``: phase 9's model; ``phase9_report``: its in-process
    ``evaluate_store`` report, which (b)'s CLI in a world of 1 must equal.
    ``dev`` ``"cpu"`` rehearses it without a card at ``width`` (tools and
    training CLIs at the test suite's sizes)."""
    import re

    from pmpu_tpu_torch import VolumeEvaluator, make_task
    from pmpu_tpu_torch.config import Config
    from pmpu_tpu_torch.data import nifti
    from pmpu_tpu_torch.data.volumes import VolumeStore
    from pmpu_tpu_torch.parallel import spawn_world
    from pmpu_tpu_torch.tools import compare_with_reference as cwr
    from pmpu_tpu_torch.train.checkpoint import load_for_inference

    width = FULL_WIDTH if width is None else tuple(width)
    cuda = dev == "cuda"
    device = torch.device(dev)
    print("phase 14: evaluation and tools over ranks")
    t_phase = time.perf_counter()
    out = {}
    tmp = tempfile.TemporaryDirectory()
    d = tmp.name
    procs = {}
    try:
        data = os.path.join(d, "data")
        write_labeled_scans(data)
        ckpt = os.path.join(d, "probunet.pt")
        torch.save(state_dict, ckpt)
        names = sorted(os.listdir(os.path.join(data, "images")))
        env = {k: v for k, v in os.environ.items() if k not in DIST_KEYS}
        env["PYTHONPATH"] = os.pathsep.join([ROOT] + [p for p in [env.get("PYTHONPATH")] if p])

        def launch(name, args, cwd=None, extra_env=None):
            cwd = cwd or os.path.join(d, name)
            os.makedirs(cwd, exist_ok=True)
            log = open(os.path.join(d, f"{name}.log"), "w")
            # a session of its own: torchrun's workers and the soak's child
            # are ended with it
            procs[name] = (subprocess.Popen([sys.executable, *args], cwd=cwd,
                                            env={**env, **(extra_env or {})}, stdout=log,
                                            stderr=subprocess.STDOUT, text=True,
                                            start_new_session=True),
                           log, time.perf_counter())

        def finish(name, timeout=600):
            proc, log, t0 = procs[name]
            try:
                proc.wait(timeout=timeout)
            finally:
                log.close()
            with open(log.name) as f:
                text = f.read()
            require(proc.returncode == 0, f"phase 14 {name}: exited {proc.returncode}:\n"
                                          f"{text[-4000:]}")
            return text, time.perf_counter() - t0

        # (a) the one-process references in this process, under cuDNN's
        # deterministic algorithms (the int8 scale file written first)
        task = make_task("probunet", num_filters=width, dtype=torch.bfloat16 if cuda else None,
                         device=dev, seed=0)
        task.net.load_state_dict(state_dict)
        store = VolumeStore.from_dirs(os.path.join(data, "images"), os.path.join(data, "labels"))
        scales = os.path.join(d, "scales.json")
        VolumeEvaluator(task, quantize="int8", calibration=scales,
                        device=dev)._maybe_quantize(sample_vol=store.images[0])
        det = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            t0 = time.perf_counter()
            ref = eval_dist_runs(task, store, os.path.join(d, "ref"), scales, None, device)
            ref_wall = time.perf_counter() - t0
        finally:
            torch.backends.cudnn.deterministic = det
        del task
        if cuda:
            torch.cuda.empty_cache()

        # (a) and (b) in a world of 2 (gloo, both ranks on cuda:0), with nothing
        # else on the card, as the one-process references had
        cli_flags = ["-m", "probunet", "-f", ckpt, "-d", data, "--seed", str(EVAL_SEED),
                     "--num-filters", ",".join(map(str, width)), "--save-uncertainty", "unc",
                     "--ged", "2", "--data-parallel", "--device", dev,
                     *(["--bf16"] if cuda else [])]
        wdir = os.path.join(d, "world")
        os.makedirs(wdir)
        t_world = time.perf_counter()
        spawn_world(eval_dist_worker, 2, (wdir, "gloo", data, ckpt, scales, width, cli_flags, dev))
        world_s = time.perf_counter() - t_world

        # (c) and (d)'s processes, started once (a) is timed: they run beside
        # (b)'s eval CLI in a world of 1 and the weight-parity tool
        train_data = os.path.join(d, "train_data")
        cube_c = 128 if cuda else 16
        cimg, clbl = labeled_scans(4, cube_c, seed=DIST_SEED + 7,
                                   block=(cube_c // 2 - 5, cube_c // 2 + 6))
        for i in range(4):
            nifti.save(os.path.join(train_data, "images", f"scan{i}.nii"), cimg[i])
            nifti.save(os.path.join(train_data, "labels", f"scan{i}.nii"),
                       clbl[i].astype(np.float32))
        small_data = os.path.join(d, "small_data")
        simg, slbl = labeled_scans(2, 16, seed=DIST_SEED + 8, block=(4, 12))
        for i in range(2):
            nifti.save(os.path.join(small_data, "images", f"scan{i}.nii"), simg[i])
            nifti.save(os.path.join(small_data, "labels", f"scan{i}.nii"),
                       slbl[i].astype(np.float32))
        run = ["-m", "torch.distributed.run", "--standalone", "--nproc-per-node"]
        rss_card = ["-m", "pmpu_tpu_torch.train", "-m", "probunet", "-d", train_data,
                    "--num-filters", ",".join(map(str, width)), "-b", "8", "-e", "2",
                    "--train-views", "0", "--device", dev, "--rss-limit-mb", "1",
                    "--checkpoint-dir", "ck", *(["--bf16"] if cuda else [])]
        launch("rss_card", [*run, "1", *rss_card])
        launch("rss_cpu_world2", [*run, "2", "-m", "pmpu_tpu_torch.train", "-m", "unet", "-d",
                                  small_data, "--num-filters", "4,8", "-e", "2", "-b", "4",
                                  "--train-views", "0", "--data-parallel", "--device", "cpu",
                                  "--rss-limit-mb", "1", "--checkpoint-dir", "ck"],
               extra_env={"OMP_NUM_THREADS": "1"})
        soak_flags = (["--minutes", "1"] if cuda else
                      ["--cpu", "--minutes", "1", "--cube", "16", "--volumes", "2",
                       "--filters", "4,8", "--batch", "4", "--sample-every", "0.5"])
        launch("soak", ["-m", "pmpu_tpu_torch.tools.soak_stream_train", *soak_flags,
                        "--rss-limit-mb", "1", "--data", os.path.join(d, "soak", "data"),
                        "--out", os.path.join(d, "soak", "rss.csv")])
        # the converged protocol of the head-to-head (batch 4, lr 0.02): the
        # 0.5-point criterion speaks of converged quality; at the reference's
        # defaults (batch 2, lr 1e-3) 10 epochs stop mid-convergence, where two
        # random streams differ by more. The tool trains both sides with
        # cuDNN's deterministic algorithms, so this seed's reading repeats
        train_flags = ["-e", "10", "-b", "4", "-l", "0.02", "-p", "10",
                       *(["--filters", "16,32", "--cube", "32"] if cuda else
                         ["--filters", "4,8", "--cube", "16", "--n-train", "6", "--device",
                          "cpu"])]
        launch("compare_train", ["-m", "pmpu_tpu_torch.tools.compare_with_reference", "--train",
                                 "--task", "landmark", *train_flags])

        launch("eval_cli_world1", [*run, "1", "-m", "pmpu_tpu_torch.eval", *cli_flags])
        pargs = cwr.parser().parse_args(
            ["--model", "probunet", "--filters", ",".join(map(str, width)), "--cube",
             "128" if cuda else "24", "--device", dev])
        (parity,) = cwr.weight_parity(pargs)
        cli1, cli1_s = finish("eval_cli_world1")
        ranks = [torch.load(os.path.join(wdir, f"rank{r}.pt"), weights_only=False)
                 for r in range(2)]

        # (a): every path bit-equal on both ranks, rank 0's exports byte-equal
        launches = {}
        for path in EVAL_DIST_PATHS:
            for r, res in enumerate(ranks):
                require(same_value(res["a"][path]["value"], ref[path]["value"]),
                        f"phase 14 (a) {path}: rank {r}'s result differs from one process's")
            if path != "ged":
                for sub in ("pred", "unc"):
                    got = tree_bytes(os.path.join(wdir, "a", path, sub))
                    want = tree_bytes(os.path.join(d, "ref", path, sub))
                    require(len(want) and got == want,
                            f"phase 14 (a) {path}/{sub}: rank 0's files differ from one "
                            f"process's ({sorted(got)} vs {sorted(want)})")
            per_rank = [res["a"][path]["launches_per_volume"] for res in ranks]
            one = ref[path]["launches_per_volume"]
            launches[path] = {k: [c[k] for c in per_rank] for k in one}
            if cuda:
                for k in SPLIT_KERNELS:
                    require(abs(sum(c[k] for c in per_rank) - one[k]) < 1e-9,
                            f"phase 14 (a) {path}: {k} launches a volume {launches[path][k]} "
                            f"do not sum to one process's {one[k]}")
                for k in WHOLE_KERNELS:
                    require(all(c[k] == one[k] for c in per_rank),
                            f"phase 14 (a) {path}: {k} launches a volume {launches[path][k]}, "
                            f"one process's {one[k]} on each rank")
                ran = [k for k, c in one.items() if c]
                require(ran and all(any(c[k] for c in per_rank) for k in ran),
                        f"phase 14 (a) {path}: launches {launches[path]}")
        s_vol = {p: {"world2": [res["a"][p]["s_per_volume"] for res in ranks],
                     "one_process": ref[p]["s_per_volume"]} for p in EVAL_DIST_PATHS}
        out["a"] = {"launches_per_volume": launches, "s_per_volume": s_vol,
                    "ref_wall_s": ref_wall, "world_wall_s": world_s,
                    "ged": ref["ged"]["value"], "fused_dice": ref["store"]["value"]["fused"].tolist()}
        label = ("gloo through the host, one card: not a multi-card speed" if cuda
                 else "CPU rehearsal")
        print(f"  [{card}] (a) a world of 2 ({ranks[0]['backend']}, both ranks on {dev}), probunet "
              f"{','.join(map(str, width))}, 5 samples, 3 labeled scans: evaluate_store at depth "
              f"2 (3 views), int8 (the in-process scale file) and 6 views on 2 scans, "
              f"evaluate_store_batched at V = 2, ged_volume with 4 draws: every report, GED and "
              f"export bit-equal to one process under cuDNN's deterministic algorithms "
              f"(GED {ref['ged']['value']:.6f}); launches a volume on each rank {launches}")
        print(f"  [{card}] (a) s/volume, 2 ranks (each) beside one process, each timed with "
              f"nothing else on the card ({label}): "
              f"{ {p: ([round(x, 4) for x in v['world2']], round(v['one_process'], 4)) for p, v in s_vol.items()} }")

        # (b) the eval CLI: in a world of 1 under torchrun, and main() in (a)'s world
        def report_part(stdout):
            return [ln for ln in stdout.splitlines()
                    if re.match(REPORT_LINE, ln.strip()) or ln.startswith("GED^2")]

        want_report = phase9_report if phase9_report is not None else report_lines(
            ref["store"]["value"])
        cli1_diff = report_diff(parse_report(cli1), want_report)
        require(cli1_diff <= 1e-6, f"phase 14 (b): the eval CLI in a world of 1 differs from "
                                   f"the in-process report by {cli1_diff}")
        c0, c1 = (res["cli"] for res in ranks)
        require(c0["rc"] == 0 and c1["rc"] == 0 and c1["stdout"] == "",
                f"phase 14 (b) eval.main in a world of 2: rc {c0['rc']}, {c1['rc']}; rank 1 "
                f"printed {c1['stdout'][:500]!r}")
        require(report_part(c0["stdout"]) == report_part(cli1) and len(report_part(cli1)) == 5,
                f"phase 14 (b): rank 0's report {report_part(c0['stdout'])} is not the world of "
                f"1's {report_part(cli1)}")
        one_dir = os.path.join(d, "eval_cli_world1")
        for sub in ("predictions", "unc"):
            got, want = tree_bytes(os.path.join(wdir, "cli", sub)), tree_bytes(
                os.path.join(one_dir, sub))
            require(sorted(want) == names and got == want,
                    f"phase 14 (b) {sub}: the world of 2's files differ from one process's")
        require(sorted(os.listdir(os.path.join(wdir, "cli"))) == ["predictions", "unc"],
                f"phase 14 (b): the world of 2 wrote {os.listdir(os.path.join(wdir, 'cli'))}")
        cli_launches = [res["cli"]["launches"] for res in ranks]
        out["b"] = {"report_diff_world1": cli1_diff, "world1_s": cli1_s,
                    "world2_s": [res["cli"]["s"] for res in ranks], "launches": cli_launches}
        print(f"  [{card}] (b) python -m torch.distributed.run --nproc-per-node 1 -m "
              f"pmpu_tpu_torch.eval --data-parallel: report within {cli1_diff:.3g} of phase 9's "
              f"in-process one ({cli1_s:.1f} s, process start included); eval.main in (a)'s "
              f"world of 2: rank 0's report and GED line equal to it, predictions/ and unc/ "
              f"written once, byte-equal ({[round(x, 1) for x in out['b']['world2_s']]} s); "
              f"launches on each rank {cli_launches}")

        # (d) weight parity, in this process beside (b)'s eval CLI, (c) and (d)
        require(parity["argmax_agreement"] >= 0.999,
                f"phase 14 (d) compare_with_reference: argmax agreement "
                f"{parity['argmax_agreement']}")
        out["d"] = {"parity": parity}
        print(f"  [{card}] (d) compare_with_reference, probunet {','.join(map(str, width))} f32, "
              f"prior mean, one {pargs.cube}³ volume: max |Δprob| "
              f"{parity['max_abs_prob_diff']:.3g}, argmax agreement "
              f"{100 * parity['argmax_agreement']:.4f} %, wall reference loop "
              f"{parity['wall_ref_s']:.2f} s, the port's engine {parity['wall_ours_s']:.3f} s")

        # (c) --rss-limit-mb 1 in a world
        log, rss_s = finish("rss_card")
        ck = os.path.join(d, "rss_card", "ck")
        written = sorted(os.listdir(ck))
        epochs = epoch_lines(log)
        require(log.count("re-exec for bounded RSS") == 1 and sorted(epochs) == [1, 2]
                and written == ["probunet_checkpoint0.pt", "probunet_checkpoint1.pt",
                                "probunet_model.pt", "probunet_rss_resume.pt"],
                f"phase 14 (c) on the card: wrote {written}, epochs {epochs}:\n{log[-3000:]}")
        task, _ = load_for_inference(os.path.join(ck, "probunet_model.pt"), Config(), device=dev)
        r = VolumeEvaluator(task, device=dev).evaluate_volume(cimg[0], clbl[0])
        require(bool(torch.isfinite(r["fused"]).all()), "phase 14 (c): the model's evaluation")
        del task
        log2, rss2_s = finish("rss_cpu_world2")
        epochs2 = epoch_lines(log2)
        execs = [log2.count(f"(rank {k}) against --rss-limit-mb 1 after epoch 1") for k in (0, 1)]
        written2 = sorted(os.listdir(os.path.join(d, "rss_cpu_world2", "ck")))
        require(execs == [1, 1] and log2.count("re-exec for bounded RSS") == 2
                and sorted(epochs2) == [1, 2]
                and all(sorted(e) == [0, 1] and e[0] == e[1] for e in epochs2.values())
                and written2 == ["unet_checkpoint0.pt", "unet_checkpoint1.pt", "unet_model.pt",
                                 "unet_rss_resume.pt"],
                f"phase 14 (c) a CPU world of 2: re-execs {execs}, epochs {epochs2}, wrote "
                f"{written2}:\n{log2[-3000:]}")
        out["c"] = {"card_s": rss_s, "cpu_world2_s": rss2_s, "card_epochs": epochs,
                    "cpu_epochs": epochs2, "dice": r["dice"].tolist()}
        print(f"  [{card}] (c) --rss-limit-mb 1 -e 2: the train CLI under torch.distributed.run "
              f"--nproc-per-node 1 ({'NCCL' if cuda else 'gloo'}, {','.join(map(str, width))}): "
              f"one re-exec into a fresh rendezvous, epochs {epochs}, rank 0 wrote {written}, the "
              f"model evaluated (Dice {np.round(r['dice'][-1], 4).tolist()}), {rss_s:.1f} s; a "
              f"CPU world of 2 (gloo, unet 4,8): each rank re-executed once, equal losses "
              f"{epochs2}, {rss2_s:.1f} s")

        # (d) the tools' processes
        text, cmp_s = finish("compare_train", timeout=900)
        require("PASS - trained val Dice within" in text,
                f"phase 14 (d) compare_with_reference --train:\n{text[-3000:]}")
        head = [ln.strip() for ln in text.splitlines()
                if ln.startswith(("reference fused", "pmpu_tpu_torch fused", "|delta|",
                                  "train wall"))]
        text, soak_s = finish("soak", timeout=900)
        line = [ln for ln in text.splitlines() if ln.startswith("SOAK ")]
        require(line, f"phase 14 (d) soak_stream_train: no summary:\n{text[-3000:]}")
        soak = json.loads(line[-1][len("SOAK "):])
        require(soak["exit_code"] == 0 and soak["reexecs"] >= 1
                and soak["sigterm_interrupted_save"],
                f"phase 14 (d) soak_stream_train: {soak}")
        out["d"].update(train=head, train_s=cmp_s, soak=soak, soak_s=soak_s)
        print(f"  [{card}] (d) compare_with_reference --train --task landmark "
              f"{' '.join(train_flags)}: PASS; {head}; {cmp_s:.1f} s")
        print(f"  [{card}] (d) soak_stream_train {' '.join(soak_flags)} --rss-limit-mb 1: "
              f"creep {soak['creep_mb_per_min_tail']} MB/min, RSS {soak['rss_min_mb']}–"
              f"{soak['rss_max_mb']} MB, {soak['epochs_done']} epochs, {soak['reexecs']} "
              f"re-execs, SIGTERM: rc {soak['exit_code']} with INTERRUPTED.pth; {soak_s:.1f} s")

        n_cards = torch.cuda.device_count() if cuda else 0
        if n_cards < 2:
            print(f"  (e) not run: {n_cards} CUDA device(s) here; (a) under NCCL across two "
                  "cards and the eval CLI with --nproc-per-node 2 need 2")
        else:
            edir = os.path.join(d, "world_nccl")
            os.makedirs(edir)
            spawn_world(eval_dist_worker, 2, (edir, "nccl", data, ckpt, scales, width,
                                              cli_flags, dev))
            for r in range(2):
                res = torch.load(os.path.join(edir, f"rank{r}.pt"), weights_only=False)
                for path in EVAL_DIST_PATHS:
                    require(same_value(res["a"][path]["value"], ref[path]["value"]),
                            f"phase 14 (e) {path}: rank {r} under NCCL differs from one process")
            launch("eval_cli_world2", [*run, "2", "-m", "pmpu_tpu_torch.eval", *cli_flags])
            cli2, _ = finish("eval_cli_world2")
            require(report_part(cli2) == report_part(cli1),
                    "phase 14 (e): the eval CLI over 2 cards differs from one process")
            print(f"  [{card}] (e) (a) under NCCL on 2 cards bit-equal; the eval CLI with "
                  "--nproc-per-node 2 prints one process's report")
        out["s"] = time.perf_counter() - t_phase
    finally:
        for proc, log, _ in procs.values():
            with contextlib.suppress(ProcessLookupError):
                os.killpg(proc.pid, signal.SIGKILL)  # the whole session
            proc.wait()
            log.close()
        tmp.cleanup()
    return out

# phase 15: the dryrun's data (``__graft_entry__.py:72-76``) and its legs
TP_ROWS, TP_LR = 16, 1e-4  # the dryrun's 2 x 8 devices rows and its lr
# the first step's gathered gradients before the clip against one
# process's: (max |Δ| of each tensor over its max |gradient|, relative L2 of
# all) at most these, or at the full-width legs FULL_WIDTH_F32_FLOORS times
# the one-process step's own f32 floor (its control: BatchNorm moments
# summed in float64) where that is larger; a gradient summed twice or
# never over the model row is off by half its tensor's size or more, which
# a bound of TP_GRAD_BLIND or more could not see. On an H100 80GB HBM3 at
# 700 W the readings were 3.67e-6 and 1.89e-7 (8,16), 1.99e-2 and 1.86e-3
# (1x2 full width, prior.encoder.layers.17.weight: its control read
# 1.99e-2 and 1.92e-3, a BatchNorm over 16 rows of 4² maps) and 1.6e-5 and
# 1.2e-5 (2x2); PERF.md section 6
TP_GRAD_BOUNDS, TP_GRAD_BLIND = (1e-4, 1e-5), 0.25
TP_EVAL_PATHS = ("store", "int8", "views6")


def tp_data():
    """The dryrun's 2 seeded 16³ scans (labels 0..2 everywhere), their view
    stacks and the first 16 rows of their unfiltered index."""
    from pmpu_tpu_torch.data.index_map import build_index_map
    from pmpu_tpu_torch.data.volumes import make_view_stacks

    rng = np.random.default_rng(0)
    img = rng.random((2, 16, 16, 16)).astype(np.float32)
    lbl = rng.integers(0, 3, size=(2, 16, 16, 16)).astype(np.int32)
    rows = torch.from_numpy(build_index_map(lbl, filter=False)[:TP_ROWS]).long()
    return img, lbl, make_view_stacks(img), make_view_stacks(lbl), rows


def tp_legs(width):
    """(key, width, min_channels, acc_steps, layout) of phase 15's steps:
    the dryrun's probunet 8,16 leg and its full-width leg, and the
    full-width leg on the view-stack sampler (the gather kernel). Off the
    card ``width`` stands in for the full width, at min_channels 8."""
    full = 64 if tuple(width) == FULL_WIDTH else 8
    return (("probunet_8_16", (8, 16), 16, 2, "plain"), ("full", tuple(width), full, 1, "plain"),
            ("full_vt", tuple(width), full, 1, "vt"))


def tp_leg_args(leg, dev):
    """A leg's step arguments after the state: the stacks of its layout, the
    rows, the lr and seeded eps (acc_steps, rows / acc_steps, 6)."""
    img, lbl, vt_i, vt_l, rows = tp_data()
    stacks = (vt_i, vt_l) if leg[4] == "vt" else (img, lbl)
    eps = torch.randn((leg[3], TP_ROWS // leg[3], 6),
                      generator=torch.Generator().manual_seed(DIST_SEED + leg[3]))
    return (*(torch.from_numpy(a).to(dev) for a in stacks), rows.to(dev), TP_LR, eps.to(dev))


def param_vector(net) -> torch.Tensor:
    return torch.cat([p.detach().float().reshape(-1).cpu() for p in net.parameters()])


def param_bytes(net) -> int:
    return sum(p.numel() * p.element_size() for p in net.parameters())


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms inside, the setting restored after."""
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = det


@contextlib.contextmanager
def pre_clip_grads(net):
    """Inside: the gradients that the step's first clip is given, before it
    clips them, by parameter name (copies on their device), in the dict
    yielded."""
    names = {p: n for n, p in net.named_parameters()}
    clip, seen = torch.nn.utils.clip_grad_value_, {}

    def spy(params, value):
        params = list(params)
        if not seen:
            seen.update({names[p]: p.grad.detach().clone() for p in params
                         if p.grad is not None})
        return clip(params, value)

    torch.nn.utils.clip_grad_value_ = spy
    try:
        yield seen
    finally:
        torch.nn.utils.clip_grad_value_ = clip


def grad_diffs(got: dict, want: dict) -> tuple:
    """(the largest over tensors of max |Δ| / max |gradient|, the tensor
    that has it, relative L2 of all the gradients) of ``got`` against
    ``want``, both {name: whole f32 host tensor}."""
    if got.keys() != want.keys():
        return float("inf"), sorted(set(got) ^ set(want))[:3], float("inf")
    per = {k: float((got[k] - w).abs().max() / w.abs().max().clamp_min(1e-30))
           for k, w in want.items()}
    worst = max(per, key=per.get)
    flat = [torch.cat([d[k].reshape(-1) for k in sorted(want)]) for d in (got, want)]
    return per[worst], worst, float((flat[0] - flat[1]).norm() / flat[1].norm())


def tp_worker(out_dir, backend, mesh_shape, legs, evaluation=None, dev_type="cuda"):
    """One rank of phase 15: (a), (b) or (d)'s legs on a ``mesh_shape``
    mesh (gloo, every rank on cuda:0; or NCCL, rank r on cuda:r; or the CPU
    rehearsal): each leg's checked step from seed-0 weights, f32, with the
    state channel-sharded, its loss, this rank's and the whole model's
    parameter bytes, the gathered parameters (rank 0), then ms a step and
    each kernel's launches a step over 4 timed steps; then with
    ``evaluation`` = (data dir, state_dict file, scale file, width) (c)'s
    ``evaluate_store`` runs on the mesh. Writes ``rank{r}.pt``."""
    import torch.distributed as dist

    from pmpu_tpu_torch import make_task
    from pmpu_tpu_torch.data.sampler import sample_batch, sample_batch_vt
    from pmpu_tpu_torch.data.volumes import VolumeStore
    from pmpu_tpu_torch.parallel import (
        gather_state,
        make_dp_train_step,
        make_mesh,
        make_state_shardings,
        shard_state,
    )
    from pmpu_tpu_torch.parallel.tensor import gather_dim0
    from pmpu_tpu_torch.train import steps

    rank, size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    cuda = dev_type == "cuda"
    dev = torch.device("cuda", rank if backend == "nccl" else 0) if cuda else torch.device("cpu")
    if cuda:
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{os.environ['MASTER_PORT']}",
                            rank=rank, world_size=size)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        mesh = make_mesh(*mesh_shape)
        out = {"backend": dist.get_backend(), "legs": {}}
        for leg in legs:
            key, width, min_channels, acc, layout = leg
            task = make_task("probunet", num_filters=width, device=dev, seed=0, train=True)
            state = steps.create_train_state(task, seed=0)
            whole_bytes = param_bytes(task.net)
            shardings = make_state_shardings(state, mesh, min_channels)
            shard_state(state, shardings)
            step = make_dp_train_step(task, mesh, acc_steps=acc,
                                      sampler=sample_batch_vt if layout == "vt" else sample_batch)
            args = tp_leg_args(leg, dev)
            with deterministic_cudnn(), pre_clip_grads(task.net) as grads:
                _, m = step(state, *args)
            res = {"loss": float(m["loss"]), "param_bytes": param_bytes(task.net),
                   "whole_param_bytes": whole_bytes}
            whole = param_vector(gather_state(state, shardings).net)
            grads = {k: (gather_dim0(g, mesh) if shardings.momentum[k] else g).float().cpu()
                     for k, g in grads.items()}
            if rank == 0:
                res["params"], res["grads"] = whole, grads
            reset_kernel_counts()
            batches = [args[:-1]] * 6
            if cuda:
                res["ms"] = time_steps(step, state, batches)[0]
            else:
                res["ms"] = None
                for b in batches:
                    step(state, *b)
            res["launches_per_step"] = {k: v / len(batches) for k, v in kernel_counts().items()}
            out["legs"][key] = res
            del task, state, step
        if evaluation is not None:
            data, ckpt, scales, width = evaluation
            task = make_task("probunet", num_filters=width, dtype=torch.bfloat16 if cuda else None,
                             device=dev, seed=0)
            task.net.load_state_dict(torch.load(ckpt, map_location=dev))
            store = VolumeStore.from_dirs(os.path.join(data, "images"),
                                          os.path.join(data, "labels"))
            two = VolumeStore.from_arrays(store.images[:2], store.labels[:2])
            torch.backends.cudnn.deterministic = True
            t0 = time.perf_counter()
            out["eval"] = eval_dist_runs(task, two, os.path.join(out_dir, "eval"), scales, mesh,
                                         dev, TP_EVAL_PATHS)
            out["eval_wall_s"] = time.perf_counter() - t0
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def tp_reference(leg, dev, control: bool = False) -> dict:
    """A leg's one-process step on ``dev`` from the same seed-0 weights and
    eps, under cuDNN's deterministic algorithms as the ranks' checked step:
    the loss, the gradients before its clip, the parameters after it, ms a
    step over 4 timed steps; ``control``: the same step with its BatchNorm
    moments summed in float64 (the gradients only), the one-process step's
    own f32 floor."""
    from pmpu_tpu_torch import make_task
    from pmpu_tpu_torch.data.sampler import sample_batch, sample_batch_vt
    from pmpu_tpu_torch.train import steps

    _, width, _, acc, layout = leg
    task = make_task("probunet", num_filters=width, device=dev, seed=0, train=True)
    state = steps.create_train_state(task, seed=0)
    step = steps.make_train_step(task, acc_steps=acc,
                                 sampler=sample_batch_vt if layout == "vt" else sample_batch)
    args = tp_leg_args(leg, dev)
    moments = f64_batchnorm_moments() if control else contextlib.nullcontext()
    with deterministic_cudnn(), moments, pre_clip_grads(task.net) as grads:
        _, m = step(state, *args)
    out = {"grads": {k: g.float().cpu() for k, g in grads.items()}}
    if control:
        return out
    out.update(loss=float(m["loss"]), params=param_vector(task.net))
    out["ms"] = time_steps(step, state, [args[:-1]] * 6)[0] if dev.type == "cuda" else None
    return out


def tp_world(worker_args, n, d, name):
    """Spawn ``tp_worker`` in a world of ``n`` under ``d/name``; the ranks'
    results and the wall seconds."""
    from pmpu_tpu_torch.parallel import spawn_world

    wdir = os.path.join(d, name)
    os.makedirs(wdir)
    t0 = time.perf_counter()
    spawn_world(tp_worker, n, (wdir, *worker_args))
    return ([torch.load(os.path.join(wdir, f"rank{r}.pt"), weights_only=False)
             for r in range(n)], time.perf_counter() - t0)


def phase_tensor_parallel(card, state_dict, dev="cuda", width=None):
    """Phase 15: tensor parallelism over the mesh's model axis (see the
    module docstring). ``state_dict``: phase 9's model. ``dev`` ``"cpu"``
    rehearses it without a card at ``width`` (legs and evaluation)."""
    from pmpu_tpu_torch import VolumeEvaluator, make_task
    from pmpu_tpu_torch.data.volumes import VolumeStore

    width = FULL_WIDTH if width is None else tuple(width)
    cuda = dev == "cuda"
    device = torch.device(dev)
    print("phase 15: tensor parallelism over the model axis")
    t_phase = time.perf_counter()
    legs = tp_legs(width)
    label = ("gloo through the host, ranks sharing one card: not a multi-card speed" if cuda
             else "CPU rehearsal")
    out = {"legs": {}}
    tmp = tempfile.TemporaryDirectory()
    d = tmp.name
    try:
        # the one-process references: each leg's plain step, the evaluator's runs
        refs = {leg[0]: tp_reference(leg, device) for leg in legs}
        floors = {leg[0]: grad_diffs(tp_reference(leg, device, control=True)["grads"],
                                     refs[leg[0]]["grads"])
                  for leg in legs if leg[0].startswith("full")}
        data = os.path.join(d, "data")
        write_labeled_scans(data)
        ckpt = os.path.join(d, "probunet.pt")
        torch.save(state_dict, ckpt)
        task = make_task("probunet", num_filters=width, dtype=torch.bfloat16 if cuda else None,
                         device=dev, seed=0)
        task.net.load_state_dict(state_dict)
        store = VolumeStore.from_dirs(os.path.join(data, "images"), os.path.join(data, "labels"))
        two = VolumeStore.from_arrays(store.images[:2], store.labels[:2])
        scales = os.path.join(d, "scales.json")
        VolumeEvaluator(task, quantize="int8", calibration=scales,
                        device=dev)._maybe_quantize(sample_vol=two.images[0])
        det = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            ref_eval = eval_dist_runs(task, two, os.path.join(d, "ref"), scales, None, device,
                                      TP_EVAL_PATHS)
        finally:
            torch.backends.cudnn.deterministic = det
        del task
        if cuda:
            torch.cuda.empty_cache()

        # (a) and (c): a 1x2 mesh of 2 gloo ranks; (b): the full-width leg on 2x2
        (a, a_s) = tp_world(("gloo", (1, 2), legs, (data, ckpt, scales, width), dev), 2, d, "a")
        (b, b_s) = tp_world(("gloo", (2, 2), legs[1:2], None, dev), 4, d, "b")
        worlds = {"world2": (a, legs), "world4": (b, legs[1:2])}
        n_cards = torch.cuda.device_count() if cuda else 0
        if n_cards >= 2:
            (nccl, _) = tp_world(("nccl", (1, 2), legs, None, dev), 2, d, "d")
            worlds["world2_nccl"] = (nccl, legs)

        for world, (ranks, wlegs) in worlds.items():
            for leg in wlegs:
                key, w, min_channels, acc, layout = leg
                got = [r["legs"][key] for r in ranks]
                ref = refs[key]
                loss_rel = max(abs(g["loss"] - ref["loss"]) / abs(ref["loss"]) for g in got)
                diff = (got[0]["params"] - ref["params"]).abs()
                bound = 1e-4 + 1e-3 * ref["params"].abs()
                grad_rel, grad_worst, grad_l2 = grad_diffs(got[0]["grads"], ref["grads"])
                floor = floors.get(key)
                bounds = TP_GRAD_BOUNDS if floor is None else tuple(
                    max(b, FULL_WIDTH_F32_FLOORS * f) for b, f in zip(TP_GRAD_BOUNDS,
                                                                      floor[::2]))
                print(f"  [{card}] {world} {key}: gradients before the clip against one "
                      f"process's: max |Δ| / max |g| {grad_rel:.3g} ({grad_worst}), relative "
                      f"L2 {grad_l2:.3g}; bounds {bounds}"
                      + ("" if floor is None else
                         f" (the f64-moment control: {floor[0]:.3g} ({floor[1]}), "
                         f"{floor[2]:.3g})"))
                require(max(bounds) < TP_GRAD_BLIND,
                        f"phase 15 {world} {key}: the gradient bounds {bounds} could not see "
                        f"a gradient summed twice or never")
                require(loss_rel <= 1e-4 and bool((diff <= bound).all()),
                        f"phase 15 {world} {key}: loss rel {loss_rel:.3g}, params max |Δ| "
                        f"{float(diff.max()):.3g} ({int((diff > bound).sum())} outside 1e-4 + "
                        f"1e-3·|x|)")
                require(grad_rel <= bounds[0] and grad_l2 <= bounds[1],
                        f"phase 15 {world} {key}: the gradients before the clip differ from "
                        f"one process's: {grad_rel:.3g} of a tensor's max ({grad_worst}), "
                        f"relative L2 {grad_l2:.3g}, bounds {bounds}")
                losses = [g["loss"] for g in got]
                require(len(set(losses)) == 1,
                        f"phase 15 {world} {key}: the ranks' losses differ {losses}")
                launches = [g["launches_per_step"] for g in got]
                want_gather = acc if cuda and layout == "vt" else 0
                require(all(c["gather_normalize_planes"] == want_gather
                            and sum(c.values()) == want_gather for c in launches),
                        f"phase 15 {world} {key}: launches a step {launches}, want gather "
                        f"{want_gather} on each rank")
                entry = {"loss": got[0]["loss"], "loss_ref": ref["loss"], "loss_rel": loss_rel,
                         "params_max_abs_diff": float(diff.max()),
                         "grad_max_rel_diff": grad_rel, "grad_max_rel_diff_at": grad_worst,
                         "grad_rel_l2": grad_l2, "grad_bounds": bounds, "grad_floor": floor,
                         "param_bytes": [g["param_bytes"] for g in got],
                         "whole_param_bytes": got[0]["whole_param_bytes"],
                         "ms": [g["ms"] for g in got], "ms_one_process": ref["ms"],
                         "launches_per_step": launches, "min_channels": min_channels}
                out["legs"][f"{key}_{world}"] = entry
                part = "(d)" if world.endswith("nccl") else "(b)" if world == "world4" else "(a)"
                mb = [round(x / 2**20, 2) for x in entry["param_bytes"]]
                print(f"  [{card}] {part} {key} ({','.join(map(str, w))}, min_channels "
                      f"{min_channels}, {layout}, {TP_ROWS} rows at 16² = {acc} x "
                      f"{TP_ROWS // acc}, f32) on a {'1x2' if len(got) == 2 else '2x2'} mesh "
                      f"({ranks[0]['backend']}): loss rel {loss_rel:.3g} (bound 1e-4), params "
                      f"max |Δ| {entry['params_max_abs_diff']:.3g} (bound 1e-4 + 1e-3·|x|) "
                      f"against one process's step on {dev}; parameter MB a rank {mb} of the "
                      f"whole model's {entry['whole_param_bytes'] / 2**20:.2f}; ms a step "
                      f"{[None if x is None else round(x, 2) for x in entry['ms']]} beside one "
                      f"process's {None if ref['ms'] is None else round(ref['ms'], 2)} "
                      f"({label}); launches a step on each rank "
                      f"{[{k: v for k, v in c.items() if v} or 'none' for c in launches]}")
        if n_cards < 2:
            print(f"  (d) not run: {n_cards} CUDA device(s) here; (a) under NCCL across two "
                  "cards needs 2")

        # (c): the evaluator on the 1x2 mesh, bit-equal to one process on each rank
        launches = {}
        for path in TP_EVAL_PATHS:
            one = ref_eval[path]["launches_per_volume"]
            per_rank = [r["eval"][path]["launches_per_volume"] for r in a]
            for i, r in enumerate(a):
                require(same_value(r["eval"][path]["value"], ref_eval[path]["value"]),
                        f"phase 15 (c) {path}: rank {i}'s result differs from one process's")
                require(per_rank[i] == one, f"phase 15 (c) {path}: rank {i}'s launches a volume "
                                            f"{per_rank[i]}, one process's {one}")
            ran = [k for k, c in one.items() if c]
            require(not cuda or ran, f"phase 15 (c) {path}: no kernel ran ({one})")
            launches[path] = {k: [c[k] for c in per_rank] for k in one}
        s_vol = {p: ([round(r["eval"][p]["s_per_volume"], 4) for r in a],
                     round(ref_eval[p]["s_per_volume"], 4)) for p in TP_EVAL_PATHS}
        out["eval"] = {"launches_per_volume": launches, "s_per_volume": s_vol,
                       "wall_s": [r["eval_wall_s"] for r in a]}
        print(f"  [{card}] (c) VolumeEvaluator on the 1x2 mesh, probunet "
              f"{','.join(map(str, width))}, 5 samples, 2 labeled scans: evaluate_store (3 "
              f"views), int8 and 6 views bit-equal to one process on both ranks under cuDNN's "
              f"deterministic algorithms; launches a volume on each rank "
              f"{ {p: {k: v for k, v in c.items() if any(v)} for p, c in launches.items()} }; "
              f"s/volume (each rank, one process; {label}) {s_vol}")
        out["world_s"] = {"a": a_s, "b": b_s}
        out["s"] = time.perf_counter() - t_phase
        print(f"  phase 15: {out['s']:.1f} s (world of 2 {a_s:.1f} s, of 4 {b_s:.1f} s)")
    finally:
        tmp.cleanup()
    return out


# phase 16: the remaining tools; demo_mmap_ramcap's dataset on the card: 4
# volumes of 128³, a pool of 64 MiB (the mmap children's VmData repeated
# within 1.3 MiB over three runs at 8 and 16 volumes on an H100 80GB HBM3
# at 700 W)
RAMCAP_DATA = (4, 128)
DRIFT_BOUND = 1e-4  # tests/test_torch_tools_rest.py's bound over 10 CPU steps
LEAK_GATE_MB = 1.0  # creep an iteration after warm-up (the TPU client: 8.00)


def quiet(fn, argv):
    """``fn(argv)`` with its standard output captured → (result, output)."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = fn(argv)
    return res, buf.getvalue()


def phase_tools_rest(card, port_wall_s, dev="cuda", width=None, cube=128):
    """Phase 16: the remaining tools (see the module docstring). ``port_wall_s``:
    phase 5's wall s/volume of the port, beside which (a)'s control
    stands."""
    from pmpu_tpu_torch import eval as eval_cli
    from pmpu_tpu_torch.tools import (
        bench_int8_resident,
        bench_stream,
        debug_probunet_drift,
        measure_baseline,
        profile_volume,
        trace_breakdown,
    )

    width = FULL_WIDTH if width is None else tuple(width)
    cuda = dev == "cuda"
    filters = ",".join(map(str, width))
    print("phase 16: the remaining tools")
    t_phase = time.perf_counter()
    out, launches, secs = {}, {}, {}
    tmp = tempfile.TemporaryDirectory()
    d = tmp.name
    procs = {}
    stamp = [time.perf_counter()]

    def mark(name):
        now = time.perf_counter()
        secs[name] = now - stamp[0]
        stamp[0] = now

    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p])}

    def counted(name, fn, argv):
        """A tool in this process, its standard output captured, the
        kernels' counts set to 0 just before and read just after."""
        reset_kernel_counts()
        res, text = quiet(fn, argv)
        if cuda:
            torch.cuda.synchronize()
        launches[name] = kernel_counts()
        return res, text

    def launch(name, cmd, extra_env=None):
        log = open(os.path.join(d, f"{name}.log"), "w")
        procs[name] = (subprocess.Popen(cmd, cwd=ROOT, env={**env, **(extra_env or {})},
                                        stdout=log, stderr=subprocess.STDOUT, text=True,
                                        start_new_session=True), log)

    def finish(name, timeout=900):
        proc, log = procs[name]
        try:
            proc.wait(timeout=timeout)
        finally:
            log.close()
        with open(log.name) as f:
            text = f.read()
        require(proc.returncode == 0, f"phase 16 {name}: exited {proc.returncode}:\n"
                                      f"{text[-4000:]}")
        return text

    try:
        # (a) the reference's algorithm, alone on the card
        base = ["--cube", str(cube), "--num-filters", filters, "--device", dev]
        full, _ = quiet(measure_baseline.main, base + ["--full", "--out", os.path.join(d, "f.json")])
        ext, _ = quiet(measure_baseline.main, base + ["--slices", "6", "--out",
                                                       os.path.join(d, "e.json")])
        trn, _ = quiet(measure_baseline.main, base + ["--mode", "train", "--out",
                                                       os.path.join(d, "t.json")])
        ref_s, ext_s = full["sec_per_volume_extrapolated"], ext["sec_per_volume_extrapolated"]
        require(full["timed_slices"] == 3 * cube and np.isfinite(ref_s), f"(a): {full}")
        print(f"  [{card}] (a) measure_baseline, the reference's algorithm (batch-1 slices, "
              f"5 forwards of the 3 towers a slice, probabilities to the host), probunet "
              f"{filters}, {cube}³: --full {ref_s:.3f} s/volume ({full['timed_slices']} slices, "
              f"{1e3 * full['sec_per_slice_median']:.2f} ms a slice); --slices 6 extrapolated "
              f"{ext_s:.3f} s/volume ({ext_s / ref_s:.3f} of --full); the train step at batch 2 "
              f"{1e3 * trn['sec_per_step_median']:.2f} ms ({trn['slices_per_sec']:.1f} slices/s); "
              f"the port's wall (phase 5) {port_wall_s:.4f} s/volume: the reference takes "
              f"{ref_s / port_wall_s:.1f} times it; TF32 cuDNN {full['cudnn_allow_tf32']}, "
              f"matmul {full['matmul_allow_tf32']}")
        out["a"] = {"full": full, "extrapolated": ext, "train": trn, "port_wall_s": port_wall_s,
                    "ratio_to_port": ref_s / port_wall_s, "extrapolated_over_full": ext_s / ref_s}
        mark("a")

        # (b) profile_volume, then trace_breakdown over its volume trace
        trace_dir = os.path.join(d, "profile")
        _, text = counted("b", profile_volume.main, ["--cube", str(cube), "--filters", filters,
                                                     "--trace-dir", trace_dir, "--device", dev])
        groups = json.loads(next(line for line in text.splitlines()
                                 if line.startswith("GROUPS "))[len("GROUPS "):])
        pv_total = sum(groups["volume"]["groups_ms"].values())
        rc, report = quiet(trace_breakdown.main, [os.path.join(trace_dir, "volume")])
        if cuda:
            require(rc == 0, f"(b) trace_breakdown: rc {rc}")
            br = json.loads(next(line for line in report.splitlines()
                                 if line.startswith("BREAKDOWN "))[len("BREAKDOWN "):])
            tb_total = sum(br["groups"].values())
            require(abs(tb_total - pv_total) <= 0.01 * pv_total,
                    f"(b): trace_breakdown's groups {tb_total} ms, profile_volume's {pv_total}")
            spans = sorted(br["spans"].items(), key=lambda kv: -kv[1][0])[:6]
            w = br["window"]
            print(f"  [{card}] (b) profile_volume then trace_breakdown on its 3-view bf16 volume: "
                  f"device op groups {tb_total:.3f} ms against profile_volume's {pv_total:.3f} ms; "
                  f"busy {w['busy_ms']:.2f} of {w['window_ms']:.2f} ms (idle "
                  f"{w['idle_share']:.3f}); spans (device ms) "
                  f"{ {k: round(v[0], 2) for k, v in spans} }; groups "
                  f"{ {k: round(v, 2) for k, v in br['groups'].items()} }")
            out["b"] = {"breakdown_groups_ms": br["groups"], "profile_volume_total_ms": pv_total,
                        "spans_ms": {k: v[0] for k, v in br["spans"].items()}, "window": w}
        else:  # a CPU trace has no device operations, which the tool refuses
            require(rc == 1, f"(b) trace_breakdown on a CPU trace: rc {rc}")
            print(f"  [{card}] (b) trace_breakdown refuses the CPU trace (rc 1)")
        mark("b")

        # (c) bench_int8_resident: both sides on the conv-chain kernel
        res, _ = counted("c", bench_int8_resident.main,
                         ["--cube", str(cube), "--filters", filters, "--rounds", "2", "--n", "5",
                          "--device", dev])
        res.pop("fused")
        q = res["qchain_launches_per_volume"]
        if cuda:
            require(all(q[side]["stripes"] > 0 and q[side]["whole_image"] > 0 for side in q),
                    f"(c): conv-chain launches by form {q}")
        print(f"  [{card}] (c) bench_int8_resident: resident {res['best_ms']['resident']:.2f} ms, "
              f"non-resident {res['best_ms']['fused']:.2f} ms a volume (best of 2 rounds of 5; "
              f"{res['speedup']:.3f}x); agreement max |dprob| {res['max_abs_dprob']:.3e}, argmax "
              f"{100 * res['argmax_agreement']:.4f} %; conv-chain launches a volume {q}")
        out["c"] = res
        mark("c")

        # (d) bench_stream: the wires bit-equal in the check, then timed
        res, _ = quiet(bench_stream.main, ["--cube", str(cube), "--batch", "32" if cuda else "4",
                                           "--steps", "10", "--rounds", "2", "--device", dev])
        print(f"  [{card}] (d) bench_stream, full-width U-Net bf16, batch {res['batch']}: losses "
              f"bit-equal on both wires over {len(res['check_losses']['wide'])} steps; ms a step "
              f"wide {res['ms_per_step']['wide']}, compact {res['ms_per_step']['compact']} "
              f"({res['speedup']:.3f}x)")
        out["d"] = res
        mark("d")

        # (e), (g), (h) as processes of their own; (f) here meanwhile
        vols, rcube = RAMCAP_DATA
        launch("e", [sys.executable, "-m", "pmpu_tpu_torch.tools.demo_mmap_ramcap", "--volumes",
                     str(vols), "--cube", str(rcube), "--device", dev, "--workdir",
                     os.path.join(d, "ramcap")], {"OMP_NUM_THREADS": "1"})
        launch("g", [sys.executable, "-m", "pmpu_tpu_torch.tools.repro_client_staging_leak",
                     "30", str(cube), "float32", "--device", dev])
        p6v = os.path.join(d, "p6v")
        script_env = {"PYTHON": sys.executable, "DATA": p6v, "DEVICE": dev, "EPOCHS": "1",
                      **({"CUBE": "64", "FILTERS": filters} if cuda else
                         {"CUBE": "16", "FILTERS": filters, "BATCH": "4"})}
        launch("h", ["bash", os.path.join(ROOT, "pmpu_tpu_torch", "tools",
                                          "run_6view_probunet.sh")], script_env)

        res, _ = counted("f", debug_probunet_drift.main, ["--device", dev])
        require(res["max_rel_drift"] <= DRIFT_BOUND,
                f"(f) debug_probunet_drift: max rel drift {res['max_rel_drift']} over "
                f"{res['steps']} steps")
        if cuda:
            require(launches["f"]["gather_normalize_planes"] == res["steps"],
                    f"(f): gather launches {launches['f']} in {res['steps']} steps")
        print(f"  [{card}] (f) debug_probunet_drift, {res['steps']} steps of probunet 8,16 beside "
              f"the mirror: max rel drift {res['max_rel_drift']:.3e} (bound {DRIFT_BOUND:g}); "
              f"last losses {res['port'][-1]:.4f} / {res['mirror'][-1]:.4f}")
        out["f"] = {k: res[k] for k in ("steps", "max_rel_drift", "rel_drift")}
        mark("f")

        text = finish("e")
        verdict = json.loads(text.strip().splitlines()[-1])
        require(verdict["discriminating"] and verdict["pool_on_heap"],
                f"(e) demo_mmap_ramcap: {verdict}\n{text[-3000:]}")
        print(f"  [{card}] (e) demo_mmap_ramcap, {vols} x {rcube}³ (pool "
              f"{verdict['pool_gib']:.3f} GiB): the uncapped children's peak VmData "
              f"{verdict['baseline_vm_data_gib']:.3f} GiB (--mmap-store) and "
              f"{verdict['inram_uncapped_vm_data_gib']:.3f} GiB (in RAM: "
              f"{verdict['inram_over_mmap_per_pool']:.3f} of the pool above), cap "
              f"{verdict['cap_gib']:.3f} GiB (RLIMIT_DATA refuses "
              f"{verdict['rlimit_data_enforced']} here; the tool polices the cap "
              f"{verdict['cap_enforced_by_tool']}); --mmap-store lived (rc 0, peak "
              f"{verdict['mmap_peak_vm_data_gib']:.3f} GiB, {verdict['mmap_stream_seconds']:.1f} s), "
              f"in RAM died (rc {verdict['inram_rc']}, peak "
              f"{verdict['inram_peak_vm_data_gib']:.3f} GiB, allocation failure "
              f"{verdict['inram_allocation_failure']}, killed past the cap by the tool "
              f"{verdict['inram_killed_over_cap']})")
        out["e"] = verdict
        mark("e (beside f)")

        text = finish("g")
        leak = json.loads(next(line for line in text.splitlines()
                               if line.startswith("RESULT "))[len("RESULT "):])
        require(leak["creep_per_iter_mb"] < LEAK_GATE_MB,
                f"(g) repro_client_staging_leak: {leak['creep_per_iter_mb']} MB/iter")
        print(f"  [{card}] (g) repro_client_staging_leak 30 {cube} float32: creep "
              f"{leak['creep_per_iter_mb']:.3f} MB/iter after warm-up (gate {LEAK_GATE_MB:g}; "
              f"the TPU client leaked 8.00), RSS {leak['rss_mb'][0]:.1f} -> "
              f"{leak['rss_mb'][-1]:.1f} MB; empty_cache {leak['empty_cache']}")
        out["g"] = {k: leak[k] for k in ("creep_per_iter_mb", "rss_mb", "empty_cache")}
        mark("g (beside e)")

        text = finish("h", timeout=1200)
        dice = parse_report(text)
        require(len(dice) == 7 and "DONE train rc=0 eval rc=0" in text,
                f"(h) run_6view_probunet.sh:\n{text[-3000:]}")
        # the script's model through the eval CLI in this process: the same
        # report, each kernel of the 6-view path launched
        cwd = os.path.join(d, "h_eval")
        os.makedirs(cwd)
        argv = ["-m", "probunet", "-f", os.path.join(p6v, "ckpt", "probunet_model.pt"), "-d",
                os.path.join(p6v, "test"), "--num-views", "6", "--bf16", "--ged", "16",
                "--eval-samples", "5", "--device", dev]
        with contextlib.chdir(cwd):
            _, report = counted("h", eval_cli.main, argv)
        diff = report_diff(parse_report(report), dice)
        require(diff <= 1e-6, f"(h): the in-process eval report differs by {diff}")
        if cuda:
            require(all(launches["h"][k] > 0 for k in ("oblique_planes", "fcomb_mean_decode",
                                                       "gather_normalize_planes")),
                    f"(h): launches {launches['h']}")
        for line in text.splitlines():
            if re.match(REPORT_LINE, line.strip()) or line.startswith(("GED", "DONE")):
                print(f"  [{card}] (h) {line.strip()}")
        print(f"  [{card}] (h) run_6view_probunet.sh, probunet {filters}, "
              f"CUBE={script_env['CUBE']} EPOCHS=1: the eval CLI in this process repeats its "
              f"report (max |diff| {diff:.2g}); its launches {launches['h']}")
        out["h"] = {"report": {k: [a.tolist() for a in v] for k, v in dice.items()},
                    "inprocess_diff": diff}
        if cuda:
            for name in ("b", "c"):
                require(launches[name]["fcomb_mean_decode"] > 0
                        and launches[name]["gather_normalize_planes"] > 0,
                        f"({name}): launches {launches[name]}")
        mark("h (beside e, g)")
        out["launches"], out["seconds"] = launches, secs
        out["s"] = time.perf_counter() - t_phase
        print(f"  [{card}] phase 16 in {out['s']:.1f} s "
              f"({ {k: round(v, 1) for k, v in secs.items()} }); kernel launches by tool "
              f"{launches}")
    finally:
        for proc, log in procs.values():
            with contextlib.suppress(ProcessLookupError):
                os.killpg(proc.pid, signal.SIGKILL)  # the whole session
            proc.wait()
            log.close()
        tmp.cleanup()
    return out


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
    # PyTorch's default, set here so that no earlier setting hides a fault:
    # the port's f32 convolutions must turn TF32 off themselves (phase 4)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    sys.path.insert(0, ROOT)
    from pmpu_tpu_torch.ops.cuda import _build

    print("phase 2: build")
    t0 = time.perf_counter()
    built = _build.build()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    print(f"  built {sorted(built)} in {build_s:.1f} s "
          f"({ {k: round(v[0], 1) for k, v in built.items()} })")
    for name, (_, log) in built.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    clock = [("start", t0)]
    errs = phase_kernels()
    phase_qconv()
    phase_oblique_kernel()
    clock.append(("kernels", time.perf_counter()))
    parity = phase_parity()
    clock.append(("parity", time.perf_counter()))
    kernels, summary, (task, vol, truth, r_bf16) = phase_full(card)
    clock.append(("full", time.perf_counter()))
    summary["phase3_max_abs_err"] = errs
    summary["parity"] = parity
    qchain_kernels, summary["int8"] = phase_int8(card, task, vol, truth, r_bf16, summary)
    kernels += qchain_kernels
    clock.append(("int8", time.perf_counter()))
    kernel, summary["oblique"] = phase_oblique(card, task, vol, truth)
    kernels.append(kernel)
    clock.append(("oblique", time.perf_counter()))
    summary["stream"] = phase_stream(card, task)
    clock.append(("stream", time.perf_counter()))
    summary["eval"] = phase_eval(card, task)
    phase9_report = summary["eval"].pop("report")
    clock.append(("eval", time.perf_counter()))
    serve_sd = {k: t.detach().cpu().clone() for k, t in task.net.state_dict().items()}
    del task, vol, truth, r_bf16
    torch.cuda.empty_cache()
    summary["train"] = phase_train(card)
    clock.append(("train", time.perf_counter()))
    summary["train_rest"] = phase_train_rest(card)
    clock.append(("train_rest", time.perf_counter()))
    summary["serve"] = phase_serve(card, serve_sd)
    clock.append(("serve", time.perf_counter()))
    torch.cuda.empty_cache()
    summary["train_dist"] = phase_train_dist(card)
    clock.append(("train_dist", time.perf_counter()))
    torch.cuda.empty_cache()
    summary["eval_dist"] = phase_eval_dist(card, serve_sd, phase9_report)
    clock.append(("eval_dist", time.perf_counter()))
    torch.cuda.empty_cache()
    summary["tensor_parallel"] = phase_tensor_parallel(card, serve_sd)
    clock.append(("tensor_parallel", time.perf_counter()))
    torch.cuda.empty_cache()
    summary["tools_rest"] = phase_tools_rest(card, min(summary["wall_s_per_volume"]))
    clock.append(("tools_rest", time.perf_counter()))
    torch.cuda.empty_cache()
    summary["epilogue"] = phase_epilogue(card)
    clock.append(("epilogue", time.perf_counter()))
    summary["hpu_epilogue"] = phase_hpu_epilogue(card)
    clock.append(("hpu_epilogue", time.perf_counter()))
    summary["phase_s"] = {name: b - a for (_, a), (name, b) in zip(clock, clock[1:])}
    summary["phase_s"]["build"] = build_s
    print(f"seconds by phase: { {k: round(v, 1) for k, v in summary['phase_s'].items()} }; "
          f"from the start {time.perf_counter() - START:.1f} s")
    gather = next(k for k in kernels if k["name"] == "gather_normalize_planes")
    gather.update({f"{k}_768": v for k, v in summary["oblique"]["gather_768"].items()})
    gather.update({f"{k}_train_b128": v for k, v in summary["train"]["gather_b128"].items()})
    gather["train_launches_per_step"] = {
        str(b): f["gather_launches_per_step"] for b, f in summary["train"]["full"].items()}
    gather["train_6view_launches_per_step"] = {
        str(b): f["gather_launches_per_step"]
        for b, f in summary["train_rest"]["oblique_steps"].items()}
    oblique = next(k for k in kernels if k["name"] == "oblique_planes")
    rest = summary["train_rest"]["view_stacks"]
    oblique["train_launches_per_precompute"] = rest["launches"]
    oblique["train_scans_per_precompute"] = rest["scans"]
    oblique["ms_train_precompute"] = rest["ms"]
    served = summary["serve"]["launches_per_volume"]
    dist_a = summary["train_dist"]["a"]
    dist_b = summary["train_dist"]["b"]["b"]
    for k in kernels:
        count = "fused_qchain_stripes" if k["name"] == "fused_qchain" else k["name"]
        k["serve_launches_per_volume"] = {path: c[count] for path, c in served.items()}
        # per rank: the world of 1 (a), and each rank of (b)'s world of 2
        k["train_dp_launches_per_step"] = {
            **{f"{path}_world1": a["launches_per_step"][count] for path, a in dist_a.items()},
            **{f"{key}_world2": [c[count] for c in dist_b["launches_per_step"][key]]
               for key in ("sharded", "dp1", "dp4")}}
        k["train_dp_loop_world2_launches"] = [c[count] for c in dist_b["loop"]["launches"]]
        # per path, each rank of phase 14 (a)'s world of 2
        k["eval_dp_launches_per_volume"] = {
            path: c[count] for path, c in summary["eval_dist"]["a"]["launches_per_volume"].items()}
        # phase 15, per rank: each leg's step on its mesh, (c)'s evaluator on 1x2
        tp = summary["tensor_parallel"]
        k["tp_launches_per_step"] = {leg: [c[count] for c in e["launches_per_step"]]
                                     for leg, e in tp["legs"].items()}
        k["tp_eval_launches_per_volume"] = {
            path: c[count] for path, c in tp["eval"]["launches_per_volume"].items()}
        # phase 16, by tool: (b) profile_volume, (c) bench_int8_resident, (f)
        # debug_probunet_drift, (h) the 6-view script's model through the eval CLI
        k["tools_launches"] = {tool: c[count]
                               for tool, c in summary["tools_rest"]["launches"].items()}
    epilogue = summary["epilogue"]
    kernels.append({"name": "bias_bn_relu_", "route": "cuda",
                    "source": "pmpu_tpu_torch/ops/cuda/csrc/bias_bn_relu.cu",
                    "replaces": "none (XLA fuses it into the conv)", "cases": epilogue["cases"],
                    "ms_a_volume": {v: epilogue[f"{v}_ms_a_volume"] for v in ("3view", "6view")},
                    "launches_per_volume": {v: r["launches_per_volume"]
                                            for v, r in epilogue["volumes"].items()}})
    hpu = summary["hpu_epilogue"]
    kernels.append({"name": "hpu_epilogue", "route": "cuda",
                    "source": "pmpu_tpu_torch/ops/cuda/csrc/hpu_epilogue.cu",
                    "replaces": "none (the JAX package has no HPU-Net)", "cases": hpu["cases"],
                    "host_us": hpu["host_us"], "volume": hpu["volume"],
                    "launches_per_volume": sum(hpu["volume"]["launches"])})
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
