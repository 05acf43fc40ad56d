"""Per-launch times and in-kernel phase clocks of the int8 conv chain.

    python3 -m pmpu_tpu_torch.tools.qconv_sweep [--json PATH]

Needs one CUDA card. Builds ``csrc/qconv.cu`` twice, as the normal library
and as the phase-clock build (``-DPMPU_QCONV_CLOCKS``), and prints each
build's ptxas register and spill lines. Then it records the 14 conv-chain
launches of one full-width int8 chunk (probunet 64..1024, 128 slices of a
seeded 128³ volume, self-calibrated, random weights from seed 0: the chunk
that ``chip_smoke.py`` phase 6 replays) and, for each launch, checks both
builds bit for bit against ``chain_reference`` and prints its time (CUDA
events over 10 launches of the normal build), TOP/s, bound, stripe rows,
blocks, and the mean cycles a warp of a block spends in each phase (one
launch of the clock build): zeroing, stripe load, and per layer the MMA
loop, the epilogue and the barrier waits.

``--variant NAME=FLAGS`` (repeatable) also builds the source with the extra
nvcc flags (for example ``exact=-DPMPU_QCONV_EXACT_EPILOGUE``) as the library
``qconv_NAME``, and with the clocks as ``qconv_clocks_NAME``, checks both bit
for bit on every launch, times it beside the normal build, in turns
(normal, variants, normal; the normal build's time is the mean of its two
turns), and prints its phase clocks.
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

PEAK_INT8_OPS = 1979e12  # H100 SXM, dense (NVIDIA data sheet)
PEAK_HBM_BYTES = 3.35e12


def _volume(cube, seed):
    """A seeded image of two nested ellipsoids (chip_smoke.py's volume)."""
    rng = np.random.default_rng(seed)
    ax = np.linspace(-1.0, 1.0, cube, dtype=np.float32)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    r1 = (x / 0.6) ** 2 + (y / 0.45) ** 2 + (z / 0.5) ** 2
    r2 = ((x - 0.1) / 0.25) ** 2 + (y / 0.2) ** 2 + ((z + 0.1) / 0.3) ** 2
    truth = np.where(r2 < 1, 2, np.where(r1 < 1, 1, 0))
    img = 0.2 + 0.4 * (truth >= 1) + 0.3 * (truth == 2) + 0.1 * rng.standard_normal(x.shape)
    return np.clip(img, 0.0, None).astype(np.float32)


def _event_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def record_chunk_launches(filters=(64, 128, 256, 512, 1024), cube=128, chunk=128, seed=0,
                          device="cuda"):
    """The conv-chain calls of one int8 chunk (full width by default), on
    their real inputs: [(x, layers, out_dtype, kwargs)]."""
    from pmpu_tpu_torch import VolumeEvaluator, make_task
    from pmpu_tpu_torch.inference.fusion import normalize_slabs, view_slabs
    from pmpu_tpu_torch.models import quantized as qz

    task = make_task("probunet", num_filters=filters, latent_dim=6, n_classes=3,
                     no_convs_fcomb=4, dtype=torch.bfloat16, seed=seed, device=device)
    vol = _volume(cube, seed=6)
    with tempfile.TemporaryDirectory() as tmp:
        ev = VolumeEvaluator(task, n_samples=5, eval_batch=0, input_dtype="uint8",
                             quantize="int8", calibration=os.path.join(tmp, "scales.json"),
                             device=device)
        with torch.inference_mode():
            ev._maybe_quantize(sample_vol=vol)
    calls, orig = [], qz.fused_qchain

    def record(x, layers, out_dtype, **kw):
        calls.append((x, layers, out_dtype, kw))
        return orig(x, layers, out_dtype, **kw)

    qz.fused_qchain = record
    try:
        with torch.inference_mode():
            slabs = normalize_slabs(view_slabs(ev._upload(vol).float()))
            qz.probunet_features_prior_int8(ev._qvars, slabs[:chunk, ..., None], task.net,
                                            dtype=task.net.dtype)
    finally:
        qz.fused_qchain = orig
    return calls


def chain_cost(x, layers, kw, out_dtype):
    """(int8 operations, bytes each read or written once) of one launch."""
    n, h, w, _ = x.shape
    ops = sum(2.0 * n * h * w * l["w"].numel() for l in layers)
    x2 = kw.get("x2")
    out_bytes = n * h * w * layers[-1]["w"].shape[-1] * torch.empty((), dtype=out_dtype).element_size()
    nbytes = (x.numel() * x.element_size() + out_bytes
              + sum(l["w"].numel() + 8 * l["w"].shape[-1] for l in layers)
              + (0 if x2 is None else x2.numel()))
    return ops, nbytes


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--json", help="also write the rows to this file")
    parser.add_argument("--reps", type=int, default=10, help="timed launches per chain")
    parser.add_argument("--variant", action="append", default=[], metavar="NAME=FLAGS",
                        help="also time the source built with these nvcc flags")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("qconv_sweep: no CUDA device", file=sys.stderr)
        return 2
    from pmpu_tpu_torch.device import card_label
    from pmpu_tpu_torch.ops.cuda import _build
    from pmpu_tpu_torch.ops.cuda.qconv import (
        chain_reference,
        fused_qchain,
        fused_qchain_clocked,
        launch_build,
        launch_plan,
    )

    card = card_label("cuda")
    print(card)

    variants = []
    for spec in args.variant:
        name, _, flags = spec.partition("=")
        _build.VARIANTS[f"qconv_{name}"] = ("qconv", tuple(flags.split()))
        _build.VARIANTS[f"qconv_clocks_{name}"] = (
            "qconv", (*flags.split(), *_build.VARIANTS["qconv_clocks"][1]))
        variants.append(f"qconv_{name}")
    t0 = time.perf_counter()
    built = _build.build(("qconv", "qconv_clocks", *variants,
                          *(v.replace("qconv_", "qconv_clocks_", 1) for v in variants)))
    print(f"built {sorted(built)} in {time.perf_counter() - t0:.1f} s")
    for name, (_, log) in sorted(built.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    calls = record_chunk_launches()
    sm_mhz = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
                            capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"{len(calls)} launches of one chunk; SM clock now {sm_mhz}")
    rows = []
    with torch.inference_mode():
        for i, (x, layers, out_dtype, kw) in enumerate(calls):
            want = chain_reference(x, layers, out_dtype, **kw)
            got = fused_qchain(x, layers, out_dtype, **kw)
            got_c, phases, blocks = fused_qchain_clocked(x, layers, out_dtype, **kw)
            torch.cuda.synchronize()
            if not (torch.equal(got, want) and torch.equal(got_c, want)):
                raise AssertionError(f"launch {i} ({tuple(x.shape)}) differs from its plain version")
            var_phases = {}
            for lib in variants:
                clk_lib = lib.replace("qconv_", "qconv_clocks_", 1)
                got_v = launch_build(x, layers, out_dtype, lib, **kw)
                got_vc, var_phases[lib], _ = fused_qchain_clocked(x, layers, out_dtype,
                                                                  library=clk_lib, **kw)
                if not (torch.equal(got_v, want) and torch.equal(got_vc, want)):
                    raise AssertionError(f"launch {i}: {lib} differs from the plain version")
            ms = _event_ms(lambda: fused_qchain(x, layers, out_dtype, **kw), args.reps)
            var_ms = {lib: _event_ms(lambda: launch_build(x, layers, out_dtype, lib, **kw),
                                     args.reps) for lib in variants}
            ms = (ms + _event_ms(lambda: fused_qchain(x, layers, out_dtype, **kw), args.reps)) / 2
            ops, nbytes = chain_cost(x, layers, kw, out_dtype)
            bound = max(ops / PEAK_INT8_OPS, nbytes / PEAK_HBM_BYTES) * 1e3
            _, th, buf, slots = launch_plan(x, layers, out_dtype, kw.get("x2"))
            rows.append({"i": i, "input": list(x.shape), "x2": kw.get("x2") is not None,
                         "chans": [list(l["w"].shape[2:]) for l in layers], "out": str(out_dtype),
                         "stripe_rows": th, "blocks": blocks, "buffers": list(buf),
                         "ring_slots": slots, "ms": ms,
                         "variant_ms": var_ms, "variant_phases": var_phases, "bound_ms": bound,
                         "tops": ops / ms / 1e9, "phases": phases})
    print(f"[{card}] per launch: ms, TOP/s, bound ms, stripe rows, blocks, weight-ring slots; "
          f"mean cycles a warp of a block spends in each phase (k = 1000 cycles)")
    for r in rows:
        ph = " ".join(f"{k} {v / 1e3:.1f}k" for k, v in r["phases"].items())
        print(f"  {r['i']:2d} {r['input']}{' +split' if r['x2'] else ''} "
              f"{[c[1] for c in r['chans']]} -> {r['out'].split('.')[-1]}: {r['ms']:.3f} ms "
              f"{r['tops']:.1f} TOP/s bound {r['bound_ms']:.4f} th {r['stripe_rows']} "
              f"blocks {r['blocks']} ring {r['ring_slots']} | {ph}")
        for lib, ms in r["variant_ms"].items():
            ph = " ".join(f"{k} {v / 1e3:.1f}k" for k, v in r["variant_phases"][lib].items())
            print(f"       {lib}: {ms:.3f} ms | {ph}")
    tiled = [r["ms"] for r in rows if r["stripe_rows"] < r["input"][1]]
    whole = [r["ms"] for r in rows if r["stripe_rows"] >= r["input"][1]]
    print(f"[{card}] chains of one chunk: {sum(r['ms'] for r in rows):.3f} ms in all; tiled "
          f"launches mean {np.mean(tiled):.3f} ms ({len(tiled)}), whole-image mean "
          f"{np.mean(whole):.3f} ms ({len(whole)})")
    for lib in variants:
        print(f"[{card}] {lib}: {sum(r['variant_ms'][lib] for r in rows):.3f} ms in all")
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump({"card": card, "sm_clock": sm_mhz, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
