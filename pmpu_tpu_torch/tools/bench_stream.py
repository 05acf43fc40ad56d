"""A/B of the ``--stream`` train wire on one device: compact (bf16 images +
uint8 masks) against wide (f32 + int32), interleaved rounds (counterpart of
the JAX package's ``tools/bench_stream.py``, flag for flag, plus
``--device``).

The streamed batch crosses the host → device link every step, so its bytes
bound the step when the link is contended. Under bf16 compute the compact
wire is bit-identical: the first conv rounds the images to bf16 either way,
and the masks are widened to int32 on the device. The tool checks that
first: from one seeded state, ``CHECK_STEPS`` steps on each wire under
cuDNN's deterministic algorithms must give the same losses, bit for bit.
Then ``--rounds`` rounds each time ``--steps`` steps of each wire, after 5
untimed ones, on ``PrefetchPipeline`` (``data/pipeline.py``) with
``sample_rows``: the train CLI's ``--stream`` path. The reference workload
shape: 128² slices, the full-width model in bf16, batch 32.

    python3 -m pmpu_tpu_torch.tools.bench_stream [--data DIR] [--batch 32] \\
        [--steps 30] [--device cpu]

Without ``--data``, 4 random 128³ volumes are made in memory. Prints ms a
step and slices/s of each wire a round, the speedup, and a ``RESULT`` JSON
line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from pmpu_tpu_torch.data.pipeline import PrefetchPipeline
from pmpu_tpu_torch.data.sampler import sample_rows
from pmpu_tpu_torch.device import card_label, resolve_device
from pmpu_tpu_torch.tools.compare_with_reference import _deterministic
from pmpu_tpu_torch.train.steps import create_train_state, make_train_step
from pmpu_tpu_torch.train.tasks import make_task

CHECK_STEPS = 2
WARMUP_STEPS = 5
WIRES = {"wide": (torch.float32, torch.int32), "compact": (torch.bfloat16, torch.uint8)}


class _SynthStore:
    def __init__(self, n, s, seed=0):
        rng = np.random.default_rng(seed)
        self.images = rng.random((n, s, s, s)).astype(np.float32)
        self.labels = rng.integers(0, 3, (n, s, s, s)).astype(np.int32)


def _batches(store, b: int, n: int, seed: int) -> list:
    """``n`` random (b, 3) rows (scan, view, slice) of ``store``."""
    rng = np.random.default_rng(seed)
    nvol, s = store.images.shape[0], store.images.shape[-1]
    return [np.stack([rng.integers(0, nvol, b), rng.integers(0, 3, b),
                      rng.integers(0, s, b)], axis=1).astype(np.int32) for _ in range(n)]


def _trainer(model: str, device, num_filters=None):
    """A seeded bf16 task (full width unless ``num_filters``), its state and
    its streamed step."""
    kw = {} if num_filters is None else {"num_filters": tuple(num_filters)}
    task = make_task(model, n_classes=3, dtype=torch.bfloat16, device=device, seed=0, train=True,
                     **kw)
    state = create_train_state(task, seed=0)
    return state, make_train_step(task, sampler=sample_rows)


def wire_losses(store, model: str, b: int, triples, device, image_dtype, mask_dtype,
                num_filters=None) -> list:
    """Losses of ``len(triples)`` steps from the seeded state on the wire of
    ``image_dtype`` and ``mask_dtype``, as floats."""
    state, step = _trainer(model, device, num_filters)
    rows = torch.arange(b, device=device)[:, None].expand(b, 3)
    pipe = PrefetchPipeline(store, depth=2, image_dtype=image_dtype, mask_dtype=mask_dtype,
                            device=device)
    losses = []
    for img, msk in pipe.iterate(triples):
        state, m = step(state, img, msk, rows, 1e-3)
        losses.append(float(m["loss"]))
    return losses


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data", default=None, help="images/+labels/ dir (else synthetic)")
    ap.add_argument("--cube", type=int, default=128)
    ap.add_argument("--volumes", type=int, default=4)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--model", default="unet", choices=["unet", "probunet"])
    ap.add_argument("--device", default=None,
                    help="the device (default: the card; 'cpu' off the card)")
    return ap


def main(argv=None) -> dict:
    """Run the check and the rounds; returns the RESULT dict. Raises when
    the wires' losses differ."""
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    if args.data:
        from pmpu_tpu_torch.data.volumes import VolumeStore

        store = VolumeStore.from_dirs(os.path.join(args.data, "images"),
                                      os.path.join(args.data, "labels"))
    else:
        store = _SynthStore(args.volumes, args.cube)
    b = args.batch

    with _deterministic(device):
        check = _batches(store, b, CHECK_STEPS, seed=1)
        losses = {w: wire_losses(store, args.model, b, check, device, *WIRES[w]) for w in WIRES}
    if losses["wide"] != losses["compact"]:
        raise RuntimeError(f"the compact wire's losses differ from the wide wire's: {losses}")
    print(f"check: {CHECK_STEPS} steps from one seeded state, losses bit-equal on both wires "
          f"{losses['wide']}", flush=True)

    state, step = _trainer(args.model, device)
    rows = torch.arange(b, device=device)[:, None].expand(b, 3)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def run(tag, wire, seed):
        nonlocal state
        idt, mdt = WIRES[wire]
        pipe = PrefetchPipeline(store, depth=2, image_dtype=idt, mask_dtype=mdt, device=device)
        it = pipe.iterate(_batches(store, b, WARMUP_STEPS + args.steps, seed))
        for _ in range(WARMUP_STEPS):
            state, m = step(state, *next(it), rows, 1e-3)
        sync()
        t0 = time.perf_counter()
        for img, msk in it:
            state, m = step(state, img, msk, rows, 1e-3)
        sync()
        dt = (time.perf_counter() - t0) / args.steps
        print(f"{tag}: {dt * 1e3:.1f} ms/step  ({b / dt:.0f} slices/s)", flush=True)
        return dt * 1e3

    ms = {w: [] for w in WIRES}
    for rnd in range(args.rounds):
        ms["wide"].append(run(f"r{rnd} wide    f32+i32", "wide", 10 + rnd))
        ms["compact"].append(run(f"r{rnd} compact bf16+u8", "compact", 20 + rnd))
        print(f"r{rnd} compact speedup {ms['wide'][-1] / ms['compact'][-1]:.3f}x", flush=True)
    out = {"device": device.type, "card": card_label(device), "model": args.model,
           "cube": store.images.shape[-1], "volumes": store.images.shape[0], "batch": b,
           "steps": args.steps, "rounds": args.rounds, "check_losses": losses,
           "ms_per_step": ms, "best_ms": {w: min(v) for w, v in ms.items()},
           "speedup": min(ms["wide"]) / min(ms["compact"])}
    print("RESULT", json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
