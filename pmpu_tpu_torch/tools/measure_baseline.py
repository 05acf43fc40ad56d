"""Time the reference's whole-volume inference algorithm on one device: the
control that the port's speed is compared with (counterpart of the JAX
package's ``tools/measure_baseline.py``, flag for flag, plus ``--device``).

The reference publishes no numbers, so the control is measured: the
reference's eval algorithm (``eval.py:131-160``, ``probunet_trainer.py:27-32``)
on ``reference_mirror``'s network at full width (filters 64..1024, latent 6):
a batch-1 loop over every slice of the 3 views, ``--samples`` prior draws a
slice, each a full forward of all three towers, the logits averaged,
softmax, and each slice's probabilities copied to the host, where the
reference reassembles the volume. On the card every clock read follows a
``torch.cuda.synchronize()``, the first ``WARMUP_SLICES`` slices (cuDNN's
and cuBLAS's first use) are not timed, and the mirror runs under PyTorch's
defaults, as the reference's code sets nothing (cuDNN's TF32 on); the JSON
records both TF32 flags and the card's name and power limit.

A 128³ volume is 384 slices x 5 forwards, so by default ``--slices``
representative slices are timed and the cost is extrapolated linearly (the
loop is sequential at batch 1: its cost is linear in the slices);
``--full`` times every slice instead, the cross-check of that protocol.
``--mode train`` times the mirror's train step at the reference's batch 2
(``train.py:45,202``) as slices/s.

    python3 -m pmpu_tpu_torch.tools.measure_baseline [--full] [--mode train] \\
        [--device cpu] [--out runs/measure_baseline/reference_infer_cuda.json]

``--out`` defaults to ``runs/measure_baseline/reference_<mode>_<device>.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from pmpu_tpu_torch.device import card_label, resolve_device
from pmpu_tpu_torch.tools.reference_mirror import TProbUNet

WARMUP_SLICES = 3  # untimed slices (or train steps) before the timed ones


def _mirror(num_filters: str, device) -> TProbUNet:
    nf = tuple(int(x) for x in num_filters.split(","))
    torch.manual_seed(0)
    return TProbUNet(1, 3, nf, latent_dim=6, no_convs_fcomb=4).to(device)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _environment(device) -> dict:
    return {"device": device.type, "card": card_label(device),
            "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
            "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "torch_threads": torch.get_num_threads()}


def measure_train(args, device) -> dict:
    """Reference train-step control: one SGD step of the reference's train
    loop (full forward of all 3 towers on (image, mask), ELBO, backward,
    clip, step) at the reference's default batch 2, as slices/s."""
    net = _mirror(args.num_filters, device)
    net.train()
    opt = torch.optim.SGD(net.parameters(), lr=1e-3, momentum=0.9)
    s, b = args.cube, 2
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random((b, 1, s, s)).astype(np.float32)).to(device)
    m = torch.from_numpy(rng.integers(0, 3, size=(b, 1, s, s)).astype(np.float32)).to(device)

    def step():
        opt.zero_grad()
        feats, (mu_p, ls_p), (mu_q, ls_q) = net(x, m)
        z_q = mu_q + torch.exp(ls_q) * torch.randn_like(mu_q)
        logits = net.fcomb(feats, z_q)
        ce = torch.nn.functional.cross_entropy(logits, m[:, 0].long(), reduction="sum")
        kl = 0.5 * (
            torch.exp(2 * ls_q) / torch.exp(2 * ls_p)
            + (mu_p - mu_q) ** 2 / torch.exp(2 * ls_p)
            - 1
            + 2 * (ls_p - ls_q)
        ).sum(1).mean()
        loss = ce + 10.0 * kl
        loss.backward()
        torch.nn.utils.clip_grad_value_(net.parameters(), 0.1)
        opt.step()

    for _ in range(WARMUP_SLICES):
        step()
    times = []
    for _ in range(args.slices):
        _sync(device)
        t0 = time.perf_counter()
        step()
        _sync(device)
        times.append(time.perf_counter() - t0)
    per_step = float(np.median(times))
    return {
        "metric": f"train slices/sec (reference algorithm, {device.type})",
        "cube": args.cube,
        "batch": b,
        "num_filters": [int(f) for f in args.num_filters.split(",")],
        "sec_per_step_median": per_step,
        "steps_timed": args.slices,
        "warmup_steps": WARMUP_SLICES,
        "slices_per_sec": b / per_step,
        **_environment(device),
        "note": "fwd(3 towers)+ELBO+bwd+SGD at reference defaults (batch 2, "
        "train.py:45,202); slices/sec = batch / sec_per_step",
    }


def measure_infer(args, device) -> dict:
    net = _mirror(args.num_filters, device)
    net.eval()
    s = args.cube
    rng = np.random.default_rng(0)
    vol = rng.random((s, s, s)).astype(np.float32)

    def predict_slice(sl):
        """One reference predict: full forward + prior sample + fcomb
        (probunet_trainer.py:27-32 under no_grad), x samples, averaged,
        softmax, the probabilities on the host."""
        x = torch.from_numpy(sl / max(sl.max(), 1e-9))[None, None].to(device)
        m = torch.zeros_like(x)
        acc = None
        with torch.no_grad():
            for _ in range(args.samples):
                feats, (mu_p, ls_p), _ = net(x, m)
                z = mu_p + torch.exp(ls_p) * torch.randn_like(mu_p)
                logits = net.fcomb(feats, z)
                acc = logits if acc is None else acc + logits
            probs = torch.softmax(acc / args.samples, dim=1)
        return probs.cpu()

    for i in range(WARMUP_SLICES):
        predict_slice(vol[(i * 17) % s])

    total_slices = 3 * s
    if args.full:
        # the un-extrapolated control: the reference's slice loop over every
        # slice of every view (eval.py:131-160)
        _sync(device)
        t0 = time.perf_counter()
        for view in range(3):
            for i in range(s):
                sl = vol[i] if view == 0 else (vol[:, i] if view == 1 else vol[:, :, i])
                predict_slice(np.ascontiguousarray(sl))
        _sync(device)
        full_sec = time.perf_counter() - t0
        per_slice = full_sec / total_slices
        est_volume_sec = full_sec
    else:
        times = []
        for i in range(args.slices):
            sl = vol[(i * 17) % s]
            _sync(device)
            t0 = time.perf_counter()
            predict_slice(sl)
            _sync(device)
            times.append(time.perf_counter() - t0)
        per_slice = float(np.median(times))
        est_volume_sec = per_slice * total_slices
    return {
        "metric": f"sec/volume multi-view inference (reference algorithm, {device.type})",
        "cube": s,
        "samples_per_slice": args.samples,
        "num_filters": [int(f) for f in args.num_filters.split(",")],
        "sec_per_slice_median": per_slice,
        "timed_slices": total_slices if args.full else args.slices,
        "warmup_slices": WARMUP_SLICES,
        "slices_per_volume": total_slices,
        "sec_per_volume_extrapolated": est_volume_sec,
        "full_measurement": bool(args.full),
        **_environment(device),
        "note": (
            ("FULL un-extrapolated measurement of the reference slice loop"
             if args.full
             else "per-slice median x (3*cube) linear extrapolation; "
             "reference eval.py is a bs=1 sequential loop so cost is linear in slices")
            + "; each slice's probabilities are copied to the host, where the "
            "reference reassembles the volume (eval.py:131-160)"
        ),
    }


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cube", type=int, default=128)
    ap.add_argument("--slices", type=int, default=6,
                    help="slices to time (extrapolated to 3*cube); train: steps to time")
    ap.add_argument("--samples", type=int, default=5, help="prior samples/slice (eval.py:148)")
    ap.add_argument("--num-filters", default="64,128,256,512,1024")
    ap.add_argument("--threads", type=int, default=0, help="torch CPU threads (0 = default)")
    ap.add_argument("--out", default=None,
                    help="JSON file (default runs/measure_baseline/reference_<mode>_<device>.json)")
    ap.add_argument("--mode", default="infer", choices=["infer", "train"],
                    help="infer = whole-volume eval control; train = train-step control")
    ap.add_argument("--full", action="store_true",
                    help="time ALL 3*cube slices (no extrapolation): the cross-check for the "
                    "linear-extrapolation protocol")
    ap.add_argument("--device", default=None,
                    help="the device (default: the card; 'cpu' off the card)")
    return ap


def main(argv=None) -> dict:
    """Measure as the module docstring says; writes ``--out``, prints the
    JSON line and returns it as a dict."""
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    if args.threads:
        torch.set_num_threads(args.threads)
    out = measure_train(args, device) if args.mode == "train" else measure_infer(args, device)
    path = args.out or os.path.join("runs", "measure_baseline",
                                    f"reference_{args.mode}_{device.type}.json")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
