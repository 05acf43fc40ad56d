"""Multi-step parity probe of the probabilistic U-Net's training dynamics
(counterpart of the JAX package's ``tools/debug_probunet_drift.py``, plus
``--device``): the port's own train step (``train/steps.py::make_train_step``:
the gather kernel on the view stacks, the inert-BatchNorm-bias mask, the
clip and SGD with momentum, the BatchNorm statistics carried) runs
``--steps`` (default 40) steps on a FIXED batch sequence beside ``reference_mirror``'s
network driven by the reference's training loop on the SAME batches and
the SAME posterior eps, from the same weights, and the losses are compared
step by step.

The eps are the step's own: drawn from a generator seeded ``EPS_SEED`` with
``task.draw_eps``, the numbers the step draws from a state generator of that
seed (``tests/test_torch_tools_rest.py`` checks that), and injected into
both sides (the step's ``eps`` argument). If the loss sequences track, the
per-step dynamics of the port are the reference's; if they part at step
k, k is the bisect point. On the card both sides run their f32 convs with
TF32 off (``device.exact_f32``) under cuDNN's deterministic algorithms.

    python3 -m pmpu_tpu_torch.tools.debug_probunet_drift [--steps 40] [--device cpu]

Prints the loss of each step on both sides with its relative drift, the max
relative drift, and a ``RESULT`` JSON line with the card's name and power
limit. Constants of the root tool: filters 8,16, cube 24, batch 4, latent
6, lr 1e-3, momentum 0.9, clip 0.1, 4 volumes of ``synth_volumes_hard``.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from pmpu_tpu_torch.data.index_map import build_index_map
from pmpu_tpu_torch.data.sampler import sample_batch_vt
from pmpu_tpu_torch.data.volumes import make_view_stacks
from pmpu_tpu_torch.device import card_label, exact_f32, resolve_device
from pmpu_tpu_torch.tools.compare_with_reference import (
    _deterministic,
    _normalized,
    _slice_of,
    synth_volumes_hard,
)
from pmpu_tpu_torch.tools.reference_mirror import TProbUNet
from pmpu_tpu_torch.train.steps import create_train_state, make_train_step
from pmpu_tpu_torch.train.tasks import make_task

NF = (8, 16)
S, B, LAT, STEPS, LR = 24, 4, 6, 40, 1e-3
EPS_SEED = 7


class Probe:
    """The fixed data, batches and eps of one run on ``device``, and the
    mirror's initial weights."""

    def __init__(self, device, steps: int):
        self.device, self.steps = device, steps
        self.imgs, self.lbls = synth_volumes_hard(4, S, 0)
        index = np.asarray(build_index_map(self.lbls, filter=True))
        self.rows = [index[(i * B) % (len(index) - B):][:B] for i in range(steps)]
        torch.manual_seed(0)
        self.init = TProbUNet(1, 3, NF, latent_dim=LAT, no_convs_fcomb=4).state_dict()
        self.vt_i = torch.from_numpy(make_view_stacks(self.imgs)).to(device)
        self.vt_l = torch.from_numpy(make_view_stacks(self.lbls)).to(device)

    def eps(self, task) -> list:
        """The posterior eps of each step as the step would draw them from a
        state generator seeded ``EPS_SEED``: one (B, latent) draw a step."""
        gen = torch.Generator(device=self.device).manual_seed(EPS_SEED)
        return [task.draw_eps(gen, B) for _ in range(self.steps)]

    def port(self, inject: bool = True):
        """The port's losses, with the eps injected or (``inject=False``)
        drawn by the step from its generator → (losses, eps)."""
        task = make_task("probunet", n_classes=3, num_filters=NF, latent_dim=LAT,
                         no_convs_fcomb=4, device=self.device, seed=0, train=True)
        task.net.load_state_dict({k: v for k, v in self.init.items()
                                  if not k.endswith("num_batches_tracked")}, strict=True)
        state = create_train_state(task, seed=EPS_SEED, momentum=0.9, lr=LR)
        step = make_train_step(task, acc_steps=1, sampler=sample_batch_vt)
        eps = self.eps(task)
        losses = []
        for i in range(self.steps):
            triples = torch.from_numpy(self.rows[i]).to(self.device)
            state, m = step(state, self.vt_i, self.vt_l, triples, LR,
                            eps=eps[i][None] if inject else None)
            losses.append(float(m["loss"]))
        return losses, eps

    def mirror(self, eps) -> list:
        """The reference's loop on the mirror (``train.py:27-196`` at batch 4:
        one microbatch a step), the same batches and eps."""
        tnet = TProbUNet(1, 3, NF, latent_dim=LAT, no_convs_fcomb=4).to(self.device)
        tnet.load_state_dict(self.init)
        tnet.train()
        opt = torch.optim.SGD(tnet.parameters(), lr=LR, momentum=0.9)
        ce_none = torch.nn.CrossEntropyLoss(reduction="none")
        losses = []
        for i in range(self.steps):
            xs = [_normalized(_slice_of(self.imgs[scan], view, idx))
                  for scan, view, idx in self.rows[i]]
            ys = [_slice_of(self.lbls[scan], view, idx).astype(np.int64)
                  for scan, view, idx in self.rows[i]]
            x = torch.from_numpy(np.stack(xs))[:, None].to(self.device)
            y = torch.from_numpy(np.stack(ys)).to(self.device)
            feats, (mu_p, ls_p), (mu_q, ls_q) = tnet(x, y[:, None].to(torch.float32))
            z_q = mu_q + torch.exp(ls_q) * eps[i]
            recon = tnet.fcomb(feats, z_q)
            kl = 0.5 * (
                2 * (ls_p - ls_q)
                + (torch.exp(2 * ls_q) + (mu_q - mu_p) ** 2) / torch.exp(2 * ls_p)
                - 1.0
            ).sum(dim=1)
            loss = ce_none(recon, y).sum() + 10.0 * kl.mean()
            opt.zero_grad()
            loss.backward()
            torch.nn.utils.clip_grad_value_(tnet.parameters(), 0.1)
            opt.step()
            losses.append(loss.item())
        return losses


def drift(steps: int, device) -> dict:
    """Both sides' losses and their relative drift a step."""
    probe = Probe(device, steps)
    with _deterministic(device), exact_f32():
        ours, eps = probe.port()
        ref = probe.mirror(eps)
    rel = [abs(a - b) / max(abs(b), 1e-9) for a, b in zip(ours, ref)]
    return {"port": ours, "mirror": ref, "rel_drift": rel, "max_rel_drift": max(rel)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--device", default=None,
                    help="the device (default: the card; 'cpu' off the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    out = drift(args.steps, device)
    for i, (a, b, r) in enumerate(zip(out["port"], out["mirror"], out["rel_drift"])):
        flag = "  <-- DIVERGED" if r > 1e-2 else ""
        print(f"step {i:3d}  port {a:14.4f}  mirror {b:14.4f} rel {r:.2e}{flag}")
    print("max rel drift:", out["max_rel_drift"])
    out = {"device": device.type, "card": card_label(device), "steps": args.steps, **out}
    print("RESULT", json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
