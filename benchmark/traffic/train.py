"""Training: the program's train step (``make_train_step``, ``acc_steps`` 1,
the gather-normalize sampler over (3,N,S,S,S) view stacks, clipped SGD with
momentum) on ``batch`` slices a step, drawn from the seed out of the planes
of the scans' three views that hold labels.

Set-up builds the one train state, drives it through ``checked_steps``
steps on rows that all differ (the first draws of a seeded permutation of
the planes), through the same call and feed as the window, and keeps what
the check compares: the batch each step's sampler (the gather-normalize
kernel) returned, the batch variance each BatchNorm took in the first
step, the weights after the last; with ``ctx.diagnose`` also each step's
loss and the first step's clipped gradient as the optimizer holds it (its
momentum buffer).
The window then runs that state on, each step on fresh rows (drawn with
replacement) and fresh posterior draws; its rate is the slices of the steps
enqueued over the whole window, ended by a device synchronize.

The control (``ctx.variant == "control"``) puts the reference in the
program's place, its convolutions in float8.
"""

from __future__ import annotations

import gc
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from benchmark import inputs
from benchmark.core import Check, Window
from benchmark.reference import model as ref_model
from benchmark.reference import train as ref_train


class ProgramSide:
    """The program's train state and step."""

    def __init__(self, ctx, weights):
        from pmpu_tpu_torch import make_task
        from pmpu_tpu_torch.data.sampler import sample_batch_vt
        from pmpu_tpu_torch.models.unet import BatchNorm2d
        from pmpu_tpu_torch.train.steps import create_train_state, make_train_step

        cfg = ctx.config
        task = make_task("probunet", n_channels=cfg["input_channels"],
                         n_classes=cfg["num_classes"], num_filters=tuple(cfg["num_filters"]),
                         latent_dim=cfg["latent_dim"], no_convs_fcomb=cfg["no_convs_fcomb"],
                         beta=ctx.workload["beta"], dtype=inputs.DTYPES[cfg["dtype"]],
                         device=ctx.device, seed=0, train=True)
        task.net.load_state_dict(weights)
        self.state = create_train_state(task, seed=0, momentum=ctx.workload["momentum"])
        self.gather = sample_batch_vt
        self.batches = []  # the sampler's batches of the checked steps, on the host
        self.fn = make_train_step(task, acc_steps=1, sampler=self.sample)
        self.lr = ctx.workload["lr"]
        self.names = {id(p): k for k, p in task.net.named_parameters()}
        self.rv0 = {k: weights[k + ".running_var"] for k, m in task.net.named_modules()
                    if isinstance(m, BatchNorm2d)}

    def sample(self, images, labels, triples):
        """The step's sampler: the gather-normalize kernel's (B,S,S,1) f32
        images and int32 labels, kept while ``batches`` is a list."""
        img, lbl = self.gather(images, labels, triples)
        if self.batches is not None:
            self.batches.append((img[..., 0].cpu(), lbl[..., 0].cpu()))
        return img, lbl

    def step(self, images, labels, triples, eps):
        """→ the step's loss, a device scalar."""
        self.state, m = self.fn(self.state, images, labels, triples, self.lr, eps=eps[None])
        return m["loss"]

    def grads(self) -> dict:
        return {self.names[id(p)]: s["momentum_buffer"].clone()
                for p, s in self.state.optimizer.state.items()}

    def params(self) -> dict:
        return {k: p.detach().clone() for k, p in self.state.net.named_parameters()}

    def bn_vars(self) -> dict:
        """The batch variance each BatchNorm took in the one step so far,
        from its running variance (running = 0.9·running + 0.1·batch)."""
        mods = dict(self.state.net.named_modules())
        return {k: (mods[k].running_var - 0.9 * v0) / 0.1 for k, v0 in self.rv0.items()}


class ControlSide:
    """The reference, its convolutions in float8, in the program's place."""

    def __init__(self, ctx, weights):
        wl = ctx.workload
        self.net = ref_model.fp8_convs(inputs.reference_model(ctx.config, ctx.device))
        self.net.load_state_dict(weights, strict=False)
        self.net.train()
        self.opt = torch.optim.SGD(self.net.parameters(), lr=wl["lr"], momentum=wl["momentum"],
                                   dampening=0.0, nesterov=False)
        self.beta, self.clip = wl["beta"], wl["clip"]
        self.vars, self.hooks = ref_train.record_bn_vars(self.net)
        self.batches = []

    def step(self, images, labels, triples, eps):
        img, msk = ref_train.batch(images, labels, triples)
        if self.batches is not None:
            self.batches.append((img[:, 0].cpu(), msk.cpu()))
        self.opt.zero_grad(set_to_none=True)
        with ref_model.exact_f32():
            loss = ref_train.neg_elbo(self.net, img, msk, eps, self.beta)
            loss.backward()
        torch.nn.utils.clip_grad_value_(self.net.parameters(), self.clip)
        self.opt.step()
        return loss.detach()

    def grads(self) -> dict:
        return {k: s["momentum_buffer"].clone() for k, p in self.net.named_parameters()
                for s in [self.opt.state.get(p)] if s}

    def bn_vars(self) -> dict:
        for h in self.hooks:
            h.remove()
        self.hooks = []
        return dict(self.vars)

    def params(self) -> dict:
        return {k: p.detach().clone() for k, p in self.net.named_parameters()}


@dataclass
class Train:
    weights: dict
    scans: tuple          # ((N,S,S,S) images, (N,S,S,S) labels) on the device
    stacks: tuple         # their (3,N,S,S,S) view stacks: what a step reads
    rows: torch.Tensor    # (R,3) (scan, view, slice) planes that hold labels
    gen: torch.Generator  # the window's draws
    side: object
    checked: dict         # what set-up kept for the check


def draw(st: Train, batch: int, latent: int, rows=None):
    """One step's (batch,3) triples and (batch,latent) posterior draws."""
    if rows is None:
        rows = torch.randint(0, st.rows.shape[0], (batch,), generator=st.gen,
                             device=st.rows.device)
    eps = torch.randn((batch, latent), generator=st.gen, device=st.rows.device)
    return st.rows[rows], eps


def setup(ctx):
    cfg, wl = ctx.config, ctx.workload
    dev = ctx.device
    weights = inputs.make_weights(cfg, ctx.seed, dev)
    images, labels = inputs.make_scans(wl["scans"], ctx.seed, cfg["scan_shape"], cfg["cube"],
                                       dev)
    inputs.balance_classes(weights, cfg, images[0], ctx.seed)
    stacks = (ref_train.view_planes(images).contiguous(),
              ref_train.view_planes(labels).contiguous())
    held = stacks[1].amax(dim=(-2, -1)) > 0            # (3,N,S)
    v, n, i = held.nonzero(as_tuple=True)
    rows = torch.stack([n, v, i], dim=1)
    gen = torch.Generator(device=dev).manual_seed(inputs.sub_seed(ctx.seed, inputs.DRAWS))
    side = ControlSide(ctx, weights) if ctx.variant == "control" else ProgramSide(ctx, weights)
    st = Train(weights, (images, labels), stacks, rows, gen, side, {})

    b, k = wl["batch"], wl["checked_steps"]
    if k * b > rows.shape[0]:
        raise ValueError(f"{k} steps of {b} distinct rows need {k * b} planes with labels, "
                         f"the scans have {rows.shape[0]}")
    perm = torch.randperm(rows.shape[0], generator=gen, device=dev)[:k * b].view(k, b)
    triples, eps, losses = [], [], []
    for j in range(k):
        t, e = draw(st, b, cfg["latent_dim"], perm[j])
        losses.append(side.step(*stacks, t, e))
        triples.append(t)
        eps.append(e)
        if j == 0:
            st.checked.update(bn_vars=side.bn_vars())
            if ctx.diagnose:
                st.checked.update(grads=side.grads())
    st.checked.update(losses=torch.stack(losses), params=side.params(), batches=side.batches,
                      triples=torch.stack(triples), eps=torch.stack(eps))
    side.batches = None
    return st


def window(ctx, st):
    b, lat = ctx.workload["batch"], ctx.config["latent_dim"]
    steps = 0
    loss = None
    t0 = time.perf_counter()
    end = t0 + ctx.seconds
    while time.perf_counter() < end:
        ctx.tracer.tick()
        t, e = draw(st, b, lat)
        loss = st.side.step(*st.stacks, t, e)
        steps += 1
    ctx.tracer.tick()
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    window_s = time.perf_counter() - t0
    failed = 0 if loss is not None and bool(torch.isfinite(loss)) else 1
    return Window(attempted=steps, failed=failed,
                  e2e={"train_slices_per_s": steps * b / window_s},
                  counts={"steps": steps, "slices": steps * b, "window_s": window_s})


def _leaf_gaps(ours: dict, ref: dict, leaves) -> dict:
    """{leaf: |‖ours‖ − ‖ref‖| / max(‖ref‖, the median leaf's ‖ref‖)} over
    ``leaves``; a leaf missing from ``ours`` has norm 0."""
    norms = {k: float(ref[k].norm()) for k in leaves}
    med = float(np.median(list(norms.values())))
    return {k: abs((float(ours[k].float().norm()) if k in ours else 0.0) - norms[k])
            / max(norms[k], med) for k in leaves}


def _rows_off(ours: list, ref: list) -> int:
    """The rows of the checked steps' batches whose image or label plane
    differs in any pixel from the reference's: the kernel divides each
    plane by its max as IEEE f32 does, so a sound batch is bit-equal."""
    off = 0
    for (img, lbl), (rimg, rlbl) in zip(ours, ref, strict=True):
        img, lbl = img.reshape(rimg.shape), lbl.reshape(rlbl.shape).long()
        off += int(((img != rimg.cpu()).flatten(1).any(1)
                    | (lbl != rlbl.cpu()).flatten(1).any(1)).sum())
    return off


def check(ctx, st, win):
    """The reference follows the checked steps from the same weights, rows
    and draws. The numbers compared: the rows of the steps' batches that
    differ from the reference's gather of the same planes
    (``batch_rows_off``); the batch variance each BatchNorm took in step 1
    (``bn_var_gap``, the median layer's relative gap; the program's from
    its running variance); the weights' change over the steps
    (``change_norm_gap_median``, the median leaf's gap of norms). Leaves
    whose reference gradient before the clip is under a thousandth of the
    median leaf's (a conv bias under BatchNorm, zero to rounding) are left
    out: after the clip their rounding reads like a gradient. With
    ``ctx.diagnose`` also: each step's loss (the worst relative gap), the
    first step's clipped gradient and the change (the worst leaf's gap of
    norms), and that worst leaf's gradient before the clip over the median
    leaf's; the three worst leaves of each go to standard error."""
    wl = ctx.workload
    kept = st.checked
    st.side = None
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    net = inputs.reference_model(ctx.config, ctx.device)
    net.load_state_dict(st.weights, strict=False)
    ref = ref_train.run_steps(net, st.scans[0], st.scans[1], kept["triples"], kept["eps"],
                              wl["lr"], wl["momentum"], wl["clip"], wl["beta"])
    numbers = {"batch_rows_off": _rows_off(kept["batches"], ref["batches"])}
    bn = [float((kept["bn_vars"][k] - v).norm() / v.norm()) for k, v in ref["bn_var1"].items()]
    numbers["bn_var_gap"] = float(np.median(bn))
    med = float(np.median(list(ref["raw1"].values())))
    leaves = [k for k, v in ref["raw1"].items() if v >= 1e-3 * med]
    w0 = st.weights
    ours = {k: kept["params"][k] - w0[k] for k in leaves if k in kept["params"]}
    theirs = {k: ref["params"][k] - w0[k] for k in leaves}
    change = _leaf_gaps(ours, theirs, leaves)
    numbers["change_norm_gap_median"] = float(np.median(list(change.values())))
    if ctx.diagnose:
        losses = kept["losses"].double().cpu().numpy()
        numbers["loss_gap"] = float(np.max(np.abs(losses - ref["loss"]) / np.abs(ref["loss"])))
        for name, gaps in (("grad_norm_gap", _leaf_gaps(kept["grads"], ref["grad1"], leaves)),
                           ("change_norm_gap", change)):
            worst = sorted(gaps.items(), key=lambda kv: -kv[1])[:3]
            numbers[name] = worst[0][1]
            numbers[name + "_leaf_raw_share"] = ref["raw1"][worst[0][0]] / med
            print(f"{name} worst leaves: " + ", ".join(
                f"{k} {v:.4g} (gradient before the clip {ref['raw1'][k] / med:.4g} of the "
                f"median leaf's, {ref['grad1'][k].numel()} elements)" for k, v in worst),
                file=sys.stderr)
    lim = wl["limits"]
    return [Check(name, value, lim.get(name)) for name, value in numbers.items()]
