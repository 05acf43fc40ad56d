"""The reference's train step, plain PyTorch in float32 with TF32 off: the
batch of (scan, view, slice) planes cut from the scans, each divided by its
max; the three towers in train-mode BatchNorm (batch statistics); the
posterior's draw z = μ_q + σ_q·ε decoded by the fcomb; −ELBO = the
cross-entropy summed over the batch's pixels + β × the KL(q‖p) averaged over
the batch; the backward; every gradient clipped to ±``clip``; SGD with
momentum (no dampening, not Nesterov).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.model import exact_f32


def view_planes(volumes: torch.Tensor) -> torch.Tensor:
    """(N,S,S,S) → (3,N,S,S,S): plane i of view v of scan n is
    vol[i], vol[:, i] or vol[:, :, i] for v = 0, 1, 2."""
    return torch.stack([volumes, volumes.permute(0, 2, 1, 3), volumes.permute(0, 3, 1, 2)])


def batch(planes_img, planes_lbl, triples):
    """(B,1,S,S) normalized images and (B,S,S) int64 labels of the rows."""
    n, v, i = triples[:, 0], triples[:, 1], triples[:, 2]
    img = planes_img[v, n, i]
    m = img.amax(dim=(-2, -1), keepdim=True)
    img = torch.where(m == 0, img, img / m)
    return img[:, None], planes_lbl[v, n, i].long()


def neg_elbo(net, img, msk, eps, beta: float):
    mu_q, ls_q = net.posterior(img, msk[:, None].float())
    mu_p, ls_p = net.prior(img)
    feats = net.unet(img)
    logits = net.fcomb(feats, mu_q + torch.exp(ls_q) * eps)
    rec = F.cross_entropy(logits, msk, reduction="sum")
    kl = ((ls_p - ls_q) + (torch.exp(2 * ls_q) + (mu_q - mu_p) ** 2) / (2 * torch.exp(2 * ls_p))
          - 0.5).sum(-1).mean()
    return rec + beta * kl


def record_bn_vars(net) -> tuple:
    """({}, hooks): while the hooks stay, each forward of ``net`` stores, by
    BatchNorm layer name, the biased f32 variance of its input over the
    batch and the pixels (the batch statistic a train-mode BatchNorm
    normalizes by)."""
    out = {}

    def hook(name):
        def fn(module, args):
            out[name] = args[0].detach().float().var(dim=(0, 2, 3), unbiased=False)
        return fn

    hooks = [m.register_forward_pre_hook(hook(n)) for n, m in net.named_modules()
             if isinstance(m, torch.nn.BatchNorm2d)]
    return out, hooks


def run_steps(net, images, labels, triples, eps, lr: float, momentum: float, clip: float,
              beta: float) -> dict:
    """The steps of ``triples`` (steps, B, 3) and ``eps`` (steps, B, latent)
    from the network's present weights → {"loss": [per step], "bn_var1":
    {BatchNorm: step 1's batch variance}, "raw1": {name: the norm of step
    1's gradient before the clip}, "grad1": {name: the clipped gradient of
    step 1, for the leaves that have one}, "params": {name: the weights
    after}, "batches": [per step, its (B,S,S) images and labels]}."""
    planes_img, planes_lbl = view_planes(images), view_planes(labels)
    named = [(k, p) for k, p in net.named_parameters()]
    opt = torch.optim.SGD([p for _, p in named], lr=lr, momentum=momentum, dampening=0.0,
                          nesterov=False)
    net.train()
    out = {"loss": [], "batches": []}
    out["bn_var1"], hooks = record_bn_vars(net)
    with exact_f32():
        for k in range(triples.shape[0]):
            img, msk = batch(planes_img, planes_lbl, triples[k].long())
            out["batches"].append((img[:, 0], msk))
            opt.zero_grad(set_to_none=True)
            loss = neg_elbo(net, img, msk, eps[k], beta)
            loss.backward()
            if k == 0:
                for h in hooks:
                    h.remove()
                out["raw1"] = {name: float(p.grad.norm()) for name, p in named
                               if p.grad is not None}
            torch.nn.utils.clip_grad_value_([p for _, p in named], clip)
            if k == 0:
                out["grad1"] = {name: p.grad.detach().clone() for name, p in named
                                if p.grad is not None}
            opt.step()
            out["loss"].append(float(loss.detach()))
    out["params"] = {name: p.detach() for name, p in named}
    return out
