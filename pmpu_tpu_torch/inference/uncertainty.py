"""Latent-space sampling of one slice (counterpart of
``pmpu_tpu/inference/uncertainty.py``): the n×n grid of decoded
segmentations that sweeps latent dims 0 and 1 over μ ± k·σ (σ scaled ×40,
reference ``visualize_sampling.py:78``), and per-pixel uncertainty
(entropy, class-probability variance) over N prior draws. Each decodes all
its latents in one batched ``ProbabilisticUNet.decode``.

The decode is the network's plain per-sample one, as in the JAX package:
the fcomb mean-decode kernel returns only the mean logits of the draws, and
these maps need each draw's probabilities. No kernel is reached.

Randomness: ``uncertainty_maps`` draws its eps from a ``torch.Generator``
(seeded 0 by default) unless an explicit ``eps`` is given, which wins (the
tests inject the JAX package's draws).
"""

from __future__ import annotations

import numpy as np
import torch

from pmpu_tpu_torch.train.tasks import _eval_mode


def latent_grid(mu: np.ndarray, sigma: np.ndarray, n_preds: int = 3, scale: float = 40.0):
    """z grid of ``visualize_sampling.py:23-26``: dims 0/1 swept over integer
    multiples of (scaled) sigma around mu; the other dims pinned at mu."""
    mu = np.asarray(mu).reshape(-1)
    sigma = np.asarray(sigma).reshape(-1) * scale
    half = n_preds // 2
    zs = []
    for z0 in range(-half, half + 1):
        for z1 in range(-half, half + 1):
            z = mu.copy()
            z[0] = z0 * sigma[0] + mu[0]
            z[1] = z1 * sigma[1] + mu[1]
            zs.append(z)
    return np.stack(zs).astype(np.float32)  # (n_preds², latent)


def _slice_input(net, img_slice) -> torch.Tensor:
    """One (H,W) or (1,H,W,1) slice as a (1,H,W,1) f32 tensor on the net's device."""
    x = torch.as_tensor(np.asarray(img_slice, np.float32))
    if x.dim() == 2:
        x = x[None, ..., None]
    return x.to(next(net.parameters()).device)


@torch.inference_mode()
def sample_grid(task, img_slice, n_preds: int = 3, sigma_scale: float = 40.0):
    """Decode the latent grid for one slice.

    Returns (grid logits (n², H, W, C) f32 numpy, mu, sigma)."""
    net = task.net
    x = _slice_input(net, img_slice)
    with _eval_mode(net):
        out = net(x)
        mu = out.prior.loc[0].cpu().numpy()
        sigma = out.prior.scale[0].cpu().numpy()
        zs = torch.from_numpy(latent_grid(mu, sigma, n_preds, sigma_scale)).to(x.device)
        feats = out.unet_features.expand((zs.shape[0],) + out.unet_features.shape[1:])
        grid = net.decode(feats, zs)
    return grid.cpu().numpy(), mu, sigma


@torch.inference_mode()
def uncertainty_maps(task, img_slice, n_samples: int = 16, generator=None, eps=None):
    """Per-pixel mean class probabilities (H,W,C), predictive entropy (H,W)
    and class-probability variance (H,W, the population variance over the
    draws averaged over the classes) over ``n_samples`` prior draws.

    ``eps``: (n_samples, 1, latent) standard-normal draws; when None they
    come from ``generator`` (on the net's device; None: seeded 0)."""
    net = task.net
    x = _slice_input(net, img_slice)
    with _eval_mode(net):
        out = net(x)
        loc, scale = out.prior.loc, out.prior.scale
        if eps is None:
            if generator is None:
                generator = torch.Generator(device=x.device).manual_seed(0)
            eps = torch.randn((n_samples,) + tuple(loc.shape), generator=generator,
                              device=x.device)
        elif not isinstance(eps, torch.Tensor):
            eps = torch.from_numpy(np.array(eps, np.float32))
        eps = eps.to(loc)
        zs = (loc[None] + scale[None] * eps).reshape(n_samples, -1)
        feats = out.unet_features.expand((n_samples,) + out.unet_features.shape[1:])
        probs = torch.softmax(net.decode(feats, zs), dim=-1)  # (N,H,W,C)
    mean_p = probs.mean(dim=0)
    entropy = -torch.sum(mean_p * torch.log(mean_p + 1e-12), dim=-1)
    var = probs.var(dim=0, correction=0).mean(dim=-1)
    return mean_p.cpu().numpy(), entropy.cpu().numpy(), var.cpu().numpy()
