"""The Hierarchical Probabilistic U-Net's sampling path (Kohl et al., "A
Hierarchical Probabilistic U-Net for Modeling Multi-Scale Ambiguities",
arXiv:1905.13077; code: github.com/google-deepmind/deepmind-research,
``hierarchical_probabilistic_unet/model.py``: ``_HierarchicalCore`` and
``_StitchingDecoder``; ``unet_utils.py``: ``res_block``, ``resize_down``,
``resize_up``), in plain torch, written from the published
formulation and not from the program. Computed in float32 with TF32 off for
cuDNN and matmuls (``model.exact_f32``); the benchmark's frozen copy, which
the program under test is held to. It loads the program's ``state_dict`` by
the same names.

  residual block res(x; c, d):  r = relu(x) → conv3×3→d → relu → conv3×3→d
      → relu → conv1×1→c (convs_per_block − 1 3×3 convs to d, each followed
      by relu, then the 1×1 to c); skip = x, or a 1×1 conv of x to c channels
      where x has another channel count; out = skip + r
  encoder:  at level l, ``blocks_per_level`` blocks at (ch[l], down[l]),
      kept as enc[l], then a 2×2 stride-2 average pool (not after the last)
  latent decoder (the prior), from enc[L−1], for k = 0 .. K−1: a 1×1 conv to
      2·latent → (μ, log σ) per pixel; z = μ + exp(log σ)·ε; concat(z,
      features); nearest ×2; concat with enc[L−2−k]; the blocks at
      ch[L−2−k]
  stitching decoder:  for the levels below the last latent one: nearest ×2,
      concat with enc of that scale, the blocks; then a 1×1 conv to the
      classes

Each draw runs the whole prior core, the encoder included, then the
stitching decoder, as the published sampling does.

Departures from the source, each an assumption of the configuration:
  * sizes not divisible by 2^(L−1) (170 is not): the average pool floors
    (VALID), and a ×2 map smaller than the skip it joins is zero-padded to
    the skip's size, d//2 before and d − d//2 after (``model.TUp``'s pad);
    the published code needs sizes divisible by 2^(L−1);
  * the nearest ×2 upsample, the VALID pool and the block's form are the
    equations above, as ``unet_utils.py`` is recalled: no copy of it is in
    the repository;
  * NCHW where the source is NHWC (the same arithmetic);
  * no posterior core, no GECO loss (inference only);
  * the noise ε is given, per latent level: (S, n, latent, h, w) for S draws
    of n slices, drawn by :func:`draw_eps` in level order from the chunk's
    generator (the serving path's documented protocol).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.infer import (chunk_plan, derive_seed, normalize, slabs, to_grid,
                                       view_bases, wire)
from benchmark.reference.model import exact_f32


class TResBlock(nn.Module):
    def __init__(self, cin, c, d, convs=3):
        super().__init__()
        chans = [cin] + [d] * (convs - 1) + [c]
        kernels = [3] * (convs - 1) + [1]
        self.convs = nn.ModuleList(nn.Conv2d(a, b, k, padding=k // 2)
                                   for a, b, k in zip(chans, chans[1:], kernels))
        self.skip = nn.Conv2d(cin, c, 1) if cin != c else None

    def forward(self, x):
        r = x
        for conv in self.convs:
            r = conv(F.relu(r))
        return (x if self.skip is None else self.skip(x)) + r


def _blocks(cin, c, d, n, convs):
    return nn.ModuleList(TResBlock(cin if i == 0 else c, c, d, convs) for i in range(n))


def _up_join(x, skip):
    """concat(nearest ×2 of x, zero-padded to skip's size; skip)."""
    x = F.interpolate(x, scale_factor=2, mode="nearest")
    dy, dx = skip.shape[2] - x.shape[2], skip.shape[3] - x.shape[3]
    x = F.pad(x, [dx // 2, dx - dx // 2, dy // 2, dy - dy // 2])
    return torch.cat([x, skip], dim=1)


class THierarchicalProbUNet(nn.Module):
    def __init__(self, cin=1, num_classes=3, channels=(24, 48, 96, 192, 192, 192, 192, 192),
                 down_channels=None, convs_per_block=3, blocks_per_level=3,
                 latent_dims=(1, 1, 1, 1)):
        super().__init__()
        ch = list(channels)
        down = list(down_channels or [c // 2 for c in ch])
        n_lev, n_lat = len(ch), len(latent_dims)
        if n_lat > n_lev - 1:
            raise ValueError(f"{n_lat} latent levels need more than {n_lev} levels")
        self.latent_dims = tuple(latent_dims)
        bpl, cpb = blocks_per_level, convs_per_block
        self.encoder = nn.ModuleList(
            _blocks(cin if l == 0 else ch[l - 1], ch[l], down[l], bpl, cpb) for l in range(n_lev))
        self.latent_heads = nn.ModuleList(
            nn.Conv2d(ch[n_lev - 1 - k], 2 * lat, 1) for k, lat in enumerate(latent_dims))
        self.latent_blocks = nn.ModuleList(
            _blocks(lat + ch[n_lev - 1 - k] + ch[n_lev - 2 - k], ch[n_lev - 2 - k],
                    down[n_lev - 2 - k], bpl, cpb) for k, lat in enumerate(latent_dims))
        self.stitch_blocks = nn.ModuleList(
            _blocks(ch[e + 1] + ch[e], ch[e], down[e], bpl, cpb)
            for e in range(n_lev - 2 - n_lat, -1, -1))
        self.logits = nn.Conv2d(ch[0], num_classes, 1)

    def encode(self, x) -> list:
        enc = []
        for level, blocks in enumerate(self.encoder):
            if level:
                x = F.avg_pool2d(x, 2, 2)
            for b in blocks:
                x = b(x)
            enc.append(x)
        return enc

    def prior_core(self, x, eps=None):
        """(n,cin,H,W) → (decoder features, encoder outputs) of one draw; ``eps``
        the draw's noise by level, (n, latent, h, w) each, or None (z = μ).
        The heads compute in the network's dtype, z in f32."""
        enc = self.encode(x)
        feats = enc[-1]
        for k, (head, blocks) in enumerate(zip(self.latent_heads, self.latent_blocks)):
            mu, log_sigma = head(feats).float().split(self.latent_dims[k], dim=1)
            z = mu if eps is None else mu + torch.exp(log_sigma) * eps[k]
            feats = _up_join(torch.cat([z.to(feats.dtype), feats], dim=1), enc[-2 - k])
            for b in blocks:
                feats = b(feats)
        return feats, enc

    def stitch(self, feats, enc):
        for j, blocks in enumerate(self.stitch_blocks):
            feats = _up_join(feats, enc[len(enc) - 2 - len(self.latent_dims) - j])
            for b in blocks:
                feats = b(feats)
        return self.logits(feats)

    def forward(self, x, eps=None):
        """One draw, the whole prior core and the stitching decoder: (n,cin,H,W)
        → (n,C,H,W) logits."""
        return self.stitch(*self.prior_core(x, eps))


def latent_sizes(net: THierarchicalProbUNet, size: int) -> list:
    """The (h, w) of each latent level on size² slices (floor halving)."""
    n_lev = len(net.encoder)
    return [(size >> (n_lev - 1 - k),) * 2 for k in range(len(net.latent_dims))]


def draw_eps(net, g: torch.Generator, samples: int, n: int, size: int) -> list:
    """The noise of a chunk of n slices: one ``randn`` a latent level, in
    level order, (samples, n, latent, h, w) f32 from the chunk's generator."""
    return [torch.randn((samples, n, lat, h, w), generator=g, device=g.device)
            for lat, (h, w) in zip(net.latent_dims, latent_sizes(net, size))]


@torch.no_grad()
def chunk_logits(net, x: torch.Tensor, eps: list) -> torch.Tensor:
    """(b,1,S,S) f32 slices, the draws' noise by level ((samples,b,latent,h,w)
    each) → (b,S,S,C) f32 mean logits over the draws, each draw a whole
    forward; a network in another dtype computes in it."""
    dt = next(net.parameters()).dtype
    x = x.to(dt)
    acc = 0
    for s in range(eps[0].shape[0]):
        acc = acc + net(x, [e[s] for e in eps]).float()
    return (acc / eps[0].shape[0]).permute(0, 2, 3, 1)


@torch.no_grad()
def fused_probs(net, volume: np.ndarray, cfg: dict, seed: int) -> torch.Tensor:
    """(S,S,S,C) f32 fused class probabilities of one host volume, on the
    network's device, chunk by chunk (the program's chunk plan, so that it
    fits on the card); ``seed`` is the volume's own. The network computes in
    its own dtype, everything around it in f32."""
    device = next(net.parameters()).device
    bases = None if cfg["views"] == 3 else view_bases(cfg["views"])
    with exact_f32():
        vol = wire(volume, cfg["wire"]).to(device)
        planes = slabs(vol, bases)
        total, s = planes.shape[0], planes.shape[-1]
        b, n = chunk_plan(total, s, s)
        probs = torch.empty((total, s, s, cfg["num_classes"]), device=device)
        for i in range(n):
            x = normalize(planes[i * b:(i + 1) * b])
            g = torch.Generator(device=device).manual_seed(derive_seed(seed, i))
            eps = draw_eps(net, g, cfg["prior_samples"], b, s)
            logits = chunk_logits(net, x[:, None], [e[:, :x.shape[0]] for e in eps])
            probs[i * b:(i + 1) * b] = torch.softmax(logits, dim=-1)
        views = to_grid(probs, bases)
        fused = views[0]
        for v in views[1:]:
            fused = fused + v
        return fused / float(len(views))
