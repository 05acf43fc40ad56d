"""Hierarchical Probabilistic U-Net (Kohl et al. 2019, arXiv:1905.13077;
deepmind-research ``hierarchical_probabilistic_unet/model.py`` and
``unet_utils.py``), its prior
path for inference. The JAX package has no such model.

* ``ResBlock``  — pre-activation residual block (``unet_utils.res_block``):
                  relu → conv3×3→d → relu → conv3×3→d → relu → conv1×1→c
                  (convs_per_block − 1 3×3 convs, then the 1×1), plus the
                  skip (x, or a 1×1 conv of x where its channel count
                  differs); no normalization
* ``encoder``   — per level ``blocks_per_level`` blocks, kept as enc[l], then
                  a 2×2 stride-2 average pool (floor sizes; not after the last)
* ``latents``   — the prior's latent decoder from enc[L−1]: per latent level
                  a 1×1 f32 head → (μ, log σ) per pixel, z = μ + σ·ε in f32,
                  concat(z, features), nearest ×2, concat with the encoder's
                  map of that scale, the blocks
* ``stitch``    — the stitching decoder's levels (×2, concat, blocks) and the
                  1×1 class head

A map smaller than the skip it joins is zero-padded to it, as ``unet.Up``
pads (170² inputs are not divisible by 2^7). Sampling decodes S draws in one
batched pass: ``encode`` runs once, and its maps are read by every draw
through a broadcast in the concatenations, never recomputed or copied per
draw; ε is given per latent level, (S, n, latent, h, w).

bf16 as in ``unet.py``: parameters f32, each conv casts to the compute dtype,
the heads and z in f32, z cast to the compute dtype where it is
concatenated, the class logits cast to f32. Public tensors are NHWC;
inside, NCHW in channels_last memory.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from pmpu_tpu_torch.models import initializers as pinit
from pmpu_tpu_torch.models.unet import Conv2d, _pad_to_match, to_nchw, to_nhwc

# the published LIDC setting
CHANNELS_PER_BLOCK = (24, 48, 96, 192, 192, 192, 192, 192)
LATENT_DIMS = (1, 1, 1, 1)


def _conv(cin, cout, k, dtype):
    # the published initializers: orthogonal weights, truncated-normal biases
    return Conv2d(cin, cout, k, padding=k // 2, compute_dtype=dtype, init_fn=pinit.ortho_trunc_)


class ResBlock(nn.Module):
    def __init__(self, cin, c, d, convs: int = 3, dtype=None):
        super().__init__()
        chans = [cin] + [d] * (convs - 1) + [c]
        kernels = [3] * (convs - 1) + [1]
        self.convs = nn.ModuleList(_conv(a, b, k, dtype)
                                   for a, b, k in zip(chans, chans[1:], kernels))
        self.skip = _conv(cin, c, 1, dtype) if cin != c else None

    def forward(self, x):
        r = x
        for conv in self.convs:
            r = conv(F.relu(r))
        return (x if self.skip is None else self.skip(x)) + r


def _blocks(cin, c, d, n, convs, dtype):
    return nn.ModuleList(ResBlock(cin if i == 0 else c, c, d, convs, dtype) for i in range(n))


def _nhwc(t, draws: int, n: int):
    """A (N,C,h,w) map as (draws, n, h, w, C): N = draws·n slices, or n
    slices that every draw shares (a broadcast view, not a copy)."""
    v = t.permute(0, 2, 3, 1)
    if t.shape[0] == draws * n:
        return v.reshape(draws, n, *v.shape[1:])
    return v.unsqueeze(0).expand(draws, *v.shape)


def _cat(parts, draws: int, n: int):
    """Channel concat of maps of draws·n or n (shared) slices → (draws·n,
    ΣC, h, w) in channels_last memory: one copy of each part."""
    out = torch.cat([_nhwc(t, draws, n) for t in parts], dim=-1)
    return out.flatten(0, 1).permute(0, 3, 1, 2)


def _up(x, skip):
    """Nearest ×2 of x, zero-padded to skip's size."""
    return _pad_to_match(F.interpolate(x, scale_factor=2, mode="nearest"), skip)


class HierarchicalProbUNet(nn.Module):
    def __init__(
        self,
        input_channels: int = 1,
        num_classes: int = 3,
        channels_per_block: Sequence[int] = CHANNELS_PER_BLOCK,
        down_channels_per_block: Optional[Sequence[int]] = None,
        convs_per_block: int = 3,
        blocks_per_level: int = 3,
        latent_dims: Sequence[int] = LATENT_DIMS,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        ch = list(channels_per_block)
        down = list(down_channels_per_block or [c // 2 for c in ch])
        n_lev, n_lat = len(ch), len(latent_dims)
        if n_lat > n_lev - 1:
            raise ValueError(f"{n_lat} latent levels need more than {n_lev} levels")
        self.num_classes = num_classes
        self.channels_per_block = tuple(ch)
        self.latent_dims = tuple(latent_dims)
        self.dtype = dtype
        bpl, cpb = blocks_per_level, convs_per_block
        self.encoder = nn.ModuleList(
            _blocks(input_channels if l == 0 else ch[l - 1], ch[l], down[l], bpl, cpb, dtype)
            for l in range(n_lev))
        # the heads compute in f32 (no compute dtype)
        self.latent_heads = nn.ModuleList(
            _conv(ch[n_lev - 1 - k], 2 * lat, 1, None) for k, lat in enumerate(latent_dims))
        self.latent_blocks = nn.ModuleList(
            _blocks(lat + ch[n_lev - 1 - k] + ch[n_lev - 2 - k], ch[n_lev - 2 - k],
                    down[n_lev - 2 - k], bpl, cpb, dtype) for k, lat in enumerate(latent_dims))
        self.stitch_blocks = nn.ModuleList(
            _blocks(ch[e + 1] + ch[e], ch[e], down[e], bpl, cpb, dtype)
            for e in range(n_lev - 2 - n_lat, -1, -1))
        self.logits = _conv(ch[0], num_classes, 1, dtype)

    def encode(self, x_nhwc) -> list:
        """(n,H,W,cin) slices → the encoder's map of each level, NCHW in the
        compute dtype."""
        x = to_nchw(x_nhwc)
        if self.dtype is not None:
            x = x.to(self.dtype)
        enc = []
        for level, blocks in enumerate(self.encoder):
            if level:
                x = F.avg_pool2d(x, 2, 2)
            for b in blocks:
                x = b(x)
            enc.append(x)
        return enc

    def latent_sizes(self, enc) -> list:
        """(h, w) of each latent level's noise."""
        return [tuple(enc[-1 - k].shape[2:]) for k in range(len(self.latent_dims))]

    def latents(self, enc, eps=None):
        """The prior's latent decoder for all draws at once → (draws·n,C,h,w)
        features. ``eps``: per latent level (S,n,latent,h,w) f32 noise of S
        draws, or None to decode μ (one draw)."""
        n = enc[0].shape[0]
        draws = 1 if eps is None else eps[0].shape[0]
        feats = enc[-1]  # shared by the draws until the first concat
        for k, (head, blocks) in enumerate(zip(self.latent_heads, self.latent_blocks)):
            mu, log_sigma = head(feats.float()).split(self.latent_dims[k], dim=1)
            if eps is None:
                z = mu
            elif feats.shape[0] == n:
                z = (mu + torch.exp(log_sigma) * eps[k]).flatten(0, 1)
            else:
                z = mu + torch.exp(log_sigma) * eps[k].flatten(0, 1)
            lo = _cat([z.to(feats.dtype), feats], draws, n)
            feats = _cat([_up(lo, enc[-2 - k]), enc[-2 - k]], draws, n)
            for b in blocks:
                feats = b(feats)
        return feats

    def stitch(self, feats, enc):
        """The stitching decoder and the class head → (draws,n,H,W,C) f32
        logits."""
        n = enc[0].shape[0]
        draws = feats.shape[0] // n
        for j, blocks in enumerate(self.stitch_blocks):
            skip = enc[len(enc) - 2 - len(self.latent_dims) - j]
            feats = _cat([_up(feats, skip), skip], draws, n)
            for b in blocks:
                feats = b(feats)
        return to_nhwc(self.logits(feats).float()).unflatten(0, (draws, n))

    def forward(self, x_nhwc, eps=None):
        """(n,H,W,cin) → (draws,n,H,W,C) f32 logits (see ``latents``)."""
        enc = self.encode(x_nhwc)
        return self.stitch(self.latents(enc, eps), enc)
