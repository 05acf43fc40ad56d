"""Probabilistic U-Net (counterpart of ``pmpu_tpu/models/prob_unet.py:42-290``).

* ``Encoder``                 — per scale (i>0) 2×2 ceil-mode average pool,
                                then ``no_convs_per_block`` × [3×3 conv → BN
                                → ReLU]
* ``AxisAlignedConvGaussian`` — Encoder → global spatial mean (f32) → 1×1
                                f32 conv → (μ, log σ) → ``DiagGaussian``
* ``Fcomb``                   — the ``no_convs_fcomb`` 1×1 convs that combine
                                z with the U-Net features; decoded by
                                ``ProbabilisticUNet.decode_samples``
* ``ProbabilisticUNet``       — UNet backbone (``apply_last_layer=False``),
                                prior p(z|x) and posterior q(z|x,y); eval
                                never runs the posterior, which exists so
                                that the reference weights load strictly.

Tensors at the public functions are NHWC, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from pmpu_tpu_torch.models import initializers as pinit
from pmpu_tpu_torch.models.distributions import DiagGaussian
from pmpu_tpu_torch.models.unet import Conv2d, UNet, conv_bn_relu, to_nchw
from pmpu_tpu_torch.ops.cuda.fcomb_mean import decode_samples_reference


def avg_pool_ceil(x: torch.Tensor) -> torch.Tensor:
    """2×2 stride-2 average pool, torch ``ceil_mode=True``: a window clipped
    by the border averages only its valid elements (JAX prob_unet.py:42)."""
    return F.avg_pool2d(x, 2, 2, ceil_mode=True)


class AvgPoolCeil(nn.Module):
    def forward(self, x):
        return avg_pool_ceil(x)


class Encoder(nn.Module):
    """Conv tower; ``layers`` indices follow the reference Sequential
    ([AvgPool (i>0)], then Conv, BN, ReLU per conv)."""

    def __init__(self, cin, num_filters: Sequence[int], no_convs_per_block=2,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        layers, prev = [], cin
        for i, f in enumerate(num_filters):
            if i != 0:
                layers.append(AvgPoolCeil())
            for _ in range(no_convs_per_block):
                layers += conv_bn_relu(prev, f, dtype, init_fn=pinit.he_trunc_)
                prev = f
        self.layers = nn.Sequential(*layers)

    def forward(self, x_nchw):
        if self.dtype is not None:
            x_nchw = x_nchw.to(self.dtype)
        return self.layers(x_nchw)


class AxisAlignedConvGaussian(nn.Module):
    def __init__(self, cin, num_filters, latent_dim, no_convs_per_block=2, dtype=None):
        super().__init__()
        self.latent_dim = latent_dim
        self.encoder = Encoder(cin, num_filters, no_convs_per_block, dtype)
        # no compute dtype: the head runs in f32 on the f32 mean (JAX :142-149)
        self.conv_layer = Conv2d(num_filters[-1], 2 * latent_dim, 1,
                                 init_fn=pinit.he_normal_bias_)

    def forward(self, x_nhwc) -> DiagGaussian:
        enc = self.encoder(to_nchw(x_nhwc))
        enc = enc.float().mean(dim=(2, 3), keepdim=True)
        mls = self.conv_layer(enc)[:, :, 0, 0]
        return DiagGaussian(mls[:, : self.latent_dim], mls[:, self.latent_dim :])


class Fcomb(nn.Module):
    """Parameters of the fcomb: ``layers`` = (1×1 conv, ReLU) × (ncf−1), the
    first over concat(features, z); ``last_layer`` the linear class head."""

    def __init__(self, num_filters, latent_dim, num_classes, no_convs_fcomb=4, dtype=None):
        super().__init__()
        f0 = num_filters[0]
        layers = []
        for i in range(no_convs_fcomb - 1):
            cin = f0 + latent_dim if i == 0 else f0
            layers += [Conv2d(cin, f0, 1, compute_dtype=dtype, init_fn=pinit.ortho_trunc_),
                       nn.ReLU()]
        self.layers = nn.Sequential(*layers)
        self.last_layer = Conv2d(f0, num_classes, 1, compute_dtype=dtype,
                                 init_fn=pinit.ortho_trunc_)


class ProbUNetOutput(NamedTuple):
    unet_features: torch.Tensor  # (N,H,W,num_filters[0]) NHWC, compute dtype
    prior: DiagGaussian
    posterior: Optional[DiagGaussian]


class ProbabilisticUNet(nn.Module):
    def __init__(
        self,
        input_channels: int = 1,
        num_classes: int = 3,
        num_filters: Sequence[int] = (64, 128, 256, 512, 1024),
        latent_dim: int = 6,
        no_convs_per_block: int = 2,
        no_convs_fcomb: int = 4,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.num_classes = num_classes
        self.num_filters = tuple(num_filters)
        self.latent_dim = latent_dim
        self.no_convs_per_block = no_convs_per_block
        self.no_convs_fcomb = no_convs_fcomb
        self.dtype = dtype
        self.unet = UNet(input_channels, num_classes, num_filters,
                         apply_last_layer=False, dtype=dtype)
        self.prior = AxisAlignedConvGaussian(
            input_channels, num_filters, latent_dim, no_convs_per_block, dtype)
        self.posterior = AxisAlignedConvGaussian(
            input_channels + 1, num_filters, latent_dim, no_convs_per_block, dtype)
        self.fcomb = Fcomb(num_filters, latent_dim, num_classes, no_convs_fcomb, dtype)

    def forward(self, patch, segm=None) -> ProbUNetOutput:
        """Prior and U-Net features (+ posterior iff ``segm`` is given; its
        input is concat(patch, segm) on the channel axis). NHWC in."""
        posterior = None
        if segm is not None:
            posterior = self.posterior(torch.cat([patch, segm.to(patch.dtype)], dim=-1))
        prior = self.prior(patch)
        feats = self.unet(patch)
        return ProbUNetOutput(feats, prior, posterior)

    def fcomb_params(self) -> dict:
        """The fcomb's parameters by torch name (``layers.0.weight``, ...),
        the port's counterpart of ``variables["params"]["fcomb"]``."""
        return dict(self.fcomb.named_parameters())

    def decode_samples(self, unet_features, zs):
        """(S,N,latent) draws → (S,N,H,W,C) f32 logits, the plain factored
        fcomb: the feature half of layer 0 runs once, the z half is an
        (S,N,f0) bias, and every matmul rounds to the compute dtype."""
        return decode_samples_reference(
            unet_features, zs, self.fcomb_params(), self.no_convs_fcomb, self.dtype
        )
