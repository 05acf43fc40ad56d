"""Parameter initializers of the reference's init families, for torch
modules (counterpart of ``pmpu_tpu/models/initializers.py``).

Each function fills a conv's ``(weight, bias)`` in place from an explicit
``torch.Generator``. Models are initialized on the CPU and then moved, so a
model made from a seed is the same on every device.

* ``torch_default_``  — torch ``Conv2d.reset_parameters``: U(±1/√fan_in) for
                        weight and bias (the plain U-Net backbone).
* ``he_trunc_``       — he-normal weight N(0, 2/fan_in) + truncated-normal
                        (σ=0.001, cut at ±2σ) bias (the prior/posterior
                        encoder convs).
* ``ortho_trunc_``    — orthogonal weight (gain 1) + truncated-normal bias
                        (the fcomb 1×1 convs).
* ``he_normal_bias_`` — he-normal weight + N(0, 1) bias (the encoders'
                        ``conv_layer`` head).

Weights are torch layout: OIHW for convs, (cin, cout, kh, kw) for
transposed convs; fan_in = size(1)·kh·kw in both, as torch computes it.
"""

from __future__ import annotations

import math

import torch
from torch import nn


def fan_in(weight: torch.Tensor) -> int:
    return int(weight.shape[1]) * math.prod(weight.shape[2:])


@torch.no_grad()
def torch_default_(weight, bias, gen):
    bound = 1.0 / math.sqrt(fan_in(weight))
    weight.uniform_(-bound, bound, generator=gen)
    bias.uniform_(-bound, bound, generator=gen)


def _he_normal(weight, gen):
    weight.normal_(0.0, math.sqrt(2.0 / fan_in(weight)), generator=gen)


def _truncated_normal(t, std, gen):
    nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)


@torch.no_grad()
def he_trunc_(weight, bias, gen):
    _he_normal(weight, gen)
    _truncated_normal(bias, 0.001, gen)


@torch.no_grad()
def ortho_trunc_(weight, bias, gen):
    nn.init.orthogonal_(weight, 1.0, generator=gen)
    _truncated_normal(bias, 0.001, gen)


@torch.no_grad()
def he_normal_bias_(weight, bias, gen):
    _he_normal(weight, gen)
    bias.normal_(0.0, 1.0, generator=gen)


def initialize(module: nn.Module, gen: torch.Generator) -> nn.Module:
    """Re-initialize every conv of ``module`` with its own init family
    (``init_fn`` attribute), in module order, from ``gen``."""
    for m in module.modules():
        init_fn = getattr(m, "init_fn", None)
        if init_fn is not None:
            init_fn(m.weight, m.bias, gen)
    return module
