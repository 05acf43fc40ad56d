"""Deterministic 2-D U-Net (counterpart of ``pmpu_tpu/models/unet.py:78-272``).

* ``DoubleConv`` — 2 × [3×3 conv (pad 1) → BatchNorm (eps 1e-5) → ReLU]
* ``Down``       — 2×2 max-pool then DoubleConv
* ``Up``         — 2×2 stride-2 transposed conv (halving channels),
                   pad-to-match, concat(skip, upsampled), DoubleConv
* ``OutConv``    — 1×1 conv
* ``UNet``       — depth from ``num_filters``; sigmoid iff ``n_classes == 1``;
                   ``apply_last_layer=False`` returns the ``num_filters[0]``
                   feature map (``outc`` still exists, as in the flax tree)

Module and parameter names are the reference's torch names, so the JAX
package's ``export_torch_state_dict`` tree loads with ``strict=True``.

Public tensors are NHWC, as in the JAX package. Inside, the backbone runs
NCHW in ``torch.channels_last`` memory (an NHWC tensor permuted to NCHW is
already channels_last, so entering and leaving costs no copy).

bf16 follows the flax cast points, not ``torch.autocast``: parameters stay
f32 and each conv casts its input, weight and bias to the compute dtype;
BatchNorm normalizes in f32 with f32 statistics and rounds its output once
to the input's dtype (flax ``BatchNorm(dtype=...)``); the head casts to f32.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from pmpu_tpu_torch.models import initializers as pinit


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in ``compute_dtype`` (None: the input's),
    with its init family as ``init_fn`` (see ``initializers.initialize``)."""

    def __init__(self, cin, cout, kernel_size, padding=0, *,
                 compute_dtype: Optional[torch.dtype] = None,
                 init_fn=pinit.torch_default_):
        super().__init__(cin, cout, kernel_size, padding=padding)
        self.compute_dtype = compute_dtype
        self.init_fn = init_fn

    def forward(self, x):
        cd = self.compute_dtype
        if cd is None:
            return super().forward(x)
        return self._conv_forward(x.to(cd), self.weight.to(cd), self.bias.to(cd))


class ConvTranspose2d(nn.ConvTranspose2d):
    """2×2 stride-2 transposed conv computing in ``compute_dtype``; torch
    default init (fan_in = cout·kh·kw, as flax ``TorchConvTranspose``)."""

    def __init__(self, cin, cout, *, compute_dtype: Optional[torch.dtype] = None):
        super().__init__(cin, cout, 2, stride=2)
        self.compute_dtype = compute_dtype
        self.init_fn = pinit.torch_default_

    def forward(self, x):
        cd = self.compute_dtype
        if cd is None:
            return super().forward(x)
        return F.conv_transpose2d(x.to(cd), self.weight.to(cd), self.bias.to(cd), stride=2)


class BatchNorm2d(nn.Module):
    """Inference BatchNorm over running statistics: f32 arithmetic, one
    rounding to the input's dtype. Holds exactly the reference's four
    tensors (no ``num_batches_tracked``), so strict loads match the export."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x):
        return F.batch_norm(
            x, self.running_mean, self.running_var, self.weight, self.bias,
            False, 0.0, self.eps,
        )


def conv_bn_relu(cin, cout, compute_dtype, init_fn=pinit.torch_default_):
    return [
        Conv2d(cin, cout, 3, padding=1, compute_dtype=compute_dtype, init_fn=init_fn),
        BatchNorm2d(cout),
        nn.ReLU(),
    ]


class DoubleConv(nn.Module):
    def __init__(self, cin, cout, compute_dtype=None):
        super().__init__()
        self.double_conv = nn.Sequential(
            *conv_bn_relu(cin, cout, compute_dtype),
            *conv_bn_relu(cout, cout, compute_dtype),
        )

    def forward(self, x):
        return self.double_conv(x)


class Down(nn.Module):
    def __init__(self, cin, cout, compute_dtype=None):
        super().__init__()
        self.maxpool_conv = nn.Sequential(
            nn.MaxPool2d(2), DoubleConv(cin, cout, compute_dtype)
        )

    def forward(self, x):
        return self.maxpool_conv(x)


def _pad_to_match(x1, x2):
    """Zero-pad x1 (NCHW) spatially to x2's H and W (JAX unet.py:183)."""
    dh = x2.shape[2] - x1.shape[2]
    dw = x2.shape[3] - x1.shape[3]
    if dh == 0 and dw == 0:
        return x1
    return F.pad(x1, [dw // 2, dw - dw // 2, dh // 2, dh - dh // 2])


class Up(nn.Module):
    """ConvTranspose(cin → cin/2) + pad + concat(skip, up) + DoubleConv."""

    def __init__(self, cin, skip, cout, compute_dtype=None):
        super().__init__()
        self.up = ConvTranspose2d(cin, cin // 2, compute_dtype=compute_dtype)
        self.conv = DoubleConv(skip + cin // 2, cout, compute_dtype)

    def forward(self, x1, x2):
        x1 = _pad_to_match(self.up(x1), x2)
        return self.conv(torch.cat([x2, x1], dim=1))  # skip first


class OutConv(nn.Module):
    def __init__(self, cin, cout, compute_dtype=None):
        super().__init__()
        self.conv = Conv2d(cin, cout, 1, compute_dtype=compute_dtype)

    def forward(self, x):
        return self.conv(x)


def to_nchw(x_nhwc):
    """NHWC → NCHW view; channels_last memory when the input is contiguous."""
    return x_nhwc.permute(0, 3, 1, 2)


def to_nhwc(x_nchw):
    """NCHW → contiguous NHWC (a free view of channels_last memory)."""
    return x_nchw.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)


class UNet(nn.Module):
    """``forward(x)``: (N,H,W,n_channels) → (N,H,W,n_classes) f32 logits
    (sigmoid probs when ``n_classes == 1``), or the (N,H,W,num_filters[0])
    feature map in the compute dtype when ``apply_last_layer=False``."""

    def __init__(
        self,
        n_channels: int = 1,
        n_classes: int = 1,
        num_filters: Sequence[int] = (64, 128, 256, 512, 1024),
        apply_last_layer: bool = True,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        nf = list(num_filters)
        self.n_classes = n_classes
        self.num_filters = tuple(nf)
        self.apply_last_layer = apply_last_layer
        self.dtype = dtype
        self.inc = DoubleConv(n_channels, nf[0], dtype)
        self.down_blocks = nn.ModuleList(
            Down(nf[i], nf[i + 1], dtype) for i in range(len(nf) - 1)
        )
        # flax up{i} == torch up_blocks.{i}: deepest first
        self.up_blocks = nn.ModuleList(
            Up(nf[k + 1], nf[k], nf[k], dtype) for k in reversed(range(len(nf) - 1))
        )
        self.outc = OutConv(nf[0], n_classes, dtype)

    def forward(self, x):
        x = to_nchw(x)
        if self.dtype is not None:
            x = x.to(self.dtype)
        xs = [self.inc(x)]
        for d in self.down_blocks:
            xs.append(d(xs[-1]))
        y = xs[-1]
        for i, u in enumerate(self.up_blocks):
            y = u(y, xs[len(xs) - 2 - i])
        if not self.apply_last_layer:
            return to_nhwc(y)
        out = self.outc(y).float()
        if self.n_classes == 1:
            out = torch.sigmoid(out)
        return to_nhwc(out)
