"""Deterministic 2-D U-Net (counterpart of ``pmpu_tpu/models/unet.py:78-272``).

* ``DoubleConv`` — 2 × [3×3 conv (pad 1) → BatchNorm (eps 1e-5, flax's
                   statistics in train mode) → ReLU]
* ``Down``       — 2×2 max-pool then DoubleConv
* ``Up``         — 2×2 stride-2 transposed conv (halving channels),
                   pad-to-match, concat(skip, upsampled), DoubleConv; with
                   ``split`` the first conv takes the pair unconcatenated
                   (``Conv2d.forward_split``), with the same parameters
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
An f32 conv runs with TF32 off (``device.exact_f32_if``), as the JAX package
computes it; a bf16 conv enters no such context. The backward convs of a
train step run after these guards have exited: the step guards its
backward pass itself (``train/steps.py::backward``).

In inference on the card (eval BatchNorm, grad off, a bf16 conv on a CUDA
tensor) each (Conv2d, BatchNorm2d, ReLU) triple of a ``DoubleConv`` or an
encoder tower runs as cuDNN's conv without its bias and one launch of the
``bias_bn_relu`` kernel, bit-equal to the three modules (``run_layers``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from pmpu_tpu_torch.device import exact_f32_if
from pmpu_tpu_torch.models import initializers as pinit
from pmpu_tpu_torch.ops.cuda import bias_bn_relu as epilogue
from pmpu_tpu_torch.utils import profiling


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in ``compute_dtype`` (None: the input's),
    with its init family as ``init_fn`` (see ``initializers.initialize``)."""

    def __init__(self, cin, cout, kernel_size, padding=0, *,
                 compute_dtype: Optional[torch.dtype] = None,
                 init_fn=pinit.torch_default_):
        super().__init__(cin, cout, kernel_size, padding=padding)
        self.compute_dtype = compute_dtype
        self.init_fn = init_fn

    def forward(self, x, with_bias: bool = True):
        """The conv; ``with_bias=False`` leaves the bias out (the caller adds
        it, as ``run_layers``'s epilogue does)."""
        cd = self.compute_dtype
        w, b = self.weight, self.bias if with_bias else None
        if cd is not None:
            x, w = x.to(cd), w.to(cd)
            b = None if b is None else b.to(cd)
        with exact_f32_if(x.dtype):
            return self._conv_forward(x, w, b)

    def forward_split(self, xs, with_bias: bool = True):
        """``forward(cat(xs, channels))`` without the concatenation: one conv
        per input over its slice of the kernel's input channels, summed,
        then the bias (JAX ``unet.py::_SplitConcatConv``, whose rounding
        points it keeps: in bf16 each partial conv rounds to bf16, the sum
        and the bias add in bf16)."""
        cd = self.compute_dtype
        w = self.weight
        if cd is not None:
            xs, w = [x.to(cd) for x in xs], w.to(cd)
        off, out = 0, None
        with exact_f32_if(xs[0].dtype):
            for x in xs:
                y = F.conv2d(x, w[:, off:off + x.shape[1]], None, padding=self.padding)
                out = y if out is None else out + y
                off += x.shape[1]
        if not with_bias:
            return out
        b = self.bias if cd is None else self.bias.to(cd)
        return out + b[:, None, None]


class ConvTranspose2d(nn.ConvTranspose2d):
    """2×2 stride-2 transposed conv computing in ``compute_dtype``; torch
    default init (fan_in = cout·kh·kw, as flax ``TorchConvTranspose``)."""

    def __init__(self, cin, cout, *, compute_dtype: Optional[torch.dtype] = None):
        super().__init__(cin, cout, 2, stride=2)
        self.compute_dtype = compute_dtype
        self.init_fn = pinit.torch_default_

    def forward(self, x):
        cd = self.compute_dtype
        w, b = self.weight, self.bias
        if cd is not None:
            x, w, b = x.to(cd), w.to(cd), b.to(cd)
        with exact_f32_if(x.dtype):
            return F.conv_transpose2d(x, w, b, stride=2)


class BatchNorm2d(nn.Module):
    """BatchNorm of flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)``.
    Holds exactly the reference's four tensors (no ``num_batches_tracked``),
    so strict loads match the export.

    Eval mode (``module.eval()``): the running statistics, f32 arithmetic,
    one rounding to the input's dtype.

    Train mode (``module.train()``), flax's fast variance: f32 batch
    statistics over N, H and W, ``mean = E[x]`` and ``var = max(E[x²] −
    mean², 0)``; ``y = (x − mean)·(rsqrt(var + eps)·weight) + bias`` in f32,
    rounded once to the input's dtype; the running statistics become
    ``0.9·running + 0.1·batch`` with the **biased** variance (torch's own
    train-mode BatchNorm would store the unbiased one), unless
    ``update_running`` is False (the train step's ``--remat`` recompute of
    a forward pass that already updated them).

    ``sync`` (None: off; set by ``parallel.sharding.synced_batchnorm``), a
    ``parallel.sharding.BatchShare``: this rank's share of a batch split
    over the default process group. Train mode then
    takes the statistics of the batch over all the ranks (the data-parallel step,
    ``parallel.sharding.synced_batchnorm``): the local f32 E[x] and E[x²]
    all-reduced as count-weighted sums, with gradients, and the same fast
    variance; the running statistics update with the global values."""

    momentum = 0.9
    update_running = True
    sync = None

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x):
        if not self.training:
            return F.batch_norm(
                x, self.running_mean, self.running_var, self.weight, self.bias,
                False, 0.0, self.eps,
            )
        x32 = x.float()
        if self.sync is None:
            mean = x32.mean(dim=(0, 2, 3))
            ex2 = (x32 * x32).mean(dim=(0, 2, 3))
        else:
            mean, ex2 = self.sync.batch_moments(x32, dim=(0, 2, 3))
        var = torch.clamp(ex2 - mean * mean, min=0.0)
        if self.update_running:
            with torch.no_grad():
                for buf, stat in ((self.running_mean, mean), (self.running_var, var)):
                    buf.copy_(self.momentum * buf + (1 - self.momentum) * stat)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x32 - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(x.dtype)


def conv_bn_relu(cin, cout, compute_dtype, init_fn=pinit.torch_default_):
    return [
        Conv2d(cin, cout, 3, padding=1, compute_dtype=compute_dtype, init_fn=init_fn),
        BatchNorm2d(cout),
        nn.ReLU(),
    ]


def _channels_last(t) -> bool:
    """Whether the strides of a 4-D ``t`` read as channels_last, as ATen
    reads them (a channel stride of 1, so also where C is 1)."""
    return t.dim() == 4 and t.stride(1) == 1 and t.is_contiguous(memory_format=torch.channels_last)


def _out_numel(conv, x) -> int:
    """The elements of ``conv``'s output for the input ``x``."""
    n = x.shape[0] * conv.out_channels
    for size, k, s, p, d in zip(x.shape[2:], conv.kernel_size, conv.stride, conv.padding,
                                conv.dilation):
        n *= (size + 2 * p - d * (k - 1) - 1) // s + 1
    return n


def _fused(layers, i: int, x) -> bool:
    """Whether ``layers[i:i + 3]`` is a (Conv2d, BatchNorm2d, ReLU) triple
    that runs as cuDNN's conv without its bias and one ``bias_bn_relu``
    launch, decided from the conv's input and the modules: inference (eval
    BatchNorm with running statistics, grad off, no NaN-check hooks) of a
    bf16 conv of a CUDA tensor, with cuDNN on (ATen then adds a conv's bias
    as a pass of its own, whose rounding the kernel repeats), the input or
    the weight channels_last (cuDNN's output then is), f32 parameters, and
    an output the kernel takes (C a multiple of 8 up to its maximum, under
    2^31 − 1 elements). ``x`` is the conv's input, or the tuple of its split
    inputs."""
    if i + 2 >= len(layers) or profiling._nan_handle is not None:
        return False
    conv, bn, relu = layers[i:i + 3]
    x = x[0] if isinstance(x, tuple) else x
    if not (type(conv) is Conv2d and type(bn) is BatchNorm2d and type(relu) is nn.ReLU
            and not bn.training and not torch.is_grad_enabled() and x.is_cuda
            and (conv.compute_dtype or x.dtype) == torch.bfloat16
            and torch.backends.cudnn.enabled):
        return False
    params = (conv.bias, bn.running_mean, bn.running_var, bn.weight, bn.bias)
    return (all(t is not None and t.dtype == torch.float32 for t in params)
            and (_channels_last(x) or _channels_last(conv.weight))
            and conv.out_channels % 8 == 0 and conv.out_channels <= epilogue.MAX_CHANNELS
            and isinstance(conv.padding, tuple) and _out_numel(conv, x) < 2**31 - 1)


def run_layers(layers: nn.Sequential, x, split: bool = False):
    """``layers(x)``, each triple that ``_fused`` admits as two launches: the
    conv without its bias, then the bias, BatchNorm and ReLU in place by the
    ``bias_bn_relu`` kernel. Every other module runs as it is; names and
    parameters stay. A fused triple calls its conv module but not its
    BatchNorm2d and ReLU modules, so their forward hooks do not run (the
    NaN checks' global hook closes the route). ``split``: ``x`` is the
    (skip, up) pair that the first conv takes unconcatenated
    (``Conv2d.forward_split``)."""
    mods, i = list(layers), 0
    while i < len(mods):
        m = mods[i]
        first_split = split and i == 0
        if not _fused(mods, i, x):
            x = m.forward_split(x) if first_split else m(x)
            i += 1
            continue
        bn = mods[i + 1]
        y = m.forward_split(x, with_bias=False) if first_split else m(x, with_bias=False)
        x = epilogue.bias_bn_relu_(y, m.bias, bn.running_mean, bn.running_var, bn.weight,
                                   bn.bias, bn.eps)
        i += 3
    return x


class DoubleConv(nn.Module):
    def __init__(self, cin, cout, compute_dtype=None):
        super().__init__()
        self.double_conv = nn.Sequential(
            *conv_bn_relu(cin, cout, compute_dtype),
            *conv_bn_relu(cout, cout, compute_dtype),
        )

    def forward(self, x):
        return run_layers(self.double_conv, x)


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
    """ConvTranspose(cin → cin/2) + pad + concat(skip, up) + DoubleConv.
    ``split`` (JAX ``Up.split``): the DoubleConv's first conv takes (skip,
    up) unconcatenated; the parameters and their names are the same."""

    def __init__(self, cin, skip, cout, compute_dtype=None, split: bool = False):
        super().__init__()
        self.split = split
        self.up = ConvTranspose2d(cin, cin // 2, compute_dtype=compute_dtype)
        self.conv = DoubleConv(skip + cin // 2, cout, compute_dtype)

    def forward(self, x1, x2):
        x1 = _pad_to_match(self.up(x1), x2)
        if not self.split:
            return self.conv(torch.cat([x2, x1], dim=1))  # skip first
        return run_layers(self.conv.double_conv, (x2, x1), split=True)


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
    feature map in the compute dtype when ``apply_last_layer=False``.
    ``split_decoder``: every ``Up`` in its split form (no skip
    concatenation; the same state_dict)."""

    def __init__(
        self,
        n_channels: int = 1,
        n_classes: int = 1,
        num_filters: Sequence[int] = (64, 128, 256, 512, 1024),
        apply_last_layer: bool = True,
        dtype: Optional[torch.dtype] = None,
        split_decoder: bool = False,
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
            Up(nf[k + 1], nf[k], nf[k], dtype, split_decoder)
            for k in reversed(range(len(nf) - 1))
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
