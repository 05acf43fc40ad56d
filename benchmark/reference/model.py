"""The reference architectures in plain torch (``nn.Conv2d``,
``nn.BatchNorm2d``; the reference's ``unet_parts.py``, ``unet_model.py`` and
``probabilistic_unet.py`` semantics and parameter names), the benchmark's
frozen copy: the program under test loads the same ``state_dict`` by the
same names (``num_batches_tracked`` aside). Computed in float32 with TF32
off (``exact_f32``).

``fp8_convs`` turns a model into the control of the train cell: every
convolution reads its input and its weight rounded to float8 e4m3, each
tensor scaled by its own absolute max (a straight-through rounding, so that
the gradients flow as in float32).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn
import torch.nn.functional as F


class TDoubleConv(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.double_conv = nn.Sequential(
            nn.Conv2d(cin, cout, 3, padding=1),
            nn.BatchNorm2d(cout),
            nn.ReLU(inplace=True),
            nn.Conv2d(cout, cout, 3, padding=1),
            nn.BatchNorm2d(cout),
            nn.ReLU(inplace=True),
        )

    def forward(self, x):
        return self.double_conv(x)


class TDown(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.maxpool_conv = nn.Sequential(nn.MaxPool2d(2), TDoubleConv(cin, cout))

    def forward(self, x):
        return self.maxpool_conv(x)


class TUp(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.up = nn.ConvTranspose2d(cin, cin // 2, 2, stride=2)
        self.conv = TDoubleConv(cin, cout)

    def forward(self, x1, x2):
        x1 = self.up(x1)
        dy = x2.size(2) - x1.size(2)
        dx = x2.size(3) - x1.size(3)
        x1 = F.pad(x1, [dx // 2, dx - dx // 2, dy // 2, dy - dy // 2])
        return self.conv(torch.cat([x2, x1], dim=1))


class TOutConv(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 1)

    def forward(self, x):
        return self.conv(x)


class TUNet(nn.Module):
    def __init__(self, n_channels, n_classes, num_filters=(64, 128, 256, 512, 1024), apply_last_layer=True):
        super().__init__()
        self.n_classes = n_classes
        self.apply_last_layer = apply_last_layer
        nf = list(num_filters)
        self.inc = TDoubleConv(n_channels, nf[0])
        self.outc = TOutConv(nf[0], n_classes)
        self.down_blocks = nn.ModuleList(
            [TDown(nf[i], nf[i + 1]) for i in range(len(nf) - 1)]
        )
        # reference builds ups ascending then reverses (unet_model.py:26-29)
        ups = [TUp(nf[i + 1], nf[i]) for i in range(len(nf) - 1)]
        self.up_blocks = nn.ModuleList(ups[::-1])

    def forward(self, x):
        xs = [self.inc(x)]
        for d in self.down_blocks:
            xs.append(d(xs[-1]))
        y = xs[-1]
        n = len(self.down_blocks)
        for i, u in enumerate(self.up_blocks):
            y = u(y, xs[n - 1 - i])
        features = y
        out = self.outc(features)
        if self.n_classes == 1:
            out = torch.sigmoid(out)
        return out if self.apply_last_layer else features


class TEncoder(nn.Module):
    def __init__(self, cin, num_filters, no_convs_per_block=2):
        super().__init__()
        layers = []
        prev = cin
        for i, f in enumerate(num_filters):
            if i != 0:
                layers.append(nn.AvgPool2d(2, stride=2, padding=0, ceil_mode=True))
            layers.append(nn.Conv2d(prev, f, 3, padding=1))
            layers.append(nn.BatchNorm2d(f))
            layers.append(nn.ReLU(inplace=True))
            for _ in range(no_convs_per_block - 1):
                layers.append(nn.Conv2d(f, f, 3, padding=1))
                layers.append(nn.BatchNorm2d(f))
                layers.append(nn.ReLU(inplace=True))
            prev = f
        self.layers = nn.Sequential(*layers)

    def forward(self, x):
        return self.layers(x)


class TAxisAlignedConvGaussian(nn.Module):
    def __init__(self, cin, num_filters, latent_dim, posterior=False):
        super().__init__()
        self.latent_dim = latent_dim
        self.encoder = TEncoder(cin + (1 if posterior else 0), num_filters)
        self.conv_layer = nn.Conv2d(num_filters[-1], 2 * latent_dim, 1)

    def forward(self, x, segm=None):
        if segm is not None:
            x = torch.cat([x, segm], dim=1)
        enc = self.encoder(x)
        enc = enc.mean(dim=(2, 3), keepdim=True)
        mls = self.conv_layer(enc)[:, :, 0, 0]
        return mls[:, : self.latent_dim], mls[:, self.latent_dim :]


class TFcomb(nn.Module):
    def __init__(self, num_filters, latent_dim, num_classes, no_convs_fcomb=4):
        super().__init__()
        f0 = num_filters[0]
        layers = [nn.Conv2d(f0 + latent_dim, f0, 1), nn.ReLU(inplace=True)]
        for _ in range(no_convs_fcomb - 2):
            layers += [nn.Conv2d(f0, f0, 1), nn.ReLU(inplace=True)]
        self.layers = nn.Sequential(*layers)
        self.last_layer = nn.Conv2d(f0, num_classes, 1)

    def forward(self, feats, z):
        zmap = z[:, :, None, None].expand(-1, -1, feats.size(2), feats.size(3))
        return self.last_layer(self.layers(torch.cat([feats, zmap], dim=1)))


class TProbUNet(nn.Module):
    def __init__(self, cin=1, num_classes=3, num_filters=(4, 8), latent_dim=6, no_convs_fcomb=4):
        super().__init__()
        self.unet = TUNet(cin, num_classes, num_filters, apply_last_layer=False)
        self.prior = TAxisAlignedConvGaussian(cin, num_filters, latent_dim)
        self.posterior = TAxisAlignedConvGaussian(cin, num_filters, latent_dim, posterior=True)
        self.fcomb = TFcomb(num_filters, latent_dim, num_classes, no_convs_fcomb)

    def forward(self, patch, segm):
        mu_q, ls_q = self.posterior(patch, segm)
        mu_p, ls_p = self.prior(patch)
        feats = self.unet(patch)
        return feats, (mu_p, ls_p), (mu_q, ls_q)


@contextlib.contextmanager
def exact_f32():
    """TF32 off for cuDNN and cuBLAS inside, restored after."""
    conv, mm = torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.set_float32_matmul_precision(mm)


FP8_MAX = 448.0  # largest finite float8 e4m3


def round_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a per-tensor scale, with the
    gradient of the identity."""
    scale = t.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
    return t + (q - t).detach()


class Fp8Conv2d(nn.Conv2d):
    def forward(self, x):
        return self._conv_forward(round_fp8(x), round_fp8(self.weight), self.bias)


class Fp8ConvTranspose2d(nn.ConvTranspose2d):
    def forward(self, x):
        return F.conv_transpose2d(round_fp8(x), round_fp8(self.weight), self.bias,
                                  self.stride, self.padding, self.output_padding,
                                  self.groups, self.dilation)


def fp8_convs(model: nn.Module) -> nn.Module:
    """Every convolution of ``model`` in its float8 form, in place."""
    for m in model.modules():
        if type(m) is nn.Conv2d:
            m.__class__ = Fp8Conv2d
        elif type(m) is nn.ConvTranspose2d:
            m.__class__ = Fp8ConvTranspose2d
    return model
