"""Operations and bytes of the probabilistic U-Net's work, from the
configuration's shapes alone, and the card's published peaks.

Nothing here asks the program what it ran: a later change that restructures
the convolutions or the kernels leaves these counts as they are. FLOPs count
a multiply-add as 2. Convolutions and matrix products are counted; the
elementwise work (BatchNorm, ReLU, pools, softmax) is not. Each input byte of
a kernel is read once and each output byte written once.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAKS = {
    "bf16_flops": 989e12,
    "f32_flops": 67e12,      # outside the tensor cores
    "hbm_bytes": 3.35e12,
}


def conv_flops(h: int, w: int, cin: int, cout: int, k: int) -> float:
    """A k×k convolution (stride 1, 'same') producing an h×w map."""
    return 2.0 * h * w * cin * cout * k * k


def unet_forward_convs(s: int, filters, cin: int = 1) -> list:
    """(flops, takes_input) of each convolution of the U-Net backbone on one
    s×s slice (2×2 floor max pools; 2×2 stride-2 transposed convs halving
    the channels; no output head: the probabilistic U-Net reads the
    features). ``takes_input`` marks the conv that reads the image."""
    f = list(filters)
    sizes = [s]
    for _ in f[1:]:
        sizes.append(sizes[-1] // 2)
    convs = [(conv_flops(s, s, cin, f[0], 3), True), (conv_flops(s, s, f[0], f[0], 3), False)]
    for i in range(1, len(f)):
        convs += [(conv_flops(sizes[i], sizes[i], f[i - 1], f[i], 3), False),
                  (conv_flops(sizes[i], sizes[i], f[i], f[i], 3), False)]
    for k in reversed(range(len(f) - 1)):
        c_in, h_in = f[k + 1], sizes[k + 1]
        # each of the (2h)² outputs of the transposed conv takes c_in products
        convs.append((2.0 * (2 * h_in) ** 2 * c_in * (c_in // 2), False))
        convs += [(conv_flops(sizes[k], sizes[k], f[k] + c_in // 2, f[k], 3), False),
                  (conv_flops(sizes[k], sizes[k], f[k], f[k], 3), False)]
    return convs


def encoder_forward_convs(s: int, filters, cin: int, latent: int) -> list:
    """(flops, takes_input) of the prior or posterior tower on one slice: 2
    convs a level, 2×2 ceil average pools between levels, then the 1×1 head
    on the spatial mean (μ and log σ)."""
    f = list(filters)
    convs, size, prev = [], s, cin
    for i, c in enumerate(f):
        if i:
            size = -(-size // 2)
        convs += [(conv_flops(size, size, prev, c, 3), i == 0),
                  (conv_flops(size, size, c, c, 3), False)]
        prev = c
    convs.append((2.0 * prev * 2 * latent, False))
    return convs


def fcomb_flops(n: int, hw: int, cf: int, f0: int, c: int, samples: int, ncf: int) -> float:
    """The mean decode of ``samples`` prior draws over n slices of hw pixels,
    factored: the feature half of the first layer once a pixel, then per
    sample the ncf − 2 hidden layers and the head (the z half of the first
    layer is a per-slice bias, not counted)."""
    return 2.0 * n * hw * (cf * f0 + samples * ((ncf - 2) * f0 * f0 + f0 * c))


def fcomb_bytes(n: int, hw: int, cf: int, c: int) -> float:
    """The kernel's features in (bf16) and the mean logits out (f32)."""
    return float(n * hw * (cf * 2 + c * 4))


def fcomb_decode_flops(hw: int, cf: int, f0: int, c: int, latent: int, ncf: int) -> float:
    """One draw decoded on one slice, unfactored (the train step's decode)."""
    return 2.0 * hw * ((cf + latent) * f0 + (ncf - 2) * f0 * f0 + f0 * c)


def gather_bytes(planes: int, hw: int, labels: bool = False) -> float:
    """The gather-normalize kernel: each f32 image plane read and written
    once; with labels the int32 label plane too."""
    return float(planes * hw * (16 if labels else 8))


# FLOPs of one trilinear output of the oblique-plane kernel: its coordinates
# (3 axes × 3 terms), fractions, 8 corner weights and 8 accumulations
OBLIQUE_FLOPS_PER_OUTPUT = 56.0


def oblique_bytes(s: int, views: int) -> float:
    """The f32 volume read once, the V·S planes of S² written once."""
    return float(s ** 3 * 4 + views * s ** 3 * 4)


def oblique_flops(s: int, views: int) -> float:
    return OBLIQUE_FLOPS_PER_OUTPUT * views * s ** 3


def least_seconds(flops: float, bytes_: float, flops_peak: float) -> float:
    """The least time the card could take: compute or memory bound."""
    return max(flops / flops_peak, bytes_ / PEAKS["hbm_bytes"])


def slices_per_volume(cfg: dict) -> int:
    return cfg["views"] * cfg["cube"]


def volume_flops(cfg: dict) -> float:
    """Model FLOPs of one volume: every slice of every view through the
    backbone and the prior, the mean decode of the prior draws."""
    s, f = cfg["cube"], cfg["num_filters"]
    per_slice = sum(x for x, _ in unet_forward_convs(s, f, cfg["input_channels"]))
    per_slice += sum(x for x, _ in encoder_forward_convs(s, f, cfg["input_channels"],
                                                         cfg["latent_dim"]))
    n = slices_per_volume(cfg)
    return n * per_slice + fcomb_flops(n, s * s, f[0], f[0], cfg["num_classes"],
                                       cfg["prior_samples"], cfg["no_convs_fcomb"])


def train_step_flops(cfg: dict, batch: int) -> float:
    """Model FLOPs of one train step on ``batch`` slices: the forward of the
    U-Net, the prior and the posterior (image and mask), one decode, and the
    backward: twice the forward for every conv, once (weights only) for the
    convs that read the inputs."""
    s, f, lat = cfg["cube"], cfg["num_filters"], cfg["latent_dim"]
    cin = cfg["input_channels"]
    convs = (unet_forward_convs(s, f, cin) + encoder_forward_convs(s, f, cin, lat)
             + encoder_forward_convs(s, f, cin + 1, lat))
    fwd = sum(x for x, _ in convs)
    bwd = sum(x if first else 2 * x for x, first in convs)
    dec = fcomb_decode_flops(s * s, f[0], f[0], cfg["num_classes"], lat, cfg["no_convs_fcomb"])
    return batch * (fwd + bwd + 3 * dec)
