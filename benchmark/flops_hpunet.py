"""Operations of the Hierarchical Probabilistic U-Net's sampling path, from
the configuration's shapes alone, as ``flops.py`` counts the probunet's:
convolutions only (a multiply-add is 2 FLOPs; ReLU, the residual adds, the
pools, the upsamples, the concatenations and the mean over the draws are not
counted). The encoder runs once a slice and the latent and stitching
decoders once a draw, the work of the batched decode; the published
sampling, which runs the encoder again for every draw, would need more.
"""

from __future__ import annotations

from benchmark.flops import conv_flops, slices_per_volume


def level_sizes(s: int, levels: int) -> list:
    """The side of each level on an s×s slice (2×2 VALID pools: floor)."""
    return [s >> level for level in range(levels)]


def block_flops(h: int, cin: int, c: int, d: int, convs: int) -> float:
    """One residual block on an h×h map: the 3×3 convs cin → d → … → d, the
    1×1 conv d → c and the 1×1 skip where cin ≠ c."""
    chans = [cin] + [d] * (convs - 1) + [c]
    kernels = [3] * (convs - 1) + [1]
    out = sum(conv_flops(h, h, a, b, k) for a, b, k in zip(chans, chans[1:], kernels))
    return out + (conv_flops(h, h, cin, c, 1) if cin != c else 0.0)


def _level(h, cin, c, d, cfg) -> float:
    n, convs = cfg["blocks_per_level"], cfg["convs_per_block"]
    return sum(block_flops(h, cin if i == 0 else c, c, d, convs) for i in range(n))


def encoder_flops(cfg: dict) -> float:
    """One slice through the encoder."""
    ch, down = cfg["channels_per_block"], cfg["down_channels_per_block"]
    sizes = level_sizes(cfg["cube"], len(ch))
    return sum(_level(sizes[l], cfg["input_channels"] if l == 0 else ch[l - 1], ch[l], down[l],
                      cfg) for l in range(len(ch)))


def latent_flops(cfg: dict) -> float:
    """One draw of one slice through the latent decoder: each level's μ/log σ
    head and its blocks."""
    ch, down, lat = cfg["channels_per_block"], cfg["down_channels_per_block"], cfg["latent_dims"]
    top = len(ch) - 1
    sizes = level_sizes(cfg["cube"], len(ch))
    out = 0.0
    for k, dim in enumerate(lat):
        out += conv_flops(sizes[top - k], sizes[top - k], ch[top - k], 2 * dim, 1)
        e = top - 1 - k
        out += _level(sizes[e], dim + ch[e + 1] + ch[e], ch[e], down[e], cfg)
    return out


def stitch_flops(cfg: dict) -> float:
    """One draw of one slice through the stitching decoder and the class
    head."""
    ch, down = cfg["channels_per_block"], cfg["down_channels_per_block"]
    sizes = level_sizes(cfg["cube"], len(ch))
    out = sum(_level(sizes[e], ch[e + 1] + ch[e], ch[e], down[e], cfg)
              for e in range(len(ch) - 2 - len(cfg["latent_dims"]), -1, -1))
    return out + conv_flops(sizes[0], sizes[0], ch[0], cfg["num_classes"], 1)


def volume_flops(cfg: dict) -> float:
    """Model FLOPs of one volume: every slice of every view through the
    encoder once and through the latent and stitching decoders once a draw."""
    per_slice = encoder_flops(cfg) + cfg["prior_samples"] * (latent_flops(cfg) + stitch_flops(cfg))
    return slices_per_volume(cfg) * per_slice
