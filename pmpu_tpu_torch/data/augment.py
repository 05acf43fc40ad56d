"""Data augmentation of training batches on the device (counterpart of
``pmpu_tpu/data/augment.py``; ``--augment``, ``--elastic-alpha``).

Plain PyTorch on (B,H,W,C) f32 image and int mask batches, run by the
train step on each microbatch after the sampler (JAX's is XLA code, no
TPU kernel). In JAX's order: random flips of H and W and 90° rotations
(when H == W) of image and mask together; an elastic warp (a Gaussian
displacement field on a coarse grid, upsampled with JAX's cubic
``jax.image.resize``; bilinear with zeros outside for the image, nearest
with clamped indices for the mask); then, on the image only, a scale, a
shift, a gamma ``sign(x)·(|x| + 1e-8)^γ`` and additive Gaussian noise.

Randomness: the eight per-batch draws (``draw_augment``) come from a
``torch.Generator``; ``augment_batch(..., draws=...)`` takes them from the
caller instead (the tests inject JAX's).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from pmpu_tpu_torch.device import exact_f32_if


@dataclass(frozen=True)
class AugmentConfig:
    flip: bool = True
    rot90: bool = True
    intensity_scale: float = 0.1  # multiplicative jitter ±10 %
    intensity_shift: float = 0.05
    gamma: float = 0.1  # exponent jitter in [1 − g, 1 + g]
    noise_std: float = 0.02
    elastic_alpha: float = 0.0  # displacement magnitude (pixels); 0 = off
    elastic_grid: int = 4  # control-point grid resolution


def draw_augment(imgs_shape, cfg: AugmentConfig, generator: torch.Generator) -> dict:
    """The draws of one batch of shape (B,H,W,C), on the generator's device:
    ``flip_h``, ``flip_w`` (B,) bool with p = 0.5; ``k`` (B,) in {0..3};
    ``field`` (B,g,g,2) standard normal; ``scale``, ``shift``, ``gamma`` (B,)
    uniform in [−a, a) of their config; ``noise`` (B,H,W,C) standard normal.
    Only the enabled transforms draw."""
    b = imgs_shape[0]
    kw = {"generator": generator, "device": generator.device}

    def uniform(a):
        return (torch.rand(b, **kw) * 2.0 - 1.0) * a

    d = {}
    if cfg.flip:
        d["flip_h"], d["flip_w"] = torch.rand(b, **kw) < 0.5, torch.rand(b, **kw) < 0.5
    if cfg.rot90:
        d["k"] = torch.randint(0, 4, (b,), **kw)
    if cfg.elastic_alpha > 0:
        d["field"] = torch.randn((b, cfg.elastic_grid, cfg.elastic_grid, 2), **kw)
    for name, a in (("scale", cfg.intensity_scale), ("shift", cfg.intensity_shift),
                    ("gamma", cfg.gamma)):
        if a > 0:
            d[name] = uniform(a)
    if cfg.noise_std > 0:
        d["noise"] = torch.randn(tuple(imgs_shape), **kw)
    return d


def _rot90_batch(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Per-sample 90° rotations of (B,H,W,C) with H == W, k (B,) in
    {0,1,2,3} (JAX :36: a rotation by 90° is the transpose flipped on H,
    by 270° the transpose flipped on W)."""
    k = k.reshape(-1, 1, 1, 1)
    t = x.transpose(1, 2)
    return torch.where(k == 0, x, torch.where(k == 1, t.flip(1), torch.where(
        k == 2, x.flip((1, 2)), t.flip(2))))


def _bilinear_warp(img: torch.Tensor, dy: torch.Tensor, dx: torch.Tensor,
                   nearest: bool) -> torch.Tensor:
    """Warp (B,H,W) images by per-pixel displacements (JAX :54): bilinear
    with zeros outside, or nearest (half to even) with clamped indices."""
    b, h, w = img.shape
    dev = img.device
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
    sy, sx = yy + dy, xx + dx
    base = (torch.arange(b, device=dev) * (h * w))[:, None, None]
    flat = img.reshape(-1)
    if nearest:
        iy = torch.round(sy).to(torch.int64).clamp(0, h - 1)
        ix = torch.round(sx).to(torch.int64).clamp(0, w - 1)
        return flat[base + iy * w + ix]
    y0f, x0f = torch.floor(sy), torch.floor(sx)
    fy, fx = sy - y0f, sx - x0f
    y0, x0 = y0f.to(torch.int64), x0f.to(torch.int64)

    def g(yi, xi):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        v = flat[base + yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)]
        return torch.where(valid, v, 0.0)

    return (g(y0, x0) * (1 - fy) * (1 - fx) + g(y0, x0 + 1) * (1 - fy) * fx
            + g(y0 + 1, x0) * fy * (1 - fx) + g(y0 + 1, x0 + 1) * fy * fx)


@functools.lru_cache(maxsize=None)
def _cubic_weights(in_size: int, out_size: int) -> torch.Tensor:
    """(in, out) f32 weights of ``jax.image.resize(..., "cubic")`` along one
    axis, as ``jax/_src/image/scale.py::compute_weight_mat`` makes them:
    the Keys kernel with a = −0.5 at half-pixel centres, each column divided
    by its sum, zero where the sample lies outside the input. (Not
    ``F.interpolate``'s bicubic: a = −0.75 and clamped indices.)"""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    kernel_scale = max(inv_scale, f32(1.0))
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = ((f32(1.5) * x - f32(2.5)) * x) * x + f32(1.0)
    w = np.where(x >= 1.0, ((f32(-0.5) * x + f32(2.5)) * x - f32(4.0)) * x + f32(2.0), w)
    w = np.where(x >= 2.0, f32(0.0), w).astype(f32)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(f32).eps,
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.from_numpy(np.where(inside[None, :], w, f32(0.0)).astype(f32))


def cubic_resize(field: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B,g,g',C) f32 → (B,h,w,C) by JAX's separable cubic resize: two f32
    products with the :func:`_cubic_weights` matrices (TF32 off on the
    card)."""
    wh = _cubic_weights(field.shape[1], h).to(field.device)
    ww = _cubic_weights(field.shape[2], w).to(field.device)
    with exact_f32_if(field.dtype):
        t = torch.einsum("bijc,ih->bhjc", field, wh)
        return torch.einsum("bhjc,jw->bhwc", t, ww)


def augment_batch(imgs: torch.Tensor, msks: torch.Tensor, generator: torch.Generator,
                  cfg: AugmentConfig, draws: dict | None = None):
    """One sampled augmentation per batch element (JAX :84): (B,H,W,C) f32
    images, (B,H,W,C) int masks → the same shapes and dtypes. ``draws``
    (:func:`draw_augment`'s keys) wins over ``generator``."""
    b, h, w, _ = imgs.shape
    d = draw_augment(imgs.shape, cfg, generator) if draws is None else draws

    def per_sample(x):
        return x.reshape(-1, 1, 1, 1).to(imgs.device)

    if cfg.flip:
        fh, fw = per_sample(d["flip_h"]), per_sample(d["flip_w"])
        imgs, msks = torch.where(fh, imgs.flip(1), imgs), torch.where(fh, msks.flip(1), msks)
        imgs, msks = torch.where(fw, imgs.flip(2), imgs), torch.where(fw, msks.flip(2), msks)
    if cfg.rot90 and h == w:
        k = d["k"].to(imgs.device)
        imgs, msks = _rot90_batch(imgs, k), _rot90_batch(msks, k)
    if cfg.elastic_alpha > 0:
        field = cubic_resize(d["field"].to(imgs.device) * cfg.elastic_alpha, h, w)
        dy, dx = field[..., 0], field[..., 1]
        imgs = _bilinear_warp(imgs[..., 0], dy, dx, nearest=False)[..., None]
        msks = _bilinear_warp(msks[..., 0], dy, dx, nearest=True)[..., None]
    if cfg.intensity_scale > 0:
        imgs = imgs * (1.0 + per_sample(d["scale"]))
    if cfg.intensity_shift > 0:
        imgs = imgs + per_sample(d["shift"])
    if cfg.gamma > 0:
        gam = 1.0 + per_sample(d["gamma"])
        imgs = torch.sign(imgs) * torch.pow(torch.abs(imgs) + 1e-8, gam)
    if cfg.noise_std > 0:
        imgs = imgs + cfg.noise_std * d["noise"].to(imgs.device)
    return imgs, msks
