"""Arbitrary-axis (oblique) plane sampling (counterpart of
``pmpu_tpu/data/sampler.py:226-310``).

``view_basis`` and ``fibonacci_views`` are numpy copies of the JAX
package's. ``trilinear`` and ``oblique_plane`` are plain PyTorch with the
JAX operation order, each step one rounded f32 operation:

  coords = ((center + u·b0) + v·b1) + off·b2,  grid = arange(S) − (S−1)/2
  frac   = c − floor(c)
  w      = (wx·wy)·wz                  (wx = frac or 1 − frac, per corner)
  out    = out + w·val                 over corners (dx,dy,dz) = 000 … 111

A corner outside the volume contributes 0; indices are clamped before the
gather. ``oblique_plane`` is the plain version of the oblique-plane kernel
(``pmpu_tpu_torch/ops/cuda/oblique_gather.py``).
"""

from __future__ import annotations

import numpy as np
import torch


def view_basis(normal) -> np.ndarray:
    """Right-handed orthonormal (u, v, n) basis for a unit view axis ``n``."""
    n = np.asarray(normal, dtype=np.float64)
    n = n / np.linalg.norm(n)
    helper = np.array([0.0, 0.0, 1.0]) if abs(n[2]) < 0.9 else np.array([1.0, 0.0, 0.0])
    u = np.cross(helper, n)
    u /= np.linalg.norm(u)
    v = np.cross(n, u)
    return np.stack([u, v, n]).astype(np.float32)


def fibonacci_views(k: int) -> np.ndarray:
    """k unit axes about uniform on the half sphere (golden spiral); k = 3
    gives the standard axes."""
    if k == 3:
        return np.eye(3, dtype=np.float32)
    i = np.arange(k, dtype=np.float64) + 0.5
    phi = np.arccos(1.0 - i / k)
    theta = np.pi * (1.0 + 5**0.5) * i
    pts = np.stack(
        [np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta), np.cos(phi)], axis=1
    )
    return pts.astype(np.float32)


def trilinear(volume: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Trilinear interpolation of ``volume`` (X,Y,Z) or class-last
    (X,Y,Z,C) at ``coords`` (..., 3) in voxel units, zero outside the
    volume → (...) or (..., C). The classes share coordinates and weights,
    so one gather per corner fetches all of them."""
    size = volume.shape[:3]
    chans = volume.shape[3:]
    flat = volume.reshape((-1,) + tuple(chans))
    c0f = torch.floor(coords)
    frac = coords - c0f
    c0 = c0f.to(torch.int32)
    fx, fy, fz = frac.unbind(-1)
    out = torch.zeros(coords.shape[:-1] + chans, dtype=volume.dtype, device=volume.device)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                idx = [c0[..., a] + d for a, d in enumerate((dx, dy, dz))]
                valid = ((idx[0] >= 0) & (idx[0] < size[0]) & (idx[1] >= 0) & (idx[1] < size[1])
                         & (idx[2] >= 0) & (idx[2] < size[2]))
                k = [i.clamp(0, n - 1).long() for i, n in zip(idx, size)]
                vals = flat[(k[0] * size[1] + k[1]) * size[2] + k[2]]
                w = (fx if dx else 1 - fx) * (fy if dy else 1 - fy) * (fz if dz else 1 - fz)
                if chans:
                    valid, w = valid[..., None], w[..., None]
                out = out + w * torch.where(valid, vals, 0.0)
    return out


def plane_grid(size: int, device=None) -> torch.Tensor:
    """(size,) f32 in-plane grid ``arange(size) − (size−1)/2``."""
    return torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0


def oblique_plane(volume: torch.Tensor, basis: torch.Tensor, offset,
                  nearest: bool = False) -> torch.Tensor:
    """Sample the plane at signed distance ``offset`` from the cube's center
    along basis row 2 (the view normal), spanned by basis rows 0 and 1 →
    (S,S) f32. With the x-axis basis (``view_basis([1,0,0])``) the plane at
    offset ``i − (S−1)/2`` is ``volume[i]`` exactly. ``nearest=True`` rounds
    the coordinates (half to even), for labels."""
    s = volume.shape[0]
    center = (s - 1) / 2.0
    grid = plane_grid(s, volume.device)
    uu, vv = torch.meshgrid(grid, grid, indexing="ij")
    basis = torch.as_tensor(basis, dtype=torch.float32, device=volume.device)
    offset = torch.as_tensor(offset, dtype=torch.float32, device=volume.device)
    coords = center + uu[..., None] * basis[0] + vv[..., None] * basis[1] + offset * basis[2]
    if nearest:
        coords = torch.round(coords)
    return trilinear(volume, coords)
