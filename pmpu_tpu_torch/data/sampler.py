"""Slice samplers of training and arbitrary-axis (oblique) plane sampling
(counterpart of ``pmpu_tpu/data/sampler.py``).

Training (``sample_batch`` :55, ``sample_batch_vt`` :74): a batch of
(scan, view, slice) rows becomes (B,S,S,1) f32 image planes, each divided
by its own max (left as it is when the max is 0), and (B,S,S,1) int32
label planes. ``sample_batch_vt`` gathers whole planes of the (3,N,S,S,S)
view stacks: on CUDA tensors that is one launch of the gather-normalize
kernel (``ops/cuda/slice_gather.py``), on CPU ones its plain version; it is
also the counterpart of ``ops/pallas/slice_gather.py::sample_batch_fused``
:104 (``--pallas-sampler``), which the JAX tests hold bit-equal to it.
``sample_batch`` reads the plain (N,S,S,S) stack with plain PyTorch
indexing (the JAX package has no kernel for that layout).

Oblique planes (:226-310): ``view_basis`` and ``fibonacci_views`` are
numpy copies of the JAX package's. ``trilinear`` and ``oblique_plane`` are
plain PyTorch with the JAX operation order, each step one rounded f32
operation:

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

from pmpu_tpu_torch.ops.cuda.slice_gather import flat_plane_index, gather_normalize_planes


def sample_batch(images: torch.Tensor, labels: torch.Tensor, triples: torch.Tensor):
    """(N,S,S,S) f32 images and int labels + (B,3) rows → ((B,S,S,1) f32
    normalized, (B,S,S,1) int32). Plane (a, b) of row (n, v, i) is voxel
    ``[i,a,b]``, ``[a,i,b]`` or ``[a,b,i]`` of volume n for v = 0, 1, 2."""
    s = images.shape[-1]
    tr = triples.long()
    n, v, i = (tr[:, k, None, None] for k in range(3))
    a = torch.arange(s, device=images.device)[:, None]
    b = torch.arange(s, device=images.device)[None, :]
    x = torch.where(v == 0, i, a)
    y = torch.where(v == 0, a, torch.where(v == 1, i, b))
    z = torch.where(v == 2, i, b)
    img = images[n, x, y, z].float()
    m = torch.amax(img, dim=(1, 2), keepdim=True)
    img = torch.where(m == 0, img, img / m)
    return img[..., None], labels[n, x, y, z].int()[..., None]


def sample_batch_vt(vt_images: torch.Tensor, vt_labels: torch.Tensor, triples: torch.Tensor):
    """The same batch from the (3,N,S,S,S) f32 image and int32 label view
    stacks, every row one whole plane: one launch of the gather-normalize
    kernel on CUDA tensors, its plain version on CPU ones (bit-equal to
    ``sample_batch`` on the plain stack)."""
    _, n, s = vt_images.shape[:3]
    flat = flat_plane_index(triples.long(), n, s)
    imgs, lbls = gather_normalize_planes(
        vt_images.reshape(-1, s, s), flat, vt_labels.reshape(-1, s, s))
    return imgs[..., None], lbls[..., None]


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
