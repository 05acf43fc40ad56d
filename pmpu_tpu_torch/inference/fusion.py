"""Multi-view slice ↔ volume fusion (counterpart of
``pmpu_tpu/inference/fusion.py``): the 3 standard views, and the k-view
isotropic oblique views. Volumes are class-last (X,Y,Z,C), as in the JAX
package."""

from __future__ import annotations

import numpy as np
import torch

from pmpu_tpu_torch.data.sampler import fibonacci_views, plane_grid, trilinear, view_basis
from pmpu_tpu_torch.ops.cuda.oblique_gather import oblique_planes
from pmpu_tpu_torch.ops.cuda.slice_gather import gather_normalize_planes


def view_slabs(volume: torch.Tensor) -> torch.Tensor:
    """(S,S,S) volume → contiguous (3S,S,S) slices of the 3 standard views,
    in the reference's view order (axis 0, 1, 2)."""
    return torch.cat([volume, volume.permute(1, 0, 2), volume.permute(2, 0, 1)], dim=0)


def normalize_slabs(slabs: torch.Tensor) -> torch.Tensor:
    """Per-slice max normalization (a slice whose max is 0 passes through):
    the gather-normalize kernel with ids 0..P-1 and no labels."""
    ids = torch.arange(slabs.shape[0], device=slabs.device)
    return gather_normalize_planes(slabs.contiguous(), ids)[0]


def reassemble_views(probs: torch.Tensor):
    """(..., 3S,S,S,C) per-slice class maps → three (..., S,S,S,C) volumes
    in the truth frame (the reference's cat + permute); leading axes, such
    as one per prior draw, pass through."""
    s = probs.shape[-4] // 3
    return (
        probs[..., :s, :, :, :],
        probs[..., s : 2 * s, :, :, :].transpose(-4, -3),  # (Y,X,Z,C) → (X,Y,Z,C)
        probs[..., 2 * s :, :, :, :].movedim(-4, -2),      # (Z,X,Y,C) → (X,Y,Z,C)
    )


def fuse_mean(volumes) -> torch.Tensor:
    """Arithmetic mean of per-view volumes, summed in view order."""
    out = volumes[0]
    for v in volumes[1:]:
        out = out + v
    return out / float(len(volumes))


# ---------------------------------------------------------------------------
# Oblique (k-view isotropic) views
# ---------------------------------------------------------------------------


def oblique_slabs(volume: torch.Tensor, bases: torch.Tensor) -> torch.Tensor:
    """All S planes of one view ((3,3) basis) or of V views ((V,3,3)):
    (S,S,S) → (V·S,S,S), plane ``v·S + i`` at offset ``i − (S−1)/2`` along
    the view normal. One launch of the oblique-plane kernel."""
    return oblique_planes(volume, bases.reshape(-1, 3, 3))


def resample_view_to_grid(view_probs: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """Map an oblique view's (S,S,S,C) plane-stack probabilities (axes:
    plane offset n, in-plane u, in-plane v, class) back onto the voxel grid:
    each voxel is rotated into view coordinates and interpolated
    trilinearly, zero outside. The view coordinates are elementwise
    products and sums, not a matmul, which could run in TF32 on the card."""
    s = view_probs.shape[0]
    center = (s - 1) / 2.0
    g = plane_grid(s, view_probs.device)
    gx, gy, gz = g[:, None, None], g[None, :, None], g[None, None, :]

    def along(b):
        return gx * b[0] + gy * b[1] + gz * b[2] + center

    coords = torch.stack([along(basis[2]), along(basis[0]), along(basis[1])], dim=-1)
    return trilinear(view_probs, coords)


def make_view_bases(num_views: int) -> np.ndarray:
    """(num_views, 3, 3) f32 orthonormal bases of ``num_views`` isotropic
    view axes (3 gives the standard axes)."""
    return np.stack([view_basis(a) for a in fibonacci_views(num_views)])
