"""Multi-view slice ↔ volume fusion, 3-view part (counterpart of
``pmpu_tpu/inference/fusion.py:25-55``). Volumes are class-last
(X,Y,Z,C), as in the JAX package."""

from __future__ import annotations

import torch

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
    """(3S,S,S,C) per-slice class maps → three (S,S,S,C) volumes in the
    truth frame (the reference's cat + permute)."""
    s = probs.shape[0] // 3
    return (
        probs[:s],
        probs[s : 2 * s].permute(1, 0, 2, 3),
        probs[2 * s :].permute(1, 2, 0, 3),
    )


def fuse_mean(volumes) -> torch.Tensor:
    """Arithmetic mean of per-view volumes, summed in view order."""
    out = volumes[0]
    for v in volumes[1:]:
        out = out + v
    return out / float(len(volumes))
