"""Oblique plane stack (8-corner trilinear gather): CUDA kernel and plain
version.

Counterpart of ``pmpu_tpu/ops/pallas/oblique_gather.py::oblique_plane_pallas``
(:87, ``pallas_call`` :93), which samples one S×S plane per call and never
lowered on the TPU. Here one launch samples all S planes of all V views
into the (V·S,S,S) slab of the oblique inference path: plane ``v·S + i``
sits at offset ``i − (S−1)/2`` along ``bases[v][2]``, as
``pmpu_tpu/inference/fusion.py::oblique_slabs`` stacks it. The kernel
(``csrc/oblique_gather.cu``) gives each block 8 columns × 8 rows × 32
planes of one view and rounds every step as the plain version does, so
the two agree bit for bit on the card.
"""

from __future__ import annotations

import ctypes

import torch

from pmpu_tpu_torch.data.sampler import oblique_plane, plane_grid
from pmpu_tpu_torch.ops.cuda import _build

MAX_VIEWS = 1024  # views a launch takes


def oblique_planes_reference(volume: torch.Tensor, bases: torch.Tensor) -> torch.Tensor:
    """The plain version: ``oblique_plane`` for every view and offset."""
    s = volume.shape[0]
    offsets = plane_grid(s, volume.device)
    return torch.cat([
        torch.stack([oblique_plane(volume, basis, off) for off in offsets])
        for basis in bases
    ])


@torch.no_grad()
def oblique_planes(volume: torch.Tensor, bases: torch.Tensor) -> torch.Tensor:
    """(S,S,S) f32 volume, (V,3,3) f32 bases → (V·S,S,S) f32 plane stack.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if volume.device.type not in ("cpu", "cuda"):
        raise ValueError(f"oblique_planes: unsupported device {volume.device}")
    if volume.dim() != 3 or len(set(volume.shape)) != 1 or volume.dtype != torch.float32:
        raise ValueError("oblique_planes: volume must be an (S,S,S) f32 cube, got "
                         f"{tuple(volume.shape)} {volume.dtype}")
    if (bases.dim() != 3 or tuple(bases.shape[1:]) != (3, 3) or bases.dtype != torch.float32
            or not 1 <= bases.shape[0] <= MAX_VIEWS):
        raise ValueError(f"oblique_planes: bases must be (V,3,3) f32 with 1 <= V <= {MAX_VIEWS}, "
                         f"got {tuple(bases.shape)} {bases.dtype}")
    if bases.device != volume.device:
        raise ValueError(f"oblique_planes: bases on {bases.device}, volume on {volume.device}")
    if volume.device.type == "cpu":
        return oblique_planes_reference(volume, bases)
    volume, bases = volume.contiguous(), bases.contiguous()
    s, v = volume.shape[0], bases.shape[0]
    if v * s**3 >= 2**31:
        raise ValueError(f"oblique_planes: {v} views of {s}^3 make 2^31 outputs or more")
    out = torch.empty((v * s, s, s), dtype=torch.float32, device=volume.device)
    lib = _library()
    with torch.cuda.device(volume.device):
        rc = lib.pmpu_oblique_planes(volume.data_ptr(), bases.data_ptr(), out.data_ptr(), s, v,
                                     torch.cuda.current_stream(volume.device).cuda_stream)
    _build.check(lib, rc, f"oblique_planes (S={s}, V={v})")
    oblique_planes.launches += 1
    return out


oblique_planes.launches = 0  # kernel launches since the last reset


def _library():
    lib = _build.library("oblique_gather")
    fn = lib.pmpu_oblique_planes
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib
