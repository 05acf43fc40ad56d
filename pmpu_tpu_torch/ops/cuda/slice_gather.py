"""Plane gather + per-plane max normalization: CUDA kernel and plain version.

Counterpart of ``pmpu_tpu/ops/pallas/slice_gather.py`` (``_pallas_gather_planes``
:49, entered by ``pallas_sample_batch`` :87). Gathers planes at flat ids
from a (P,S,S) stack, divides each image plane by its own max (by 1 when
the max is 0) and copies the label plane. With the (3S,S,S) view slab and
ids ``0..3S-1`` it is exactly ``normalize_slabs`` of the inference path.

The kernel (``csrc/slice_gather.cu``) gives each output plane one block.
A plane of up to 128² floats whose size is a multiple of 4 is read once
into registers with 16-byte loads, reduced to its max and divided in
place; other planes take a two-pass general path of the same kernel. It is
CUDA C++ so that the kernels of the inference path share one build route.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from pmpu_tpu_torch.ops.cuda import _build


def flat_plane_index(triples: torch.Tensor, n_scans: int, cube: int) -> torch.Tensor:
    """(scan, view, slice) rows → flat plane id into the (3,N,S,...) view
    stack reshaped to (3·N·S, S, S): id = (view·N + scan)·S + slice."""
    return (triples[:, 1] * n_scans + triples[:, 0]) * cube + triples[:, 2]


def gather_normalize_planes_reference(img_planes, flat_idx, lbl_planes=None):
    img = img_planes[flat_idx]
    m = torch.amax(img, dim=(1, 2), keepdim=True)
    img = img / torch.where(m == 0, torch.ones_like(m), m)
    return img, (None if lbl_planes is None else lbl_planes[flat_idx])


@torch.no_grad()
def gather_normalize_planes(
    img_planes: torch.Tensor,                  # (P, S, S) f32
    flat_idx: torch.Tensor,                    # (B,) int64 plane ids
    lbl_planes: Optional[torch.Tensor] = None,  # (P, S, S) int32
):
    """→ ((B,S,S) f32 normalized planes, (B,S,S) int32 labels or None).
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if img_planes.device.type == "cpu":
        return gather_normalize_planes_reference(img_planes, flat_idx, lbl_planes)
    if img_planes.device.type != "cuda":
        raise ValueError(f"gather_normalize_planes: unsupported device {img_planes.device}")
    dev = img_planes.device
    if img_planes.dim() != 3 or img_planes.dtype != torch.float32 or not img_planes.is_contiguous():
        raise ValueError("gather_normalize_planes: img_planes must be contiguous (P,S,S) f32, "
                         f"got {tuple(img_planes.shape)} {img_planes.dtype}")
    if flat_idx.dim() != 1 or flat_idx.dtype != torch.int64 or flat_idx.device != dev:
        raise ValueError(f"gather_normalize_planes: flat_idx must be (B,) int64 on {dev}")
    if lbl_planes is not None and (
        lbl_planes.shape != img_planes.shape or lbl_planes.dtype != torch.int32
        or not lbl_planes.is_contiguous() or lbl_planes.device != dev
    ):
        raise ValueError("gather_normalize_planes: lbl_planes must be contiguous int32 of "
                         "img_planes' shape, on its device")
    flat_idx = flat_idx.contiguous()
    p, h, w = img_planes.shape
    if h * w >= 2**31:
        raise ValueError(f"gather_normalize_planes: a plane of {h}x{w} has 2^31 floats or more")
    b = flat_idx.shape[0]
    img_out = torch.empty((b, h, w), dtype=torch.float32, device=dev)
    lbl_out = None if lbl_planes is None else torch.empty((b, h, w), dtype=torch.int32, device=dev)
    if b == 0:
        return img_out, lbl_out
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.pmpu_gather_normalize(
            img_planes.data_ptr(), None if lbl_planes is None else lbl_planes.data_ptr(),
            flat_idx.data_ptr(), img_out.data_ptr(),
            None if lbl_out is None else lbl_out.data_ptr(),
            b, h * w, p, torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(lib, rc, f"gather_normalize_planes (P={p}, B={b}, plane={h}x{w})")
    gather_normalize_planes.launches += 1
    return img_out, lbl_out


gather_normalize_planes.launches = 0  # kernel launches since the last reset


def _library():
    lib = _build.library("slice_gather")
    fn = lib.pmpu_gather_normalize
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_longlong,
                                           ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib
