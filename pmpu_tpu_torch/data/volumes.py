"""Volume geometry for the serving path: the port's copy of the geometry
part of ``pmpu_tpu/data/volumes.py`` (``_squeeze3d_shape`` :35,
``_squeeze3d`` :45, ``pad_to_cube`` :55, ``SourceGeom`` :86,
``crop_to_source`` :96, ``geom_from_header`` :104, ``restore_geometry``
:110).

A volume is zero-padded at the high end of each axis to a cube (the
reference's ``mri_dataset.py:85-98``); an output is cropped back to the
source shape and carries the source affine, unless identity exports (the
padded cube, identity affine, the reference's ``eval.py:51-57``) are asked
for.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def _squeeze3d_shape(sh, path: str) -> tuple:
    """Shape-level twin of :func:`_squeeze3d` for header-only passes."""
    sh = tuple(int(d) for d in sh)
    while len(sh) > 3 and sh[-1] == 1:
        sh = sh[:-1]
    if len(sh) != 3:
        raise ValueError(f"{path}: expected a 3-D volume, got shape {sh}")
    return sh


def _squeeze3d(vol: np.ndarray) -> np.ndarray:
    """Drop trailing singleton dims (NIfTI files often declare dim[0]=4 with
    a unit 4th axis); 3-D volumes pass through unchanged."""
    while vol.ndim > 3 and vol.shape[-1] == 1:
        vol = vol[..., 0]
    if vol.ndim != 3:
        raise ValueError(f"expected a 3-D volume, got shape {vol.shape}")
    return vol


def pad_to_cube(vol: np.ndarray, size: int | None = None) -> np.ndarray:
    """Zero-pad a 3-D volume at the high end of each axis to ``size``
    (default: its own max dimension). Trailing singleton dims are squeezed
    first; a volume that is not 3-D raises."""
    if vol.ndim != 3:
        vol = _squeeze3d(vol)
    target = int(max(vol.shape)) if size is None else int(size)
    pads = [(0, target - s) for s in vol.shape]
    if any(p[1] < 0 for p in pads):
        raise ValueError(f"volume {vol.shape} larger than target cube {target}")
    if all(p[1] == 0 for p in pads):
        return vol
    return np.pad(vol, pads)


@dataclass
class SourceGeom:
    """Source-scan geometry carried from the input header to the output
    header: the voxel shape before padding and the voxel→world affine."""

    shape: tuple
    affine: np.ndarray


def crop_to_source(arr: np.ndarray, shape) -> np.ndarray:
    """Undo :func:`pad_to_cube`: the padding is at the high end of each
    axis, so the source volume is the leading corner."""
    x, y, z = (int(d) for d in shape)
    return np.ascontiguousarray(arr[:x, :y, :z])


def geom_from_header(hdr, path: str = "") -> SourceGeom:
    """A :class:`SourceGeom` from a parsed NIfTI header."""
    return SourceGeom(_squeeze3d_shape(hdr.shape, path), hdr.affine)


def restore_geometry(arr: np.ndarray, geom: SourceGeom | None, identity: bool):
    """(volume, affine) for a NIfTI export: the source shape and affine by
    default; the padded cube and no affine (identity on save) when
    ``identity`` or no geometry is known."""
    if identity or geom is None:
        return arr, None
    return crop_to_source(arr, geom.shape), geom.affine
