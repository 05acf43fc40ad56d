"""Host volume store and volume geometry: the port's copy of
``pmpu_tpu/data/volumes.py`` (``_squeeze3d_shape`` :35, ``_squeeze3d`` :45,
``pad_to_cube`` :55, ``SourceGeom`` :86, ``crop_to_source`` :96,
``geom_from_header`` :104, ``restore_geometry`` :110, ``_read_geoms`` :121,
``VolumeStore`` :132 with ``from_dirs`` :148, ``_from_dirs_mmap`` :255 and
``from_arrays`` :346) and ``make_view_stacks`` :26, the training layout.

Each NIfTI volume of a ``{images,labels}`` tree is loaded once (the native
loader, ``data/native.py``, or the numpy reader) and padded to the common
cube; the store holds them stacked. ``--mmap-store`` builds the padded pool
into file-backed memmaps once and reopens it while its ``manifest.json``
matches; the files and the manifest are the JAX package's, so a pool built
by either package reopens in the other without a rebuild.

A volume is zero-padded at the high end of each axis to a cube (the
reference's ``mri_dataset.py:85-98``); an output is cropped back to the
source shape and carries the source affine, unless identity exports (the
padded cube, identity affine, the reference's ``eval.py:51-57``) are asked
for.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np

from pmpu_tpu_torch.data import native, nifti


def make_view_stacks(arr: np.ndarray) -> np.ndarray:
    """(N,S,S,S) → (3,N,S,S,S) per-view stacks: ``stack[v, n, i]`` is slice
    i of volume n along axis v as one contiguous (S,S) plane, so a training
    batch is a gather of whole planes (``sampler.sample_batch_vt``, the
    gather-normalize kernel on the card)."""
    return np.stack([arr, arr.transpose(0, 2, 1, 3), arr.transpose(0, 3, 1, 2)])


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


def _read_geoms(img_paths) -> list:
    """Header-only geometry pass, shared by every ``from_dirs`` mode."""
    out = []
    for p in img_paths:
        hdr = nifti.read_header(p)
        out.append(SourceGeom(_squeeze3d_shape(hdr.shape, p), hdr.affine))
    return out


def _native_shape3(p) -> tuple:
    """Header shape with ``_squeeze3d``'s semantics: trailing unit dims are
    fine (the native reader loads exactly nx·ny·nz voxels), anything else
    must not be truncated silently."""
    sh = native.read_shape(p)
    if len(sh) < 3 or any(d != 1 for d in sh[3:]):
        raise ValueError(f"{p}: expected a 3-D volume, got shape {sh}")
    return tuple(sh[:3])


@dataclass
class VolumeStore:
    """Stacked dataset: images (N,S,S,S) float32, labels (N,S,S,S) int32.

    ``geoms``: per-volume :class:`SourceGeom` (pre-pad shape + affine) when
    loaded from NIfTI files; None for array stores."""

    images: np.ndarray
    labels: np.ndarray
    ids: list
    cube: int
    geoms: list | None = None

    def __len__(self) -> int:
        return self.images.shape[0]

    @classmethod
    def from_dirs(cls, imgs_dir, masks_dir, dtype=np.float32, use_native: bool | None = None,
                  names=None, cube: int | None = None,
                  mmap_dir: str | None = None) -> "VolumeStore":
        """Load a ``{images,labels}`` directory pair whose file names are
        shared between the two directories.

        ``use_native``: True/False forces the C++ loader / the numpy reader;
        None uses the C++ loader when it builds, and falls back to the numpy
        reader on a header it cannot represent (big-endian, true 4-D).
        ``names``: load only these file names. ``cube``: force the
        pad-to-cube size (default: the largest dimension loaded).
        ``mmap_dir``: the out-of-core pool (see the module docstring)."""
        ids = (sorted(filter(nifti.is_nifti_name, os.listdir(imgs_dir)))
               if names is None else sorted(names))
        if not ids:
            raise FileNotFoundError(f"no volumes in {imgs_dir}")
        img_paths = [os.path.join(imgs_dir, n) for n in ids]
        lbl_paths = [os.path.join(masks_dir, n) for n in ids]
        geoms = _read_geoms(img_paths)

        if mmap_dir is not None:
            store = cls._from_dirs_mmap(img_paths, lbl_paths, ids, np.dtype(dtype), cube,
                                        mmap_dir, use_native,
                                        img_shapes=[g.shape for g in geoms])
            store.geoms = geoms
            return store

        if use_native is None or use_native:
            if native.available():
                try:
                    # the image-vs-label shape guard of the numpy path below:
                    # padding a mismatched pair to one cube would misalign
                    # the labels with the image grid
                    img_shapes = [_native_shape3(p) for p in img_paths]
                    for ish, lp, name in zip(img_shapes, lbl_paths, ids):
                        lsh = _native_shape3(lp)
                        if ish != lsh:
                            raise ValueError(f"{name}: image {ish} != label {lsh}")
                except ValueError:
                    if use_native:
                        raise
                    # a header the native reader cannot represent goes to the
                    # numpy reader, which loads it or raises its own error
                    img_shapes = None
                if img_shapes is not None:
                    c = cube or int(max(max(s) for s in img_shapes))
                    images = native.load_dataset(img_paths, c)
                    labels = native.load_dataset(lbl_paths, c).astype(np.int32)
                    return cls(images=images.astype(dtype, copy=False), labels=labels,
                               ids=ids, cube=c, geoms=geoms)
            elif use_native:
                raise RuntimeError("native io requested but unavailable")

        imgs, lbls = [], []
        for ip, lp, name in zip(img_paths, lbl_paths, ids):
            img = _squeeze3d(nifti.load(ip, dtype=dtype))
            lbl = _squeeze3d(nifti.load(lp, dtype=dtype))
            if img.shape != lbl.shape:
                raise ValueError(f"{name}: image {img.shape} != label {lbl.shape}")
            imgs.append(img)
            lbls.append(lbl)
        c = cube or int(max(max(v.shape) for v in imgs))
        images = np.stack([pad_to_cube(v, c) for v in imgs]).astype(dtype)
        labels = np.stack([pad_to_cube(v, c) for v in lbls]).astype(np.int32)
        return cls(images=images, labels=labels, ids=ids, cube=c, geoms=geoms)

    @classmethod
    def _from_dirs_mmap(cls, img_paths, lbl_paths, ids, dtype, cube, mmap_dir, use_native,
                        img_shapes=None) -> "VolumeStore":
        """Build or reopen the out-of-core pool (``images.dat``,
        ``labels.dat``, ``manifest.json`` under ``mmap_dir``). The manifest
        (ids, cube, dtype, the sources' sizes and mtimes) is written last by
        an atomic rename, so a killed build leaves none and the next run
        rebuilds."""
        os.makedirs(mmap_dir, exist_ok=True)
        img_file = os.path.join(mmap_dir, "images.dat")
        lbl_file = os.path.join(mmap_dir, "labels.dat")
        man_file = os.path.join(mmap_dir, "manifest.json")

        def _stat(p):
            st = os.stat(p)
            return [st.st_size, st.st_mtime_ns]

        # headers only: the shape guard and the cube before any voxel is read
        shapes = []
        for i, (ip, lp, name) in enumerate(zip(img_paths, lbl_paths, ids)):
            ish = (img_shapes[i] if img_shapes is not None
                   else _squeeze3d_shape(nifti.read_header(ip).shape, ip))
            lsh = _squeeze3d_shape(nifti.read_header(lp).shape, lp)
            if ish != lsh:
                raise ValueError(f"{name}: image {ish} != label {lsh}")
            shapes.append(ish)
        c = cube or int(max(max(s) for s in shapes))
        manifest = {
            "ids": list(ids),
            "cube": c,
            "dtype": np.dtype(dtype).name,
            "sources": [[name, _stat(ip), _stat(lp)]
                        for name, ip, lp in zip(ids, img_paths, lbl_paths)],
        }
        shape = (len(ids), c, c, c)
        if os.path.exists(man_file):
            try:
                with open(man_file) as f:
                    have = json.load(f)
            except (OSError, json.JSONDecodeError):
                have = None
            if have == manifest:
                return cls(images=np.memmap(img_file, dtype=dtype, mode="r", shape=shape),
                           labels=np.memmap(lbl_file, dtype=np.int32, mode="r", shape=shape),
                           ids=list(ids), cube=c)
            os.remove(man_file)  # a stale pool: rebuilt below

        use_nat = native.available() if use_native is None else use_native
        images = np.memmap(img_file, dtype=dtype, mode="w+", shape=shape)
        labels = np.memmap(lbl_file, dtype=np.int32, mode="w+", shape=shape)
        if use_nat and np.dtype(dtype) == np.float32:
            # the C++ loader pads and writes straight into the mapping
            native.load_dataset(img_paths, c, out=images)
        else:
            for i, ip in enumerate(img_paths):
                images[i] = pad_to_cube(_squeeze3d(nifti.load(ip, dtype=np.float32)), c)
        for i, lp in enumerate(lbl_paths):
            # labels take the int32 cast one volume at a time
            vol = native.load_volume(lp) if use_nat else nifti.load(lp, dtype=np.float32)
            labels[i] = pad_to_cube(_squeeze3d(vol), c)
        images.flush()
        labels.flush()
        tmp = man_file + ".tmp"
        with open(tmp, "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, man_file)
        return cls(images=images, labels=labels, ids=list(ids), cube=c)

    @classmethod
    def from_arrays(cls, images, labels, ids=None) -> "VolumeStore":
        images = np.asarray(images, dtype=np.float32)
        labels = np.asarray(labels, dtype=np.int32)
        ids = ids or [f"vol{i}.nii" for i in range(images.shape[0])]
        return cls(images=images, labels=labels, ids=list(ids), cube=images.shape[-1])

    @property
    def image_dims(self) -> tuple:
        """(S, S, S), the padded cube."""
        return (self.cube,) * 3

    @property
    def slices_per_volume(self) -> int:
        """Slices of one volume over the 3 views."""
        return 3 * self.cube
