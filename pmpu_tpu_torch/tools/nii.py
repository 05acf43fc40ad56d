""".mat → NIfTI dataset converter of the port (counterpart of the JAX
package's ``tools/nii.py``; reference ``Utils/nii.py:40-109``). It uses no
device: numpy, h5py or scipy, and ``pmpu_tpu_torch.data.nifti``.

Converts a directory of MATLAB knee-MRI scans (keys ``scan``, ``CartTM``,
``CartFM``, ``Tibia``, ``isright`` — ``Utils/nii.py:11-15``) into the
``data_folder/{train,test}/{images,labels}`` NIfTI tree with an 85/15
split; labels encoded {0=bg, 1=CartTM, 2=CartFM} via elementwise max-merge
(``Utils/nii.py:83-90``). Reads both MATLAB v7.3 (HDF5, via h5py — the
reference's hdf5storage) and v5 (scipy.io) files.

    python -m pmpu_tpu_torch.tools.nii ScanManTrim [--out data_folder] [--split 0.85]
"""

from __future__ import annotations

import argparse
import os
import shutil

import numpy as np

from pmpu_tpu_torch.data import nifti


def loadmat_any(path: str) -> dict:
    """Load v7.3 (HDF5) or v5 MATLAB files into {key: ndarray}."""
    try:
        import h5py

        with h5py.File(path, "r") as f:
            # MATLAB v7.3 stores arrays transposed (C vs F order)
            return {k: np.asarray(f[k]).T for k in f.keys() if not k.startswith("#")}
    except (OSError, ImportError):
        from scipy.io import loadmat

        m = loadmat(path)
        return {k: v for k, v in m.items() if not k.startswith("__")}


def crop3d(mat: dict):
    """Leg-side cropper — reference ``Utils/nii.py:10-37`` (present for
    parity; the reference main() never calls it either)."""
    scan, cart_tm, cart_fm, tibia = mat["scan"], mat["CartTM"], mat["CartFM"], mat["Tibia"]
    rows = scan.shape[0]
    is_left = not bool(np.asarray(mat["isright"]).ravel()[0])
    start, end, step = (0, rows - 1, 1) if is_left else (rows - 1, 0, -1)
    label_img = np.maximum(cart_tm, cart_fm)
    for i in range(start, end, step):
        if np.max(label_img[i, :, :]) > 0:
            sl = slice(end, i)
            return cart_tm[sl], cart_fm[sl], tibia[sl], scan[sl]
    return cart_tm, cart_fm, tibia, scan


def convert(path: str, out_dir: str, split: float = 0.85) -> int:
    shutil.rmtree(out_dir, ignore_errors=True)
    for s in ("train", "test"):
        for d in ("images", "labels"):
            os.makedirs(os.path.join(out_dir, s, d))
    print("Created folders")

    files = sorted(os.listdir(path))
    n = len(files)
    print(f"Saving {n} scans.")
    n_train = int(round(n * split))
    for i, f in enumerate(files):
        mat = loadmat_any(os.path.join(path, f))
        scan = np.asarray(mat["scan"], dtype=np.float32)
        # class merge: CartTM→1, CartFM→2, max-combined (Utils/nii.py:83-90)
        label = np.maximum(
            np.asarray(mat["CartTM"], dtype=np.float32) * 1.0,
            np.asarray(mat["CartFM"], dtype=np.float32) * 2.0,
        )
        part = "train" if i < n_train else "test"
        nifti.save(os.path.join(out_dir, part, "images", f"image{i}.nii"), scan)
        nifti.save(os.path.join(out_dir, part, "labels", f"image{i}.nii"), label)
        print(f"  [{i + 1}/{n}] {f} → {part} {scan.shape}")
    return n


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("path", nargs="?", default="ScanManTrim")
    ap.add_argument("--out", default="data_folder")
    ap.add_argument("--split", type=float, default=0.85)
    a = ap.parse_args()
    convert(a.path, a.out, a.split)
