"""Minimal, dependency-free NIfTI-1 reader/writer (numpy only): the port's
copy of ``pmpu_tpu/data/nifti.py`` (``NiftiHeader`` :42, ``is_nifti_name``
:101, ``read_header`` :115, ``load`` :190, ``save`` :230, ``AsyncWriter``
:271), kept here because importing the JAX package pulls in jax.

The single-file NIfTI-1 format (``.nii`` / ``.nii.gz``): 348-byte header,
optional extensions, data at ``vox_offset``, ``scl_slope``/``scl_inter``
scaling (what nibabel's ``get_fdata`` applies). A file written by either
package reads back equal in the other; ``save`` writes the same header
and data as the JAX package's.
"""

from __future__ import annotations

import gzip
import struct
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

# NIfTI-1 datatype codes → numpy dtypes
_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}

HDR_SIZE = 348


@dataclass
class NiftiHeader:
    dim: tuple = (3, 1, 1, 1, 1, 1, 1, 1)
    datatype: int = 16
    bitpix: int = 32
    pixdim: tuple = (1.0,) * 8
    vox_offset: float = 352.0
    scl_slope: float = 0.0
    scl_inter: float = 0.0
    qform_code: int = 0
    sform_code: int = 1
    srow: np.ndarray = field(default_factory=lambda: np.eye(4, dtype=np.float32)[:3])
    quatern: tuple = (0.0, 0.0, 0.0)  # (b, c, d); a derived
    qoffset: tuple = (0.0, 0.0, 0.0)
    descrip: bytes = b"pmpu_tpu"
    magic: bytes = b"n+1\x00"
    endian: str = "<"

    @property
    def shape(self) -> tuple:
        nd = self.dim[0]
        return tuple(int(d) for d in self.dim[1 : 1 + nd])

    @property
    def affine(self) -> np.ndarray:
        """Voxel→world transform: sform when set, else the quaternion
        qform, else pixdim-scaled identity (the NIfTI-1 'method 3 > 2 > 1'
        order — method 1 carries spacing in pixdim alone, so a plain
        identity here would silently claim 1 mm isotropic voxels for
        legacy scans with both transform codes 0)."""
        a = np.eye(4, dtype=np.float64)
        if self.sform_code > 0:
            a[:3] = self.srow
        elif self.qform_code > 0:
            a = self.qform_affine
        else:
            for i in range(3):
                sp = float(self.pixdim[i + 1])
                a[i, i] = sp if np.isfinite(sp) and sp > 0 else 1.0
        return a

    @property
    def qform_affine(self) -> np.ndarray:
        """Quaternion qform → 4×4 affine (NIfTI-1 'method 2': rotation
        columns scaled by pixdim, qfac = pixdim[0] flipping the third)."""
        b, c, d = (float(x) for x in self.quatern)
        aa = max(0.0, 1.0 - b * b - c * c - d * d) ** 0.5
        r = np.array([
            [aa * aa + b * b - c * c - d * d, 2 * (b * c - aa * d), 2 * (b * d + aa * c)],
            [2 * (b * c + aa * d), aa * aa + c * c - b * b - d * d, 2 * (c * d - aa * b)],
            [2 * (b * d - aa * c), 2 * (c * d + aa * b), aa * aa + d * d - b * b - c * c],
        ])
        qfac = -1.0 if self.pixdim[0] < 0 else 1.0
        sp = [self.pixdim[1], self.pixdim[2], qfac * self.pixdim[3]]
        m = np.eye(4, dtype=np.float64)
        m[:3, :3] = r * np.asarray(sp)[None, :]
        m[:3, 3] = self.qoffset
        return m


def is_nifti_name(name) -> bool:
    """True for the file suffixes this codec reads (.nii / .nii.gz) — the
    shared filter for directory-scanning CLIs (predict batch, serve watch)."""
    name = str(name)
    return name.endswith(".nii") or name.endswith(".nii.gz")


def _open(path, mode="rb"):
    p = str(path)
    if p.endswith(".gz"):
        return gzip.open(p, mode)
    return open(p, mode)


def read_header(path) -> NiftiHeader:
    with _open(path) as f:
        raw = f.read(HDR_SIZE)
    if len(raw) < HDR_SIZE:
        raise ValueError(f"{path}: truncated NIfTI header ({len(raw)} bytes)")
    (sizeof_hdr,) = struct.unpack("<i", raw[0:4])
    endian = "<"
    if sizeof_hdr != HDR_SIZE:
        (sizeof_hdr,) = struct.unpack(">i", raw[0:4])
        if sizeof_hdr != HDR_SIZE:
            raise ValueError(f"{path}: not a NIfTI-1 file (sizeof_hdr={sizeof_hdr})")
        endian = ">"

    def unpack(fmt, off, n):
        return struct.unpack(f"{endian}{fmt}", raw[off : off + n])

    dim = unpack("8h", 40, 16)
    (datatype,) = unpack("h", 70, 2)
    (bitpix,) = unpack("h", 72, 2)
    pixdim = unpack("8f", 76, 32)
    (vox_offset,) = unpack("f", 108, 4)
    (scl_slope,) = unpack("f", 112, 4)
    (scl_inter,) = unpack("f", 116, 4)
    (qform_code,) = unpack("h", 252, 2)
    (sform_code,) = unpack("h", 254, 2)
    quatern = unpack("3f", 256, 12)
    qoffset = unpack("3f", 268, 12)
    srow = np.array(
        [unpack("4f", 280, 16), unpack("4f", 296, 16), unpack("4f", 312, 16)],
        dtype=np.float32,
    )
    magic = raw[344:348]
    if magic == b"ni1\x00":
        # NIfTI-1 PAIR files ("ni1", data in a sibling .img with
        # vox_offset=0) are not supported by this single-file codec —
        # reject explicitly rather than via a misleading vox_offset error
        # (the >=348 floor below would make every conforming pair fail).
        raise ValueError(
            f"{path}: NIfTI-1 pair (.hdr/.img) files are unsupported; "
            "convert to single-file .nii/.nii.gz"
        )
    if magic != b"n+1\x00":
        raise ValueError(f"{path}: bad NIfTI magic {magic!r}")
    # Structural validation: corrupt headers must fail HERE, not downstream.
    # Negative dims would otherwise reach np.prod as a negative count (and a
    # pair of them multiplies back to a positive one); a NaN / sub-header
    # vox_offset would re-read header bytes as voxel data.
    nd = int(dim[0])
    if not (1 <= nd <= 7):
        raise ValueError(f"{path}: bad NIfTI dim[0]={nd}")
    if any(int(d) < 1 for d in dim[1 : 1 + nd]):
        raise ValueError(
            f"{path}: non-positive dimension in {tuple(dim[1 : 1 + nd])}"
        )
    if not np.isfinite(vox_offset) or vox_offset < HDR_SIZE:
        raise ValueError(f"{path}: bad vox_offset {vox_offset}")
    return NiftiHeader(
        endian=endian,
        dim=dim,
        datatype=int(datatype),
        bitpix=int(bitpix),
        pixdim=pixdim,
        vox_offset=float(vox_offset),
        scl_slope=float(scl_slope),
        scl_inter=float(scl_inter),
        qform_code=int(qform_code),
        sform_code=int(sform_code),
        quatern=tuple(float(q) for q in quatern),
        qoffset=tuple(float(q) for q in qoffset),
        srow=srow,
        descrip=raw[148:228].rstrip(b"\x00"),
        magic=magic,
    )


def load(path, dtype=np.float32) -> np.ndarray:
    """Read volume data, applying scl_slope/inter (nibabel ``get_fdata``
    semantics — used throughout the reference, e.g. ``mri_dataset.py:124``).
    Returns Fortran-order-decoded data as a C-contiguous array of ``dtype``."""
    hdr = read_header(path)
    if hdr.datatype not in _DTYPES:
        raise ValueError(f"{path}: unsupported NIfTI datatype {hdr.datatype}")
    np_dtype = np.dtype(_DTYPES[hdr.datatype]).newbyteorder(hdr.endian)
    shape = hdr.shape
    count = int(np.prod(shape))
    with _open(path) as f:
        try:
            # a corrupt-but-finite vox_offset (e.g. 3.9e14) can make the
            # seek itself fail at the OS level; that's file corruption, so
            # surface it under the codec's ValueError contract
            f.seek(int(hdr.vox_offset))
            buf = f.read(count * np_dtype.itemsize)
        except (OSError, OverflowError) as e:
            raise ValueError(f"{path}: unreadable data section ({e})") from e
    if len(buf) < count * np_dtype.itemsize:
        raise ValueError(f"{path}: truncated data section")
    arr = np.frombuffer(buf, dtype=np_dtype, count=count)
    # NIfTI data is Fortran (column-major) ordered
    arr = arr.reshape(shape, order="F")
    out = arr.astype(dtype)
    slope, inter = hdr.scl_slope, hdr.scl_inter
    # scl_slope == 0 (or NaN — some writers leave the fields unset as NaN)
    # means "scaling unset" per the NIfTI-1 spec; nibabel's get_fdata
    # ignores BOTH fields then (inter included) — match that. Non-finite
    # values must never be multiplied in: that would NaN the whole volume.
    if (
        np.isfinite(slope)
        and np.isfinite(inter)
        and slope != 0.0
        and (slope != 1.0 or inter != 0.0)
    ):
        out = out * dtype(slope) + dtype(inter)
    return np.ascontiguousarray(out)


def save(path, data: np.ndarray, affine: np.ndarray | None = None) -> None:
    """Write a single-file NIfTI-1 (.nii or .nii.gz). Default affine is
    identity — matching the reference's exports (``eval.py:51-57``,
    ``Utils/nii.py:92-104`` use ``affine=np.eye(4)``)."""
    data = np.asarray(data)
    if data.dtype not in _DTYPE_CODES:
        data = data.astype(np.float32)
    if affine is None:
        affine = np.eye(4)
    nd = data.ndim
    dim = [nd] + list(data.shape) + [1] * (7 - nd)

    hdr = bytearray(HDR_SIZE)
    struct.pack_into("<i", hdr, 0, HDR_SIZE)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, _DTYPE_CODES[data.dtype])
    struct.pack_into("<h", hdr, 72, data.dtype.itemsize * 8)
    # pixdim from the affine's column norms so anisotropic voxel spacing
    # survives in consumers that read pixdim rather than the sform
    sp = np.linalg.norm(np.asarray(affine, dtype=np.float64)[:3, :3], axis=0)
    sp = [float(s) if np.isfinite(s) and s > 0 else 1.0 for s in sp]
    struct.pack_into("<8f", hdr, 76, 1.0, sp[0], sp[1], sp[2], 1.0, 1.0, 1.0, 1.0)
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)  # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)  # scl_inter
    hdr[148 : 148 + 8] = b"pmpu_tpu"
    struct.pack_into("<h", hdr, 252, 0)  # qform_code
    struct.pack_into("<h", hdr, 254, 1)  # sform_code
    struct.pack_into("<4f", hdr, 280, *affine[0])
    struct.pack_into("<4f", hdr, 296, *affine[1])
    struct.pack_into("<4f", hdr, 312, *affine[2])
    hdr[344:348] = b"n+1\x00"

    # tobytes(order="F") serializes column-major directly — no asfortranarray
    # copy first (that would materialize a second full-volume buffer per save)
    payload = bytes(hdr) + b"\x00" * 4 + data.tobytes(order="F")
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with _open(path, "wb") as f:
        f.write(payload)


class AsyncWriter:
    """Background-thread NIfTI exporter for the eval/serving hot loops.

    ``save`` enqueues a write and returns immediately, so disk IO (and gzip
    compression for ``.nii.gz``) overlaps the next volume's device fetch and
    compute instead of sitting on the critical path between fetches. The
    reference writes synchronously inside its eval loop (``eval.py:194``).

    ``close()`` drains the queue, joins the thread, and re-raises the first
    write error; also usable as a context manager. ``max_pending`` bounds
    host memory held by queued arrays (back-pressure via a blocking put).
    """

    def __init__(self, max_pending: int = 8):
        import queue
        import threading

        self._q: "queue.Queue" = queue.Queue(maxsize=max_pending)
        self._err: Exception | None = None
        self._closed = False
        self._thread = threading.Thread(
            target=self._run, name="pmpu-nifti-writer", daemon=True
        )
        self._thread.start()

    def _run(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                path, data, affine = item
                if self._err is None:  # first error wins; drain the rest
                    save(path, data, affine)
            except Exception as e:
                self._err = e
            finally:
                self._q.task_done()

    def save(self, path, data: np.ndarray, affine: np.ndarray | None = None) -> None:
        if self._closed:
            raise RuntimeError("AsyncWriter.save() after close()")
        if self._err is not None:
            raise self._err
        self._q.put((path, np.asarray(data), affine))

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._q.put(None)
            self._thread.join()
        if self._err is not None:
            raise self._err

    def __enter__(self) -> "AsyncWriter":
        return self

    def __exit__(self, *exc) -> None:
        # don't mask an in-flight exception with a write error
        if exc and exc[0] is not None:
            try:
                self.close()
            except Exception:
                pass
        else:
            self.close()
