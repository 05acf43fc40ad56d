"""ctypes bindings of the native C++ NIfTI loader (``native/pmpu_io.cpp``):
the port's copy of ``pmpu_tpu/data/native.py`` (``get_lib`` :43,
``available`` :84, ``read_shape`` :113, the payload preflight :117-200,
``load_volume`` :203, ``load_dataset`` :226), over the same C API
(``pmpu_read_header``, ``pmpu_load_volume_f32``, ``pmpu_load_dataset_f32``).

The library is built at first use from the source with the host's ``g++``
into ``_build/libpmpu_io-<hash>.so`` beside this file (the hash covers the
source and the flags, so an edited source rebuilds). The committed
``native/libpmpu_io.so`` is never loaded: it is built with
``-march=native`` and can die with SIGILL on another host, which no
fallback could catch. Without a compiler or zlib the pure-numpy reader
(``pmpu_tpu_torch.data.nifti``) is the fallback, logged once; the two give
the same arrays (tested). This is host I/O, not the device.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import logging
import os
import subprocess
import zlib
from pathlib import Path

import numpy as np

log = logging.getLogger(__name__)

SOURCE = Path(__file__).resolve().parents[2] / "native" / "pmpu_io.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")
LD_FLAGS = ("-lz", "-pthread")


def target() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(CXX_FLAGS + LD_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libpmpu_io-{digest}.so"


def _build() -> Path:
    """The library, compiled now if it is missing; raises when it cannot be."""
    out = target()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE), *LD_FLAGS]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed (rc {proc.returncode}): {proc.stderr[-2000:]}")
    os.replace(tmp, out)  # concurrent builders each rename a complete file
    return out


@functools.cache
def get_lib():
    """The loaded CDLL, or None when native I/O is unavailable (logged once)."""
    try:
        lib = ctypes.CDLL(str(_build()))
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        log.warning("native NIfTI loader unavailable (%s); using the numpy reader", e)
        return None
    lib.pmpu_read_header.restype = ctypes.c_int
    lib.pmpu_read_header.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.pmpu_load_volume_f32.restype = ctypes.c_int64
    lib.pmpu_load_volume_f32.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.pmpu_load_dataset_f32.restype = ctypes.c_int
    lib.pmpu_load_dataset_f32.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int,
    ]
    return lib


def available() -> bool:
    return get_lib() is not None


def _lib():
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native io unavailable")
    return lib


_DTYPE_BYTES = {2: 1, 256: 1, 4: 2, 512: 2, 8: 4, 768: 4, 16: 4,
                64: 8, 1024: 8, 1280: 8}


def _read_header(path: str) -> tuple:
    """(shape, datatype, vox_offset) with structural validation."""
    lib = _lib()
    dims = (ctypes.c_int64 * 8)()
    dt = ctypes.c_int()
    scl = (ctypes.c_double * 2)()
    off = ctypes.c_int64()
    rc = lib.pmpu_read_header(str(path).encode(), dims, ctypes.byref(dt), scl,
                              ctypes.byref(off))
    if rc != 0:
        raise ValueError(f"{path}: native header error {rc}")
    nd = int(dims[0])
    if not (1 <= nd <= 7):
        raise ValueError(f"{path}: bad NIfTI dim[0]={nd}")
    shape = tuple(int(dims[1 + i]) for i in range(nd))
    if any(d < 1 for d in shape):
        raise ValueError(f"{path}: non-positive dimension in {shape}")
    return shape, int(dt.value), int(off.value)


def read_shape(path: str) -> tuple:
    return _read_header(path)[0]


def _gz_yields_at_least(path: str, want: int) -> bool:
    """True iff the (possibly multi-member) gzip stream decompresses to at
    least ``want`` bytes; a streaming count that stops at ``want``."""
    seen = 0
    d = zlib.decompressobj(wbits=31)  # 31 = gzip wrapper
    try:
        with open(path, "rb") as f:
            buf = b""
            while True:
                if not buf:
                    buf = f.read(1 << 20)
                    if not buf:
                        return False  # input exhausted before `want`
                seen += len(d.decompress(buf, 1 << 20))
                if seen >= want:
                    return True
                if d.eof:
                    # a following gzip member continues the logical stream
                    # (zlib's gzread concatenates them); anything else ends it
                    buf = d.unused_data
                    if len(buf) < 2:
                        buf += f.read(1 << 20)
                    if not buf.startswith(b"\x1f\x8b"):
                        return False
                    d = zlib.decompressobj(wbits=31)
                else:
                    buf = d.unconsumed_tail
    except zlib.error:
        return False


def _preflight_payload(path: str, count: int, esz: int, vox_offset: int) -> None:
    """Reject implausible header-claimed sizes before the output buffer is
    allocated: plain files against their size; gzip files against deflate's
    maximum expansion, then the trailing ISIZE field, then (multi-member
    files) an exact streaming count."""
    claimed = vox_offset + count * esz
    try:
        fsize = os.path.getsize(path)
    except OSError as e:
        raise ValueError(f"{path}: {e}") from e
    if not str(path).endswith(".gz"):
        if claimed > fsize:
            raise ValueError(f"{path}: header claims {claimed} bytes but file has {fsize}")
        return
    if claimed > fsize * 1032 + (1 << 16):
        raise ValueError(f"{path}: header claims {claimed} bytes from a "
                         f"{fsize}-byte gzip (exceeds max deflate expansion)")
    if claimed < (1 << 32):
        try:
            with open(path, "rb") as f:
                f.seek(-4, os.SEEK_END)
                isize = int.from_bytes(f.read(4), "little")
        except OSError as e:
            raise ValueError(f"{path}: {e}") from e
        if claimed > isize and not _gz_yields_at_least(path, claimed):
            raise ValueError(f"{path}: header claims {claimed} bytes but gzip "
                             f"decompresses to {isize}")


def load_volume(path: str) -> np.ndarray:
    """One volume as C-order float32 (scl applied), as
    ``nifti.load(path, dtype=np.float32)``."""
    lib = _lib()
    full_shape, datatype, vox_offset = _read_header(path)
    shape = full_shape[:3]
    n = int(np.prod(shape))
    esz = _DTYPE_BYTES.get(datatype)
    if esz is None:
        raise ValueError(f"{path}: unsupported NIfTI datatype {datatype}")
    _preflight_payload(path, int(np.prod(full_shape)), esz, vox_offset)
    out = np.empty(n, dtype=np.float32)
    sh = (ctypes.c_int64 * 3)()
    rc = lib.pmpu_load_volume_f32(
        str(path).encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n, sh)
    if rc < 0:
        raise ValueError(f"{path}: native load error {-rc}")
    return out.reshape(shape)


def load_dataset(paths: list, cube: int, nthreads: int = 0, out=None) -> np.ndarray:
    """Parallel stacked load: (len(paths), cube, cube, cube) float32, each
    volume zero-padded at the high end. ``out``: a C-contiguous float32
    buffer of that shape to fill in place (an ``np.memmap`` for the
    out-of-core pool)."""
    lib = _lib()
    n = len(paths)
    if out is None:
        out = np.empty((n, cube, cube, cube), dtype=np.float32)
    elif (out.shape != (n, cube, cube, cube) or out.dtype != np.float32
          or not out.flags["C_CONTIGUOUS"]):
        raise ValueError(f"out must be C-contiguous float32 {(n, cube, cube, cube)}, "
                         f"got {out.dtype} {out.shape}")
    arr = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    rc = lib.pmpu_load_dataset_f32(
        arr, n, cube, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), nthreads)
    if rc != 0:
        raise ValueError(f"native dataset load error {rc}")
    return out
