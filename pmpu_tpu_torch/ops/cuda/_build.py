"""Build the CUDA sources in ``csrc/`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` is compiled at first use by ``nvcc`` for
``sm_90a`` into ``_build/<name>-<hash>.so``, a shared library with a plain
``extern "C"`` API (no PyTorch headers, no ninja). A variant (``VARIANTS``)
is one source built with extra defines under a library name of its own;
the default build (``SOURCES``) never builds or loads one. The hash covers
the source and the flags, so an edited source rebuilds. A failed build
raises with nvcc's stderr. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("fcomb_mean", "slice_gather", "qconv", "oblique_gather")
# library name -> (source, extra nvcc flags); built only when asked for
VARIANTS = {"qconv_clocks": ("qconv", ("-DPMPU_QCONV_CLOCKS",))}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc_path() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin)")
    return path


def _source_flags(name: str):
    source, extra = VARIANTS.get(name, (name, ()))
    return CSRC / f"{source}.cu", (*NVCC_FLAGS, *extra)


def target(name: str) -> Path:
    src, flags = _source_flags(name)
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names=SOURCES) -> dict:
    """Compile every library of ``names`` (sources or variants) that is
    missing, one nvcc process per library, all started together. Returns {name: (seconds,
    nvcc's stderr)} for the sources built now."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        out = target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        src, flags = _source_flags(name)
        cmd = [nvcc_path(), *flags, "-o", str(tmp), str(src)]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                       text=True), tmp, out, time.perf_counter())
    done, failed = {}, []
    for name, (proc, tmp, out, t0) in jobs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name} (rc {proc.returncode}):\n{stdout}{stderr}")
            continue
        os.replace(tmp, out)
        done[name] = (time.perf_counter() - t0, stderr)
    if failed:
        raise RuntimeError("\n".join(failed))
    return done


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (a source of ``csrc/`` or a variant),
    built first if needed."""
    build((name,))
    return ctypes.CDLL(str(target(name)))


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if rc != 0:
        lib.pmpu_error_string.restype = ctypes.c_char_p
        lib.pmpu_error_string.argtypes = [ctypes.c_int]
        msg = lib.pmpu_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc}: {msg}")
