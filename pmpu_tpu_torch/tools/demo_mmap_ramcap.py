"""Out-of-core demo: ``--stream`` training of the port on a dataset whose
pool does not fit under a heap cap beside the trainer's own heap (counterpart of the JAX package's
``tools/demo_mmap_ramcap.py``, flag for flag, plus ``--device``).

Builds a synthetic NIfTI dataset (``pmpu_tpu_torch.data.nifti``) and runs
``python -m pmpu_tpu_torch.train --stream`` in child processes on
``--device``:

  0. once without a cap with ``--mmap-store`` (the baseline) and once
     without a cap in RAM, side by side: the peak of each one's ``VmData``
     (``/proc/<pid>/status``: heap and private writable mappings, what
     ``RLIMIT_DATA`` limits), sampled every 10 ms over the run, is printed.
     On the card it holds the CUDA context, the CUDA libraries' writable
     data and the host side of the caching allocators besides the
     trainer's heap;
  1. with ``--mmap-store`` under ``RLIMIT_DATA`` = the cap: the pool lives
     in file-backed shared memmaps, which the limit does not count, so it
     must live;
  2. without, under the same cap: the in-RAM ``VolumeStore`` holds the
     whole pool on the heap, so it must die.

The children train the U-Net 4,8 for one epoch at batch 4 on the 3
classes of the labels, on the axial view only (``--train-views 0``: a
third of the steps; the store still holds all of every volume): a step's
host buffers stay small, so a child's
VmData repeats within a few MB from run to run (at batch 64 its transient
buffers on the CPU moved it by about 30 MB). glibc's malloc in the
children keeps what it frees (``MALLOC_KEEPS_MEMORY``), so VmData only
grows and the last sample is the run's high-water mark. Freed memory is
reused, though (the in-RAM loader frees its f32 labels, half the pool,
after the load), so the in-RAM peak can lie less than the whole pool
above the baseline; run 0 measures it.

Where the kernel holds ``brk`` to ``RLIMIT_DATA`` but not private
anonymous mappings (gVisor: an H100 machine under it, ``uname`` Linux
4.4.0 ``runsc``, refused ``brk`` past a 64 MiB limit and granted a 128
MiB mapping), the limit alone caps nothing, since glibc's malloc falls
back to such a mapping when ``brk`` fails. A probe child finds that out
(``rlimit_data_enforced``: under a 64 MiB limit it asks for 128 MiB by
``brk`` and by a private mapping). Where either is granted, this tool
enforces the same cap on the same ``VmData`` itself, killing a child whose
sample passes it; where the kernel refuses both, as Linux does, the limit
alone acts and the in-RAM run dies by an allocation failure, as the root
tool's does. Since VmData only grows, a child past the cap stays past it
until the next 10 ms sample. The verdict says which of the two ended the
in-RAM run. Either way the demo rests on run 0: the
in-RAM run's peak must lie at least ``POOL_ON_HEAP`` (0.8) of the pool
above the mmap run's, or the pool did not leave the heap and the run is
"inconclusive" (exit 1).

The cap must lie between the baseline and the baseline plus the pool: a
``--cap-gb`` outside that range is refused (exit 2), since a cap below it
kills both runs and one above it lets both live, and neither proves
anything. Without ``--cap-gb`` the cap is the middle of the baseline and
the lower of the in-RAM peak and the baseline plus the pool. Runs 1 and 2
run side by side. Exit 0 iff (1) lives and (2) dies; an in-RAM run that
lives is "inconclusive" (exit 1). Bit-parity of the memmap pool with
the in-RAM store is covered separately (``tests/test_torch_volumes.py``).

    python3 -m pmpu_tpu_torch.tools.demo_mmap_ramcap [--volumes 32] [--cube 160] \\
        [--cap-gb G] [--workdir DIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

from pmpu_tpu_torch.data import nifti
from pmpu_tpu_torch.data.volumes import VolumeStore
from pmpu_tpu_torch.device import card_label, resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
GIB = 2 ** 30
CHILD_TIMEOUT = 3600.0  # seconds a child may run
# glibc's malloc of the children never gives memory back (no mmap'd
# blocks, no trimming), so a child's VmData only grows and its last sample
# is the run's high-water mark: a step's transient buffers, which the 10 ms
# samples would miss, count in the baseline as they do against the cap
MALLOC_KEEPS_MEMORY = {"MALLOC_MMAP_MAX_": "0", "MALLOC_ARENA_MAX": "1",
                       "MALLOC_TRIM_THRESHOLD_": str(2 ** 62)}
# the least share of the pool by which the uncapped in-RAM run's peak VmData
# must exceed the mmap run's: less, and the pool did not leave the heap
POOL_ON_HEAP = 0.8
ALLOCATION_FAILURES = ("MemoryError", "bad_alloc", "Unable to allocate", "can't allocate",
                       "out of memory", "OutOfMemory", "Cannot allocate memory",
                       "can't start new thread", "could not create a primitive")


def build_dataset(root, n, s):
    """One volume of heap at a time; about n*s^3*8 bytes of .nii on disk."""
    rng = np.random.default_rng(0)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    os.makedirs(os.path.join(root, "labels"), exist_ok=True)
    for i in range(n):
        img = rng.random((s, s, s)).astype(np.float32)
        lbl = (rng.random((s, s, s)) > 0.7).astype(np.float32) * 2
        img += 0.5 * (lbl > 0)
        nifti.save(os.path.join(root, "images", f"v{i:03d}.nii"), img)
        nifti.save(os.path.join(root, "labels", f"v{i:03d}.nii"), lbl)


def vm_data_bytes(pid) -> int:
    """``VmData`` of process ``pid`` in bytes; 0 once it cannot be read."""
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith("VmData:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 0


class Child:
    """``python -m pmpu_tpu_torch.train ARGS`` under ``RLIMIT_DATA`` = ``cap``
    (none when 0), its output in files of ``work``; ``peak_vm_data`` is the
    largest ``VmData`` sampled while it ran. With ``police`` (a kernel that
    does not hold the process to the limit), a sample above the cap kills
    the child: ``over_cap``."""

    def __init__(self, name, args_list, cap_bytes, work, police=False):
        self.name, self.cap, self.police = name, cap_bytes, police
        self.out = open(os.path.join(work, f"{name}.out"), "w+")
        self.err = open(os.path.join(work, f"{name}.err"), "w+")
        preexec = None
        if cap_bytes:
            def preexec():
                resource.setrlimit(resource.RLIMIT_DATA, (cap_bytes, cap_bytes))
        env = dict(os.environ, **MALLOC_KEEPS_MEMORY, PYTHONPATH=os.pathsep.join(
            p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
        self.t0 = time.time()
        self.proc = subprocess.Popen([sys.executable, "-m", "pmpu_tpu_torch.train", *args_list],
                                     cwd=work, env=env, stdout=self.out, stderr=self.err,
                                     preexec_fn=preexec)
        self.peak_vm_data = 0
        self.seconds = None
        self.over_cap = False

    def poll(self) -> bool:
        """Sample ``VmData``, kill the child past its cap; True once the
        child has exited."""
        if self.proc.poll() is None:
            vm = vm_data_bytes(self.proc.pid)
            self.peak_vm_data = max(self.peak_vm_data, vm)
            if self.police and vm > self.cap and not self.over_cap:
                self.over_cap = True
                self.proc.kill()
            return False
        if self.seconds is None:
            self.seconds = time.time() - self.t0
        return True

    def stderr(self) -> str:
        self.err.seek(0)
        return self.err.read()

    def close(self):
        self.out.close()
        self.err.close()


def run_children(children, timeout: float):
    """Sample every 10 ms until each child has exited; a child past
    ``timeout`` seconds is killed (and reads as died)."""
    deadline = time.time() + timeout
    try:
        while not all([c.poll() for c in children]):
            if time.time() > deadline:
                for c in children:
                    if c.proc.poll() is None:
                        c.proc.kill()
                        c.proc.wait()
            time.sleep(0.01)
    finally:
        for c in children:
            if c.proc.poll() is None:
                c.proc.kill()
                c.proc.wait()


_PROBE = """
import ctypes, mmap, resource
lim = 64 * 2**20
resource.setrlimit(resource.RLIMIT_DATA, (lim, lim))
out = []
try:
    mmap.mmap(-1, 2 * lim, flags=mmap.MAP_PRIVATE | mmap.MAP_ANONYMOUS,
                  prot=mmap.PROT_READ | mmap.PROT_WRITE)
    out.append("mmap allowed")
except OSError:
    out.append("mmap refused")
libc = ctypes.CDLL(None)
libc.sbrk.restype = ctypes.c_void_p
out.append("brk refused" if libc.sbrk(ctypes.c_long(2 * lim)) in (None, 2**64 - 1)
           else "brk allowed")
print(" ".join(out))
"""


def rlimit_data_enforced() -> dict:
    """Whether this machine's kernel holds a process to ``RLIMIT_DATA``: a
    child under a 64 MiB limit asks for 128 MiB by a private anonymous
    mapping and by ``brk``. Where the mapping is granted, the limit caps
    nothing (glibc's malloc falls back to a mapping when ``brk`` fails)."""
    res = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True, text=True,
                         timeout=60, check=True)
    words = res.stdout.split()
    return {"mmap": "refused" in words[:2], "brk": "refused" in words[2:]}


def check_cap(cap_bytes: int, baseline_bytes: int, pool_bytes: int):
    """Refuse a cap outside (baseline, baseline + pool)."""
    if not baseline_bytes < cap_bytes < baseline_bytes + pool_bytes:
        raise ValueError(
            f"cap {cap_bytes / GIB:.3f} GiB is outside the discriminating range "
            f"({baseline_bytes / GIB:.3f}, {(baseline_bytes + pool_bytes) / GIB:.3f}) GiB: the "
            "uncapped trainer's VmData and that plus the pool")


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--volumes", type=int, default=32)
    p.add_argument("--cube", type=int, default=160)
    p.add_argument("--cap-gb", type=float, default=None,
                   help="heap cap; must sit between the trainer's baseline VmData and "
                   "baseline + pool size (default: the middle of that range)")
    p.add_argument("--workdir", type=str, default=None)
    p.add_argument("--device", default=None,
                   help="the children's device (default: the card; 'cpu' off the card)")
    return p


def main(argv=None) -> int:
    a = parser().parse_args(argv)
    device = resolve_device(a.device)
    work = a.workdir or tempfile.mkdtemp(prefix="pmpu_ramcap_")
    data = os.path.join(work, "data")
    pool = os.path.join(work, "pool")
    pool_bytes = a.volumes * a.cube ** 3 * (4 + 4)  # f32 images + i32 labels
    print(f"dataset: {a.volumes} x {a.cube}^3 -> padded pool {pool_bytes / GIB:.3f} GiB; "
          f"children on {card_label(device)}", flush=True)
    if not os.path.isdir(os.path.join(data, "images")):
        build_dataset(data, a.volumes, a.cube)
    # the pool is built here, so that every child reopens it alike: a child
    # that built it would carry the build's heap into the baseline
    VolumeStore.from_dirs(os.path.join(data, "images"), os.path.join(data, "labels"),
                          mmap_dir=pool)
    train_args = [
        "-m", "unet", "--n-classes", "3", "-d", data, "-e", "1", "-b", "4", "-l", "0.01",
        "--num-filters", "4,8", "--train-views", "0", "--stream", "--device", str(device),
        "--checkpoint-dir", os.path.join(work, "ckpt"),
    ]
    children = []
    try:
        base = Child("baseline", train_args + ["--mmap-store", pool], 0, work)
        free = Child("inram_uncapped", train_args, 0, work)
        children += [base, free]
        run_children([base, free], CHILD_TIMEOUT)
        for c in (base, free):
            if c.proc.returncode != 0:
                print(f"[{c.name}] rc={c.proc.returncode}: an uncapped run failed\n"
                      f"{c.stderr()[-3000:]}")
                return 1
        baseline, inram_peak = base.peak_vm_data, free.peak_vm_data
        upper = min(inram_peak, baseline + pool_bytes)
        print(f"[baseline ] uncapped runs side by side: peak VmData {baseline / GIB:.3f} GiB "
              f"with --mmap-store ({base.seconds:.1f}s), {inram_peak / GIB:.3f} GiB in RAM "
              f"({free.seconds:.1f}s); discriminating caps ({baseline / GIB:.3f}, "
              f"{(baseline + pool_bytes) / GIB:.3f}) GiB", flush=True)
        pool_on_heap = inram_peak - baseline >= POOL_ON_HEAP * pool_bytes
        if not pool_on_heap:
            print(f"inconclusive: the in-RAM run peaks {(inram_peak - baseline) / GIB:.3f} GiB "
                  f"above the mmap run, less than {POOL_ON_HEAP} of the pool")
            return 1
        cap = int(a.cap_gb * GIB) if a.cap_gb is not None else (baseline + upper) // 2
        print(f"[cap      ] {cap / GIB:.3f} GiB", flush=True)
        try:
            check_cap(cap, baseline, pool_bytes)
        except ValueError as e:
            print(f"refused: {e}")
            return 2
        enforced = rlimit_data_enforced()
        police = not (enforced["brk"] and enforced["mmap"])
        print(f"[cap      ] RLIMIT_DATA on this machine refuses brk {enforced['brk']}, private "
              f"mappings {enforced['mmap']}: "
              f"{'this tool kills a child past the cap' if police else 'the limit alone acts'}",
              flush=True)
        mm = Child("mmap", train_args + ["--mmap-store", pool], cap, work, police)
        ram = Child("inram", train_args, cap, work, police)
        children += [mm, ram]
        run_children([mm, ram], CHILD_TIMEOUT)
        mm_ok = mm.proc.returncode == 0
        print(f"[mmap-store] rc={mm.proc.returncode} in {mm.seconds:.1f}s "
              f"{'OK' if mm_ok else 'FAILED'}")
        if not mm_ok:
            print(mm.stderr()[-3000:])
        ram_err = ram.stderr()
        ram_died = ram.proc.returncode != 0
        oomish = not ram.over_cap and (ram.proc.returncode < 0
                                       or any(k in ram_err for k in ALLOCATION_FAILURES))
        how = (" [killed by this tool: VmData past the cap]" if ram.over_cap else
               " [allocation failure confirmed]" if ram_died and oomish else "")
        print(f"[in-RAM   ] rc={ram.proc.returncode} in {ram.seconds:.1f}s "
              f"{'died under the cap (expected)' if ram_died else 'SURVIVED (cap too generous — inconclusive)'}"
              f"{how}")
        if ram_died and not ram.over_cap:
            print("  " + "\n  ".join(ram_err.strip().splitlines()[-3:]))
        verdict = {
            "device": device.type,
            "card": card_label(device),
            "pool_gib": pool_bytes / GIB,
            "baseline_vm_data_gib": baseline / GIB,
            "inram_uncapped_vm_data_gib": inram_peak / GIB,
            "cap_gib": cap / GIB,
            "mmap_stream_rc": mm.proc.returncode,
            "mmap_stream_seconds": mm.seconds,
            "mmap_peak_vm_data_gib": mm.peak_vm_data / GIB,
            "inram_rc": ram.proc.returncode,
            "inram_peak_vm_data_gib": ram.peak_vm_data / GIB,
            "inram_allocation_failure": bool(ram_died and oomish),
            "inram_killed_over_cap": ram.over_cap,
            "mmap_killed_over_cap": mm.over_cap,
            "rlimit_data_enforced": enforced,
            "cap_enforced_by_tool": police,
            "inram_over_mmap_per_pool": (inram_peak - baseline) / pool_bytes,
            "pool_on_heap": pool_on_heap,
            "discriminating": bool(pool_on_heap and mm_ok and ram_died),
        }
        print(json.dumps(verdict))
        return 0 if verdict["discriminating"] else 1
    finally:
        for c in children:
            c.close()
        if not a.workdir:
            shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
