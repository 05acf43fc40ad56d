"""Serving soak of the port (counterpart of the JAX package's
``tools/soak_serve.py``): stream volumes into a ``python -m
pmpu_tpu_torch.serve`` watch daemon, interleaved with corrupt files,
truncated gzip payloads, stalled uploads and oversize inputs, and check the
three invariants of a daemon that runs for days:

  1. bounded RSS: the peak stays at most ``--rss-slack-mb`` above the RSS
     taken once ``--warmup`` volumes are served (the verdict also gives the
     least-squares MB/volume slope of the RSS after the warm-up);
  2. no wedge: every good volume is served within ``--timeout``;
  3. recovery: a stalled upload that drew three failed loads (quarantined)
     is served once its upload completes; corrupt files are quarantined
     and oversize ones rejected without taking the daemon down.

Exit 0 iff all three hold and the daemon exits 0 on SIGINT; one JSON
verdict line on stdout.

    python3 -m pmpu_tpu_torch.tools.soak_serve --volumes 32 --cube 128 \\
        --filters 64,128,256,512,1024 --fault-every 8           # the card
    python3 -m pmpu_tpu_torch.tools.soak_serve --volumes 8 --cube 12 \\
        --poll 0.2 --fault-every 3 --device cpu                 # CI size

The stream is paced to fill ``--minutes`` when given (else it runs free).
A fault fires every ``--fault-every`` good volumes, cycling garbage bytes,
a truncated ``.nii.gz``, a stalled upload and an input 4 voxels larger than
the cube. The daemon runs on ``--device`` (the card by default).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

from pmpu_tpu_torch.data import nifti
from pmpu_tpu_torch.utils.profiling import rss_mb

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def wait_for(path: str, timeout: float) -> bool:
    """True once ``path`` exists and parses as a NIfTI volume."""
    t0 = time.time()
    while time.time() - t0 < timeout:
        if os.path.exists(path):
            try:
                nifti.load(path)
                return True
            except Exception:  # mid-write: try again
                pass
        time.sleep(0.1)
    return False


def rss_slope(points) -> float | None:
    """Least-squares slope (MB/volume) of RSS against volumes served."""
    if len(points) < 2 or len({s for s, _ in points}) < 2:
        return None
    served, rss = np.asarray(points, np.float64).T
    return float(np.polyfit(served, rss, 1)[0])


def _wait_for_log(log_lines: list, needle: str, timeout: float) -> bool:
    """True once ``needle`` appears in the daemon's captured log lines."""
    t0 = time.time()
    scanned = 0
    while time.time() - t0 < timeout:
        n = len(log_lines)
        if any(needle in ln for ln in log_lines[scanned:n]):
            return True
        scanned = n
        time.sleep(0.1)
    return False


def _nii_bytes(vol: np.ndarray, suffix: str = ".nii") -> bytes:
    with tempfile.TemporaryDirectory() as td:
        p = os.path.join(td, "v" + suffix)
        nifti.save(p, vol)
        with open(p, "rb") as f:
            return f.read()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Soak the port's serving daemon")
    p.add_argument("--volumes", type=int, default=300, help="good volumes to stream")
    p.add_argument("--cube", type=int, default=64)
    p.add_argument("--minutes", type=float, default=0.0,
                   help="pace the stream to fill this long (0 = free-run)")
    p.add_argument("--poll", type=float, default=0.5)
    p.add_argument("--fault-every", type=int, default=5, dest="fault_every",
                   help="interleave a fault every N volumes")
    p.add_argument("--timeout", type=float, default=300.0,
                   help="per-volume serve deadline (a miss counts as a wedge)")
    p.add_argument("--first-timeout", type=float, default=0.0, dest="first_timeout",
                   help="deadline for volume 0 only (covers start-up and the "
                   "kernels' build; 0 = max(900, --timeout))")
    p.add_argument("--rss-slack-mb", type=float, default=400.0, dest="rss_slack",
                   help="allowed RSS growth over the post-warmup baseline")
    p.add_argument("--warmup", type=int, default=5,
                   help="volumes served before the RSS baseline is taken")
    p.add_argument("--workdir", type=str, default=None)
    p.add_argument("--filters", type=str, default="4,8",
                   help="daemon --num-filters (full width: 64,128,256,512,1024)")
    p.add_argument("--rss-log", type=str, default=None, dest="rss_log",
                   help="write one 'volume_index served rss_mb' line per good volume")
    p.add_argument("--daemon-log", type=str, default=None, dest="daemon_log",
                   help="tee the daemon's output to this file (pairs with "
                   "PMPU_SERVE_DIAG=1 for the live-tensor census)")
    p.add_argument("--serve-arg", action="append", default=[], dest="serve_args",
                   help="extra flag passed through to the daemon (repeatable), "
                   "e.g. --serve-arg=--bf16")
    p.add_argument("--device", type=str, default="cuda",
                   help="the daemon's --device: cuda, or cpu")
    a = p.parse_args(argv)

    from pmpu_tpu_torch.device import resolve_device

    resolve_device(a.device)  # no CUDA device: refuse before starting anything
    work = a.workdir or tempfile.mkdtemp(prefix="pmpu_soak_")
    watch = os.path.join(work, "watch")
    out = os.path.join(work, "out")
    os.makedirs(watch, exist_ok=True)
    os.makedirs(out, exist_ok=True)
    rng = np.random.default_rng(0)
    s = a.cube

    proc = subprocess.Popen(
        [sys.executable, "-m", "pmpu_tpu_torch.serve", "-m", "unet",
         "--num-filters", a.filters, "--watch", watch, "--out", out,
         "--cube", str(s), "--poll", str(a.poll), "--device", a.device] + a.serve_args,
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    # drain the daemon's log in a thread so its pipe never fills and blocks it
    log_lines: list = []
    dlog_f = open(a.daemon_log, "w") if a.daemon_log else None

    def _drain():
        for ln in iter(proc.stdout.readline, ""):
            log_lines.append(ln)
            if dlog_f is not None:
                dlog_f.write(ln)
                dlog_f.flush()

    t_log = threading.Thread(target=_drain, daemon=True)
    t_log.start()

    interval = (a.minutes * 60.0 / a.volumes) if a.minutes else 0.0
    wedges, served, faults = [], 0, 0
    stalls_quarantined = 0
    rss_base = rss_peak = -1.0
    after_warmup = []  # (served, rss) once the baseline is taken
    rss_f = open(a.rss_log, "w") if a.rss_log else None
    verdict = {}
    try:
        for i in range(a.volumes):
            t_next = time.time() + interval
            name = f"vol{i:05d}.nii"
            vol = (rng.random((s, s, s)) * 0.5).astype(np.float32)
            vol[s // 4: s // 2, s // 4: s // 2, s // 4: s // 2] += 0.5
            nifti.save(os.path.join(watch, name), vol)

            if i % a.fault_every == 1:
                kind = (i // a.fault_every) % 4
                faults += 1
                if kind == 0:  # garbage bytes under a .nii name
                    with open(os.path.join(watch, f"bad{i:05d}.nii"), "wb") as f:
                        f.write(rng.bytes(2048))
                elif kind == 1:  # truncated gzip payload
                    blob = _nii_bytes(vol, ".nii.gz")
                    with open(os.path.join(watch, f"trunc{i:05d}.nii.gz"), "wb") as f:
                        f.write(blob[: len(blob) // 2])
                elif kind == 2:  # stalled upload: half now, the rest after quarantine
                    blob = _nii_bytes(vol)
                    stall = os.path.join(watch, f"stall{i:05d}.nii")
                    with open(stall, "wb") as f:
                        f.write(blob[: len(blob) // 2])
                        f.flush()
                        # hold the stall until the daemon quarantines the
                        # file, so that the completed write exercises the
                        # self-heal (a fixed sleep undershoots whenever
                        # inference delays the poll)
                        if _wait_for_log(log_lines, f"quarantining {os.path.basename(stall)}",
                                         max(20 * a.poll, 30.0)):
                            stalls_quarantined += 1
                        f.write(blob[len(blob) // 2:])
                    if not wait_for(os.path.join(out, os.path.basename(stall)), a.timeout):
                        wedges.append(os.path.basename(stall))
                else:  # oversize: rejected from its header
                    nifti.save(os.path.join(watch, f"big{i:05d}.nii"),
                               np.zeros((s + 4,) * 3, np.float32))

            vol_deadline = (a.first_timeout or max(900.0, a.timeout)) if i == 0 else a.timeout
            if not wait_for(os.path.join(out, name), vol_deadline):
                wedges.append(name)
            else:
                served += 1
            if proc.poll() is not None:
                wedges.append(f"DAEMON DIED rc={proc.returncode} at volume {i}")
                break
            r = rss_mb(proc.pid)
            rss_peak = max(rss_peak, r)
            if served == a.warmup and rss_base < 0:
                rss_base = r
            if rss_base >= 0:
                after_warmup.append((served, r))
            if rss_f is not None:
                rss_f.write(f"{i} {served} {r:.1f}\n")
                rss_f.flush()
            if interval:
                time.sleep(max(0.0, t_next - time.time()))

        alive = proc.poll() is None
        if alive:
            proc.send_signal(signal.SIGINT)
            rc = proc.wait(timeout=120)
        else:
            rc = proc.returncode
        t_log.join(timeout=10)
        rss_ok = rss_base < 0 or rss_peak <= rss_base + a.rss_slack
        log = "".join(log_lines)
        quarantines = log.count("quarantining")
        heals = log.count("re-inspecting")
        verdict = {
            "volumes": a.volumes,
            "served": served,
            "faults_injected": faults,
            "quarantines_logged": quarantines,
            "rejects_logged": log.count("; rejected"),
            "stalls_quarantined": stalls_quarantined,
            "self_heals_logged": heals,
            "wedges": wedges,
            "rss_base_mb": round(rss_base, 1),
            "rss_peak_mb": round(rss_peak, 1),
            "rss_slope_mb_per_volume": rss_slope(after_warmup),
            "rss_bounded": bool(rss_ok),
            "daemon_exit": rc,
            "device": a.device,
            # every stall the daemon quarantined must have healed (its output
            # is checked on its own through wait_for and wedges)
            "ok": bool(not wedges and rss_ok and alive and rc == 0
                       and served == a.volumes and heals >= stalls_quarantined),
        }
    finally:
        for f in (rss_f, dlog_f):
            if f is not None:
                f.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        if not a.workdir:
            shutil.rmtree(work, ignore_errors=True)
    print(json.dumps(verdict))
    return 0 if verdict.get("ok") else 1


if __name__ == "__main__":
    sys.exit(main())
