"""Stream-training RSS soak of the port (counterpart of the JAX package's
``tools/soak_stream_train.py``): drive a ``python -m pmpu_tpu_torch.train
--stream`` subprocess for N minutes, sampling its host RSS, and measure
the creep of a training run that uploads a batch every step
(``data/pipeline.py::PrefetchPipeline``: host gather, pinned buffers).

    # unbounded creep (the card, full width):
    python3 -m pmpu_tpu_torch.tools.soak_stream_train --minutes 30 --out runs/soak_stream.csv

    # bounded: the train CLI re-executes itself at an epoch boundary above
    # the limit
    python3 -m pmpu_tpu_torch.tools.soak_stream_train --minutes 30 --rss-limit-mb 4000

    # CI size on the CPU
    python3 -m pmpu_tpu_torch.tools.soak_stream_train --cpu --minutes 0.25 --cube 16 \\
        --volumes 2 --filters 4,8 --batch 4 --rss-limit-mb 1

The re-exec keeps the PID (``os.execv``), so one PID is sampled
throughout. The run ends with SIGTERM (the preemption path: the child saves
``INTERRUPTED.pth`` in its working directory, the data directory, and
exits 0), sent once the child's present process image runs its epoch loop
(after the deadline the tool waits for that: before the loop, SIGTERM ends
the train CLI at once) and prints one JSON summary line ``SOAK {...}``: the creep (a
least-squares fit over the last 80 % of the samples, MB/min), the first,
least, largest and last RSS, the epochs completed, the re-execs, whether
the interrupt save happened and the child's exit code. ``--cpu`` passes
``--device cpu`` to the child; without it the child trains on the card.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np

from pmpu_tpu_torch.data import nifti
from pmpu_tpu_torch.utils.profiling import rss_mb

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def write_volumes(directory: str, n: int, s: int) -> None:
    """``n`` seeded labeled ``s``³ scans under ``directory/{images,labels}``
    (the JAX tool's: a cube of class 1 around a random center, class 2 at
    its middle)."""
    rng = np.random.default_rng(0)
    for i in range(n):
        lbl = np.zeros((s, s, s), np.float32)
        c = rng.integers(s // 3, 2 * s // 3, size=3)
        w = s // 6
        lbl[c[0] - w : c[0] + w, c[1] - w : c[1] + w, c[2] - w : c[2] + w] = 1
        lbl[c[0] - 2 : c[0] + 2, c[1] - 2 : c[1] + 2, c[2] - 2 : c[2] + 2] = 2
        img = (rng.random((s, s, s)) * 0.3 + 0.6 * (lbl > 0)).astype(np.float32)
        nifti.save(os.path.join(directory, "images", f"v{i}.nii"), img)
        nifti.save(os.path.join(directory, "labels", f"v{i}.nii"), lbl)


def in_loop(log: str) -> bool:
    """Whether the child's present process image runs its epoch loop: its
    last "Starting training" line (logged once the loop's SIGTERM handler is
    in place) follows the last "against --rss-limit-mb" line (the loop's
    last check before a re-exec)."""
    return log.rfind("Starting training") > log.rfind("against --rss-limit-mb")


def wait_in_loop(proc, log_path: str, timeout: float = 600.0) -> None:
    """Wait (at most ``timeout`` s) until the child runs its epoch loop or
    has ended. Outside the loop (start-up, a re-exec) SIGTERM ends the train
    CLI at once, without ``INTERRUPTED.pth``."""
    end = time.monotonic() + timeout
    while proc.poll() is None and time.monotonic() < end:
        with open(log_path) as f:
            if in_loop(f.read()):
                return
        time.sleep(0.05)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--minutes", type=float, default=30.0)
    ap.add_argument("--cube", type=int, default=128)
    ap.add_argument("--volumes", type=int, default=8)
    ap.add_argument("--filters", default="64,128,256,512,1024")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--rss-limit-mb", dest="rss_limit_mb", type=float, default=0.0)
    ap.add_argument("--out", default="runs/soak_stream.csv")
    ap.add_argument("--data", default=os.path.join(tempfile.gettempdir(), "soak_stream_data"))
    ap.add_argument("--sample-every", type=float, default=2.0)
    ap.add_argument("--cpu", action="store_true", help="train on the CPU (CI size)")
    args = ap.parse_args(argv)
    # the child runs in the data directory: a relative --data would resolve twice
    args.data = os.path.abspath(args.data)

    img_dir = os.path.join(args.data, "images")
    if not os.path.isdir(img_dir) or len(os.listdir(img_dir)) != args.volumes:
        write_volumes(args.data, args.volumes, args.cube)
        print(f"wrote {args.volumes} synthetic {args.cube}^3 volumes to {args.data}", flush=True)
    if os.path.exists(os.path.join(args.data, "INTERRUPTED.pth")):
        os.remove(os.path.join(args.data, "INTERRUPTED.pth"))

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH")) if p)
    cmd = [
        sys.executable, "-m", "pmpu_tpu_torch.train", "-m", "probunet",
        "-d", args.data, "--num-filters", args.filters,
        "-e", "100000", "-b", str(args.batch), "--stream", "--bf16",
        "--checkpoint-dir", os.path.join(args.data, "ckpt"),
        "--checkpoint-every", "1000000",  # no per-epoch saves: isolate the creep
    ]
    if args.rss_limit_mb:
        cmd += ["--rss-limit-mb", str(args.rss_limit_mb)]
    if args.cpu:
        cmd += ["--device", "cpu"]
    log_path = os.path.join(args.data, "train.log")
    with open(log_path, "w") as logf:
        proc = subprocess.Popen(cmd, env=env, stdout=logf, stderr=subprocess.STDOUT,
                                cwd=args.data)
    print(f"train pid {proc.pid} (log {log_path})", flush=True)

    out_dir = os.path.dirname(os.path.abspath(args.out))
    os.makedirs(out_dir, exist_ok=True)
    rows = []
    t0 = time.monotonic()
    deadline = t0 + args.minutes * 60.0
    try:
        with open(args.out, "w") as f:
            f.write("t_s,rss_mb\n")
            while time.monotonic() < deadline and proc.poll() is None:
                time.sleep(args.sample_every)
                r = rss_mb(proc.pid)
                if r > 0:
                    rows.append((time.monotonic() - t0, r))
                    f.write(f"{rows[-1][0]:.1f},{r:.1f}\n")
                    f.flush()
    finally:
        if proc.poll() is None:
            wait_in_loop(proc, log_path)
            proc.send_signal(signal.SIGTERM)  # the preemption path: INTERRUPTED.pth
            try:
                proc.wait(timeout=600)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()

    with open(log_path) as f:
        log = f.read()
    arr = np.asarray(rows) if rows else np.zeros((0, 2))
    # the creep over the tail (the first 20 % holds the imports, the first
    # touch of the weights and data, the first cuDNN and cuBLAS calls)
    rate = None
    if len(arr) > 10:
        tail = arr[len(arr) // 5 :]
        rate = float(np.polyfit(tail[:, 0], tail[:, 1], 1)[0] * 60.0)
    rss = arr[:, 1]
    print("SOAK", json.dumps({
        "minutes": round((time.monotonic() - t0) / 60.0, 2),
        "samples": len(rows),
        "rss_first_mb": round(float(rss[0]), 1) if len(rss) else None,
        "rss_min_mb": round(float(rss.min()), 1) if len(rss) else None,
        "rss_max_mb": round(float(rss.max()), 1) if len(rss) else None,
        "rss_last_mb": round(float(rss[-1]), 1) if len(rss) else None,
        "creep_mb_per_min_tail": None if rate is None else round(rate, 2),
        "epochs_done": log.count(" done ("),
        "reexecs": log.count("re-exec for bounded RSS"),
        "sigterm_interrupted_save": "Saved interrupt" in log
        and os.path.exists(os.path.join(args.data, "INTERRUPTED.pth")),
        "rss_limit_mb": args.rss_limit_mb,
        "exit_code": proc.returncode,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
