"""``--rss-limit-mb`` in a world of ranks on the CPU (gloo):

* the decision is the ranks' together: with rank 1 alone over the limit
  (``rss_mb`` patched), both ranks stop at the same epoch, after rank 0 wrote
  the resume checkpoint;
* the train CLI with ``--rss-limit-mb 1`` for 2 epochs in a world of 2,
  under ``python -m torch.distributed.run --standalone`` (torchrun's agent
  store outlives the re-exec) and under ``parallel.spawn_world`` (rank 0
  hosts the store): each rank re-executes once into a fresh rendezvous,
  both epochs run, the ranks' losses are equal, rank 0 wrote the
  checkpoints;
* SIGTERM before the epoch loop (here a re-executed rank waiting in its
  rendezvous for a rank that never comes) ends the train CLI at once.
"""

import os
import pathlib
import re
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from pmpu_tpu_torch.data import nifti
from tests.torch_dist_worker import run_world

ROOT = pathlib.Path(__file__).resolve().parent.parent
EPOCH_LINE = re.compile(r"epoch (\d)/2 done \(.*; train loss (\S+), val loss (\S+); "
                        r"rank (\d) of 2\)")


def _scans(n=2, s=16, seed=0):
    rng = np.random.default_rng(seed)
    lbl = np.zeros((n, s, s, s), np.int32)
    lbl[:, 4:10, 4:10, 4:10] = 1
    lbl[:, 6:8, 6:8, 6:8] = 2
    img = (rng.random((n, s, s, s)) * 0.2 + 0.6 * (lbl > 0)).astype(np.float32)
    return img, lbl


def test_one_rank_over_the_limit_stops_both(tmp_path):
    cfg = dict(net="unet", num_filters=(4, 8), epochs=2, batchsize=4, train_views=(0,),
               data_parallel=True, rss_limit_mb=100.0, checkpoint_dir="ck")
    case = {"kind": "rss_decision", "cfg": cfg, "data": _scans(), "over": 1,
            "cwd": str(tmp_path / "run")}
    ranks = [r[0] for r in run_world(2, [case], tmp_path / "io")]
    for r in ranks:
        assert r["raised"] == "RssLimitExceeded" and r["epochs_done"] == 1, r
        assert r["path"] == "ck/unet_rss_resume.pt", r
    assert ranks[1]["files"] == ["unet_checkpoint0.pt", "unet_rss_resume.pt"]


def _data(root):
    img, lbl = _scans()
    for i in range(2):
        nifti.save(str(root / "DATA" / "images" / f"scan{i}.nii"), img[i])
        nifti.save(str(root / "DATA" / "labels" / f"scan{i}.nii"), lbl[i].astype(np.float32))
    # the CLIs' TensorBoard import pulls in TensorFlow (about 16 s a process
    # here); a package that fails to import keeps the metrics in memory
    shim = root / "shim" / "tensorboard"
    shim.mkdir(parents=True)
    (shim / "__init__.py").write_text('raise ImportError("hidden by the test")\n')


SPAWN = ("import sys; from pmpu_tpu_torch.parallel import spawn_world; "
         "from pmpu_tpu_torch.train.__main__ import main; spawn_world(main, 2, (sys.argv[1:],))")


@pytest.mark.parametrize("launcher", ["torchrun", "spawn_world"])
def test_train_cli_re_executes_every_rank(launcher, tmp_path):
    _data(tmp_path)
    flags = ["-m", "unet", "-d", "DATA", "--num-filters", "4,8", "-e", "2", "-b", "4",
             "--train-views", "0", "--checkpoint-dir", "ck", "--data-parallel", "--device", "cpu",
             "--rss-limit-mb", "1"]
    if launcher == "torchrun":
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", "2", "-m", "pmpu_tpu_torch.train", *flags]
    else:
        cmd = [sys.executable, "-c", SPAWN, *flags]
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=f"{ROOT}{os.pathsep}{tmp_path / 'shim'}")
    proc = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True, text=True,
                          timeout=240)
    log = proc.stdout + proc.stderr
    assert proc.returncode == 0, log[-6000:]
    for rank in range(2):
        assert log.count(f"(rank {rank}) against --rss-limit-mb 1 after epoch 1") == 1, log[-6000:]
    assert log.count("re-exec for bounded RSS") == 2
    epochs = {}
    for m in EPOCH_LINE.finditer(log):
        epochs.setdefault(int(m[1]), {})[int(m[4])] = (m[2], m[3])
    assert sorted(epochs) == [1, 2], log[-6000:]
    for e, by_rank in epochs.items():
        assert sorted(by_rank) == [0, 1] and by_rank[0] == by_rank[1], (e, by_rank)
    assert sorted(os.listdir(tmp_path / "ck")) == [
        "unet_checkpoint0.pt", "unet_checkpoint1.pt", "unet_model.pt", "unet_rss_resume.pt"]


def test_sigterm_before_the_loop_ends_the_cli(tmp_path):
    _data(tmp_path)
    from pmpu_tpu_torch.parallel.mesh import free_port

    env = {k: v for k, v in os.environ.items() if k != "TORCHELASTIC_USE_AGENT_STORE"}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=f"{ROOT}{os.pathsep}{tmp_path / 'shim'}",
               RANK="0", LOCAL_RANK="0", WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(free_port()), PMPU_WORLD_GENERATION="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "pmpu_tpu_torch.train", "-m", "unet", "-d", "DATA",
         "--num-filters", "4,8", "-e", "2", "-b", "4", "--data-parallel", "--device", "cpu"],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        time.sleep(3.0)  # importing, or waiting in the rendezvous for rank 1
        assert proc.poll() is None, proc.communicate()[0][-3000:]
        proc.send_signal(signal.SIGTERM)
        out = proc.communicate(timeout=30)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == -signal.SIGTERM, out[-3000:]
    assert "Starting training" not in out and not (tmp_path / "INTERRUPTED.pth").exists()
