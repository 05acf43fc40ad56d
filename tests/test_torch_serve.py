"""The port's serving daemon (``python -m pmpu_tpu_torch.serve``), its soak
harness and its A/B tool on the CPU, against the JAX package's root
``serve.py`` where both can run: the upload gate and the restart gate
over the same directory states; ``--once`` on a U-Net checkpoint that both
packages read (segmentations equal, entropy within 1 LSB of the uint16
step, source shapes and affines kept); corrupt, oversize and torn first
files; the idempotent re-run; in subprocesses, the watch loop (a stalled
upload quarantined and healed, SIGINT exits 0) and the ``--rss-limit-mb``
re-exec as ``-m pmpu_tpu_torch.serve``; the soak harness at its CI size;
``ab_device_compute`` at cube 16."""

import argparse
import json
import logging
import os
import signal
import struct
import subprocess
import sys
import threading
import time

import numpy as np

import serve as jax_serve
from pmpu_tpu_torch import serve
from pmpu_tpu_torch.data import nifti
from pmpu_tpu_torch.train import checkpoint as ckpt
from pmpu_tpu_torch.train import steps
from pmpu_tpu_torch.train.tasks import make_task
from tests.test_torch_weights import _randomize_bn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NF = (4, 8)
DAEMON = ["-m", "unet", "--num-filters", "4,8", "--device", "cpu"]


def _touch(path, size, mtime=None):
    with open(path, "wb") as f:
        f.write(b"\0" * size)
    if mtime is not None:
        os.utime(path, (mtime, mtime))


def test_stable_new_files_matches_jax(tmp_path):
    """Both gates over one sequence of directory states: growth, a stable
    file, a non-NIfTI name, a vanished name and its re-upload."""
    w = str(tmp_path)
    states = [
        {"a.nii": 10, "b.nii.gz": 5, "notes.txt": 3},
        {"a.nii": 20, "b.nii.gz": 5, "notes.txt": 3},
        {"a.nii": 20, "b.nii.gz": 5, "c.nii": 7},
        {"a.nii": 20, "c.nii": 7},
        {"a.nii": 20, "c.nii": 7, "b.nii.gz": 9},
        {"a.nii": 20, "c.nii": 7, "b.nii.gz": 9},
        {"c.nii": 8, "b.nii.gz": 9},
        {"c.nii": 8, "b.nii.gz": 9, "a.nii": 20},
        {"c.nii": 8, "b.nii.gz": 9, "a.nii": 20},
    ]
    port, ref = (set(), {}), (set(), {})
    for i, state in enumerate(states):
        for n in set(os.listdir(w)) - set(state):
            os.remove(os.path.join(w, n))
        for n, size in state.items():
            path = os.path.join(w, n)
            if not os.path.exists(path) or os.path.getsize(path) != size:
                _touch(path, size)
        got = serve._stable_new_files(w, *port)
        want = jax_serve._stable_new_files(w, *ref)
        assert got == want and port == ref, i
        for seen, _ in (port, ref):  # what the daemon does with a served name
            seen.update(got)
    assert port[0] == {"a.nii", "b.nii.gz", "c.nii"}


def test_served_and_current_matches_jax(tmp_path):
    for d in ("in", "out", "unc"):
        os.makedirs(tmp_path / d)
    t = time.time() - 100
    cases = {  # name: (input mtime, output mtime or None, entropy mtime or None)
        "new.nii": (t, None, None), "older_out.nii": (t, t - 5, t), "current.nii": (t, t, t + 1),
        "older_unc.nii": (t, t + 1, t - 1), "no_unc.nii": (t, t + 1, None),
    }
    for n, (ti, to, tu) in cases.items():
        _touch(tmp_path / "in" / n, 4, ti)
        if to is not None:
            _touch(tmp_path / "out" / n, 4, to)
        if tu is not None:
            _touch(tmp_path / "unc" / n, 4, tu)
    for unc in (None, str(tmp_path / "unc")):
        args = argparse.Namespace(watch=str(tmp_path / "in"), out=str(tmp_path / "out"),
                                  uncertainty=unc)
        got = {n: serve._served_and_current(args, n) for n in cases}
        assert got == {n: jax_serve._served_and_current(args, n) for n in cases}
        assert got["current.nii"] and not got["new.nii"] and not got["older_out.nii"]
        assert got["no_unc.nii"] is (unc is None)


def _unet_checkpoint(path):
    """A U-Net (3 classes) train-state pickle with BatchNorm randomized, which
    both packages' ``load_for_inference`` read."""
    task = make_task("unet", n_classes=3, num_filters=NF, device="cpu", train=True, seed=5)
    ckpt.load_flax_variables(task.net, _randomize_bn(ckpt.flax_variables(task.net),
                                                     np.random.default_rng(5)))
    ckpt.save_checkpoint(path, steps.create_train_state(task), extra={"model_config": {
        "net": "unet", "n_channels": 1, "n_classes": 3, "num_filters": list(NF)}})


def _scans(directory, shapes=((16, 12, 14), (13, 16, 15)), seed=1):
    rng = np.random.default_rng(seed)
    os.makedirs(directory, exist_ok=True)
    names = []
    for i, shape in enumerate(shapes):
        affine = np.diag([1.0 + 0.25 * i, 0.9, 1.2, 1.0])
        affine[:3, 3] = (3.0 * i, -2.0, 5.0)
        img = rng.random(shape).astype(np.float32)
        img[3:9, 2:10, 4:11] += 0.6
        names.append(f"v{i}.nii")
        nifti.save(os.path.join(directory, names[-1]), img, affine)
    return names


def test_once_matches_the_jax_daemon(tmp_path, monkeypatch):
    ck = str(tmp_path / "unet.pt")
    _unet_checkpoint(ck)
    names = _scans(str(tmp_path / "in"))
    common = ["-f", ck, "--watch", str(tmp_path / "in"), "--cube", "16", "--once"]
    monkeypatch.setattr(sys, "argv", ["serve.py", *common, "--out", str(tmp_path / "jax"),
                                      "--uncertainty", str(tmp_path / "jax_unc")])
    assert jax_serve.main() == 0
    assert serve.main([*common, "--out", str(tmp_path / "port"), "--uncertainty",
                       str(tmp_path / "port_unc"), "--device", "cpu"]) == 0
    step = np.log(3) / 65535.0
    for n in names:
        src = nifti.read_header(tmp_path / "in" / n)
        for d in ("port", "port_unc"):
            hdr = nifti.read_header(tmp_path / d / n)
            assert hdr.shape == src.shape and np.array_equal(hdr.affine, src.affine)
        got, want = (nifti.load(tmp_path / d / n) for d in ("port", "jax"))
        assert np.array_equal(got, want) and set(np.unique(got)) <= {0.0, 1.0, 2.0}
        ent = [np.rint(nifti.load(tmp_path / d / n) / step) for d in ("port_unc", "jax_unc")]
        assert np.abs(ent[0] - ent[1]).max() <= 1


def _run_once(watch, out, caplog, *extra):
    caplog.clear()
    with caplog.at_level(logging.INFO):
        rc = serve.main([*DAEMON, "--watch", str(watch), "--out", str(out), "--once", *extra])
    return rc, caplog.text


def test_once_rejects_corrupt_and_oversize(tmp_path, caplog):
    watch = tmp_path / "watch"
    watch.mkdir()
    rng = np.random.default_rng(7)
    nifti.save(watch / "good.nii", rng.random((16, 16, 16)).astype(np.float32))
    nifti.save(watch / "big.nii", rng.random((24, 24, 24)).astype(np.float32))
    corrupt = watch / "corrupt.nii"
    nifti.save(corrupt, rng.random((16, 16, 16)).astype(np.float32))
    raw = bytearray(corrupt.read_bytes())
    struct.pack_into("<8h", raw, 40, 3, -16, -16, 16, 1, 1, 1, 1)  # negative dims
    corrupt.write_bytes(bytes(raw))
    rc, log = _run_once(watch, tmp_path / "out", caplog, "--cube", "16")
    assert rc == 1
    assert "big.nii shape (24, 24, 24) exceeds cube 16; rejected" in log
    assert "skipping corrupt.nii (attempt 1)" in log
    assert "served 1 volumes" in log
    assert sorted(os.listdir(tmp_path / "out")) == ["good.nii"]


def test_corrupt_first_file_does_not_fix_the_cube(tmp_path, caplog):
    watch = tmp_path / "watch"
    watch.mkdir()
    rng = np.random.default_rng(11)
    bad = watch / "a_corrupt.nii"  # sorts first: inspected first
    nifti.save(bad, rng.random((8, 8, 8)).astype(np.float32))
    bad.write_bytes(bad.read_bytes()[:400])  # the header (8³) intact, the payload torn
    nifti.save(watch / "good.nii", rng.random((16, 16, 16)).astype(np.float32))
    rc, log = _run_once(watch, tmp_path / "out", caplog, "--cube", "0")
    assert rc == 1
    assert "program cube fixed at 16 from good.nii" in log
    assert os.listdir(tmp_path / "out") == ["good.nii"]
    assert nifti.load(tmp_path / "out" / "good.nii").shape == (16, 16, 16)


def test_once_rerun_skips_current_outputs(tmp_path, caplog):
    watch, out = tmp_path / "watch", tmp_path / "out"
    _scans(str(watch), shapes=((12, 12, 12), (12, 12, 12)), seed=9)
    assert _run_once(watch, out, caplog, "--cube", "12")[0] == 0
    mt = {p.name: p.stat().st_mtime_ns for p in out.iterdir()}
    assert len(mt) == 2
    rc, log = _run_once(watch, out, caplog, "--cube", "12")
    assert rc == 0 and "skipping 2 already-served" in log and "volumes in" not in log
    assert {p.name: p.stat().st_mtime_ns for p in out.iterdir()} == mt
    time.sleep(0.05)
    nifti.save(watch / "v0.nii", np.random.default_rng(3).random((12, 12, 12)).astype(np.float32))
    rc, log = _run_once(watch, out, caplog, "--cube", "12")
    assert rc == 0 and "skipping 1 already-served" in log and "served 1 volumes" in log
    assert (out / "v0.nii").stat().st_mtime_ns > mt["v0.nii"]
    assert (out / "v1.nii").stat().st_mtime_ns == mt["v1.nii"]


class _Daemon:
    """``python -m pmpu_tpu_torch.serve`` in watch mode, its output read by
    a thread."""

    def __init__(self, *args):
        self.proc = subprocess.Popen([sys.executable, "-m", "pmpu_tpu_torch.serve", *args],
                                     cwd=ROOT, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)
        self.lines = []
        self.reader = threading.Thread(
            target=lambda: self.lines.extend(iter(self.proc.stdout.readline, "")), daemon=True)
        self.reader.start()

    def log(self):
        return "".join(self.lines)

    def wait_for(self, needle, timeout=120):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if needle in self.log():
                return
            assert self.proc.poll() is None, self.log()
            time.sleep(0.1)
        raise AssertionError(f"no {needle!r} in the log:\n{self.log()}")

    def interrupt(self):
        self.proc.send_signal(signal.SIGINT)
        rc = self.proc.wait(timeout=60)
        self.reader.join(timeout=10)
        return rc

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def test_watch_mode_heals_a_stalled_upload_and_exits_on_sigint(tmp_path):
    watch, out = tmp_path / "watch", tmp_path / "out"
    watch.mkdir()
    rng = np.random.default_rng(3)
    d = _Daemon(*DAEMON, "--watch", str(watch), "--out", str(out), "--cube", "16",
                "--poll", "0.2")
    try:
        nifti.save(watch / "v0.nii", rng.random((16, 16, 16)).astype(np.float32))
        d.wait_for("served 1 volumes")
        nifti.save(tmp_path / "_v1.nii", rng.random((16, 16, 16)).astype(np.float32))
        blob = (tmp_path / "_v1.nii").read_bytes()
        with open(watch / "v1.nii", "wb") as f:  # an upload that stalls half-way
            f.write(blob[:400])
            f.flush()
            d.wait_for("quarantining v1.nii after 3 failed loads")
            f.write(blob[400:])
        d.wait_for("v1.nii grew after quarantine; re-inspecting")
        d.wait_for("2 total")
        rc = d.interrupt()
    finally:
        d.kill()
    assert rc == 0, d.log()
    assert "interrupted" in d.log()
    assert nifti.load(out / "v1.nii").shape == (16, 16, 16)


def test_rss_limit_reexecs_as_a_module(tmp_path):
    watch, out = tmp_path / "watch", tmp_path / "out"
    watch.mkdir()
    rng = np.random.default_rng(7)
    nifti.save(watch / "v0.nii", rng.random((12, 12, 12)).astype(np.float32))
    d = _Daemon(*DAEMON, "--watch", str(watch), "--out", str(out), "--cube", "12",
                "--poll", "0.2", "--rss-limit-mb", "1")
    try:
        d.wait_for("skipping 1 already-served")  # the re-executed daemon's startup
        nifti.save(watch / "v1.nii", rng.random((12, 12, 12)).astype(np.float32))
        d.wait_for("served 1 volumes in", timeout=120)
        d.wait_for("skipping 2 already-served")
        rc = d.interrupt()
    finally:
        d.kill()
    log = d.log()
    assert rc == 0, log
    assert f"re-exec: {sys.executable} -m pmpu_tpu_torch.serve -m unet" in log
    assert log.count("re-exec:") >= 2 and sorted(os.listdir(out)) == ["v0.nii", "v1.nii"]


def test_soak_harness_ci_size(tmp_path, capsys):
    """The port's soak harness at the JAX harness's CI size: corrupt,
    truncated-gzip and stalled-upload faults; every good volume served, the
    stall healed, RSS bounded, the daemon's SIGINT exit 0."""
    from pmpu_tpu_torch.tools import soak_serve

    rc = soak_serve.main(["--volumes", "8", "--cube", "12", "--poll", "0.2",
                          "--fault-every", "3", "--timeout", "240",
                          "--workdir", str(tmp_path / "soak"), "--device", "cpu"])
    verdict = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and verdict["ok"], verdict
    assert verdict["served"] == 8 and not verdict["wedges"] and verdict["daemon_exit"] == 0
    assert verdict["quarantines_logged"] >= 2 and verdict["self_heals_logged"] >= 1
    assert verdict["stalls_quarantined"] == 1 and verdict["faults_injected"] == 3
    assert isinstance(verdict["rss_slope_mb_per_volume"], float)


def test_ab_device_compute_on_the_cpu(capsys):
    from pmpu_tpu_torch.tools import ab_device_compute

    assert ab_device_compute.main(["--device", "cpu", "--cube", "16", "--filters", "4,8",
                                   "--configs", "fused,split", "--rounds", "2",
                                   "--chain", "1"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("RESULT ")]
    results = [json.loads(ln[len("RESULT "):]) for ln in lines]
    assert [r["config"] for r in results] == ["fused", "split"]
    assert results[0]["argmax_agreement_vs_first"] == 1.0
    for r in results:
        assert r["device"] == "cpu" and r["clock"] == "host" and len(r["times"]) == 2
        assert 0 < r["min_s"] <= r["median_s"]
