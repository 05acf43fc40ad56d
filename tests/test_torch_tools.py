"""The port's copies of the root tools (``pmpu_tpu_torch/tools/``) on the CPU:

* ``nii`` (.mat → NIfTI tree) byte-equal to root ``tools/nii.py`` on the
  same synthetic MATLAB v7.3 files; ``slicer`` panels and ``nifti_info``
  (header printout and figure) equal to the JAX tools' outputs, run as
  ``tests/test_tools.py`` runs those;
* ``reference_mirror`` equal to ``tests/torch_mirror.py`` on the same weights;
* ``compare_with_reference`` weight parity (unet and probunet 8,16 at
  cube 24: 100 % argmax agreement, max |Δprob| ≤ 1e-5) and ``--train`` at
  ``tests/test_trained_dice.py``'s size printing PASS;
* ``soak_stream_train --cpu --rss-limit-mb 1`` for 30 seconds (a child's
  start-up under the parallel test run's load can outlast 15): a valid
  summary, at least one re-exec, the SIGTERM save, rc 0; the tool sends
  SIGTERM once the child's present process image runs its epoch loop.
"""

import argparse
import contextlib
import importlib.util
import io
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from pmpu_tpu_torch.data import nifti
from pmpu_tpu_torch.tools import compare_with_reference as cwr
from pmpu_tpu_torch.tools import nifti_info, nii, reference_mirror, slicer
from tests import torch_mirror

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _root_tool(name):
    """The JAX package's ``tools/{name}.py`` as a module of its own name."""
    spec = importlib.util.spec_from_file_location(f"root_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _files(d):
    return {str(p.relative_to(d)): p.read_bytes() for p in sorted(pathlib.Path(d).rglob("*"))
            if p.is_file()}


def test_nii_equals_the_root_tool(tmp_path, capsys):
    import h5py

    rng = np.random.default_rng(5)
    src = tmp_path / "mats"
    src.mkdir()
    for i in range(4):
        with h5py.File(src / f"scan{i}.mat", "w") as f:  # v7.3 stores arrays transposed
            f["scan"] = rng.random((6, 7, 5)).T
            f["CartTM"] = (rng.random((6, 7, 5)) > 0.8).astype(np.float64).T
            f["CartFM"] = (rng.random((6, 7, 5)) > 0.8).astype(np.float64).T
            f["Tibia"] = np.zeros((6, 7, 5)).T
            f["isright"] = np.array([[1.0]])
    assert nii.convert(str(src), str(tmp_path / "port"), split=0.75) == 4
    port_out = capsys.readouterr().out
    assert _root_tool("nii").convert(str(src), str(tmp_path / "jax"), split=0.75) == 4
    assert capsys.readouterr().out == port_out
    got, want = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert len(got) == 8 and got == want


def test_slicer_equals_the_root_tool(tmp_path, capsys):
    """The port's CLI as a process; the JAX tool's ``dump_panels`` (what its
    CLI runs) in this one, which has jax imported already."""
    pred = np.zeros((8, 8, 8), np.float32)
    pred[4] = 1
    truth = np.zeros((8, 8, 8), np.float32)
    truth[3:6, 2:7] = 2
    nifti.save(str(tmp_path / "pred.nii"), pred)
    nifti.save(str(tmp_path / "truth.nii"), truth)
    for d in ("port", "jax"):
        (tmp_path / d).mkdir()
    res = subprocess.run([sys.executable, "-m", "pmpu_tpu_torch.tools.slicer",
                          str(tmp_path / "pred.nii"), str(tmp_path / "truth.nii"),
                          "--out", str(tmp_path / "port")],
                         capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    root = _root_tool("slicer")
    root.dump_panels(root.nifti.load(str(tmp_path / "pred.nii")),
                     root.nifti.load(str(tmp_path / "truth.nii")), None, str(tmp_path / "jax"))
    assert res.stdout.replace("port", "jax") == capsys.readouterr().out
    got, want = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert sorted(got) == ["axial.png", "coronal.png", "sagittal.png"] and got == want
    assert slicer.center_slice(pred, 0).shape == (8, 8)


def test_nifti_info_equals_the_root_tool(tmp_path):
    vol = np.random.default_rng(0).random((6, 5, 4)).astype(np.float32)
    vol[0, 0, 0] = np.nan
    path = str(tmp_path / "v.nii")
    nifti.save(path, vol, affine=np.diag([-1.5, 2.0, 3.0, 1.0]))
    root = _root_tool("nifti_info")
    outs = {}
    for name, mod in (("port", nifti_info), ("jax", root)):
        buf = io.StringIO()
        argv = sys.argv
        sys.argv = ["nifti_info", path, "--fig", str(tmp_path / f"{name}.png")]
        try:
            with contextlib.redirect_stdout(buf):
                mod.main()
        finally:
            sys.argv = argv
        outs[name] = buf.getvalue().replace(f"{name}.png", "FIG")
    assert outs["port"] == outs["jax"]
    assert "image-left=R image-right=L" in outs["port"]
    assert (tmp_path / "port.png").read_bytes() == (tmp_path / "jax.png").read_bytes()


@pytest.mark.parametrize("name", ["TUNet", "TProbUNet"])
def test_mirror_copy_equals_the_test_mirror(name):
    torch.manual_seed(2)
    a = getattr(reference_mirror, name)(1, 3, (4, 8))
    b = getattr(torch_mirror, name)(1, 3, (4, 8))
    assert list(a.state_dict()) == list(b.state_dict())
    b.load_state_dict(a.state_dict(), strict=True)
    x = torch.from_numpy(np.random.default_rng(1).random((2, 1, 16, 16)).astype(np.float32))
    a.eval(), b.eval()
    with torch.no_grad():
        if name == "TUNet":
            torch.testing.assert_close(a(x), b(x), rtol=0, atol=0)
        else:
            seg = torch.ones_like(x)
            fa, pa, qa = a(x, seg)
            fb, pb, qb = b(x, seg)
            torch.testing.assert_close((fa, pa, qa), (fb, pb, qb), rtol=0, atol=0)
            z = torch.randn(2, 6)
            torch.testing.assert_close(a.fcomb(fa, z), b.fcomb(fb, z), rtol=0, atol=0)


@pytest.mark.parametrize("model", ["unet", "probunet"])
def test_compare_weight_parity(model, capsys):
    args = cwr.parser().parse_args(["--model", model, "--filters", "8,16", "--cube", "24",
                                    "--device", "cpu"])
    (row,) = cwr.weight_parity(args)
    assert row["argmax_agreement"] == 1.0 and row["max_abs_prob_diff"] <= 1e-5, row
    assert row["dice_ref"] == row["dice_ours"]
    assert "argmax agreement=100.000%" in capsys.readouterr().out


def test_compare_trained_dice_head_to_head(capsys):
    """``--train`` at ``tests/test_trained_dice.py``'s size: the mirror and
    the port, each trained on the same data and split, within 0.5 Dice
    points on held-out volumes. One intra-op thread: thousands of tiny steps
    on a pool of threads that spin while another test's pool runs beside
    them took 14 minutes instead of seconds."""
    args = argparse.Namespace(
        dir=None, filters="4,8", cube=16, model="unet", seed=0, sampled=False, samples=3,
        train=True, epochs=10, batch=4, lr=0.02, patience=10, val=10.0, n_train=6, n_test=2,
        assert_pts=0.5, task="landmark", seeds=1, device="cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert cwr.run_trained_head_to_head(args) == 0
    finally:
        torch.set_num_threads(threads)
    assert "PASS - trained val Dice within 0.5 pts" in capsys.readouterr().out


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_head_to_head_is_deterministic_on_the_card_only(device):
    """``--train`` turns on cuDNN's deterministic algorithms (and its
    algorithm search off) on the card, so a seed repeats there, and restores
    both flags after; on the CPU it touches neither."""
    cudnn = torch.backends.cudnn
    before = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = False, True
    try:
        with cwr._deterministic(torch.device(device)):
            inside = (cudnn.deterministic, cudnn.benchmark)
        assert inside == ((True, False) if device == "cuda" else (False, True))
        assert (cudnn.deterministic, cudnn.benchmark) == (False, True)
    finally:
        cudnn.deterministic, cudnn.benchmark = before


def test_soak_stream_train_reexecs(tmp_path):
    # the child's TensorBoard import pulls in TensorFlow (about 16 s a process
    # here); a package that fails to import keeps the metrics in memory
    shim = tmp_path / "shim" / "tensorboard"
    shim.mkdir(parents=True)
    (shim / "__init__.py").write_text('raise ImportError("hidden by the test")\n')
    env = {**os.environ, "PYTHONPATH": f"{ROOT}{os.pathsep}{tmp_path / 'shim'}",
           "OMP_NUM_THREADS": "1"}
    res = subprocess.run(
        [sys.executable, "-m", "pmpu_tpu_torch.tools.soak_stream_train", "--cpu",
         "--minutes", "0.5", "--cube", "16", "--volumes", "2", "--filters", "4,8",
         "--batch", "4", "--rss-limit-mb", "1", "--sample-every", "0.5",
         "--data", str(tmp_path / "data"), "--out", str(tmp_path / "soak.csv")],
        capture_output=True, text=True, timeout=180, cwd=tmp_path, env=env)
    assert res.returncode == 0, res.stderr[-4000:]
    line = [x for x in res.stdout.splitlines() if x.startswith("SOAK ")][-1]
    summary = json.loads(line[len("SOAK "):])
    assert summary["exit_code"] == 0 and summary["sigterm_interrupted_save"], summary
    assert summary["reexecs"] >= 1 and summary["epochs_done"] >= summary["reexecs"], summary
    assert summary["samples"] > 10 and summary["creep_mb_per_min_tail"] is not None, summary
    # a sample taken as the child re-executes can read a near-empty image
    assert 0 <= summary["rss_min_mb"] <= summary["rss_max_mb"] and summary["rss_max_mb"] > 0, \
        summary
    assert (tmp_path / "soak.csv").read_text().startswith("t_s,rss_mb\n")


@pytest.mark.parametrize("log, running", [
    ("", False),
    ("INFO: Starting training: epochs=5\n", True),
    ("INFO: Starting training: epochs=5\nWARNING: rss 90 MB (rank 0) against --rss-limit-mb 1 "
     "after epoch 1\nWARNING: re-exec for bounded RSS: ...\n", False),
    ("INFO: Starting training: epochs=5\nWARNING: rss 90 MB (rank 0) against --rss-limit-mb 1 "
     "after epoch 1\nINFO: Starting training: epochs=4\n", True),
])
def test_soak_waits_for_the_epoch_loop(log, running):
    from pmpu_tpu_torch.tools import soak_stream_train

    assert soak_stream_train.in_loop(log) is running
