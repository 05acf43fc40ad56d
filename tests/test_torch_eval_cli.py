"""The port's eval CLI (``python -m pmpu_tpu_torch.eval --device cpu``)
against the JAX package's root ``eval.py`` on one synthetic NIfTI tree and
one JAX-written pickle checkpoint of a U-Net (which draws no randomness):
the same report lines within 1e-4 and byte-equal ``predictions/``. Then
``--mmap-store``, ``--eval-mode batched`` and ``--split-decoder`` each give
the sequential report, and a probabilistic U-Net with ``--ged`` and
``--save-uncertainty`` writes its maps and its GED line."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

from pmpu_tpu.data import nifti as jax_nifti
from pmpu_tpu_torch.eval import main as eval_main
from tests.test_torch_predict import _jax_checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ((16, 14, 12), (13, 16, 15), (16, 16, 11))
REPORT = re.compile(r"^(view \d+ dice|avg volume): mean=\[(.*)\], std=\[(.*)\]$")


def _data(root):
    rng = np.random.default_rng(31)
    for sub in ("images", "labels"):
        (root / sub).mkdir(parents=True)
    for i, shape in enumerate(SHAPES):
        affine = np.diag([1.0, 1.0 + 0.5 * i, 0.9, 1.0])
        affine[:3, 3] = (-4.0, 2.0 * i, 0.5)
        lbl = np.zeros(shape, np.float32)
        lbl[3:11, 4:12, 2:10] = 1
        lbl[5:8, 6:9, 4:7] = 2
        img = (rng.random(shape) * 0.2 + 0.6 * (lbl > 0) + 0.2 * (lbl == 2)).astype(np.float32)
        jax_nifti.save(root / "images" / f"image{i}.nii", img, affine)
        jax_nifti.save(root / "labels" / f"image{i}.nii", lbl)
    return str(root)


def _report(stdout):
    """{label: (mean, std)} of the report lines."""
    out = {}
    for line in stdout.splitlines():
        m = REPORT.match(line.strip())
        if m:
            out[m.group(1)] = tuple(np.array(g.split(), np.float64) for g in m.group(2, 3))
    return out


def _assert_reports_close(got, want, tol=1e-4):
    assert sorted(got) == sorted(want) and len(want) == 4
    for k in want:
        for g, w in zip(got[k], want[k]):
            np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=k)


def _predictions(cwd):
    d = cwd / "predictions"
    return {n: (d / n).read_bytes() for n in sorted(os.listdir(d))}


def _port(cwd, monkeypatch, capsys, *args):
    cwd.mkdir(exist_ok=True)
    monkeypatch.chdir(cwd)
    capsys.readouterr()
    assert eval_main([*args, "--device", "cpu"]) == 0
    return capsys.readouterr().out


@pytest.fixture(scope="module")
def unet_case(tmp_path_factory):
    """The data tree, a JAX pickle checkpoint of a 3-class U-Net (4,8), and
    the root eval.py's stdout and predictions, run in its own cwd."""
    tmp = tmp_path_factory.mktemp("eval_cli")
    data = _data(tmp / "data")
    ck = str(tmp / "unet.pt")
    _jax_checkpoint(ck, "unet", seed=1)  # a seed whose argmax is not constant
    cwd = tmp / "jax"
    cwd.mkdir()
    out = subprocess.run([sys.executable, os.path.join(ROOT, "eval.py"), "-m", "unet", "-f", ck,
                          "-d", data], cwd=cwd, capture_output=True, text=True, timeout=600,
                         env={**os.environ, "PMPU_FORCE_CPU": "1"})
    assert out.returncode == 0, out.stderr
    return data, ck, out.stdout, _predictions(cwd)


def test_eval_cli_matches_jax_eval(unet_case, tmp_path, monkeypatch, capsys):
    data, ck, jax_out, jax_preds = unet_case
    out = _port(tmp_path, monkeypatch, capsys, "-m", "unet", "-f", ck, "-d", data)
    assert out.splitlines()[0] == jax_out.splitlines()[0] == "UNET EVALUATION (pmpu_tpu)"
    _assert_reports_close(_report(out), _report(jax_out))
    preds = _predictions(tmp_path)
    assert sorted(preds) == ["image0.nii", "image1.nii", "image2.nii"]
    assert preds == jax_preds
    for i, shape in enumerate(SHAPES):  # the source geometry is carried
        hdr = jax_nifti.read_header(tmp_path / "predictions" / f"image{i}.nii")
        assert hdr.shape == shape


@pytest.mark.parametrize("flags", [
    ("--mmap-store", "POOL"),
    ("--eval-mode", "batched", "--eval-volumes-batch", "2"),
    ("--split-decoder",),
])
def test_eval_cli_modes_give_the_sequential_report(unet_case, tmp_path, monkeypatch, capsys,
                                                   flags):
    data, ck, jax_out, jax_preds = unet_case
    flags = tuple(str(tmp_path / "pool") if f == "POOL" else f for f in flags)
    out = _port(tmp_path, monkeypatch, capsys, "-m", "unet", "-f", ck, "-d", data, *flags)
    _assert_reports_close(_report(out), _report(jax_out))
    if "--split-decoder" not in flags:  # the same arithmetic: the same bits
        assert _predictions(tmp_path) == jax_preds
    if "--mmap-store" in flags:
        assert os.path.exists(tmp_path / "pool" / "manifest.json")
        again = _port(tmp_path / "again", monkeypatch, capsys, "-m", "unet", "-f", ck,
                      "-d", data, *flags)
        _assert_reports_close(_report(again), _report(out), tol=0)


def test_eval_cli_probunet_ged_and_uncertainty(unet_case, tmp_path, monkeypatch, capsys, caplog):
    """Untrained weights from ``--seed``; ``--compile-cache`` is accepted
    and ignored; ``--data-parallel`` on one device changes nothing."""
    data = unet_case[0]
    args = ("-m", "probunet", "-d", data, "--num-filters", "4,8", "--latent-dim", "3",
            "--eval-samples", "2", "--seed", "3", "--ged", "2", "--save-uncertainty", "unc",
            "--compile-cache", "cache", "--data-parallel")
    with caplog.at_level("INFO"):
        out = _port(tmp_path, monkeypatch, capsys, *args)
    assert "--compile-cache cache ignored" in caplog.text
    assert not os.path.exists(tmp_path / "cache")
    assert re.search(r"^GED\^2 \(2 samples\): mean=\d+\.\d{4}, std=\d+\.\d{4}$", out, re.M)
    assert len(_report(out)) == 4
    for i, shape in enumerate(SHAPES):
        ent = jax_nifti.load(tmp_path / "unc" / f"image{i}.nii")
        assert ent.shape == shape and 0.0 <= ent.min() and ent.max() <= np.log(3) + 1e-6
        assert (tmp_path / "predictions" / f"image{i}.nii").exists()
    same_seed = _port(tmp_path / "again", monkeypatch, capsys, *args)
    _assert_reports_close(_report(same_seed), _report(out), tol=0)
