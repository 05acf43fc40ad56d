"""The port's slice-parallel evaluation on the CPU (gloo worlds of 2 and 3,
``tests/torch_dist_worker.py``):

* ``VolumeEvaluator(mesh=make_mesh())`` bit-equal to the one-process
  evaluator with the same weights and seeds: ``evaluate_volume`` (sampled
  probunet over 3 chunks split 2/1; int8 with its scale file; 6 oblique
  views), ``evaluate_store`` at depth 2 with its exports and entropy maps
  (written once, by rank 0, byte-equal), ``evaluate_store_batched`` at
  V = 2, ``ged_volume`` and ``predict_volumes_pipelined``; in a world of 3
  over 2 chunks, so that rank 2 runs none;
* the port in a world of 2 against the JAX package's
  ``VolumeEvaluator(mesh=make_mesh(data=2))`` on its CPU devices in mean_z
  mode, at ``tests/test_torch_engine.py``'s tolerance;
* ``python -m pmpu_tpu_torch.eval --data-parallel`` as 2 processes given
  torchrun's environment: one ``predictions/``, byte-equal to one
  process's, and rank 0's report equal to one process's.
"""

import os
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmpu_tpu.inference import engine as jax_engine
from pmpu_tpu.parallel import make_mesh as jax_mesh
from pmpu_tpu.train import checkpoint as jax_ckpt
from pmpu_tpu.train.tasks import make_task as jax_make_task
from pmpu_tpu_torch.data import nifti
from pmpu_tpu_torch.data.volumes import VolumeStore
from pmpu_tpu_torch.eval import main as eval_main
from pmpu_tpu_torch.inference.engine import VolumeEvaluator
from pmpu_tpu_torch.parallel.mesh import free_port
from pmpu_tpu_torch.train.tasks import make_task
from tests.torch_dist_worker import run_world

ROOT = pathlib.Path(__file__).resolve().parent.parent
CUBE = 16
KW = {"probunet": dict(n_classes=3, num_filters=(4, 8), latent_dim=3),
      "unet": dict(n_classes=3, num_filters=(4, 8))}


def _scans(n, seed=3):
    rng = np.random.default_rng(seed)
    img = rng.random((n, CUBE, CUBE, CUBE)).astype(np.float32)
    lbl = np.zeros((n, CUBE, CUBE, CUBE), np.int32)
    for i in range(n):
        c = rng.integers(5, 11, 3)
        lbl[i, c[0] - 4:c[0] + 4, c[1] - 3:c[1] + 4, c[2] - 4:c[2] + 3] = 1
        lbl[i, c[0] - 1:c[0] + 2, c[1] - 1:c[1] + 2, c[2] - 1:c[2] + 2] = 2
    img[lbl > 0] += 0.6
    return img, lbl


def _state_dict(name, seed=0):
    task = make_task(name, **KW[name], device="cpu", seed=seed)
    return {k: v.numpy().copy() for k, v in task.net.state_dict().items()}


def _one_process(case):
    """The case's ops run by the one-process evaluator (no mesh); exports
    and the scale file under ``case["cwd"]/one``."""
    task = make_task(case["name"], **KW[case["name"]], device="cpu")
    task.net.load_state_dict({k: torch.from_numpy(v) for k, v in case["state_dict"].items()})
    one = os.path.join(case["cwd"], "one")
    os.makedirs(one, exist_ok=True)
    kw = dict(case.get("ev", {}))
    if "calibration" in kw:
        kw["calibration"] = os.path.join(one, kw["calibration"])
    ev = VolumeEvaluator(task, device="cpu", **kw)
    out = []
    for op, args in case["ops"]:
        if op == "volume":
            r = ev.evaluate_volume(*args)
            out.append({"fused": r["fused"].numpy(), "argmax": r["argmax"],
                        "dice": r.get("dice"), "views": [v.numpy() for v in r["views"]]})
        elif op in ("store", "batched"):
            imgs, lbls, seed, save, unc = args
            dirs = [None if d is None else os.path.join(one, d) for d in (save, unc)]
            store = VolumeStore.from_arrays(imgs, lbls)
            if op == "store":
                out.append(ev.evaluate_store(store, seed, *dirs))
            else:
                out.append(ev.evaluate_store_batched(store, seed, *dirs, volumes_per_batch=2))
        elif op == "ged":
            out.append(ev.ged_volume(*args))
        else:
            vols, seed = args
            out.append(ev.predict_volumes_pipelined(list(vols), seed, 2, want_entropy=True))
    return out


def _case(name, cwd, ops, **ev):
    return {"kind": "evaluator", "name": name, "kw": KW[name], "state_dict": _state_dict(name),
            "ev": ev, "ops": ops, "cwd": str(cwd)}


IMG, LBL = _scans(3)
# 48 slices in chunks of 16: 3 chunks, split 2/1 over 2 ranks
SAMPLED = dict(n_samples=3, eval_batch=16)
CASES2 = {
    "sampled": ("probunet", lambda: [
        ("volume", (IMG[0], LBL[0], 5)),
        ("store", (IMG, LBL, 7, "pred", "unc")),
        ("batched", (IMG, LBL, 7, "pred_b", None)),
        ("ged", (IMG[1], LBL[1], 4, 11)),
        ("stream", (IMG[:2], 13)),
    ], SAMPLED),
    "int8": ("unet", lambda: [("volume", (IMG[0], LBL[0], 0)), ("volume", (IMG[2], LBL[2], 0))],
             dict(quantize="int8", calibration="scales.json", eval_batch=16)),
    "int8_probunet": ("probunet", lambda: [("volume", (IMG[1], LBL[1], 2)),
                                           ("ged", (IMG[1], LBL[1], 2, 3))],
                      dict(quantize="int8", calibration="scales.json", **SAMPLED)),
    # 6 views of 16 planes: 96 planes in chunks of 40 (the last padded)
    "views6": ("probunet", lambda: [("volume", (IMG[2], LBL[2], 1)), ("ged", (IMG[2], LBL[2], 3, 4))],
               dict(num_views=6, n_samples=2, eval_batch=40)),
}
# 48 slices in chunks of 24: 2 chunks over 3 ranks, rank 2 runs none
CASES3 = {
    "sampled": ("probunet", lambda: [
        ("volume", (IMG[0], LBL[0], 5)),
        ("store", (IMG, LBL, 7, "pred", None)),
        ("batched", (IMG, LBL, 7, None, None)),
        ("ged", (IMG[1], LBL[1], 3, 11)),
    ], dict(n_samples=3, eval_batch=24)),
}


def _worlds(world, cases, tmp):
    built = {k: _case(name, tmp / k, ops(), **ev) for k, (name, ops, ev) in cases.items()}
    ranks = run_world(world, list(built.values()), tmp / "io", timeout=300)
    return {k: ([r[i] for r in ranks], built[k]) for i, k in enumerate(built)}


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return _worlds(2, CASES2, tmp_path_factory.mktemp("eval2"))


@pytest.fixture(scope="module")
def world3(tmp_path_factory):
    return _worlds(3, CASES3, tmp_path_factory.mktemp("eval3"))


def _assert_equal(got, want, where):
    if isinstance(want, dict):
        assert got.keys() == want.keys(), where
        for k in want:
            _assert_equal(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_equal(g, w, f"{where}[{i}]")
    elif want is None or isinstance(want, float):
        assert got == want, (where, got, want)
    else:
        np.testing.assert_array_equal(got, want, err_msg=where)


def _files(d):
    return {p.name: p.read_bytes() for p in sorted(pathlib.Path(d).iterdir())}


def _check_world(results, name):
    ranks, case = results[name]
    want = _one_process(case)
    for r, got in enumerate(ranks):
        _assert_equal(got, want, f"{name} rank {r}")
    cwd = pathlib.Path(case["cwd"])
    for d in ("pred", "unc", "pred_b", "scales.json"):
        if (cwd / "one" / d).exists():
            if d.endswith(".json"):
                assert (cwd / d).read_bytes() == (cwd / "one" / d).read_bytes(), d
            else:
                assert _files(cwd / d) == _files(cwd / "one" / d), d
    return ranks


@pytest.mark.parametrize("name", sorted(CASES2))
def test_world_of_2_is_one_process_bit_for_bit(name, world2):
    """Every entry point of the split evaluator, on both ranks, bit-equal
    to one process; rank 0's exports and scale file byte-equal to one
    process's (``_check_world``)."""
    _check_world(world2, name)
    if name == "sampled":
        assert len(os.listdir(pathlib.Path(world2[name][1]["cwd"]) / "pred")) == 3


def test_world_of_3_over_2_chunks(world3):
    """Rank 2 holds no chunk and still joins every gather; the results are
    one process's on all three ranks."""
    _check_world(world3, "sampled")


def test_world_of_2_matches_jax_mesh_mean_z(tmp_path):
    """The port's split evaluator against JAX's ``VolumeEvaluator`` on a mesh
    of 2 CPU devices with the same weights (the port's, imported by the JAX
    package), mean_z: argmax and Dice equal, fused and per-view
    probabilities within 1e-5."""
    sd = _state_dict("probunet", seed=4)
    variables = jax_ckpt.import_torch_state_dict(
        {k: torch.from_numpy(v) for k, v in sd.items()}, "probunet", num_filters=(4, 8),
        no_convs_fcomb=4)
    jtask = jax_make_task("probunet", **KW["probunet"], no_convs_fcomb=4)
    case = {"kind": "evaluator", "name": "probunet", "cwd": str(tmp_path), "kw": KW["probunet"],
            "state_dict": sd, "ev": dict(eval_batch=20, mean_z=True),
            "ops": [("volume", (IMG[0], LBL[0], 0))]}
    ranks = run_world(2, [case], tmp_path / "io")
    jev = jax_engine.VolumeEvaluator(jtask, eval_batch=20, mean_z=True, mesh=jax_mesh(data=2))
    want = jev.evaluate_volume(jax.tree_util.tree_map(jnp.asarray, variables), IMG[0], LBL[0])
    for r in ranks:
        got = r[0][0]
        np.testing.assert_array_equal(got["argmax"], want["argmax"])
        np.testing.assert_allclose(got["fused"], np.asarray(want["fused"]), rtol=0, atol=1e-5)
        for g, w in zip(got["views"], want["views"]):
            np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-5)
        np.testing.assert_array_equal(got["dice"], want["dice"])


def _data_tree(root):
    for i in range(3):
        nifti.save(str(root / "DATA" / "images" / f"scan{i}.nii"), IMG[i])
        nifti.save(str(root / "DATA" / "labels" / f"scan{i}.nii"), LBL[i].astype(np.float32))


def test_eval_cli_in_a_world_of_2(tmp_path, monkeypatch, capsys):
    """``python -m pmpu_tpu_torch.eval --data-parallel`` as 2 processes given
    torchrun's environment (gloo): rank 0 prints one process's report and
    GED line and writes the only ``predictions/`` and uncertainty maps,
    byte-equal to one process's; rank 1 prints no report; each rank logs
    its block of the chunks."""
    _data_tree(tmp_path)
    flags = ["-m", "probunet", "-d", str(tmp_path / "DATA"), "--num-filters", "4,8",
             "--eval-samples", "3", "--eval-batch", "16", "--ged", "2",
             "--save-uncertainty", "unc", "--device", "cpu"]
    one = tmp_path / "one"
    one.mkdir()
    monkeypatch.chdir(one)
    assert eval_main(flags) == 0
    want = capsys.readouterr().out
    port = str(free_port())
    world = tmp_path / "world"
    world.mkdir()
    procs = []
    for rank in range(2):
        env = {**os.environ, "RANK": str(rank), "LOCAL_RANK": str(rank), "WORLD_SIZE": "2",
               "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": port, "OMP_NUM_THREADS": "1",
               "PYTHONPATH": str(ROOT)}
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "pmpu_tpu_torch.eval", *flags, "--data-parallel"],
            cwd=world, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-4000:]
    assert "slice slabs over {'data': 2, 'model': 1}" in outs[1][1]
    blocks = [re.findall(r"rank %d of 2: chunks \[(\d+), (\d+)\) of (\d+)" % r, err)
              for r, (_, err) in enumerate(outs)]
    assert blocks[0] and blocks[1], [err[-2000:] for _, err in outs]
    (lo0, hi0, n0), (lo1, hi1, n1) = blocks[0][0], blocks[1][0]
    assert lo0 == "0" and hi0 == lo1 and hi1 == n0 == n1, blocks
    assert outs[0][0] == want and "GED^2 (2 samples)" in want
    assert outs[1][0] == ""
    for d in ("predictions", "unc"):
        assert _files(world / d) == _files(one / d)
    assert sorted(os.listdir(world)) == ["predictions", "unc"]
