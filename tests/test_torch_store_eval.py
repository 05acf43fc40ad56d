"""The port's store evaluation on the CPU (plain kernel versions) against
the JAX package: ``evaluate_store`` gives the JAX report (within 1e-5),
byte-equal segmentation exports with and without the source geometry and
entropy exports within 1 LSB, at every pipeline depth; the batched path
gives per-volume and sequential evaluation's results in sampling mode, and
falls back to the sequential evaluator under the memory guard and on an
out-of-memory error in the first group."""

import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmpu_tpu.data import nifti as jax_nifti
from pmpu_tpu.data.volumes import VolumeStore as JaxStore
from pmpu_tpu.inference.engine import VolumeEvaluator as JaxEvaluator
from pmpu_tpu_torch.data.volumes import VolumeStore
from pmpu_tpu_torch.inference import engine
from tests.test_torch_weights import jax_task_and_variables, port_task

NF = (4, 8)
LSB = np.log(3) / 65535.0


def _tree(root):
    """3 scans of mixed shapes and affines (cube 16) with 3-class labels."""
    rng = np.random.default_rng(29)
    for sub in ("images", "labels"):
        (root / sub).mkdir(parents=True)
    for i, shape in enumerate(((12, 16, 10), (16, 9, 14), (11, 13, 16))):
        affine = np.diag([1.0 + 0.5 * i, 2.0, 0.75, 1.0])
        affine[:3, 3] = (i, -3.0 * i, 8.0)
        lbl = np.zeros(shape, np.int16)
        lbl[2:9, 2:8, 2:9] = 1
        lbl[4:7, 3:6, 4:7] = 2
        img = (rng.random(shape) * 0.3 + 0.5 * (lbl > 0) + 0.2 * (lbl == 2)).astype(np.float32)
        jax_nifti.save(root / "images" / f"s{i}.nii", img, affine)
        jax_nifti.save(root / "labels" / f"s{i}.nii", lbl)
    return str(root / "images"), str(root / "labels")


def _files(directory):
    return {n: (directory / n).read_bytes() for n in sorted(os.listdir(directory))}


def _assert_reports_close(got, want, tol):
    assert len(got["per_view"]) == len(want["per_view"])
    for g, w in zip(got["per_view"] + [got["fused"]], want["per_view"] + [want["fused"]]):
        assert g.shape == np.asarray(w).shape
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=tol)


@pytest.mark.parametrize("name", ["unet", "probunet"])
def test_evaluate_store_matches_jax(tmp_path, name):
    """mean_z, f32, the same weights and NIfTI store: the report within
    1e-5, segmentations byte-equal and entropy within 1 LSB, exported with
    the source geometry and without it; depth 0 gives depth 2's bits."""
    imgs, lbls = _tree(tmp_path)
    jtask, variables = jax_task_and_variables(name, NF, 3)
    jev = JaxEvaluator(jtask, mean_z=True)
    ev = engine.VolumeEvaluator(port_task(name, NF, 3, variables=variables), mean_z=True,
                                device="cpu")
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    # the JAX numpy reader: no in-place build of the JAX native library here
    jstore = JaxStore.from_dirs(imgs, lbls, use_native=False)
    store = VolumeStore.from_dirs(imgs, lbls)
    for source_geometry in (True, False):
        jev.source_geometry = ev.source_geometry = source_geometry
        out = tmp_path / f"geom{source_geometry}"
        want = jev.evaluate_store(jvars, jstore, key=jax.random.key(0),
                                  save_dir=str(out / "jseg"), uncertainty_dir=str(out / "jent"))
        runs = {}
        for depth in (2, 0):
            runs[depth] = ev.evaluate_store(store, seed=0, save_dir=str(out / f"seg{depth}"),
                                            uncertainty_dir=str(out / f"ent{depth}"),
                                            pipeline_depth=depth)
            _assert_reports_close(runs[depth], want, 1e-5)
            assert _files(out / f"seg{depth}") == _files(out / "jseg")
            for n in os.listdir(out / "jent"):
                got, ref = (jax_nifti.load(out / d / n) for d in (f"ent{depth}", "jent"))
                assert got.shape == ref.shape
                assert np.abs(np.rint(got / LSB) - np.rint(ref / LSB)).max() <= 1
        for a, b in zip(runs[0]["per_view"] + [runs[0]["fused"]],
                        runs[2]["per_view"] + [runs[2]["fused"]]):
            np.testing.assert_array_equal(a, b)
        assert _files(out / "seg0") == _files(out / "seg2")
        assert _files(out / "ent0") == _files(out / "ent2")
        hdr = jax_nifti.read_header(out / "seg2" / "s1.nii")
        assert hdr.shape == ((16, 9, 14) if source_geometry else (16, 16, 16))


def _volumes(n, cube=12, seed=0):
    rng = np.random.default_rng(seed)
    imgs = rng.random((n, cube, cube, cube)).astype(np.float32)
    imgs[:, 3:9, 2:8, 3:9] += 0.6
    return imgs, (imgs > 0.8).astype(np.int32) + (imgs > 1.3)


@pytest.mark.parametrize("num_views", [3, 6])
def test_batched_equals_per_volume_sampled(num_views):
    """Prior draws sampled: volume j of a batch gives what
    ``evaluate_volume`` with seed ``derive_seed(seed, j)`` gives."""
    imgs, lbls = _volumes(3)
    ev = engine.VolumeEvaluator(port_task("probunet"), n_samples=3, eval_batch=16,
                                num_views=num_views, device="cpu")
    got = ev.evaluate_volumes_batched(imgs, lbls, seed=11)
    assert tuple(got["fused"].shape) == (3, 12, 12, 12, 3)
    assert got["dice"].shape == (3, num_views + 1, 2)
    for j in range(3):
        want = ev.evaluate_volume(imgs[j], lbls[j], seed=engine.derive_seed(11, j))
        torch.testing.assert_close(got["fused"][j], want["fused"], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["dice"][j], want["dice"], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["unet", "probunet"])
def test_batched_store_matches_jax_batched(tmp_path, name):
    """mean_z: ``evaluate_store_batched`` (a padded last group) gives the
    JAX batched report and byte-equal exports, with the entropy."""
    imgs, lbls = _tree(tmp_path)
    jtask, variables = jax_task_and_variables(name, NF, 3)
    jev = JaxEvaluator(jtask, mean_z=True)
    ev = engine.VolumeEvaluator(port_task(name, NF, 3, variables=variables), mean_z=True,
                                device="cpu")
    want = jev.evaluate_store_batched(jax.tree_util.tree_map(jnp.asarray, variables),
                                      JaxStore.from_dirs(imgs, lbls, use_native=False),
                                      key=jax.random.key(0),
                                      save_dir=str(tmp_path / "jseg"),
                                      uncertainty_dir=str(tmp_path / "jent"))
    got = ev.evaluate_store_batched(VolumeStore.from_dirs(imgs, lbls), save_dir=str(
        tmp_path / "seg"), uncertainty_dir=str(tmp_path / "ent"), volumes_per_batch=2)
    _assert_reports_close(got, want, 1e-5)
    assert _files(tmp_path / "seg") == _files(tmp_path / "jseg")
    for n in os.listdir(tmp_path / "jent"):
        a, b = (jax_nifti.load(tmp_path / d / n) for d in ("ent", "jent"))
        assert np.abs(np.rint(a / LSB) - np.rint(b / LSB)).max() <= 1


def test_batched_store_equals_sequential_sampled(tmp_path):
    """Prior draws sampled: the batched store path gives each volume the
    sequential path's seed, so the reports and exports agree."""
    imgs, lbls = _tree(tmp_path)
    ev = engine.VolumeEvaluator(port_task("probunet"), n_samples=3, eval_batch=16,
                                device="cpu")
    store = VolumeStore.from_dirs(imgs, lbls)
    want = ev.evaluate_store(store, seed=8, save_dir=str(tmp_path / "seq"),
                             uncertainty_dir=str(tmp_path / "seq_ent"))
    got = ev.evaluate_store_batched(store, seed=8, save_dir=str(tmp_path / "bat"),
                                    uncertainty_dir=str(tmp_path / "bat_ent"),
                                    volumes_per_batch=2)
    _assert_reports_close(got, want, 1e-6)
    assert _files(tmp_path / "bat") == _files(tmp_path / "seq")
    assert _files(tmp_path / "bat_ent") == _files(tmp_path / "seq_ent")


def _fallback_case(tmp_path):
    imgs, lbls = _tree(tmp_path)
    ev = engine.VolumeEvaluator(port_task("probunet"), n_samples=2, eval_batch=16,
                                device="cpu")
    store = VolumeStore.from_dirs(imgs, lbls)
    want = ev.evaluate_store(store, seed=5, save_dir=str(tmp_path / "want"))
    return ev, store, want


def test_batched_falls_back_under_the_memory_guard(tmp_path, monkeypatch, caplog):
    ev, store, want = _fallback_case(tmp_path)
    monkeypatch.setenv("PMPU_HBM_BYTES", "1e6")
    assert engine.device_hbm_limit() == 1_000_000
    assert ev.batched_hbm_estimate(16, 2) > 0.9e6
    with caplog.at_level(logging.WARNING):
        got = ev.evaluate_store_batched(store, seed=5, save_dir=str(tmp_path / "got"))
    assert any("falling back to the sequential" in r.message and "estimated" in r.message
               for r in caplog.records)
    _assert_reports_close(got, want, 0)
    assert _files(tmp_path / "got") == _files(tmp_path / "want")


def test_batched_falls_back_on_out_of_memory_in_the_first_group(tmp_path, monkeypatch, caplog):
    """An out-of-memory error in the first group falls back (after
    ``empty_cache``); in a later group it propagates."""
    ev, store, want = _fallback_case(tmp_path)
    emptied = []
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: emptied.append(1))
    dispatch = ev._dispatch_group

    def oom_at(group):
        calls = []

        def fake(*args, **kwargs):
            calls.append(1)
            if len(calls) == group:
                raise torch.cuda.OutOfMemoryError("CUDA out of memory (injected)")
            return dispatch(*args, **kwargs)
        return fake

    monkeypatch.setattr(ev, "_dispatch_group", oom_at(1))
    with caplog.at_level(logging.WARNING):
        got = ev.evaluate_store_batched(store, seed=5, save_dir=str(tmp_path / "got"))
    assert emptied == [1]
    assert any("out of device memory" in r.message for r in caplog.records)
    _assert_reports_close(got, want, 0)
    assert _files(tmp_path / "got") == _files(tmp_path / "want")
    monkeypatch.setattr(ev, "_dispatch_group", oom_at(2))
    with pytest.raises(torch.cuda.OutOfMemoryError):
        ev.evaluate_store_batched(store, seed=5, volumes_per_batch=2)


def test_device_hbm_limit(monkeypatch):
    monkeypatch.delenv("PMPU_HBM_BYTES", raising=False)
    assert engine.device_hbm_limit("cpu") is None
    monkeypatch.setenv("PMPU_HBM_BYTES", "15e9")
    assert engine.device_hbm_limit("cpu") == 15_000_000_000
    monkeypatch.setenv("PMPU_HBM_BYTES", "lots")
    with pytest.warns(UserWarning, match="malformed PMPU_HBM_BYTES"):
        assert engine.device_hbm_limit("cpu") is None
