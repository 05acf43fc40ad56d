"""The port's latent-space sampling (``inference/uncertainty.py``), its
``take_plane`` and its sampling visualizer against the JAX package on the
CPU, with the same weights (BatchNorm statistics randomized):
``latent_grid`` bit-equal; ``sample_grid``'s logits within 1e-5; the
uncertainty maps with the JAX draws injected within 1e-5; ``take_plane``
bit-equal on the 3 views; ``python -m pmpu_tpu_torch.visualize_sampling``
picks the JAX visualizer's slice (its scan and label images byte-equal)
and writes its four images."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmpu_tpu.data import sampler as jsm
from pmpu_tpu.data.volumes import VolumeStore as JaxStore
from pmpu_tpu.inference import uncertainty as jun
from pmpu_tpu.train.tasks import make_task as jax_make_task
from pmpu_tpu_torch.data import nifti, sampler
from pmpu_tpu_torch.inference import uncertainty
from pmpu_tpu_torch.train import checkpoint as ckpt
from pmpu_tpu_torch.train import steps
from pmpu_tpu_torch.train.tasks import make_task
from tests.test_torch_weights import _randomize_bn, port_task

NF, LATENT, S = (4, 8), 3, 16


def _weights(seed=2):
    """Port-initialized probunet weights, BatchNorm randomized, as a flax tree."""
    task = make_task("probunet", n_classes=3, num_filters=NF, latent_dim=LATENT, device="cpu",
                     seed=seed)
    return _randomize_bn(ckpt.flax_variables(task.net), np.random.default_rng(seed))


def _slice():
    img = np.random.default_rng(6).random((S, S)).astype(np.float32)
    img[4:11, 3:12] += 0.8
    return img / img.max()


@pytest.mark.parametrize("n_preds,scale", [(3, 40.0), (5, 2.5)])
def test_latent_grid_bit_equal(n_preds, scale):
    rng = np.random.default_rng(n_preds)
    mu, sigma = rng.normal(size=6).astype(np.float32), rng.random(6).astype(np.float32)
    got = uncertainty.latent_grid(mu, sigma, n_preds, scale)
    want = jun.latent_grid(mu, sigma, n_preds, scale)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_sample_grid_matches_jax():
    variables = _weights()
    jtask = jax_make_task("probunet", n_classes=3, num_filters=NF, latent_dim=LATENT)
    task = port_task("probunet", NF, 3, 4, LATENT, variables=variables)
    img = _slice()
    want, wmu, wsigma = jun.sample_grid(jtask, variables, img, 3, 40.0)
    got, mu, sigma = uncertainty.sample_grid(task, img, 3, 40.0)
    assert got.shape == want.shape == (9, S, S, 3) and got.dtype == np.float32
    np.testing.assert_allclose(mu, wmu, rtol=0, atol=1e-6)
    np.testing.assert_allclose(sigma, wsigma, rtol=1e-6, atol=0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_uncertainty_maps_match_jax_with_its_draws():
    variables = _weights(seed=3)
    jtask = jax_make_task("probunet", n_classes=3, num_filters=NF, latent_dim=LATENT)
    task = port_task("probunet", NF, 3, 4, LATENT, variables=variables)
    img = _slice()
    key = jax.random.key(11)
    want = jun.uncertainty_maps(jtask, variables, img, n_samples=16, key=key)
    eps = np.asarray(jax.random.normal(key, (16, 1, LATENT)))  # JAX's own draws
    got = uncertainty.uncertainty_maps(task, img, n_samples=16, eps=eps)
    for g, w, name in zip(got, want, ("mean probabilities", "entropy", "variance")):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5, err_msg=name)
    assert got[0].shape == (S, S, 3) and got[1].shape == got[2].shape == (S, S)
    # drawn from a generator: seeded, repeatable, another draw than JAX's
    a = uncertainty.uncertainty_maps(task, img, 16, torch.Generator().manual_seed(1))
    b = uncertainty.uncertainty_maps(task, img, 16, torch.Generator().manual_seed(1))
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert (a[1] >= 0).all() and (a[1] <= np.log(3) + 1e-6).all()


def test_take_plane_bit_equal_on_every_view():
    vol = np.random.default_rng(8).random((S, S, S)).astype(np.float32)
    for view in range(3):
        for idx in (0, 5, S - 1):
            got = sampler.take_plane(torch.from_numpy(vol), view, idx).numpy()
            want = np.asarray(jsm.take_plane(jnp.asarray(vol), view, idx))
            assert np.array_equal(got, want), (view, idx)
            assert np.array_equal(sampler.normalize_slice(torch.from_numpy(got)).numpy(),
                                  np.asarray(jsm.normalize_slice(jnp.asarray(want))))


def _dataset(root):
    rng = np.random.default_rng(12)
    for d in ("images", "labels"):
        os.makedirs(os.path.join(root, d))
    for i in range(2):
        img = rng.random((S, S, S)).astype(np.float32) * 0.3
        lbl = np.zeros((S, S, S), np.float32)
        lbl[5:9 + i, 4:10, 6:11] = 1
        lbl[6:8, 6:8, 7:9] = 2
        img += 0.5 * (lbl > 0)
        nifti.save(os.path.join(root, "images", f"s{i}.nii"), img)
        nifti.save(os.path.join(root, "labels", f"s{i}.nii"), lbl)


def test_visualizer_picks_the_jax_slice(tmp_path, monkeypatch):
    import visualize_sampling as jax_vis

    from pmpu_tpu_torch.visualize_sampling import main

    _dataset(str(tmp_path / "data"))
    variables = _weights(seed=4)
    task = make_task("probunet", n_classes=3, num_filters=NF, latent_dim=LATENT, device="cpu",
                     train=True)
    ckpt.load_flax_variables(task.net, variables)
    state = steps.create_train_state(task)
    ck = str(tmp_path / "ck.pt")
    ckpt.save_checkpoint(ck, state, extra={"model_config": {
        "net": "probunet", "n_channels": 1, "n_classes": 3, "num_filters": list(NF),
        "latent_dim": LATENT, "no_convs_fcomb": 4, "beta": 10.0}})
    args = ["-f", ck, "-d", str(tmp_path / "data"), "--seed", "5"]

    class _NumpyStore:  # the JAX store through its numpy reader, never its native build
        from_dirs = staticmethod(lambda i, m: JaxStore.from_dirs(i, m, use_native=False))

    monkeypatch.setattr(jax_vis, "VolumeStore", _NumpyStore)
    for out in ("jax", "port"):
        os.makedirs(tmp_path / out)
    monkeypatch.chdir(tmp_path / "jax")
    monkeypatch.setattr(sys, "argv", ["visualize_sampling.py", *args])
    assert jax_vis.main() == 0
    monkeypatch.chdir(tmp_path / "port")
    assert main([*args, "--device", "cpu"]) == 0
    files = sorted(os.listdir(tmp_path / "port"))
    assert files == sorted(os.listdir(tmp_path / "jax"))
    assert [f.split(".")[0] for f in files] == [
        "viz_grid", "viz_label", "viz_scan", "viz_uncertainty"]
    for f in files:
        if f.startswith(("viz_scan", "viz_label")):
            assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f
