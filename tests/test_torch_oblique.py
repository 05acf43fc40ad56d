"""The port's oblique k-view path on the CPU (plain kernel versions) against
the JAX package, with the same numpy inputs: view bases, the plain oblique
plane, the oblique-plane kernel's plain version (against the Pallas kernel
in interpret mode), the resample back to the grid, the k-view evaluator and
its per-sample path in mean_z mode, and the generalized energy distance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmpu_tpu.data import sampler as jax_sampler
from pmpu_tpu.inference import engine as jax_engine
from pmpu_tpu.inference import fusion as jax_fusion
from pmpu_tpu.ops import metrics as jax_metrics
from pmpu_tpu.ops.pallas.oblique_gather import oblique_plane_pallas
from pmpu_tpu_torch.data import sampler
from pmpu_tpu_torch.inference import engine, fusion
from pmpu_tpu_torch.ops import metrics
from pmpu_tpu_torch.ops.cuda.oblique_gather import oblique_planes, oblique_planes_reference
from tests.test_torch_weights import jax_task_and_variables, port_task

RNG = np.random.default_rng(23)
# view normals: generic, near the z pole (the other helper axis), axis-aligned
NORMALS = [(0.3, 0.5, 0.81), (0.05, -0.1, 0.99), (-0.7, 0.2, 0.1), (1.0, 0.0, 0.0)]


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("k", [2, 5, 6, 7])
def test_view_bases_bit_equal(k):
    np.testing.assert_array_equal(sampler.fibonacci_views(k), jax_sampler.fibonacci_views(k))
    for a in jax_sampler.fibonacci_views(k):
        np.testing.assert_array_equal(sampler.view_basis(a), jax_sampler.view_basis(a))
    got = fusion.make_view_bases(k)
    assert got.dtype == np.float32 and got.shape == (k, 3, 3)
    np.testing.assert_array_equal(got, jax_fusion.make_view_bases(k))


@pytest.mark.parametrize("nearest", [False, True])
@pytest.mark.parametrize("normal", NORMALS)
def test_oblique_plane_matches_jax(normal, nearest):
    """On a [0,1) volume: within 3e-6 (f32 rounding of the coordinates);
    with nearest=True the rounded coordinates pick the same voxels."""
    s = 13
    vol = RNG.random((s, s, s)).astype(np.float32)
    basis = jax_sampler.view_basis(normal)
    for off in (-7.25, -2.5, 0.0, 1.75, 6.0):
        want = np.asarray(jax_sampler.oblique_plane(jnp.asarray(vol), jnp.asarray(basis), off,
                                                    nearest=nearest))
        got = sampler.oblique_plane(_t(vol), _t(basis), off, nearest=nearest).numpy()
        assert got.shape == (s, s) and got.dtype == np.float32
        if nearest:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=3e-6)


@pytest.mark.parametrize("s", [12, 13])
def test_x_axis_basis_gives_the_volume_slices(s):
    vol = _t(RNG.random((s, s, s)).astype(np.float32))
    basis = _t(sampler.view_basis([1.0, 0.0, 0.0]))
    for i in range(s):
        assert torch.equal(sampler.oblique_plane(vol, basis, i - (s - 1) / 2.0), vol[i])
    assert torch.equal(oblique_planes(vol, basis[None]), vol)


@pytest.mark.parametrize("s,k", [(12, 2), (13, 5), (33, 1)])
def test_oblique_planes_match_pallas_and_jax_slabs(s, k):
    """Plane by plane against the Pallas kernel in interpret mode, and the
    whole (k·S,S,S) stack against the JAX package's oblique_slabs: 3e-6 up
    to S = 16, in proportion to S beyond (XLA may contract a coordinate's
    multiply-add into one FMA; that rounding difference grows with the
    coordinates' magnitude, up to 2S, and the [0,1) volume passes it on at
    most 1:1). (33, 1) has ragged 8-voxel tiles."""
    atol = 3e-6 * max(1.0, s / 16)
    vol = RNG.random((s, s, s)).astype(np.float32)
    bases = jax_fusion.make_view_bases(k)
    got = oblique_planes(_t(vol), _t(bases)).numpy()
    assert got.shape == (k * s, s, s)
    np.testing.assert_array_equal(got, oblique_planes_reference(_t(vol), _t(bases)).numpy())
    want = np.concatenate([np.asarray(jax_fusion.oblique_slabs(jnp.asarray(vol), jnp.asarray(b)))
                           for b in bases])
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    pallas = jax.jit(lambda v, b, off: oblique_plane_pallas(v, b, off, interpret=True))
    for v in range(k):
        for i in range(s):
            plane = pallas(vol, bases[v], np.float32(i - (s - 1) / 2.0))
            np.testing.assert_allclose(got[v * s + i], np.asarray(plane), rtol=0, atol=atol)


def test_oblique_planes_checks_its_inputs():
    vol, bases = torch.rand(6, 6, 6), torch.from_numpy(fusion.make_view_bases(2))
    with pytest.raises(ValueError, match="cube"):
        oblique_planes(torch.rand(6, 6, 5), bases)
    with pytest.raises(ValueError, match="cube"):
        oblique_planes(vol.double(), bases)
    with pytest.raises(ValueError, match="bases"):
        oblique_planes(vol, bases[0])
    with pytest.raises(ValueError, match="bases"):
        oblique_planes(vol, bases.double())
    with pytest.raises(ValueError, match="bases on"):
        oblique_planes(vol, bases.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        oblique_planes(vol.to("meta"), bases.to("meta"))


@pytest.mark.parametrize("normal", NORMALS)
def test_resample_view_to_grid_matches_jax(normal):
    s, c = 12, 3
    probs = RNG.random((s, s, s, c)).astype(np.float32)
    basis = jax_sampler.view_basis(normal)
    want = np.asarray(jax_fusion.resample_view_to_grid(jnp.asarray(probs), jnp.asarray(basis)))
    got = fusion.resample_view_to_grid(_t(probs), _t(basis)).numpy()
    assert got.shape == (s, s, s, c)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_resample_round_trip_axis_aligned():
    """tests/test_fusion.py's round trip: the x-axis view's slabs resampled
    back give the volume."""
    s = 8
    vol = RNG.random((s, s, s)).astype(np.float32)
    basis = _t(sampler.view_basis([1.0, 0.0, 0.0]))
    back = fusion.resample_view_to_grid(fusion.oblique_slabs(_t(vol), basis)[..., None], basis)
    np.testing.assert_allclose(back[..., 0].numpy(), vol, rtol=0, atol=1e-5)


def _volume_and_truth(cube=16):
    vol = RNG.random((cube, cube, cube)).astype(np.float32)
    truth = np.zeros((cube, cube, cube), np.int32)
    truth[3:11, 4:12, 2:10] = 1
    truth[5:8, 6:9, 4:7] = 2
    vol[truth > 0] += 0.5
    return vol, truth


def _pair(name, n_classes):
    jtask, variables = jax_task_and_variables(name, (4, 8), n_classes)
    task = port_task(name, (4, 8), n_classes, variables=variables)
    return jtask, jax.tree_util.tree_map(jnp.asarray, variables), task


@pytest.mark.parametrize("name,n_classes,eval_batch", [
    ("probunet", 3, 20),  # 96 slices in 5 chunks of 20: one padded chunk
    ("unet", 1, 0),       # binary: sigmoid probs expanded to [bg, fg]
])
def test_six_view_evaluator_matches_jax_mean_z(name, n_classes, eval_batch):
    """Probabilities within 1e-5, Dice within 1e-4; argmax equal wherever
    the JAX result's top two probabilities differ by more than 1e-5."""
    jtask, variables, task = _pair(name, n_classes)
    vol, truth = _volume_and_truth()
    if n_classes == 1:
        truth = (truth > 0).astype(np.int32)
    jev = jax_engine.VolumeEvaluator(jtask, eval_batch=eval_batch, num_views=6, mean_z=True)
    want = jev.evaluate_volume(variables, vol, truth)
    ev = engine.VolumeEvaluator(task, eval_batch=eval_batch, num_views=6, mean_z=True,
                                device="cpu")
    got = ev.evaluate_volume(vol, truth)
    fused = np.asarray(want["fused"])
    np.testing.assert_allclose(got["fused"].numpy(), fused, rtol=0, atol=1e-5)
    assert len(got["views"]) == 6
    for g, w in zip(got["views"], want["views"]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)
    top2 = np.sort(fused, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 1e-5
    np.testing.assert_array_equal(got["argmax"][clear], want["argmax"][clear])
    print(f"{int((~clear).sum())} voxels with the top two probabilities within 1e-5, "
          f"{int((got['argmax'] != want['argmax']).sum())} argmax mismatches")
    assert got["dice"].shape == (7, max(n_classes, 2) - 1)
    np.testing.assert_allclose(got["dice"], want["dice"], rtol=0, atol=1e-4)


@pytest.mark.parametrize("num_views", [3, 6])
def test_per_sample_predict_matches_jax_mean_z(num_views):
    jtask, variables, task = _pair("probunet", 3)
    vol, _ = _volume_and_truth(12)
    jev = jax_engine.VolumeEvaluator(jtask, eval_batch=16, num_views=num_views, mean_z=True)
    want = jev._predict_volume(variables, jnp.asarray(vol), jax.random.key(0), per_sample=True)
    ev = engine.VolumeEvaluator(task, eval_batch=16, num_views=num_views, mean_z=True,
                                device="cpu")
    with torch.inference_mode():
        got = ev._predict_volume(_t(vol), 0, per_sample=True)
    assert len(got) == num_views + 1
    for g, w in zip(got, want):
        assert tuple(g.shape) == (1, 12, 12, 12, 3)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)


def test_per_sample_draws_average_to_the_sampled_logits():
    """Sampling mode: the per-sample slab logits hold one map per draw, and
    their mean is the mean path's logits for the same seed."""
    task = port_task("probunet")
    ev = engine.VolumeEvaluator(task, n_samples=3, eval_batch=10, num_views=2, device="cpu")
    slabs = torch.from_numpy(RNG.random((24, 12, 12)).astype(np.float32))
    with torch.inference_mode():
        per = ev._chunked_logits(slabs, 4, per_sample=True)
        mean = ev._chunked_logits(slabs, 4)
    assert per.shape == (3, 24, 12, 12, 3)
    torch.testing.assert_close(per.mean(0), mean, rtol=0, atol=1e-6)


@pytest.mark.parametrize("n,m", [(4, 1), (3, 2)])
def test_generalized_energy_distance_matches_jax(n, m):
    samples = RNG.integers(0, 3, (n, 6, 7, 5)).astype(np.int32)
    truths = RNG.integers(0, 3, (m, 6, 7, 5)).astype(np.int32)
    samples[0, ..., 0] = truths[0, ..., 0]
    samples[-1] = np.where(samples[-1] == 2, 0, samples[-1])  # class 2 absent from one map
    want = jax_metrics.generalized_energy_distance(jnp.asarray(samples), jnp.asarray(truths), 3)
    got = metrics.generalized_energy_distance(_t(samples), _t(truths), 3)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)
    d = metrics._pairwise_iou_distance(_t(samples[0]), _t(samples[0]), 3)
    assert float(d) == 0.0


@pytest.mark.parametrize("num_views,quantize", [(3, None), (6, None), (6, "int8")])
def test_ged_volume(num_views, quantize):
    """Finite and in [-1, 2]; the draws come from a kept evaluator with this
    one's settings (sharing its int8 tree), and n_samples stays as it was."""
    task = port_task("probunet")
    vol, truth = _volume_and_truth(12)
    ev = engine.VolumeEvaluator(task, n_samples=5, eval_batch=16, num_views=num_views,
                                quantize=quantize, device="cpu")
    ged = ev.ged_volume(vol, truth, n_ged_samples=3, seed=1)
    assert np.isfinite(ged) and -1.0 <= ged <= 2.0
    assert ev.n_samples == 5
    assert ev.ged_volume(vol, truth, n_ged_samples=3, seed=1) == ged
    child = ev._ged_evaluators[3]
    assert (child.n_samples, child.num_views, child.eval_batch, child.quantize) == \
        (3, num_views, 16, quantize)
    if quantize:
        assert child._qvars is ev._qvars


def test_num_views_must_be_positive():
    with pytest.raises(ValueError, match="num_views"):
        engine.VolumeEvaluator(port_task(), num_views=0, device="cpu")
