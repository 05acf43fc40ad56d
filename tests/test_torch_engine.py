"""The port's VolumeEvaluator on the CPU (plain kernel versions) against the
JAX package's VolumeEvaluator with the same weights, in mean_z mode:
argmax equal everywhere, fused and per-view probabilities within 1e-5,
Dice tables equal. Plus the chunk plan, the 2-bit wire and the uploads."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from pmpu_tpu.inference import engine as jax_engine
from pmpu_tpu_torch.inference import engine
from tests.test_torch_weights import jax_task_and_variables, port_task

RNG = np.random.default_rng(11)
CUBE = 16


def _volume_and_truth(cube=CUBE):
    vol = RNG.random((cube, cube, cube)).astype(np.float32)
    truth = np.zeros((cube, cube, cube), np.int32)
    truth[3:11, 4:12, 2:10] = 1
    truth[5:8, 6:9, 4:7] = 2
    vol[truth > 0] += 0.5
    return vol, truth


@pytest.mark.parametrize("name,n_classes,eval_batch", [
    ("probunet", 3, 20),  # 48 slices in 3 chunks of 20: one padded chunk
    ("unet", 1, 0),       # binary: sigmoid probs expanded to [bg, fg]
])
def test_evaluator_matches_jax_mean_z(name, n_classes, eval_batch):
    nf = (4, 8)
    jtask, variables = jax_task_and_variables(name, nf, n_classes)
    task = port_task(name, nf, n_classes, variables=variables)
    vol, truth = _volume_and_truth()
    if n_classes == 1:
        truth = (truth > 0).astype(np.int32)
    jev = jax_engine.VolumeEvaluator(jtask, eval_batch=eval_batch, mean_z=True)
    want = jev.evaluate_volume(jax.tree_util.tree_map(jnp.asarray, variables), vol, truth)
    ev = engine.VolumeEvaluator(task, eval_batch=eval_batch, mean_z=True, device="cpu")
    got = ev.evaluate_volume(vol, truth)
    np.testing.assert_array_equal(got["argmax"], want["argmax"])
    np.testing.assert_allclose(got["fused"].numpy(), np.asarray(want["fused"]), rtol=0, atol=1e-5)
    for g, w in zip(got["views"], want["views"]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got["dice"], want["dice"])
    assert got["dice"].shape == (4, max(n_classes, 2) - 1)


@torch.inference_mode()
def test_sampled_draws_follow_the_seed():
    """Sampling mode: one seed gives one result, another seed another;
    probabilities stay normalized."""
    task = port_task("probunet")
    vol, _ = _volume_and_truth()
    ev = engine.VolumeEvaluator(task, n_samples=3, eval_batch=16, device="cpu")
    a = ev.evaluate_volume(vol, seed=1)["fused"]
    b = ev.evaluate_volume(vol, seed=1)["fused"]
    c = ev.evaluate_volume(vol, seed=2)["fused"]
    assert torch.equal(a, b) and not torch.equal(a, c)
    torch.testing.assert_close(a.sum(-1), torch.ones(a.shape[:-1]), rtol=0, atol=1e-5)
    g0, g1 = (engine.chunk_generator(torch.device("cpu"), 1, i) for i in range(2))
    assert not torch.equal(torch.randn(4, generator=g0), torch.randn(4, generator=g1))


def test_per_sample_logits_match_decode_samples():
    """The per-sample branch is the plain decode_samples; its mean is the
    mean path within f32 rounding."""
    task = port_task("probunet")
    ev = engine.VolumeEvaluator(task, n_samples=3, device="cpu")
    x = torch.from_numpy(RNG.random((4, 8, 8, 1)).astype(np.float32))
    with torch.inference_mode():
        per = ev._model_logits(x, torch.Generator().manual_seed(5), per_sample=True)
        mean = ev._model_logits(x, torch.Generator().manual_seed(5))
    assert per.shape == (3, 4, 8, 8, 3)
    torch.testing.assert_close(per.mean(0), mean, rtol=0, atol=1e-6)


def test_chunk_plan_matches_jax():
    for total in (3, 48, 96, 100, 127, 384, 389, 768):
        for hw in (16, 96, 128, 200, 256):
            for eval_batch in (0, -1, 7, 128):
                assert engine.eval_chunk_plan(total, hw, hw, eval_batch) == \
                    jax_engine.eval_chunk_plan(total, hw, hw, eval_batch)
            assert engine.auto_eval_batch(total, hw, hw) == jax_engine.auto_eval_batch(total, hw, hw)
    b, n = engine.eval_chunk_plan(389, 128, 128, 0)
    assert n * b > 389  # a padded plan is among the cases


def test_pack2bit_round_trip_matches_jax():
    seg = RNG.integers(0, 4, (6, 5, 8)).astype(np.uint8)
    packed = engine._pack2bit(torch.from_numpy(seg)).numpy()
    np.testing.assert_array_equal(packed, np.asarray(jax_engine._pack2bit(jnp.asarray(seg))))
    np.testing.assert_array_equal(engine._unpack2bit(packed), seg)


def test_uploads_match_jax():
    """uint8 wire: the same bytes as the JAX engine's upload; signed or
    non-finite volumes demote to the same bf16; bf16 wire equal bits."""
    jtask, _ = jax_task_and_variables("unet", (4, 8), 1)
    task = port_task("unet", (4, 8), 1)
    vol = (RNG.random((2, 8, 8, 8)) * 300).astype(np.float32)
    signed = vol - 100.0
    nonfinite = vol.copy()
    nonfinite[0, 0, 0, 0] = np.inf
    u8 = engine.VolumeEvaluator(task, input_dtype="uint8", device="cpu")
    ju8 = jax_engine.VolumeEvaluator(jtask, input_dtype="uint8")
    got = u8._upload(vol)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(ju8._upload(vol)))
    for bad in (signed, nonfinite):
        got = u8._upload(bad)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(ju8._upload(bad)).astype(np.float32))
    bf = engine.VolumeEvaluator(task, input_dtype="bfloat16", device="cpu")
    got = bf._upload(vol)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  vol.astype(ml_dtypes.bfloat16).astype(np.float32))
    with pytest.raises(ValueError, match="input_dtype"):
        engine.VolumeEvaluator(task, input_dtype="int16", device="cpu")


@pytest.mark.parametrize("n_classes", [1, 3])
def test_per_class_dice_matches_jax(n_classes):
    from pmpu_tpu.ops.metrics import per_class_dice as jax_per_class_dice
    from pmpu_tpu_torch.ops.metrics import per_class_dice

    preds = RNG.random((3, 8, 8, n_classes)).astype(np.float32)
    masks = RNG.integers(0, max(n_classes, 2), (3, 8, 8, 1)).astype(np.int32)
    want = np.asarray(jax_per_class_dice(jnp.asarray(preds), jnp.asarray(masks), n_classes))
    got = per_class_dice(torch.from_numpy(preds), torch.from_numpy(masks), n_classes).numpy()
    np.testing.assert_array_equal(got, want)
