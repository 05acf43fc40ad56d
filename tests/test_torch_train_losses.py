"""The port's training losses, KL divergence and train-mode BatchNorm on the
CPU against the JAX package and flax, on seeded inputs.

Tolerances: the losses rtol 1e-6 (the same f32 operations in the same
order, reductions summed in another order); BatchNorm output rtol 1e-5 /
atol 1e-6 in f32, one bf16 ulp in bf16; the running statistics rtol 1e-5,
which torch's own train-mode BatchNorm misses (its unbiased running
variance is off by n/(n−1), 2e-3 at 2×16² pixels), as the test shows."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pmpu_tpu.models.distributions import DiagGaussian as JaxGaussian
from pmpu_tpu.models.distributions import kl_divergence as jax_kl
from pmpu_tpu.ops import losses as jl
from pmpu_tpu_torch.models.distributions import DiagGaussian, kl_divergence
from pmpu_tpu_torch.models.unet import BatchNorm2d
from pmpu_tpu_torch.ops import losses as tl

RTOL = 1e-6
RNG = np.random.default_rng(12)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want), rtol=rtol, atol=atol)


def _labels(shape, c):
    """Labels in range, with a few out of range on both sides."""
    y = RNG.integers(0, c, size=shape).astype(np.int32)
    y.reshape(-1)[:4] = [-1, c, c + 2, -3]
    return y


@pytest.mark.parametrize("weights", [None, (0.5, 2.0, 4.0)])
def test_cross_entropy_clamps_labels_and_weights(weights):
    logits = RNG.normal(size=(2, 5, 6, 3)).astype(np.float32) * 3
    y = _labels((2, 5, 6), 3)
    want = jl.cross_entropy(jnp.asarray(logits), jnp.asarray(y), weights)
    _close(tl.cross_entropy(_t(logits), _t(y), weights), want)


@pytest.mark.parametrize("n_classes,weights", [(1, None), (3, None), (3, (1.0, 2.0, 8.0))])
def test_unet_loss(n_classes, weights):
    if n_classes == 1:
        preds = RNG.random((3, 6, 6, 1)).astype(np.float32)
        preds.reshape(-1)[:2] = [0.0, 1.0]  # the clip at eps
        y = RNG.integers(0, 2, size=(3, 6, 6, 1)).astype(np.int32)
    else:
        preds = RNG.normal(size=(3, 6, 6, 3)).astype(np.float32)
        y = _labels((3, 6, 6, 1), 3)
    want = jl.unet_loss(jnp.asarray(preds), jnp.asarray(y), n_classes, weights)
    _close(tl.unet_loss(_t(preds), _t(y), n_classes, weights), want)


def _gaussians(n, latent):
    return [(RNG.normal(size=(n, latent)).astype(np.float32),
             RNG.normal(size=(n, latent)).astype(np.float32) * 0.5) for _ in range(2)]


def test_kl_divergence():
    (lq, sq), (lp, sp) = _gaussians(4, 6)
    want = jax_kl(JaxGaussian(jnp.asarray(lq), jnp.asarray(sq)),
                  JaxGaussian(jnp.asarray(lp), jnp.asarray(sp)))
    got = kl_divergence(DiagGaussian(_t(lq), _t(sq)), DiagGaussian(_t(lp), _t(sp)))
    _close(got, want)


@pytest.mark.parametrize("n_classes,weights", [(1, None), (3, None), (3, (1.0, 3.0, 0.5))])
def test_elbo_loss(n_classes, weights):
    (lq, sq), (lp, sp) = _gaussians(2, 6)
    logits = RNG.normal(size=(2, 8, 8, n_classes)).astype(np.float32) * 2
    y = (RNG.integers(0, 2, size=(2, 8, 8)) if n_classes == 1
         else _labels((2, 8, 8), 3)).astype(np.int32)
    want, want_aux = jl.elbo_loss(
        jnp.asarray(logits), jnp.asarray(y), JaxGaussian(jnp.asarray(lq), jnp.asarray(sq)),
        JaxGaussian(jnp.asarray(lp), jnp.asarray(sp)), 10.0, n_classes, weights)
    got, aux = tl.elbo_loss(_t(logits), _t(y), DiagGaussian(_t(lq), _t(sq)),
                            DiagGaussian(_t(lp), _t(sp)), 10.0, n_classes, weights)
    _close(got, want)
    assert set(aux) == set(want_aux) == {"reconstruction_loss", "kl"}
    for k in aux:
        _close(aux[k], want_aux[k])


def test_small_losses():
    p = RNG.random((2, 7, 7)).astype(np.float32)
    t = (RNG.random((2, 7, 7)) > 0.5).astype(np.float32)
    logits = RNG.normal(size=(2, 7, 7)).astype(np.float32) * 4
    _close(tl.soft_dice_loss(_t(p), _t(t)), jl.soft_dice_loss(jnp.asarray(p), jnp.asarray(t)))
    _close(tl.bce(_t(p), _t(t)), jl.bce(jnp.asarray(p), jnp.asarray(t)))
    _close(tl.bce_with_logits(_t(logits), _t(t)),
           jl.bce_with_logits(jnp.asarray(logits), jnp.asarray(t)), atol=1e-7)


def test_sample_takes_explicit_eps():
    loc, log_scale = (RNG.normal(size=(3, 6)).astype(np.float32) for _ in range(2))
    eps = jax.random.normal(jax.random.key(3), (3, 6))
    want = JaxGaussian(jnp.asarray(loc), jnp.asarray(log_scale)).sample(jax.random.key(3))
    got = DiagGaussian(_t(loc), _t(log_scale)).sample(eps=_t(eps))
    _close(got, want)
    # an explicit eps wins over the generator
    g = torch.Generator().manual_seed(0)
    _close(DiagGaussian(_t(loc), _t(log_scale)).sample(g, _t(eps)), want)


def _flax_bn(x_nhwc, scale, bias, mean, var, dtype):
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5, dtype=dtype)
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}}
    y, mut = bn.apply(variables, x_nhwc, mutable=["batch_stats"])
    return y, mut["batch_stats"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_mode_batchnorm_matches_flax(dtype):
    """2×16² pixels, 5 channels: the output and the running statistics after
    one forward; eval mode afterwards reads the updated statistics."""
    c = 5
    x = (RNG.normal(size=(2, 16, 16, c)) * 3 + 1).astype(np.float32)
    scale, bias = RNG.uniform(0.5, 1.5, c), RNG.normal(size=c)
    mean, var = RNG.normal(size=c) * 0.1, RNG.uniform(0.01, 0.05, c)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                        torch.bfloat16)
    y_want, stats = _flax_bn(jnp.asarray(x, jdt), *(np.float32(a) for a in (scale, bias, mean,
                                                                             var)), jdt)
    bn = BatchNorm2d(c).train()
    with torch.no_grad():
        for t, a in ((bn.weight, scale), (bn.bias, bias), (bn.running_mean, mean),
                     (bn.running_var, var)):
            t.copy_(_t(np.float32(a)))
    y = bn(_t(x).to(tdt).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert y.dtype == tdt
    y_want = np.asarray(y_want.astype(jnp.float32))
    if dtype == "float32":
        _close(y.float(), y_want, rtol=1e-5, atol=1e-6)
    else:  # one bf16 ulp
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(y_want), 1e-30))) - 7)
        assert np.all(np.abs(y.float().detach().numpy() - y_want) <= ulp)
    _close(bn.running_mean, stats["mean"], rtol=1e-5, atol=1e-7)
    _close(bn.running_var, stats["var"], rtol=1e-5)
    assert sorted(bn.state_dict()) == ["bias", "running_mean", "running_var", "weight"]
    # torch's train-mode BatchNorm stores the unbiased variance: the
    # tolerance above is tight enough to see it
    rv = _t(np.float32(var)).clone()
    F.batch_norm(_t(x).permute(0, 3, 1, 2), _t(np.float32(mean)).clone(), rv,
                 training=True, momentum=0.1, eps=1e-5)
    with pytest.raises(AssertionError):
        _close(rv, stats["var"], rtol=1e-5)
    # eval mode normalizes with the updated running statistics, as flax does
    bn.eval()
    y_eval = bn(_t(x).to(tdt).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    want_eval = fnn.BatchNorm(use_running_average=True, momentum=0.9, epsilon=1e-5,
                              dtype=jdt).apply(
        {"params": {"scale": jnp.asarray(np.float32(scale)), "bias": jnp.asarray(np.float32(bias))},
         "batch_stats": stats}, jnp.asarray(x, jdt))
    np.testing.assert_allclose(y_eval.float().detach().numpy(),
                               np.asarray(want_eval.astype(jnp.float32)),
                               rtol=1e-5 if dtype == "float32" else 1e-2, atol=1e-5)


@pytest.mark.parametrize("n_classes", [1, 3])
@pytest.mark.parametrize("loss_type", ["auto", "dice", "ce+dice"])
def test_unet_task_loss_types(n_classes, loss_type):
    """``UNetTask``'s loss options (``--loss``) against the JAX task's."""
    from pmpu_tpu.train.tasks import make_task as jax_make_task
    from pmpu_tpu_torch.train.tasks import make_task

    kw = dict(n_classes=n_classes, num_filters=(4, 8), loss_type=loss_type,
              class_weights=None if n_classes == 1 else (1.0, 2.0, 0.5))
    if n_classes == 1:
        preds = RNG.random((2, 8, 8, 1)).astype(np.float32)
        y = RNG.integers(0, 2, size=(2, 8, 8, 1)).astype(np.int32)
    else:
        preds = RNG.normal(size=(2, 8, 8, 3)).astype(np.float32)
        y = _labels((2, 8, 8, 1), 3)
    want = jax_make_task("unet", **kw)._loss(jnp.asarray(preds), jnp.asarray(y))
    got = make_task("unet", **kw, device="cpu")._loss(_t(preds), _t(y))
    _close(got, want)
