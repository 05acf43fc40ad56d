"""The port's models (pmpu_tpu_torch.models) on the CPU against the JAX
package's ``net.apply(..., train=False)`` with the same weights.

Tolerances: f32 rtol 1e-4 / atol 1e-5 (the two frameworks sum conv
products in different orders); bf16 by argmax agreement, since the two
round at the same points but accumulate in different orders."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmpu_tpu.models.prob_unet import ProbabilisticUNet as JaxProbUNet
from pmpu_tpu.models.prob_unet import avg_pool_ceil as jax_avg_pool_ceil
from pmpu_tpu_torch.models.prob_unet import avg_pool_ceil
from tests.test_torch_weights import jax_task_and_variables, port_task

RTOL, ATOL = 1e-4, 1e-5
RNG = np.random.default_rng(7)


def _slices(n, cube):
    return RNG.random((n, cube, cube, 1)).astype(np.float32)


@torch.inference_mode()
@pytest.mark.parametrize("n_classes", [1, 3])
def test_unet_forward_f32(n_classes):
    nf = (4, 8, 16)
    jtask, variables = jax_task_and_variables("unet", nf, n_classes)
    task = port_task("unet", nf, n_classes, variables=variables)
    x = _slices(3, 16)
    want = np.asarray(jtask.net.apply(variables, jnp.asarray(x), train=False))
    got = task.net(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (3, 16, 16, n_classes)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@torch.inference_mode()
@pytest.mark.parametrize("cube,nf", [(16, (4, 8)), (13, (4, 8, 16))])
def test_probunet_features_prior_posterior_f32(cube, nf):
    """Features, prior and posterior; cube 13 runs the ceil-mode average
    pool on odd sizes and the decoder's pad-to-match."""
    jtask, variables = jax_task_and_variables("probunet", nf, cube=cube)
    task = port_task("probunet", nf, variables=variables)
    x = _slices(2, cube)
    segm = RNG.integers(0, 3, (2, cube, cube, 1)).astype(np.float32)
    out = jtask.net.apply(variables, jnp.asarray(x), jnp.asarray(segm), train=False)
    got = task.net(torch.from_numpy(x), torch.from_numpy(segm))
    np.testing.assert_allclose(got.unet_features.numpy(), np.asarray(out.unet_features),
                               rtol=RTOL, atol=ATOL)
    for g, w in ((got.prior, out.prior), (got.posterior, out.posterior)):
        np.testing.assert_allclose(g.loc.numpy(), np.asarray(w.loc), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(g.log_scale.numpy(), np.asarray(w.log_scale),
                                   rtol=RTOL, atol=ATOL)
    assert got.unet_features.is_contiguous()


@torch.inference_mode()
@pytest.mark.parametrize("ncf", [2, 4])
def test_decode_samples_shared_zs_f32(ncf):
    jtask, variables = jax_task_and_variables("probunet", (4, 8), ncf=ncf)
    task = port_task("probunet", (4, 8), ncf=ncf, variables=variables)
    feats = np.maximum(RNG.standard_normal((2, 8, 8, 4)), 0).astype(np.float32)
    zs = RNG.standard_normal((3, 2, 3)).astype(np.float32)
    want = np.asarray(jtask.net.apply(variables, jnp.asarray(feats), jnp.asarray(zs),
                                      method=JaxProbUNet.decode_samples))
    got = task.net.decode_samples(torch.from_numpy(feats), torch.from_numpy(zs)).numpy()
    assert got.shape == want.shape == (3, 2, 8, 8, 3)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@torch.inference_mode()
def test_probunet_bf16_argmax_agreement():
    """bf16 compute (params f32, cast at the flax cast points): the mean
    logits of 3 shared draws agree with JAX's argmax on >= 97% of pixels of
    an untrained model, whose logits sit close together."""
    nf = (8, 16)
    jtask, variables = jax_task_and_variables("probunet", nf, dtype=jnp.bfloat16)
    task = port_task("probunet", nf, dtype=torch.bfloat16, variables=variables)
    x = _slices(4, 16)
    out = jtask.net.apply(variables, jnp.asarray(x), train=False)
    zs = np.asarray(out.prior.loc)[None] + RNG.standard_normal((3, 4, 3)).astype(np.float32)
    want = np.asarray(jtask.net.apply(variables, out.unet_features, jnp.asarray(zs),
                                      method=JaxProbUNet.decode_samples)).mean(0)
    got_out = task.net(torch.from_numpy(x))
    assert got_out.unet_features.dtype == torch.bfloat16
    assert got_out.prior.loc.dtype == torch.float32
    got = task.net.decode_samples(got_out.unet_features, torch.from_numpy(zs)).mean(0).numpy()
    agree = (got.argmax(-1) == want.argmax(-1)).mean()
    assert agree >= 0.97, agree
    np.testing.assert_allclose(got_out.prior.loc.numpy(), np.asarray(out.prior.loc),
                               rtol=0.05, atol=0.05)


@pytest.mark.parametrize("h,w", [(8, 8), (7, 9), (5, 1)])
def test_avg_pool_ceil_matches_jax(h, w):
    x = RNG.standard_normal((2, h, w, 3)).astype(np.float32)
    want = np.asarray(jax_avg_pool_ceil(jnp.asarray(x)))
    got = avg_pool_ceil(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_diag_gaussian_sample_uses_its_generator():
    from pmpu_tpu_torch.models.distributions import DiagGaussian

    loc = torch.from_numpy(RNG.standard_normal((4, 3)).astype(np.float32))
    log_scale = torch.from_numpy(RNG.standard_normal((4, 3)).astype(np.float32))
    d = DiagGaussian(loc, log_scale)
    z = d.sample(torch.Generator().manual_seed(9))
    eps = torch.randn((4, 3), generator=torch.Generator().manual_seed(9))
    torch.testing.assert_close(z, loc + torch.exp(log_scale) * eps, rtol=0, atol=0)
    torch.testing.assert_close(d.scale, torch.exp(log_scale), rtol=0, atol=0)
