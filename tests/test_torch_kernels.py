"""The plain versions of the port's two CUDA kernels (what the wrappers run
on CPU tensors) against the JAX package's Pallas kernels in interpret mode
and their XLA counterparts, plus the 3-view fusion helpers."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmpu_tpu.data.sampler import sample_batch_vt
from pmpu_tpu.data.volumes import make_view_stacks
from pmpu_tpu.inference import fusion as jax_fusion
from pmpu_tpu.ops.pallas.fcomb_mean import fcomb_mean_decode as jax_fcomb_mean_decode
from pmpu_tpu.ops.pallas.slice_gather import flat_plane_index as jax_flat_plane_index
from pmpu_tpu.ops.pallas.slice_gather import pallas_sample_batch
from pmpu_tpu_torch.inference import fusion
from pmpu_tpu_torch.ops.cuda.fcomb_mean import fcomb_mean_decode, fcomb_mean_decode_reference
from pmpu_tpu_torch.ops.cuda.slice_gather import flat_plane_index, gather_normalize_planes
from tests.test_torch_weights import jax_task_and_variables, port_task

RNG = np.random.default_rng(3)


def _fcomb_case(samples, ncf, dtype=None):
    jtask, variables = jax_task_and_variables("probunet", (8, 16), ncf=ncf, dtype=dtype)
    task = port_task("probunet", (8, 16), ncf=ncf, variables=variables,
                     dtype=None if dtype is None else torch.bfloat16)
    feats = RNG.standard_normal((3, 16, 16, 8)).astype(np.float32)
    zs = RNG.standard_normal((samples, 3, 3)).astype(np.float32)
    return variables, task.net, feats, zs


@pytest.mark.parametrize("samples,ncf", [(5, 4), (4, 4), (1, 4), (3, 3), (2, 2)])
def test_fcomb_reference_matches_pallas_f32(samples, ncf):
    """f32 within 1e-6 of the Pallas kernel (interpret mode), for odd and
    even sample counts and fcomb depths 4, 3 and 2; the CPU wrapper is the
    plain version."""
    variables, net, feats, zs = _fcomb_case(samples, ncf)
    want = np.asarray(jax_fcomb_mean_decode(
        jnp.asarray(feats), jnp.asarray(zs), variables["params"]["fcomb"],
        no_convs_fcomb=ncf, dtype=jnp.float32, tile_pixels=64, interpret=True))
    t_feats, t_zs = torch.from_numpy(feats), torch.from_numpy(zs)
    got = fcomb_mean_decode_reference(t_feats, t_zs, net.fcomb_params(), ncf).numpy()
    assert got.shape == want.shape == (3, 16, 16, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    via_wrapper = fcomb_mean_decode(t_feats, t_zs, net.fcomb_params(), ncf)
    np.testing.assert_array_equal(via_wrapper.numpy(), got)


def test_fcomb_reference_matches_pallas_bf16():
    """bf16 compute: within one bf16 rounding step (2^-7 relative) of the
    logit scale, and argmax equal on >= 99% of pixels."""
    variables, net, feats, zs = _fcomb_case(5, 4, dtype=jnp.bfloat16)
    want = np.asarray(jax_fcomb_mean_decode(
        jnp.asarray(feats), jnp.asarray(zs), variables["params"]["fcomb"],
        no_convs_fcomb=4, dtype=jnp.bfloat16, tile_pixels=64, interpret=True))
    got = fcomb_mean_decode_reference(
        torch.from_numpy(feats).to(torch.bfloat16), torch.from_numpy(zs),
        net.fcomb_params(), 4, torch.bfloat16).numpy()
    scale = max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -7 * scale)
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.99


def _stacks(n=2, s=8):
    imgs = (RNG.random((n, s, s, s)) * 50).astype(np.float32)
    imgs[1, 3] = 0.0  # an all-zero plane (view 0, scan 1, slice 3)
    lbls = RNG.integers(0, 3, size=(n, s, s, s)).astype(np.int32)
    return make_view_stacks(imgs), make_view_stacks(lbls)


@pytest.mark.parametrize("s,nan", [(8, False), (13, True), (16, True)])
def test_gather_normalize_reference_bitexact(s, nan):
    """Against the Pallas kernel (interpret mode) and the XLA sampler,
    bit for bit, with repeated ids, an all-zero plane and labels; at 13²
    (169 floats, not a multiple of 4: the kernel's general path on the
    card) and with a NaN in the plane of triple (0, 2, 7), whose normalized
    plane is all NaN."""
    vt_i, vt_l = _stacks(s=s)
    if nan:
        vt_i[2, 0, 7, s // 2, 1] = np.nan  # (view, scan, slice, ...)
    triples = np.array([[1, 0, 3], [0, 1, 4], [0, 2, 7], [1, 0, 3], [1, 1, 2],
                        [1, 2, 3], [0, 0, 5], [1, 0, 3]], np.int32)
    want_i, want_l = pallas_sample_batch(jnp.asarray(vt_i), jnp.asarray(vt_l),
                                         jnp.asarray(triples), interpret=True)
    xla_i, xla_l = sample_batch_vt(jnp.asarray(vt_i), jnp.asarray(vt_l), jnp.asarray(triples))
    flat = flat_plane_index(torch.from_numpy(triples).long(), vt_i.shape[1], s)
    np.testing.assert_array_equal(
        flat.numpy(), np.asarray(jax_flat_plane_index(jnp.asarray(triples), vt_i.shape[1], s)))
    got_i, got_l = gather_normalize_planes(
        torch.from_numpy(vt_i.reshape(-1, s, s)), flat, torch.from_numpy(vt_l.reshape(-1, s, s)))
    for want_img, want_lbl in ((want_i, want_l), (xla_i, xla_l)):
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_img)[..., 0])
        np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_lbl)[..., 0])
    assert got_i[0].abs().sum() == 0  # the zero plane passes through
    assert np.isnan(got_i[2].numpy()).all() == nan


def test_normalize_view_slabs_matches_jax():
    vol = (RNG.random((12, 12, 12)) * 9).astype(np.float32)
    vol[:, 4, :] = 0.0  # a zero slice in view 1
    want = np.asarray(jax_fusion.normalize_slabs(jax_fusion.view_slabs(jnp.asarray(vol))))
    got = fusion.normalize_slabs(fusion.view_slabs(torch.from_numpy(vol)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_reassemble_and_fuse_match_jax():
    probs = RNG.random((3 * 6, 6, 6, 3)).astype(np.float32)
    want = jax_fusion.reassemble_views(jnp.asarray(probs))
    got = fusion.reassemble_views(torch.from_numpy(probs))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(
        fusion.fuse_mean(got).numpy(), np.asarray(jax_fusion.fuse_mean(list(want))))


def test_wrappers_reject_other_devices():
    """Only CPU (plain version) and CUDA (kernel) tensors are taken."""
    meta = torch.empty((2, 4, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        gather_normalize_planes(meta, torch.arange(2, device="meta"))
    net = port_task().net
    with pytest.raises(ValueError, match="unsupported device"):
        fcomb_mean_decode(torch.empty((1, 4, 4, 4), device="meta"),
                          torch.empty((1, 1, 3), device="meta"), net.fcomb_params())
