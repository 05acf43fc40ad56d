"""The port's int8 post-training quantization (pmpu_tpu_torch.models.quantized)
against the JAX package's (pmpu_tpu.models.quantized), on the CPU, in f32:
the quantized trees, the calibration path, the int8-resident forward and
prior tower with scales from the JAX package's scale file, the scale file
in both directions, and the int8 fcomb."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmpu_tpu.models import quantized as jq
from pmpu_tpu_torch.models import quantized as pq
from tests.test_torch_weights import jax_task_and_variables, port_task

RNG = np.random.default_rng(21)
F32 = dict(dtype=jnp.float32), dict(dtype=torch.float32)


def _pair(name, nf, cube=16):
    jtask, v = jax_task_and_variables(name, nf, 3, cube=cube)
    task = port_task(name, nf, 3, variables=v)
    return jtask, jax.tree_util.tree_map(jnp.asarray, v), task


def _x(n, s):
    return RNG.random((n, s, s, 1)).astype(np.float32)


def _assert_layers_equal(jax_layers, port_layers, keys=("w", "ws", "b")):
    jax_layers, port_layers = list(jax_layers), list(port_layers)
    assert len(jax_layers) == len(port_layers)
    for a, b in zip(jax_layers, port_layers):
        for k in keys:
            want_dtype = torch.int8 if np.asarray(a[k]).dtype == np.int8 else torch.float32
            assert b[k].dtype == want_dtype, k
            np.testing.assert_array_equal(b[k].numpy(), np.asarray(a[k]), err_msg=k)


def test_quantize_unet_tree_equals_jax():
    nf = (4, 8, 16)
    _, v, task = _pair("unet", nf)
    _assert_layers_equal(jq._walk_unet_layers(jq.quantize_unet(v, nf), nf),
                         pq._walk_unet_layers(pq.quantize_unet(task.net), nf))


def test_quantize_probunet_tree_equals_jax():
    nf = (4, 8)
    jtask, v, task = _pair("probunet", nf)
    J = jq.quantize_probunet(v, jtask.net, quantize_fcomb=True)
    P = pq.quantize_probunet(task.net, quantize_fcomb=True)
    _assert_layers_equal(jq._calibrated_layers(J, nf, True), pq._calibrated_layers(P, nf, True))
    _assert_layers_equal(J["fcomb_q"]["layers"], P["fcomb_q"]["layers"])
    for k in ("k0_feat", "k0_feat_sc", "k0_z", "last_w"):
        np.testing.assert_array_equal(P["fcomb_q"][k].numpy(), np.asarray(J["fcomb_q"][k]))
    assert "posterior" not in P and "fcomb_q" not in pq.quantize_probunet(task.net)


def test_fake_quant_unet_matches_float_model():
    """BN fold + graph replication alone: within 1e-4 of the float U-Net."""
    nf = (4, 8, 16)
    _, _, task = _pair("unet", nf)
    x = torch.from_numpy(_x(2, 16))
    q = pq.quantize_unet(task.net, fake=True)
    with torch.no_grad():
        want = task.net(x)
    got = pq.unet_int8(q, x, nf, 3, dtype=torch.float32)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def test_calibration_path_equals_jax():
    """Dynamic (uncalibrated) forward within f32 noise of JAX's, and the
    scales that calibration bakes equal JAX's."""
    nf = (4, 8, 16)
    _, v, task = _pair("unet", nf)
    x = _x(3, 16)
    J, P = jq.quantize_unet(v, nf), pq.quantize_unet(task.net)
    want = np.asarray(jq.unet_int8(J, jnp.asarray(x), nf, 3, **F32[0]))
    got = pq.unet_int8(P, torch.from_numpy(x), nf, 3, **F32[1]).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    jq.calibrate_unet(J, jnp.asarray(x), nf, 3, **F32[0])
    pq.calibrate_unet(P, torch.from_numpy(x), nf, 3, **F32[1])
    dj, dp = jq.export_scales(J, nf, False), pq.export_scales(P, nf, False)
    np.testing.assert_allclose(dp["xs"], dj["xs"], rtol=1e-6)
    np.testing.assert_allclose(dp["us"], dj["us"], rtol=1e-6)


def _record(monkeypatch, module, name, out, keep=lambda r: True, caller=None):
    """Record what ``module.name`` returns (when ``keep``, and only for calls
    made from the function named ``caller`` when given)."""
    fn = getattr(module, name)

    def wrapped(*a, **k):
        r = fn(*a, **k)
        if keep(r) and (caller is None or sys._getframe(1).f_code.co_name == caller):
            out.append(np.asarray(r))
        return r

    monkeypatch.setattr(module, name, wrapped)


@pytest.mark.parametrize("nf,s", [((4, 8, 16), 16), ((4, 8, 16, 32), 24)])
def test_resident_unet_with_jax_scale_file(monkeypatch, nf, s):
    """Scales calibrated and exported by the JAX package; both resident
    forwards in f32. 24² floors to 3² at the bottleneck, so the decoder pads
    the up half back to 6² and 12² (int8 zeros). The encoder's int8 edges
    are bit-equal. An up-half code may differ: the transposed conv is a
    float conv that XLA and torch sum in different orders, and a value
    within an ulp of a rounding boundary then requantizes to the
    neighbouring code; the test prints that count."""
    _, v, task = _pair("unet", nf, cube=s)
    x = _x(2, s)
    J = jq.quantize_unet(v, nf)
    jq.calibrate_unet(J, jnp.asarray(x), nf, 3, **F32[0])
    P = pq.import_scales(pq.quantize_unet(task.net), jq.export_scales(J, nf, False), nf, False)
    assert pq._unet_tree_resident(P, nf)

    j_edges, j_up, p_edges, p_up = [], [], [], []
    _record(monkeypatch, jq, "_qconv_r", j_edges, lambda r: r.dtype == jnp.int8)
    _record(monkeypatch, jq, "_requant", j_up, caller="_unet_int8_resident")
    _record(monkeypatch, pq, "fused_qchain", p_edges, lambda r: r.dtype == torch.int8)
    _record(monkeypatch, pq, "_requant", p_up)
    want = np.asarray(jq.unet_int8(J, jnp.asarray(x), nf, 3, **F32[0]))
    got = pq.unet_int8(P, torch.from_numpy(x), nf, 3, **F32[1]).numpy()

    L = len(nf) - 1
    assert want.shape == got.shape == (2, s, s, 3)
    for je, pe in zip(j_edges[1::2][:L], p_edges):  # JAX records mid-chain codes too
        np.testing.assert_array_equal(pe, je)
    up_diff = sum(int((a != b).sum()) for a, b in zip(j_up[1:], p_up))
    print(f"up-half int8 codes that differ: {up_diff} of {sum(a.size for a in p_up)}")
    assert len(p_edges) == L and len(p_up) == L
    assert up_diff <= max(1, sum(a.size for a in p_up) // 1000)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_resident_probunet_prior_with_jax_scale_file():
    nf = (4, 8, 16)
    jtask, v, task = _pair("probunet", nf)
    x = _x(3, 16)
    J = jq.quantize_probunet(v, jtask.net)
    jq.calibrate_probunet(J, jnp.asarray(x), jtask.net, **F32[0])
    d = jq.export_scales(J, nf, True)
    P = pq.import_scales(pq.quantize_probunet(task.net), d, nf, True)
    assert pq._enc_resident(P["prior_enc"]) and pq._unet_tree_resident(P["unet"], nf)
    wf, wl, ws = jq.probunet_features_prior_int8(J, jnp.asarray(x), jtask.net, **F32[0])
    gf, gl, gs = pq.probunet_features_prior_int8(P, torch.from_numpy(x), task.net, **F32[1])
    for g, w in ((gf, wf), (gl, wl), (gs, ws)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * max(np.abs(w).max(), 1.0))
    # the calibration path of the probabilistic tree: the same scales
    P2 = pq.quantize_probunet(task.net)
    pq.calibrate_probunet(P2, torch.from_numpy(x), task.net, **F32[1])
    np.testing.assert_allclose(pq.export_scales(P2, nf, True)["xs"], d["xs"], rtol=1e-6)


def test_scale_file_round_trip_both_ways():
    """The port re-exports a JAX file unchanged; a port-calibrated file
    imports into the JAX package, whose forward then agrees with the port."""
    nf = (4, 8)
    _, v, task = _pair("unet", nf)
    x = _x(2, 16)
    J = jq.quantize_unet(v, nf)
    jq.calibrate_unet(J, jnp.asarray(x), nf, 3, **F32[0])
    dj = jq.export_scales(J, nf, False)
    P = pq.import_scales(pq.quantize_unet(task.net), dj, nf, False)
    assert pq.export_scales(P, nf, False) == dj

    P2 = pq.calibrate_unet(pq.quantize_unet(task.net), torch.from_numpy(x), nf, 3, **F32[1])
    dp = pq.export_scales(P2, nf, False)
    J2 = jq.import_scales(jq.quantize_unet(v, nf), dp, nf, False)
    assert jq.export_scales(J2, nf, False) == dp
    want = np.asarray(jq.unet_int8(J2, jnp.asarray(x), nf, 3, **F32[0]))
    got = pq.unet_int8(P2, torch.from_numpy(x), nf, 3, **F32[1]).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    with pytest.raises(ValueError, match="not calibrated"):
        pq.export_scales(pq.quantize_unet(task.net), nf, False)


def test_import_mismatches_raise_before_touching_the_tree():
    nf = (4, 8)
    jtask, v, task = _pair("probunet", nf)
    J = jq.quantize_probunet(v, jtask.net, quantize_fcomb=True)
    jq.calibrate_probunet(J, jnp.asarray(_x(2, 16)), jtask.net, **F32[0])
    d = jq.export_scales(J, nf, True)
    bad = [
        ({**d, "xs": d["xs"][:-1]}, "scales"),
        ({**d, "num_filters": [64, 128]}, "num_filters"),
        ({**d, "probabilistic": False}, "probabilistic"),
        ({**d, "fcomb_xs": d["fcomb_xs"][:-1]}, "fcomb"),
        ({**d, "us": d["us"] + [0.1]}, "up-half"),
    ]
    for dd, match in bad:
        P = pq.quantize_probunet(task.net, quantize_fcomb=True)
        with pytest.raises(ValueError, match=match):
            pq.import_scales(P, dd, nf, True)
        assert all(l.get("xs") is None for l in pq._calibrated_layers(P, nf, True))
        assert P["fcomb_q"].get("k0_feat_xs") is None
    # a version-1 file (no fingerprint, no up-half scales) imports on count
    P = pq.import_scales(pq.quantize_probunet(task.net), {"version": 1, "xs": d["xs"]}, nf, True)
    assert not pq._unet_tree_resident(P["unet"], nf) and pq._enc_resident(P["prior_enc"])


def test_int8_fcomb_matches_jax():
    """The int8 fcomb (off the engine's path; its scales ride in the file)
    from JAX's exported fcomb scales, on the same features and draws."""
    nf = (8, 16)
    jtask, v, task = _pair("probunet", nf)
    x = _x(2, 16)
    J = jq.quantize_probunet(v, jtask.net, quantize_fcomb=True)
    jq.calibrate_probunet(J, jnp.asarray(x), jtask.net, **F32[0])
    P = pq.import_scales(pq.quantize_probunet(task.net, quantize_fcomb=True),
                         jq.export_scales(J, nf, True), nf, True)
    feats = np.maximum(RNG.standard_normal((2, 16, 16, 8)), 0).astype(np.float32)
    zs = RNG.standard_normal((3, 2, 3)).astype(np.float32)
    want = np.asarray(jq.fcomb_decode_samples_int8(J["fcomb_q"], jnp.asarray(feats),
                                                   jnp.asarray(zs), **F32[0]))
    got = pq.fcomb_decode_samples_int8(P["fcomb_q"], torch.from_numpy(feats),
                                       torch.from_numpy(zs), **F32[1]).numpy()
    assert got.shape == want.shape == (3, 2, 16, 16, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    # and the float fcomb of the int8 path is the model's decode_samples
    wf = np.asarray(jq.fcomb_decode_samples(J["fcomb"], jnp.asarray(feats), jnp.asarray(zs),
                                            4, dtype=jnp.float32))
    gf = pq.fcomb_decode_samples(P["fcomb"], torch.from_numpy(feats), torch.from_numpy(zs), 4,
                                 dtype=torch.float32).numpy()
    np.testing.assert_allclose(gf, wf, rtol=0, atol=1e-6 * np.abs(wf).max())
