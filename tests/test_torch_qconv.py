"""The plain version of the port's int8 conv-chain kernel (what
``fused_qchain`` runs on CPU tensors) against the JAX package's
``chain_reference`` (XLA) and ``np_oracle``, on the same numpy layers:
bit-equal in f32 and in bf16. Plus the split-input first layer against
``quantized._split_dec_conv``, and the wrapper's checks."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from pmpu_tpu.models import quantized as jax_qz
from pmpu_tpu.ops.pallas import qconv as jax_qconv
from pmpu_tpu_torch.ops.cuda import qconv

RNG = np.random.default_rng(7)


def _jax_layers(layers):
    return [{k: jnp.asarray(v.numpy()) for k, v in l.items()} for l in layers]


def _input(n, hw, cin, scale=0.5):
    return (RNG.standard_normal((n,) + tuple(hw) + (cin,)) * scale).astype(np.float32)


@pytest.mark.parametrize("shapes,hw,kernel", [
    ([(8, 16), (16, 16)], (8, 8), 3),       # DoubleConv shape family
    ([(4, 8)], (5, 7), 3),                  # single conv, odd non-square
    ([(8, 8), (8, 4), (4, 4)], (6, 6), 3),  # 3-layer chain
    ([(1, 8), (8, 8)], (8, 8), 3),          # Cin=1 (the network input)
    ([(8, 16)], (4, 4), 1),                 # 1x1
])
def test_plain_chain_bitequal_to_jax_and_oracle(shapes, hw, kernel):
    layers = qconv.make_random_chain(int(RNG.integers(1000)), shapes, kernel)
    x = _input(2, hw, shapes[0][0])
    got = qconv.fused_qchain(torch.from_numpy(x), layers, torch.float32).numpy()
    jl = _jax_layers(layers)
    np.testing.assert_array_equal(got, jax_qconv.np_oracle(x, jl))
    np.testing.assert_array_equal(
        got, np.asarray(jax_qconv.chain_reference(jnp.asarray(x), jl, out_dtype=jnp.float32)))
    np.testing.assert_array_equal(qconv.np_oracle(x, layers), got)


def test_plain_chain_on_jax_random_layers():
    """Layers from the JAX package's own make_random_chain, fed to both."""
    jl = jax_qconv.make_random_chain(jax.random.PRNGKey(4), [(4, 8), (8, 8)])
    layers = [{k: torch.from_numpy(np.array(v)) for k, v in l.items()} for l in jl]
    x = _input(3, (7, 9), 4)
    got = qconv.chain_reference(torch.from_numpy(x), layers, torch.float32).numpy()
    np.testing.assert_array_equal(got, jax_qconv.np_oracle(x, jl))


def test_plain_chain_bf16_output_equals_jax():
    layers = qconv.make_random_chain(5, [(8, 8), (8, 8)])
    x = _input(2, (8, 8), 8)
    got = qconv.fused_qchain(torch.from_numpy(x), layers, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    want = np.asarray(jax_qconv.chain_reference(jnp.asarray(x), _jax_layers(layers),
                                                out_dtype=jnp.bfloat16))
    np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32))
    # a bf16 input is quantized from its f32 value
    xb = torch.from_numpy(x).to(torch.bfloat16)
    np.testing.assert_array_equal(
        qconv.fused_qchain(xb, layers, torch.float32).numpy(),
        jax_qconv.np_oracle(x.astype(ml_dtypes.bfloat16).astype(np.float32), _jax_layers(layers)))


def test_plain_chain_edge_zero_padding():
    """A constant image: corners see 4 taps, the interior 9."""
    layers = qconv.make_random_chain(3, [(4, 4)])
    x = np.ones((1, 6, 6, 4), np.float32)
    got = qconv.fused_qchain(torch.from_numpy(x), layers, torch.float32).numpy()
    np.testing.assert_array_equal(got, jax_qconv.np_oracle(x, _jax_layers(layers)))
    assert not np.allclose(got[0, 0, 0], got[0, 3, 3])


@pytest.mark.parametrize("out_dtype", [torch.int8, torch.float32, torch.bfloat16])
def test_split_first_layer_matches_jax_split_dec_conv(out_dtype):
    """conv(concat(skip, up)) as two int8 halves at their own scales,
    summed in f32 (JAX ``_split_dec_conv``), bit for bit."""
    layer = qconv.make_random_chain(8, [(10, 8)])[0]
    skip = RNG.integers(-127, 128, (2, 7, 9, 6)).astype(np.int8)
    up = RNG.integers(-127, 128, (2, 7, 9, 4)).astype(np.int8)
    s_skip, s_up, out_xs = (np.float32(v) for v in (0.021, 0.034, 0.05))
    t = lambda v: torch.tensor(v)  # noqa: E731
    got = qconv.fused_qchain(torch.from_numpy(skip), [layer], out_dtype, x_scale=t(s_skip),
                             x2=torch.from_numpy(up), x2_scale=t(s_up), out_xs=t(out_xs))
    jdt = {torch.int8: jnp.int8, torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
    want = jax_qz._split_dec_conv(
        jnp.asarray(skip), jnp.asarray(s_skip), jnp.asarray(up), jnp.asarray(s_up),
        _jax_layers([layer])[0], out_xs=jnp.asarray(out_xs) if out_dtype == torch.int8 else None,
        act_dtype=jdt[out_dtype])
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want).astype(np.float32))


def test_int8_in_out_chain_matches_jax_qconv_r():
    """int8 input at its edge scale, int8 output at the next edge's scale:
    the resident encoder's ``_qconv_r`` pair."""
    c0, c1 = qconv.make_random_chain(9, [(8, 8), (8, 8)])
    xq = RNG.integers(-127, 128, (2, 6, 6, 8)).astype(np.int8)
    edge, nxt = np.float32(0.02), np.float32(0.07)
    got = qconv.fused_qchain(torch.from_numpy(xq), [c0, c1], torch.int8,
                             x_scale=torch.tensor(edge), out_xs=torch.tensor(nxt))
    j0, j1 = _jax_layers([c0, c1])
    h = jax_qz._qconv_r(jnp.asarray(xq), jnp.asarray(edge), j0, out_xs=j1["xs"])
    want = jax_qz._qconv_r(h, j1["xs"], j1, out_xs=jnp.asarray(nxt))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_tile_and_layer_checks():
    """The JAX kernel's tile_h and _prep_layer errors, raised on the CPU too."""
    layers = qconv.make_random_chain(0, [(4, 4), (4, 4)])
    x = torch.ones((1, 12, 12, 4))
    with pytest.raises(ValueError, match="divisible"):
        qconv.fused_qchain(x, layers, tile_h=10)
    with pytest.raises(ValueError, match="multiple"):
        qconv.fused_qchain(x, layers, tile_h=3)
    for bad in (0, -2):
        with pytest.raises(ValueError, match="positive"):
            qconv.fused_qchain(x, layers, tile_h=bad)
    only1x1 = qconv.make_random_chain(1, [(4, 4)], kernel=1)
    with pytest.raises(ValueError, match="3x3"):
        qconv.fused_qchain(x, only1x1, tile_h=4)
    # a valid tiling and tile_h >= H run the same function
    full = qconv.fused_qchain(x, layers, torch.float32)
    assert torch.equal(qconv.fused_qchain(x, layers, torch.float32, tile_h=4), full)
    assert torch.equal(qconv.fused_qchain(x, layers, torch.float32, tile_h=12), full)
    uncal = qconv.make_random_chain(0, [(4, 4)])
    uncal[0]["xs"] = None
    with pytest.raises(ValueError, match="calibrated"):
        qconv.fused_qchain(torch.ones((1, 4, 4, 4)), uncal)
    fake = qconv.make_random_chain(0, [(4, 4)])
    fake[0]["w"] = fake[0]["w"].float()
    with pytest.raises(ValueError, match="int8"):
        qconv.fused_qchain(torch.ones((1, 4, 4, 4)), fake)
    with pytest.raises(ValueError, match="Cin"):
        qconv.fused_qchain(torch.ones((1, 4, 4, 3)), layers)
    with pytest.raises(ValueError, match="out_xs"):
        qconv.fused_qchain(x, layers, torch.int8)


def test_stripe_plan_fits_shared_memory():
    """Whole image when it fits; else the tallest stripe that fits, for
    the full-width chains of the int8 path."""
    assert qconv.stripe_rows([(9, 32), (9, 32)], 8, 8) == 8
    for metas, h in [([(9, 32), (9, 64)], 128), ([(9, 64), (9, 128)], 64),
                     ([(9, 512), (9, 1024)], 8), ([(9, 1024), (9, 512)], 16),
                     ([(9, 128), (9, 64)], 128)]:
        th = qconv.stripe_rows(metas, h, h)
        assert 1 <= th <= h
        assert sum(qconv.buffer_bytes(metas, h, th)) <= qconv.SMEM_LIMIT
        assert th == h or sum(qconv.buffer_bytes(metas, h, th + 1)) > qconv.SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        qconv.stripe_rows([(9, 4096)], 64, 64)


def test_wrapper_takes_plain_path_on_cpu_and_raises_elsewhere(monkeypatch):
    """Without CUDA, CPU tensors run the plain version and launch nothing;
    any other device raises (no fallback)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    layers = qconv.make_random_chain(2, [(4, 8)])
    x = torch.from_numpy(_input(1, (5, 5), 4))
    before = qconv.fused_qchain.launches
    got = qconv.fused_qchain(x, layers, torch.float32)
    assert torch.equal(got, qconv.chain_reference(x, layers, torch.float32))
    assert qconv.fused_qchain.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        qconv.fused_qchain(torch.empty((1, 5, 5, 4), device="meta"), layers)
