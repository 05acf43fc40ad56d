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


def _seed_stripe_rows(metas, h, w):
    """The stripe plan before the weight ring: the tallest stripe whose two
    activation buffers alone fit."""
    for th in range(h, 0, -1):
        sh = th + 2 * sum(m[0] == 9 for m in metas)
        need, c = [0, 0], 0
        for li, (ntap, cin_pad, _) in enumerate(metas):
            need[li % 2] = max(need[li % 2], (sh - 2 * c) * (w + 2) * (cin_pad + 16))
            c += ntap == 9
        if sum(-(-b // 16) * 16 for b in need) <= qconv.SMEM_LIMIT:
            return th
    raise AssertionError("no stripe fits")


# the nine distinct chain shapes of the full-width int8 probunet (filters
# 64..1024 at 128² down to 8²): inc (Cin = 1), the down blocks, the decoder
# blocks (their first layer split); (metas, H = W, output dtype)
FULL_WIDTH_CHAINS = [
    (((9, 32, 64), (9, 64, 64)), 128, torch.int8),
    (((9, 64, 128), (9, 128, 128)), 64, torch.int8),
    (((9, 128, 256), (9, 256, 256)), 32, torch.float32),
    (((9, 256, 512), (9, 512, 512)), 16, torch.int8),
    (((9, 512, 1024), (9, 1024, 1024)), 8, torch.float32),
    (((9, 1024, 512), (9, 512, 512)), 16, torch.bfloat16),
    (((9, 512, 256), (9, 256, 256)), 32, torch.bfloat16),
    (((9, 256, 128), (9, 128, 128)), 64, torch.bfloat16),
    (((9, 128, 64), (9, 64, 64)), 128, torch.bfloat16),
]


@pytest.mark.parametrize("metas,h,out_dtype", FULL_WIDTH_CHAINS + [
    (((9, 32, 32), (9, 32, 32)), 8, torch.float32),  # the whole image fits
    (((1, 64, 64),), 128, torch.float32),            # one 1x1 layer stages its output
])
def test_stripe_plan_fits_shared_memory(metas, h, out_dtype):
    """The plan (buffers, the last layer's staging, the weight ring) fits
    in shared memory, cuts the image into at most one stripe more than the
    plan without a ring did, and its rounds cover every tile once, each
    within 8 tiles and the ring's n-tiles."""
    osz = qconv._OUT_SIZE[out_dtype]
    th, buf, slots = qconv._plan(metas, h, h, None, osz)
    assert 1 <= th <= h and 1 <= slots <= qconv.WARPS
    assert sum(buf) + qconv.STAGES * qconv.SLOT_BYTES * slots <= qconv.SMEM_LIMIT
    if len(metas) > 1:
        assert -(-h // th) <= -(-h // _seed_stripe_rows(metas, h, h)) + 1
    if h == 8:
        assert th == h
    assert buf[len(metas) % 2] >= qconv.WARPS * qconv.TILE_M * qconv._stage_pitch(osz)
    assert qconv.stripe_rows(metas, h, h, None, osz) == th
    for m, li in set(qconv._layer_pixels(metas, h, h, th)):
        mtiles = -(-m // qconv.TILE_M)
        ntiles = metas[li][2] // 32
        rounds = qconv._rounds(mtiles, ntiles, slots)
        assert [r0 for r0, _ in rounds[1:]] == [r1 for _, r1 in rounds[:-1]]
        assert rounds[0][0] == 0 and rounds[-1][1] == mtiles * ntiles
        for r0, r1 in rounds:
            assert 0 < r1 - r0 <= qconv.WARPS
            assert (r1 - 1) // mtiles - r0 // mtiles < slots


def test_stripe_plan_checks():
    """A stripe that cannot fit raises; a given tile_h is kept."""
    with pytest.raises(ValueError, match="shared memory"):
        qconv.stripe_rows([(9, 4096, 4096)], 64, 64)
    assert qconv.stripe_rows([(9, 32, 32), (9, 32, 32)], 12, 12, tile_h=4) == 4
    x = torch.zeros((2, 16, 16, 24), dtype=torch.int8)
    layers = qconv.make_random_chain(0, [(24, 40), (40, 72)])
    metas, th, buf, slots = qconv.launch_plan(x, layers, torch.float32)
    assert metas == [(9, 32, 64), (9, 64, 96)] and th == 16 and slots == 2


def _image_byte(wk, tap, k, n):
    """The byte of the weight image that the kernel reads as input channel
    k (padded numbering), output channel n of a tap: slice (tap, k // 32,
    n // 32); lane (g, t) of 8-channel block jn = 2·jp + e loads the 16
    bytes at ((jp·8 + g)·4 + t)·16, e selects their 8-byte half, hi = k % 32
    // 16 the B register, k % 4 its byte."""
    kc, kk = np.divmod(k, 32)
    nt, nn = np.divmod(n, 32)
    jn, g = np.divmod(nn, 8)
    jp, e = np.divmod(jn, 2)
    hi, r = np.divmod(kk, 16)
    t, b = np.divmod(r, 4)
    return wk[tap, kc, nt, ((jp * 8 + g) * 4 + t) * 16 + e * 8 + hi * 4 + b]


@pytest.mark.parametrize("cin,cout,split,kernel", [
    (64, 40, 24, 3),    # split 24 + 40, cout not a multiple of 32
    (256, 64, 128, 3),  # split 128 + 128
    (1, 64, None, 3),   # Cin = 1
    (40, 72, None, 1),  # 1x1, both padded
    (96, 24, None, 3),
])
def test_weight_image_reads_back_hwio(cin, cout, split, kernel):
    """The packed weight image, read through the kernel's index map, gives
    the HWIO weights bit for bit, and zero in every padding channel."""
    layer = qconv.make_random_chain(int(RNG.integers(1000)), [(cin, cout)], kernel)[0]
    wk = qconv._kernel_weights(layer, split).numpy()
    w = layer["w"].numpy().reshape(kernel * kernel, cin, cout)
    groups = [(0, split), (split, cin)] if split else [(0, cin)]
    cin_pad = sum(-(-(hi - lo) // 32) * 32 for lo, hi in groups)
    cout_pad = -(-cout // 32) * 32
    assert wk.shape == (kernel * kernel, cin_pad // 32, cout_pad // 32, qconv.SLOT_BYTES)
    want = np.zeros((kernel * kernel, cin_pad, cout_pad), np.int8)
    k0 = 0
    for lo, hi in groups:
        want[:, k0:k0 + hi - lo, :cout] = w[:, lo:hi]
        k0 += -(-(hi - lo) // 32) * 32
    tap, k, n = np.meshgrid(np.arange(kernel * kernel), np.arange(cin_pad), np.arange(cout_pad),
                            indexing="ij")
    np.testing.assert_array_equal(_image_byte(wk, tap, k, n), want)
    assert qconv._kernel_weights(layer, split) is qconv._kernel_weights(layer, split)  # cached


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


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reciprocal_quant_rule_matches_ieee_divide(seed):
    """The kernel's epilogue requantizes by q = RN(v · RN(1/xs)) and takes
    the IEEE divide only where q lies within 2^-13 of a half-integer (below
    |q| = 200): in float32, every value outside that band rounds and clips
    to the integer of clip(rint(RN(v / xs))), including values a few ulps
    from a half-integer step, zeros, infinities, NaN and huge values."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    xs = (10.0 ** rng.uniform(-4, 1, 64)).astype(f32)
    for x in xs:
        k = rng.integers(-160, 160, 20000).astype(f32) + f32(0.5)
        ulps = rng.integers(-64, 65, k.size).astype(np.int32)
        near_half = (k * x).astype(f32).view(np.int32) + ulps
        v = np.concatenate([
            near_half.view(f32),
            (rng.standard_normal(20000) * 127 * x).astype(f32),
            (rng.standard_normal(2000) * 1e6 * x).astype(f32),
            np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 3e38, -3e38, 1e-40], f32),
        ])
        with np.errstate(over="ignore", invalid="ignore"):
            q = v * (f32(1) / x)
            near = (np.abs((q - np.floor(q)) - f32(0.5)) <= f32(2.0 ** -13)) & (np.abs(q) < 200)
            exact = np.clip(np.rint(v / x), -127, 127)
            fast = np.clip(np.rint(q), -127, 127)
        nan_as = lambda a: np.where(np.isnan(a), -127, a)  # noqa: E731  fmaxf(NaN, -127)
        assert q.dtype == f32 and near[20000:40000].mean() < 0.01  # the divide stays rare
        np.testing.assert_array_equal(nan_as(fast)[~near], nan_as(exact)[~near])


def test_clock_build_is_a_library_of_its_own():
    """The phase-clock build is the same source with one define, under its
    own name and hash; the default build never includes it."""
    from pmpu_tpu_torch.ops.cuda import _build

    src, flags = _build._source_flags("qconv_clocks")
    assert src == _build.CSRC / "qconv.cu" and "-DPMPU_QCONV_CLOCKS" in flags
    assert "-DPMPU_QCONV_CLOCKS" not in _build._source_flags("qconv")[1]
    assert _build.target("qconv_clocks") != _build.target("qconv")
    assert "qconv_clocks" not in _build.SOURCES
    names = qconv.clock_slot_names(2)
    assert names == {0: "zero", 1: "load", 15: "total", 2: "mma0", 3: "epi0", 4: "wait0",
                     5: "mma1", 6: "epi1", 7: "wait1"}


def test_sweep_refuses_to_run_without_a_card(monkeypatch, capsys):
    from pmpu_tpu_torch.tools import qconv_sweep

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("sys.argv", ["qconv_sweep"])
    assert qconv_sweep.main() == 2
    assert "no CUDA device" in capsys.readouterr().err
