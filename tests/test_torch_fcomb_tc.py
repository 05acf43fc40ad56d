"""The fcomb mean-decode kernel's tensor-core route, as far as the CPU can
hold it: the zero padding that the kernel's weight image carries is exact,
the packed image unpacks to the fcomb's matrices, the route follows dtype
and shape, the packed bf16x2 epilogue rounds as the plain version does, and
the plain version agrees with the JAX Pallas kernel at full fcomb width."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pmpu_tpu.ops.pallas.fcomb_mean import fcomb_mean_decode as jax_fcomb_mean_decode
from pmpu_tpu_torch.ops.cuda import fcomb_mean as fm

BF16, F32 = torch.bfloat16, torch.float32


def _params(seed, cf, f0, latent, c, ncf, integer=False):
    """Random fcomb weights by torch name (OIHW) and as the JAX tree;
    ``integer``: weights in {-1, 0, 1} and biases in {-2, ..., 2}."""
    rng = np.random.default_rng(seed)
    torch_p, jax_p = {}, {}

    def layer(tname, jname, cin, cout):
        if integer:
            w = rng.integers(-1, 2, (cout, cin)).astype(np.float32)
            b = rng.integers(-2, 3, cout).astype(np.float32)
        else:
            w = (rng.standard_normal((cout, cin)) / np.sqrt(cin)).astype(np.float32)
            b = (0.1 * rng.standard_normal(cout)).astype(np.float32)
        torch_p[f"{tname}.weight"] = torch.from_numpy(w[:, :, None, None].copy())
        torch_p[f"{tname}.bias"] = torch.from_numpy(b)
        jax_p[jname] = {"conv": {"kernel": w.T[None, None].copy(), "bias": b}}

    layer("layers.0", "layer0", cf + latent, f0)
    for i in range(1, ncf - 1):
        layer(f"layers.{2 * i}", f"layer{i}", f0, f0)
    layer("last_layer", "last_layer", f0, c)
    return torch_p, jax_p


def _inputs(seed, n, hw, cf, s, latent):
    rng = np.random.default_rng(seed)
    feats = np.maximum(rng.standard_normal((n, hw, hw, cf)), 0).astype(np.float32)
    zs = rng.standard_normal((s, n, latent)).astype(np.float32)
    return feats, zs


@pytest.mark.parametrize("c", [1, 2, 3])
@pytest.mark.parametrize("f0", [4, 8, 64])
@pytest.mark.parametrize("ncf", [2, 3, 4])
@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
def test_padding_is_exact(dtype, ncf, f0, c):
    """The plain version fed the zero-padded matrices the kernel holds (Cf
    24 -> 32, f0 to a power of two >= 16, C to 8) and zero-padded features
    gives the unpadded result bit for bit, and zeros in the padded classes.
    Weights and inputs are small integers, so that every f32 sum is exact
    in any order: the CPU BLAS sums in another order when a width changes
    (a matrix-vector product at C = 1), and that is not what is checked."""
    cf = 24
    torch_p, _ = _params(f0 * 10 + ncf + c, cf, f0, 3, c, ncf, integer=True)
    rng = np.random.default_rng(ncf + c)
    feats = torch.from_numpy(rng.integers(0, 3, (2, 6, 6, cf)).astype(np.float32)).to(dtype)
    zs = torch.from_numpy(rng.integers(-1, 2, (3, 2, 3)).astype(np.float32))
    m = fm.fcomb_matrices(torch_p, ncf, cf, dtype)
    lay = fm.tc_layout(cf, f0, ncf - 2)
    assert lay.cfp == 32 and lay.f0p == max(16, f0)
    padded = fm.pad_fcomb_matrices(m, lay.cfp, lay.f0p, fm.TC_HEAD_ROWS)
    want = fm.mean_decode_matrices(feats, zs, m, dtype)
    got = fm.mean_decode_matrices(F.pad(feats, (0, lay.cfp - cf)), zs, padded, dtype)
    assert got.shape == want.shape[:-1] + (fm.TC_HEAD_ROWS,)
    assert torch.equal(got[..., :c], want)
    assert not got[..., c:].any()


@pytest.mark.parametrize("cf,f0,c,ncf", [(64, 64, 3, 4), (8, 8, 2, 2), (24, 40, 1, 3),
                                         (128, 128, 8, 5)])
def test_packed_image_unpacks_to_the_matrices(cf, f0, c, ncf):
    """Every matrix of the packed bf16 image, read back transposed at the
    layout's offsets and strides, is the fcomb's; every other entry is 0."""
    torch_p, _ = _params(cf + f0, cf, f0, 6, c, ncf)
    m = fm.fcomb_matrices(torch_p, ncf, cf, BF16)
    lay = fm.tc_layout(cf, f0, ncf - 2)
    buf = fm.pack_fcomb_weights(m, lay)
    assert buf.dtype == BF16 and buf.shape == (lay.total,)
    for ld in (lay.ldk, lay.ldf):  # 16-byte rows, an odd number of them
        assert ld % 8 == 0 and (ld // 8) % 2 == 1
    for off in lay[4:]:
        assert off % 8 == 0
    seen = torch.zeros(lay.total, dtype=torch.bool)

    def matrix(off, rows, ld, mat):  # (in, out) stored as [out][in]
        n_in, n_out = mat.shape
        assert torch.equal(buf[off:off + rows * ld].view(rows, ld)[:n_out, :n_in], mat.t())
        seen[off:off + rows * ld].view(rows, ld)[:n_out, :n_in] = True

    def vector(off, vec):
        assert torch.equal(buf[off:off + vec.numel()], vec)
        seen[off:off + vec.numel()] = True

    matrix(0, lay.f0p, lay.ldk, m.k0f)
    for i, (w, b) in enumerate(zip(m.hidden, m.hidden_bias)):
        matrix(lay.hidden + i * lay.f0p * lay.ldf, lay.f0p, lay.ldf, w)
        vector(lay.bias + i * lay.f0p, b)
    matrix(lay.head, fm.TC_HEAD_ROWS, lay.ldf, m.head)
    vector(lay.head_bias, m.head_bias)
    assert not buf[~seen].any()


def test_layout_of_the_main_path():
    """Cf = f0 = 64, two hidden layers: the offsets the CUDA source's
    tc::layout computes for the same arguments."""
    assert tuple(fm.tc_layout(64, 64, 2)) == (64, 64, 72, 72, 4608, 13824, 14400, 14528, 14536)
    assert fm.tc_layout(8, 4, 0).f0p == 16 and fm.tc_layout(8, 48, 0).f0p == 64


def test_packed_weights_made_once_per_set_of_weights():
    torch_p, _ = _params(5, 16, 16, 3, 3, 4)
    first = fm._tc_weights(torch_p, 4, 16)
    assert fm._tc_weights(dict(torch_p), 4, 16)[2] is first[2]
    with torch.no_grad():
        torch_p["layers.2.weight"].mul_(2.0)  # an in-place reload bumps the version
    again = fm._tc_weights(torch_p, 4, 16)
    assert again[2] is not first[2]
    assert torch.equal(again[0].hidden[0], torch_p["layers.2.weight"][:, :, 0, 0].t().to(BF16))


@pytest.mark.parametrize("cf,f0,c,dtype,route", [
    (64, 64, 3, BF16, "tensor_core"),    # the main path
    (8, 8, 3, BF16, "tensor_core"),
    (16, 128, 8, BF16, "tensor_core"),
    (128, 16, 1, BF16, "tensor_core"),
    (64, 64, 3, F32, "cuda_core"),       # no exact f32 product on the tensor cores
    (64, 136, 3, BF16, "cuda_core"),     # f0 > 128
    (12, 64, 3, BF16, "cuda_core"),      # Cf % 8 != 0
    (136, 64, 3, BF16, "cuda_core"),     # Cf > 128
    (64, 64, 9, BF16, "cuda_core"),      # C > 8
])
def test_route_follows_dtype_and_shape(cf, f0, c, dtype, route):
    assert fm.fcomb_route(cf, f0, c, dtype) == route


def _bf16_bits(x32):
    """float32 -> bf16 bit patterns, round to nearest even (not for NaN)."""
    u = x32.view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)


def _bf16_bits_once(x64):
    """float64 -> bf16 bit patterns with one rounding: the significand is
    cut to 8 bits in float64 (nearest even), then the exact value is
    narrowed (normal results only; NaN excluded)."""
    u = x64.view(np.uint64)
    lsb = (u >> np.uint64(45)) & np.uint64(1)
    r = (u + np.uint64((1 << 44) - 1) + lsb) & ~np.uint64((1 << 45) - 1)
    with np.errstate(over="ignore"):
        return _bf16_bits(r.view(np.float64).astype(np.float32))


def test_packed_epilogue_rounds_once():
    """A bf16 sum rounded once (the kernel's __hadd2) equals the f32 sum of
    the same operands rounded to bf16 (the plain version's add), over 10^6
    pairs with exponent gaps up to 40, infinities and NaN."""
    rng = np.random.default_rng(11)
    n = 1_000_000
    exp_a = rng.integers(127 - 90, 127 + 90, n)
    gap = np.where(rng.random(n) < 0.5, rng.integers(0, 41, n), rng.integers(0, 8, n))
    exp_b = np.clip(exp_a - gap * rng.choice([-1, 1], n), 1, 254)

    def make(exp):
        sign = rng.integers(0, 2, n) << 15
        return (sign | (exp << 7) | rng.integers(0, 128, n)).astype(np.uint16)

    a, b = make(exp_a), make(exp_b)
    special = np.array([0x7F80, 0xFF80, 0x7FC0, 0x0000, 0x8000], np.uint16)  # +-inf, NaN, +-0
    pick = rng.random(n) < 0.01
    a[pick] = special[rng.integers(0, len(special), pick.sum())]
    a32 = (a.astype(np.uint32) << 16).view(np.float32)
    b32 = (b.astype(np.uint32) << 16).view(np.float32)
    assert (gap > 16).sum() > 100_000
    with np.errstate(over="ignore", invalid="ignore"):
        s32 = a32 + b32
        s64 = a32.astype(np.float64) + b32.astype(np.float64)
    nan = np.isnan(s32)
    assert np.array_equal(nan, np.isnan(s64)) and nan.any()
    assert np.isinf(s32).any()
    np.testing.assert_array_equal(_bf16_bits_once(s64[~nan]), _bf16_bits(s32[~nan]))


def test_plain_matches_pallas_full_width_bf16():
    """f0 = Cf = 64 (the main path's fcomb width), N = 2, 16², bf16, S = 5,
    ncf 4: the port's plain version against the Pallas kernel in interpret
    mode, within one bf16 rounding step of the logit scale, argmax equal on
    >= 99% of pixels (the tolerance of test_fcomb_reference_matches_pallas_bf16)."""
    torch_p, jax_p = _params(7, 64, 64, 6, 3, 4)
    feats, zs = _inputs(8, 2, 16, 64, 5, 6)
    want = np.asarray(jax_fcomb_mean_decode(
        jnp.asarray(feats), jnp.asarray(zs), jax_p, no_convs_fcomb=4, dtype=jnp.bfloat16,
        tile_pixels=64, interpret=True))
    got = fm.fcomb_mean_decode_reference(
        torch.from_numpy(feats).to(BF16), torch.from_numpy(zs), torch_p, 4, BF16).numpy()
    assert got.shape == want.shape == (2, 16, 16, 3)
    scale = max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -7 * scale)
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.99
