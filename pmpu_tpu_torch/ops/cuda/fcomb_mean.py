"""Fused fcomb multi-sample mean-decode: CUDA kernel and plain version.

Counterpart of ``pmpu_tpu/ops/pallas/fcomb_mean.py::fcomb_mean_decode``.
The mean over S prior samples of the fcomb decode, (N,H,W,C) f32, with the
rounding of ``decode_samples`` followed by ``mean(axis=0)``: every matmul
accumulates in f32 and rounds to the compute dtype, biases add in the
compute dtype, the head casts to f32, and the samples are summed in order
in f32 and divided by S.

The z half of layer 0, ``zs @ k0[Cf:] + b0`` of shape (S,N,f0), is a plain
torch matmul outside the kernel (the JAX package also computes it outside
its kernel); everything per pixel runs in ``csrc/fcomb_mean.cu``, on one
of two routes that ``fcomb_route`` picks from dtype and shape: bf16 with
Cf % 8 == 0, Cf <= 128, f0 <= 128 and C <= 8 on the tensor cores (the
weights zero-padded and packed once per set of weights, see
``pack_fcomb_weights``), everything else on the CUDA cores in f32.
``fcomb_mean_decode.launches_by_route`` counts the launches of each.

``fcomb_params`` maps the fcomb's torch parameter names (``layers.0.weight``,
``layers.0.bias``, ..., ``last_layer.weight``) to tensors, the port's
counterpart of ``variables["params"]["fcomb"]`` — see
``ProbabilisticUNet.fcomb_params``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from pmpu_tpu_torch.device import exact_f32
from pmpu_tpu_torch.ops.cuda import _build

COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


class FcombMatrices(NamedTuple):
    """The fcomb as (cin, cout) matrices in the compute dtype."""

    k0f: torch.Tensor      # (Cf, f0) feature half of layer 0
    k0z: torch.Tensor      # (latent, f0) z half of layer 0
    b0: torch.Tensor       # (f0,)
    hidden: list           # [(f0, f0)] × (ncf − 2)
    hidden_bias: list      # [(f0,)] × (ncf − 2)
    head: torch.Tensor     # (f0, C)
    head_bias: torch.Tensor  # (C,)


def fcomb_matrices(fcomb_params, no_convs_fcomb: int, cf: int, dtype) -> FcombMatrices:
    cd = dtype or torch.float32

    def mat(name):  # OIHW 1×1 conv weight → (cin, cout)
        return fcomb_params[f"{name}.weight"][:, :, 0, 0].t().to(cd)

    def bias(name):
        return fcomb_params[f"{name}.bias"].to(cd)

    k0 = mat("layers.0")
    hidden = [f"layers.{2 * i}" for i in range(1, no_convs_fcomb - 1)]
    return FcombMatrices(
        k0[:cf], k0[cf:], bias("layers.0"),
        [mat(n) for n in hidden], [bias(n) for n in hidden],
        mat("last_layer"), bias("last_layer"),
    )


def _mm(x, w, cd):
    """Matmul with f32 accumulation rounded once to ``cd`` (exact f32
    products: TF32 off whatever the process set)."""
    with exact_f32():
        return (x.float() @ w.float()).to(cd)


def _z_half(zs, m: FcombMatrices, cd):
    return _mm(zs.to(cd), m.k0z, cd) + m.b0  # (S, N, f0)


def _decode_one(fh, zh_s, m: FcombMatrices, cd):
    """One sample's logits (N,H,W,C) f32 from the rounded feature half."""
    x = torch.relu(fh + zh_s[:, None, None, :])
    for w, b in zip(m.hidden, m.hidden_bias):
        x = torch.relu(_mm(x, w, cd) + b)
    return (_mm(x, m.head, cd) + m.head_bias).float()


def _decode_samples(feats, zs, m: FcombMatrices, cd):
    fh = _mm(feats.to(cd), m.k0f, cd)
    zh = _z_half(zs, m, cd)
    for s in range(zs.shape[0]):
        yield _decode_one(fh, zh[s], m, cd)


def decode_samples_reference(feats, zs, fcomb_params, no_convs_fcomb=4, dtype=None):
    """(S,N,latent) draws → (S,N,H,W,C) f32 logits (the plain factored
    fcomb of ``ProbabilisticUNet.decode_samples``)."""
    cd = dtype or torch.float32
    m = fcomb_matrices(fcomb_params, no_convs_fcomb, feats.shape[-1], cd)
    return torch.stack(list(_decode_samples(feats, zs, m, cd)))


def mean_decode_matrices(feats, zs, m: FcombMatrices, dtype=None):
    """The plain version on the fcomb's matrices: the in-order f32 sum of
    the S decodes, divided by S (one sample's activations live at a time)."""
    cd = dtype or torch.float32
    acc = None
    for y in _decode_samples(feats, zs, m, cd):
        acc = y if acc is None else acc + y
    return acc / zs.shape[0]


def fcomb_mean_decode_reference(feats, zs, fcomb_params, no_convs_fcomb=4, dtype=None):
    """Plain version of the kernel."""
    cd = dtype or torch.float32
    m = fcomb_matrices(fcomb_params, no_convs_fcomb, feats.shape[-1], cd)
    return mean_decode_matrices(feats, zs, m, cd)


# ---------------------------------------------------------------------------
# Routes. The tensor-core route (bf16 mma.sync, ``pmpu_fcomb_mean_decode_tc``)
# holds the zero-padded weights in shared memory; the CUDA-core route (f32
# FMAs, ``pmpu_fcomb_mean_decode``) serves f32, whose products the tensor
# cores cannot take exactly, and bf16 shapes outside the tensor-core range.

ROUTES = ("tensor_core", "cuda_core")
TC_MAX_CF = 128
TC_MAX_F0 = 128
TC_HEAD_ROWS = 8  # the class head padded to one 8-wide n-tile


def fcomb_route(cf: int, f0: int, c: int, dtype) -> str:
    """The kernel body that serves a launch, from dtype and shape alone."""
    if (dtype == torch.bfloat16 and cf % 8 == 0 and 0 < cf <= TC_MAX_CF
            and 0 < f0 <= TC_MAX_F0 and 0 < c <= TC_HEAD_ROWS):
        return "tensor_core"
    return "cuda_core"


class TcLayout(NamedTuple):
    """The tensor-core route's packed weight image (csrc ``tc::layout``),
    offsets and row strides in bf16 elements: k0f^T [f0p][ldk], the hidden
    W^T [n_hidden][f0p][ldf], the head W^T [8][ldf], the hidden biases
    [n_hidden][f0p], the head bias [8]. A row stride of in + 8 puts
    ldmatrix's 8 rows in 8 distinct shared-memory bank groups."""

    cfp: int
    f0p: int
    ldk: int
    ldf: int
    hidden: int
    head: int
    bias: int
    head_bias: int
    total: int


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def tc_layout(cf: int, f0: int, n_hidden: int) -> TcLayout:
    """Cf padded to a multiple of 16, f0 to a power of two >= 16."""
    cfp = _round_up(cf, 16)
    f0p = max(16, 1 << (f0 - 1).bit_length())
    ldk, ldf = cfp + 8, f0p + 8
    hidden = f0p * ldk
    head = hidden + n_hidden * f0p * ldf
    bias = head + TC_HEAD_ROWS * ldf
    head_bias = bias + n_hidden * f0p
    return TcLayout(cfp, f0p, ldk, ldf, hidden, head, bias, head_bias,
                    _round_up(head_bias + TC_HEAD_ROWS, 8))


def pad_fcomb_matrices(m: FcombMatrices, cfp: int, f0p: int, cp: int) -> FcombMatrices:
    """The fcomb with zeros appended: Cf to ``cfp`` input channels, f0 to
    ``f0p`` hidden channels, C to ``cp`` classes. Exact: a padded channel
    is relu(rnd(0 + 0)) = 0 and adds nothing to a product."""

    def pad(x, *shape):
        out = x.new_zeros(shape)
        out[tuple(slice(0, d) for d in x.shape)] = x
        return out

    return FcombMatrices(
        pad(m.k0f, cfp, f0p), pad(m.k0z, m.k0z.shape[0], f0p), pad(m.b0, f0p),
        [pad(w, f0p, f0p) for w in m.hidden], [pad(b, f0p) for b in m.hidden_bias],
        pad(m.head, f0p, cp), pad(m.head_bias, cp),
    )


def pack_fcomb_weights(m: FcombMatrices, lay: TcLayout) -> torch.Tensor:
    """The zero-padded bf16 weight image that the tensor-core kernel copies
    into shared memory, (lay.total,) on the matrices' device."""
    p = pad_fcomb_matrices(m, lay.cfp, lay.f0p, TC_HEAD_ROWS)
    buf = torch.zeros(lay.total, dtype=torch.bfloat16, device=m.k0f.device)
    f0p = lay.f0p
    buf[:lay.hidden].view(f0p, lay.ldk)[:, :lay.cfp] = p.k0f.t()
    if p.hidden:
        buf[lay.hidden:lay.head].view(-1, f0p, lay.ldf)[:, :, :f0p] = torch.stack(
            [w.t() for w in p.hidden])
        buf[lay.bias:lay.head_bias] = torch.cat(p.hidden_bias)
    buf[lay.head:lay.bias].view(TC_HEAD_ROWS, lay.ldf)[:, :f0p] = p.head.t()
    buf[lay.head_bias:lay.head_bias + TC_HEAD_ROWS] = p.head_bias
    return buf


_PACKED: dict = {}  # packed images by the identity of their source tensors
_PACKED_MAX = 8


def _tc_weights(fcomb_params, no_convs_fcomb, cf):
    """(matrices, layout, packed image), made once per set of weights: the
    cache holds its source tensors, so a key's ids stay theirs, and compares
    their storage and version counters (an in-place reload bumps them)."""
    names = sorted(fcomb_params)
    src = tuple(fcomb_params[k] for k in names)
    key = (tuple(id(t) for t in src), no_convs_fcomb, cf)
    cacheable = not any(t.is_inference() for t in src)  # they keep no version
    state = tuple((t.data_ptr(), t._version) for t in src) if cacheable else None
    hit = _PACKED.get(key)
    if cacheable and hit is not None and hit[0] == state:
        return hit[1]
    m = fcomb_matrices(fcomb_params, no_convs_fcomb, cf, torch.bfloat16)
    lay = tc_layout(cf, m.k0f.shape[1], len(m.hidden))
    entry = (m, lay, pack_fcomb_weights(m, lay))
    if cacheable:
        _PACKED.pop(key, None)
        _PACKED[key] = (state, entry, src)
        while len(_PACKED) > _PACKED_MAX:
            _PACKED.pop(next(iter(_PACKED)))
    return entry


@torch.no_grad()
def fcomb_mean_decode(
    feats: torch.Tensor,          # (N, H, W, Cf) contiguous, compute dtype
    zs: torch.Tensor,             # (S, N, latent)
    fcomb_params: dict,
    no_convs_fcomb: int = 4,
    dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Mean over S prior samples of the fcomb decode, (N,H,W,C) f32. CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    if feats.device.type == "cpu":
        return fcomb_mean_decode_reference(feats, zs, fcomb_params, no_convs_fcomb, dtype)
    cd = dtype or torch.float32
    if feats.device.type != "cuda":
        raise ValueError(f"fcomb_mean_decode: unsupported device {feats.device}")
    if cd not in COMPUTE_DTYPES:
        raise ValueError(f"fcomb_mean_decode: compute dtype must be f32 or bf16, got {cd}")
    if feats.dim() != 4 or feats.dtype != cd:
        raise ValueError(
            f"fcomb_mean_decode: feats must be (N,H,W,Cf) {cd}, got "
            f"{tuple(feats.shape)} {feats.dtype}"
        )
    if not feats.is_contiguous():
        raise ValueError("fcomb_mean_decode: feats must be contiguous NHWC "
                         "(run the backbone in torch.channels_last)")
    if no_convs_fcomb < 2:
        raise ValueError(f"fcomb_mean_decode: no_convs_fcomb must be >= 2, got {no_convs_fcomb}")
    n, h, w, cf = feats.shape
    if zs.dim() != 3 or zs.shape[1] != n or zs.shape[0] < 1 or zs.device != feats.device:
        raise ValueError(f"fcomb_mean_decode: zs must be (S>=1, {n}, latent) on "
                         f"{feats.device}, got {tuple(zs.shape)} on {zs.device}")
    if n > 65535:
        raise ValueError(f"fcomb_mean_decode: at most 65535 slices per launch, got {n}")
    dev = feats.device
    f0 = fcomb_params["layers.0.weight"].shape[0]
    c = fcomb_params["last_layer.weight"].shape[0]
    if fcomb_params["layers.0.weight"].device != dev:
        raise ValueError(f"fcomb_mean_decode: fcomb params on "
                         f"{fcomb_params['layers.0.weight'].device}, feats on {dev}")
    s = zs.shape[0]
    route = fcomb_route(cf, f0, c, cd)
    out = torch.empty((n, h, w, c), dtype=torch.float32, device=dev)
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    if route == "tensor_core":
        if feats.data_ptr() % 16:
            raise ValueError("fcomb_mean_decode: bf16 feats must start 16-byte aligned")
        m, lay, packed = _tc_weights(fcomb_params, no_convs_fcomb, cf)
        zh = F.pad(_z_half(zs, m, cd), (0, lay.f0p - f0)).contiguous()
        with torch.cuda.device(dev):
            rc = lib.pmpu_fcomb_mean_decode_tc(
                feats.data_ptr(), zh.data_ptr(), packed.data_ptr(), out.data_ptr(),
                n, h * w, cf, lay.f0p, len(m.hidden), c, s, stream)
    else:
        m = fcomb_matrices(fcomb_params, no_convs_fcomb, cf, cd)
        zh = _z_half(zs, m, cd).contiguous()
        if m.hidden:
            wh = torch.stack(m.hidden).contiguous()
            bh = torch.stack(m.hidden_bias).contiguous()
        else:  # ncf 2: no hidden layer; the kernel reads nothing from these
            wh = bh = torch.empty(1, dtype=cd, device=dev)
        k0f, wl, bl = m.k0f.contiguous(), m.head.contiguous(), m.head_bias.contiguous()
        with torch.cuda.device(dev):
            rc = lib.pmpu_fcomb_mean_decode(
                feats.data_ptr(), zh.data_ptr(), k0f.data_ptr(), wh.data_ptr(),
                bh.data_ptr(), wl.data_ptr(), bl.data_ptr(), out.data_ptr(),
                n, h * w, cf, f0, len(m.hidden), c, s, int(cd == torch.bfloat16), stream)
    _build.check(lib, rc, f"fcomb_mean_decode {route} (N={n}, HW={h * w}, Cf={cf}, f0={f0}, "
                          f"C={c}, S={s}, ncf={no_convs_fcomb})")
    fcomb_mean_decode.launches += 1
    fcomb_mean_decode.launches_by_route[route] += 1
    return out


fcomb_mean_decode.launches = 0  # kernel launches since the last reset
fcomb_mean_decode.launches_by_route = dict.fromkeys(ROUTES, 0)  # the same, by route


def _library():
    lib = _build.library("fcomb_mean")
    fn = lib.pmpu_fcomb_mean_decode
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.pmpu_fcomb_mean_decode_tc
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib
