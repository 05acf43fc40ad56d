"""Fused fcomb multi-sample mean-decode: CUDA kernel and plain version.

Counterpart of ``pmpu_tpu/ops/pallas/fcomb_mean.py::fcomb_mean_decode``.
The mean over S prior samples of the fcomb decode, (N,H,W,C) f32, with the
rounding of ``decode_samples`` followed by ``mean(axis=0)``: every matmul
accumulates in f32 and rounds to the compute dtype, biases add in the
compute dtype, the head casts to f32, and the samples are summed in order
in f32 and divided by S.

The z half of layer 0, ``zs @ k0[Cf:] + b0`` of shape (S,N,f0), is a plain
torch matmul outside the kernel (the JAX package also computes it outside
its kernel); everything per pixel runs in ``csrc/fcomb_mean.cu``.

``fcomb_params`` maps the fcomb's torch parameter names (``layers.0.weight``,
``layers.0.bias``, ..., ``last_layer.weight``) to tensors, the port's
counterpart of ``variables["params"]["fcomb"]`` — see
``ProbabilisticUNet.fcomb_params``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

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
    """Matmul with f32 accumulation rounded once to ``cd``."""
    return (x.float() @ w.float()).to(cd)


def _z_half(zs, m: FcombMatrices, cd):
    return _mm(zs.to(cd), m.k0z, cd) + m.b0  # (S, N, f0)


def _decode_one(fh, zh_s, m: FcombMatrices, cd):
    """One sample's logits (N,H,W,C) f32 from the rounded feature half."""
    x = torch.relu(fh + zh_s[:, None, None, :])
    for w, b in zip(m.hidden, m.hidden_bias):
        x = torch.relu(_mm(x, w, cd) + b)
    return (_mm(x, m.head, cd) + m.head_bias).float()


def _decode_samples(feats, zs, fcomb_params, no_convs_fcomb, dtype):
    cd = dtype or torch.float32
    m = fcomb_matrices(fcomb_params, no_convs_fcomb, feats.shape[-1], cd)
    fh = _mm(feats.to(cd), m.k0f, cd)
    zh = _z_half(zs, m, cd)
    for s in range(zs.shape[0]):
        yield _decode_one(fh, zh[s], m, cd)


def decode_samples_reference(feats, zs, fcomb_params, no_convs_fcomb=4, dtype=None):
    """(S,N,latent) draws → (S,N,H,W,C) f32 logits (the plain factored
    fcomb of ``ProbabilisticUNet.decode_samples``)."""
    return torch.stack(list(_decode_samples(feats, zs, fcomb_params, no_convs_fcomb, dtype)))


def fcomb_mean_decode_reference(feats, zs, fcomb_params, no_convs_fcomb=4, dtype=None):
    """Plain version of the kernel: the in-order f32 sum of the S decodes,
    divided by S (one sample's activations live at a time)."""
    acc = None
    for y in _decode_samples(feats, zs, fcomb_params, no_convs_fcomb, dtype):
        acc = y if acc is None else acc + y
    return acc / zs.shape[0]


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
    m = fcomb_matrices(fcomb_params, no_convs_fcomb, cf, cd)
    dev = feats.device
    if m.k0f.device != dev:
        raise ValueError(f"fcomb_mean_decode: fcomb params on {m.k0f.device}, feats on {dev}")
    f0, c = m.k0f.shape[1], m.head.shape[1]
    zh = _z_half(zs, m, cd).contiguous()
    if m.hidden:
        wh = torch.stack(m.hidden).contiguous()
        bh = torch.stack(m.hidden_bias).contiguous()
    else:  # ncf 2: no hidden layer; the kernel reads nothing from these
        wh = bh = torch.empty(1, dtype=cd, device=dev)
    k0f, wl, bl = m.k0f.contiguous(), m.head.contiguous(), m.head_bias.contiguous()
    out = torch.empty((n, h, w, c), dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.pmpu_fcomb_mean_decode(
            feats.data_ptr(), zh.data_ptr(), k0f.data_ptr(), wh.data_ptr(),
            bh.data_ptr(), wl.data_ptr(), bl.data_ptr(), out.data_ptr(),
            n, h * w, cf, f0, len(m.hidden), c, zs.shape[0], int(cd == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(lib, rc, f"fcomb_mean_decode (N={n}, HW={h * w}, Cf={cf}, f0={f0}, "
                          f"C={c}, S={zs.shape[0]}, ncf={no_convs_fcomb})")
    fcomb_mean_decode.launches += 1
    return out


fcomb_mean_decode.launches = 0  # kernel launches since the last reset


def _library():
    lib = _build.library("fcomb_mean")
    fn = lib.pmpu_fcomb_mean_decode
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib
