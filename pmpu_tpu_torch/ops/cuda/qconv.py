"""Fused int8 conv chain: CUDA kernel and plain version.

Counterpart of ``pmpu_tpu/ops/pallas/qconv.py`` (``fused_qchain`` :245, its
two ``pallas_call`` sites ``_fused_qchain_tiled`` :151 and ``_fused_qchain``
:216). A chain of quantized stride-1 SAME 3×3 or 1×1 convs, each layer

    q = clip(round(cur / xs), -127, 127)          int8, round half to even
    y = relu(float(int32 conv(q, w)) * (xs·ws) + b)   f32

with the int8 intermediates kept on chip. Layer dicts are those of
``pmpu_tpu_torch.models.quantized``: ``w`` (kh,kw,cin,cout) int8 (HWIO, the
JAX layout), ``ws`` and ``b`` (cout,) f32, ``xs`` a 0-d f32 tensor.

Beyond the JAX kernel, the wrapper takes what the int8-resident forward
needs: an int8 input already at scale ``x_scale``; a second int8 input
``x2`` at ``x2_scale`` whose channels follow ``x``'s (the decoder's conv over
concat(skip, up) as two int8 halves summed in f32, ``_split_dec_conv``); an
int8 output requantized at ``out_xs``; and ``relu=False`` on the last layer.

CPU tensors take the plain version (:func:`chain_reference`); CUDA tensors
launch ``csrc/qconv.cu``. The two are bit-equal: the int core is exact and
every float step is one correctly rounded operation in both.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from pmpu_tpu_torch.ops.cuda import _build

SMEM_LIMIT = 232448  # shared memory one block may opt into on sm_90
MAX_LAYERS = 4
_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _requant(y: torch.Tensor, xs) -> torch.Tensor:
    """f32 activation → int8 at scale ``xs`` (quantized.py ``_requant``)."""
    return torch.clamp(torch.round(y / xs), -127, 127).to(torch.int8)


def _int_conv(q: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The int32 sum of a SAME conv of int8 ``q`` (N,H,W,Cin) with int8 HWIO
    ``w``, as f32. Accumulated in float64, exact below 2^53 (|sum| <= 9 ·
    Cin · 127², 1.5e8 at Cin 1024), then rounded once to f32 as int32 → f32
    rounds."""
    acc = F.conv2d(q.permute(0, 3, 1, 2).double(), w.permute(3, 2, 0, 1).double(),
                   padding=w.shape[0] // 2)
    return acc.permute(0, 2, 3, 1).float()


def chain_reference(x, layers, out_dtype=torch.bfloat16, *, x_scale=None, x2=None,
                    x2_scale=None, out_xs=None, relu: bool = True):
    """Plain version of the kernel, on any device: the exact semantics of
    ``quantized._qconv`` chained through f32 intermediates (JAX
    ``chain_reference``), of ``_qconv_r`` for int8 input and of
    ``_split_dec_conv`` for a split input."""
    s = layers[0]["xs"] if x_scale is None else x_scale
    q = x if x.dtype == torch.int8 else _requant(x.float(), s)
    parts = [(q, s)] + ([(x2, x2_scale)] if x2 is not None else [])
    y = None
    for i, layer in enumerate(layers):
        if i:
            parts = [(_requant(y, layer["xs"]), layer["xs"])]
        y, c = None, 0
        for qg, sg in parts:
            cg = qg.shape[-1]
            t = _int_conv(qg, layer["w"][:, :, c:c + cg]) * (sg * layer["ws"])
            y = t if y is None else y + t
            c += cg
        y = y + layer["b"]
        if relu or i < len(layers) - 1:
            y = torch.relu(y)
    return _requant(y, out_xs) if out_dtype == torch.int8 else y.to(out_dtype)


def _prep_layer(layer):
    """Validation of qconv.py ``_prep_layer``; → (ntap, cin, cout)."""
    w = layer["w"]
    if w.dtype != torch.int8:
        raise ValueError("fused qchain needs int8 weights (not fake-quant)")
    if layer.get("xs") is None:
        raise ValueError("fused qchain needs calibrated static input scales")
    kh, kw, cin, cout = w.shape
    if (kh, kw) not in ((3, 3), (1, 1)):
        raise ValueError(f"unsupported kernel size {(kh, kw)}")
    return kh * kw, cin, cout


def _check_tile(tile_h, h, halo):
    """The row-stripe checks of qconv.py ``_fused_qchain_tiled``."""
    if tile_h <= 0:
        raise ValueError(f"tile_h must be positive, got {tile_h}")
    if halo == 0:
        raise ValueError("tiling needs a 3x3 layer (1x1-only chains have no "
                         "halo; use the whole-image kernel)")
    if tile_h % halo:
        raise ValueError(f"tile_h {tile_h} must be a multiple of halo {halo}")
    if h % tile_h:
        raise ValueError(f"H {h} must be divisible by tile_h {tile_h}")


def buffer_bytes(metas, w: int, th: int):
    """Shared-memory bytes of the kernel's two activation buffers for a
    stripe of ``th`` output rows; ``metas`` = [(ntap, cin_pad)] per layer.
    Layer k's input holds stripe rows [c_k, SH - c_k), c_k = 3×3 layers
    before k, SH = th + 2·halo; a pixel is cin_pad + 16 bytes."""
    sh = th + 2 * sum(nt == 9 for nt, _ in metas)
    need, c = [0, 0], 0
    for li, (ntap, cin_pad) in enumerate(metas):
        need[li % 2] = max(need[li % 2], (sh - 2 * c) * (w + 2) * (cin_pad + 16))
        c += ntap == 9
    return [_round_up(b, 16) for b in need]


def stripe_rows(metas, h: int, w: int, tile_h=None) -> int:
    """Output rows per block: ``tile_h`` if given (and < H), else the whole
    image when it fits in shared memory, else the most rows that fit."""
    if tile_h is not None and tile_h < h:
        candidates = [tile_h]
    else:
        candidates = range(h, 0, -1)
    for th in candidates:
        if sum(buffer_bytes(metas, w, th)) <= SMEM_LIMIT:
            return th
    raise ValueError(f"fused qchain: a stripe of {candidates[-1]} rows of width {w} "
                     f"does not fit in {SMEM_LIMIT} bytes of shared memory")


def launch_plan(x, layers, x2=None, tile_h=None):
    """The kernel's plan for a chain: ([(ntap, cin_pad)] per layer, stripe
    rows, the two buffers' bytes). Each input-channel group pads to 32."""
    cin0 = _round_up(x.shape[-1], 32) + (0 if x2 is None else _round_up(x2.shape[-1], 32))
    metas = [(l["w"].shape[0] * l["w"].shape[1],
              cin0 if i == 0 else _round_up(l["w"].shape[2], 32)) for i, l in enumerate(layers)]
    th = stripe_rows(metas, x.shape[1], x.shape[2], tile_h)
    return metas, th, buffer_bytes(metas, x.shape[2], th)


def _kernel_weights(layer, split):
    """(ntap, cout_pad8, cin_pad) int8 weights, each input-channel group
    (split at ``split``) zero-padded to a multiple of 32, every 32-channel
    chunk reordered so that the kernel's lane t finds its two mma B
    registers (channels 4t..4t+3 and 16+4t..16+4t+3) as the 8 bytes at 8t;
    cached in the layer dict under ``_wk``."""
    w = layer["w"]
    key = (split, w.data_ptr(), tuple(w.shape))
    cached = layer.get("_wk")
    if cached is not None and cached[0] == key:
        return cached[1]
    kh, kw, cin, cout = w.shape
    wt = w.reshape(kh * kw, cin, cout).permute(0, 2, 1)
    groups = [wt[..., :split], wt[..., split:]] if split else [wt]
    wk = torch.cat([
        F.pad(gw, (0, _round_up(gw.shape[-1], 32) - gw.shape[-1],
                   0, _round_up(cout, 8) - cout))
        for gw in groups
    ], dim=-1)
    ntap, cout_pad, cin_pad = wk.shape
    wk = (wk.reshape(ntap, cout_pad, cin_pad // 32, 2, 4, 4).permute(0, 1, 2, 4, 3, 5)
          .reshape(ntap, cout_pad, cin_pad).contiguous())
    layer["_wk"] = (key, wk)
    return wk


@torch.no_grad()
def fused_qchain(x, layers, out_dtype=torch.bfloat16, tile_h=None, *, x_scale=None,
                 x2=None, x2_scale=None, out_xs=None, relu: bool = True):
    """Run a chain of quantized convs (layer dicts, stride-1 SAME, 3×3 or
    1×1) fused in one kernel launch.

    x: (N,H,W,Cin) f32/bf16 (quantized at ``x_scale``, default layer 0's
    ``xs``) or int8 (already at ``x_scale``); x2: optional int8 second input
    at ``x2_scale`` (split layer 0); → (N,H,W,Cout_last) ``out_dtype``
    (f32, bf16, or int8 at ``out_xs``). ``tile_h``: output rows per stripe,
    checked as the JAX kernel checks it; None picks the whole image, or the
    tallest stripe that fits in shared memory. CPU tensors take
    :func:`chain_reference`."""
    if x.dim() != 4:
        raise ValueError(f"fused qchain: x must be (N,H,W,C), got {tuple(x.shape)}")
    n, h, w_, cin = x.shape
    metas = []
    for i, layer in enumerate(layers):
        if i == 0 and x_scale is not None and layer.get("xs") is None:
            layer = {**layer, "xs": x_scale}
        metas.append(_prep_layer(layer))
    c1 = 0 if x2 is None else x2.shape[-1]
    if metas[0][1] != cin + c1:
        raise ValueError(f"input C={cin + c1} != layer0 Cin={metas[0][1]}")
    for (_, _, co), (_, ci, _) in zip(metas, metas[1:]):
        if ci != co:
            raise ValueError(f"fused qchain: a layer of Cout={co} feeds one of Cin={ci}")
    halo = sum(nt == 9 for nt, _, _ in metas)
    if tile_h is not None and tile_h < h:
        _check_tile(tile_h, h, halo)
    if x2 is not None and (x.dtype != torch.int8 or x2.dtype != torch.int8
                           or x2.shape[:3] != x.shape[:3] or x2_scale is None):
        raise ValueError("fused qchain: a split input is two int8 tensors of one "
                         "(N,H,W) with x2_scale")
    if out_dtype not in _KINDS or x.dtype not in _KINDS:
        raise ValueError(f"fused qchain: dtypes {x.dtype} → {out_dtype} not supported")
    if out_dtype == torch.int8 and out_xs is None:
        raise ValueError("fused qchain: an int8 output needs out_xs")
    kw = dict(x_scale=x_scale, x2=x2, x2_scale=x2_scale, out_xs=out_xs, relu=relu)
    if x.device.type == "cpu":
        return chain_reference(x, layers, out_dtype, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"fused qchain: unsupported device {x.device}")
    return _launch(x, layers, metas, out_dtype, tile_h, halo, **kw)


fused_qchain.launches = 0  # kernel launches since the last reset


def _launch(x, layers, metas, out_dtype, tile_h, halo, *, x_scale, x2, x2_scale, out_xs,
            relu):
    dev = x.device
    if len(layers) > MAX_LAYERS:
        raise ValueError(f"fused qchain: at most {MAX_LAYERS} layers per launch on CUDA")
    n, h, w_, cin = x.shape
    if n > 65535:
        raise ValueError(f"fused qchain: at most 65535 images per launch, got {n}")
    split = cin if x2 is not None else None
    kmetas, th, buf = launch_plan(x, layers, x2, tile_h)
    keep, ptrs, ints = [], [], []
    for i, (layer, (ntap, lcin, cout)) in enumerate(zip(layers, metas)):
        wk = _kernel_weights(layer, split if i == 0 else None)
        ws = layer["ws"].float().contiguous()
        b = layer["b"].float().contiguous()
        xs = layer["xs"] if i or x_scale is None else x_scale
        xs = torch.as_tensor(xs, dtype=torch.float32, device=dev).reshape(())
        xs1 = None
        if i == 0 and x2 is not None:
            xs1 = torch.as_tensor(x2_scale, dtype=torch.float32, device=dev).reshape(())
        for t in (wk, ws, b, xs) + ((xs1,) if xs1 is not None else ()):
            if t.device != dev:
                raise ValueError(f"fused qchain: layer {i} tensors on {t.device}, x on {dev}")
        keep += [wk, ws, b, xs, xs1]
        cin_pad = kmetas[i][1]
        k_split = _round_up(split, 32) if (i == 0 and split) else cin_pad
        ptrs += [wk.data_ptr(), ws.data_ptr(), b.data_ptr(), xs.data_ptr(),
                 None if xs1 is None else xs1.data_ptr()]
        ints += [ntap, cin_pad, k_split, cout, wk.shape[1]]
    x = x.contiguous()
    x2 = None if x2 is None else x2.contiguous()
    oxs = None
    if out_dtype == torch.int8:
        oxs = torch.as_tensor(out_xs, dtype=torch.float32, device=dev).reshape(())
    out = torch.empty((n, h, w_, metas[-1][2]), dtype=out_dtype, device=dev)
    dims = [n, h, w_, cin, 0 if x2 is None else x2.shape[-1], _KINDS[x.dtype],
            _KINDS[out_dtype], int(relu), th, halo, buf[0], buf[1]]
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.pmpu_qconv_chain(
            x.data_ptr(), None if x2 is None else x2.data_ptr(), out.data_ptr(),
            None if oxs is None else oxs.data_ptr(),
            (ctypes.c_void_p * len(ptrs))(*ptrs), (ctypes.c_int * len(ints))(*ints),
            len(layers), (ctypes.c_int * len(dims))(*dims),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(lib, rc, f"fused_qchain (N={n}, H={h}, W={w_}, layers={ints}, th={th}, "
                          f"smem={buf})")
    fused_qchain.launches += 1
    del keep
    return out


def _library():
    lib = _build.library("qconv")
    fn = lib.pmpu_qconv_chain
    fn.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


# ---------------------------------------------------------------------------
# test helpers (qconv.py :292, :310), numpy and torch only
# ---------------------------------------------------------------------------

def make_random_chain(seed, shapes, kernel=3):
    """Random calibrated int8 layer dicts (torch, CPU) for (cin→cout)
    pairs, built with numpy: the weights of ``make_random_chain`` in the
    JAX package, drawn from another generator."""
    rng = np.random.default_rng(seed)
    layers = []
    for i, (cin, cout) in enumerate(shapes):
        wf = (rng.standard_normal((kernel, kernel, cin, cout)) * 0.2).astype(np.float32)
        amax = np.abs(wf).max(axis=(0, 1, 2))
        ws = np.where(amax > 0, amax / np.float32(127.0), np.float32(1.0)).astype(np.float32)
        w = np.clip(np.round(wf / ws), -127, 127).astype(np.int8)
        layers.append({
            "w": torch.from_numpy(w),
            "ws": torch.from_numpy(ws),
            "b": torch.from_numpy((rng.standard_normal(cout) * 0.1).astype(np.float32)),
            "xs": torch.tensor(0.011 + 0.003 * i, dtype=torch.float32),
        })
    return layers


def np_oracle(x, layers):
    """Pure-numpy chain (int64 accumulation), independent of torch's conv."""
    cur = np.asarray(x, np.float32)
    for layer in layers:
        w = np.asarray(layer["w"], np.int32)
        kh = w.shape[0]
        pad = kh // 2
        xs = np.float32(np.asarray(layer["xs"]))
        q = np.clip(np.round(cur / xs), -127, 127).astype(np.int32)
        n, h, ww, ci = q.shape
        qp = np.zeros((n, h + 2 * pad, ww + 2 * pad, ci), np.int32)
        qp[:, pad:pad + h, pad:pad + ww] = q
        acc = np.zeros((n, h, ww, w.shape[-1]), np.int64)
        for ky in range(kh):
            for kx in range(kh):
                patch = qp[:, ky:ky + h, kx:kx + ww, :]
                acc += np.einsum("nhwc,cf->nhwf", patch, w[ky, kx]).astype(np.int64)
        sv = xs * np.asarray(layer["ws"], np.float32)
        cur = np.maximum(acc.astype(np.float32) * sv + np.asarray(layer["b"], np.float32), 0.0)
    return cur
