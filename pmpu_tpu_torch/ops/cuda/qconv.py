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
import functools

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


WARPS = 8          # kWarps of csrc/qconv.cu: warps of a block, tiles of a round
STAGES = 4         # kStages: K-steps the weight ring holds (copies run 2 steps ahead)
SLOT_BYTES = 1024  # kSlotBytes: one n-tile's weight slice of one K-step (32 x 32 int8)
TILE_M = 64        # kTileM: output pixels of a warp's tile (x 32 output channels)
_OUT_SIZE = {torch.float32: 4, torch.bfloat16: 2, torch.int8: 1}


def _stage_pitch(out_size: int) -> int:
    """Bytes per pixel of the last layer's staged tile (32 channels + pad)."""
    return 32 * out_size + (32 if out_size == 4 else 16)


def buffer_bytes(metas, w: int, th: int, out_size: int = 4):
    """Shared-memory bytes of the kernel's two activation buffers for a
    stripe of ``th`` output rows; ``metas`` = [(ntap, cin_pad, cout_pad)]
    per layer. Layer k's input holds stripe rows [c_k, SH - c_k), c_k = 3×3
    layers before k, SH = th + 2·halo; a pixel is cin_pad + 16 bytes. The
    buffer that is dead during the last layer also stages its output: 8
    warps' tiles of 64 pixels of ``out_size``-byte values."""
    sh = th + 2 * sum(m[0] == 9 for m in metas)
    need, c = [0, 0], 0
    for li, (ntap, cin_pad, _) in enumerate(metas):
        need[li % 2] = max(need[li % 2], (sh - 2 * c) * (w + 2) * (cin_pad + 16))
        c += ntap == 9
    dead = len(metas) % 2
    need[dead] = max(need[dead], WARPS * TILE_M * _stage_pitch(out_size))
    return [_round_up(b, 16) for b in need]


def _layer_pixels(metas, h: int, w: int, th: int):
    """[(pixels layer li computes in a stripe, li)] over the stripes and
    layers of a launch (the kernel's lo/hi rows; rows outside the image are
    not computed)."""
    halo = sum(m[0] == 9 for m in metas)
    sh = th + 2 * halo
    out = []
    for b in range(-(-h // th)):
        g0 = b * th - halo
        r_lo, r_hi = max(0, -g0), min(sh, h - g0)
        c = 0
        for li, (ntap, _, _) in enumerate(metas):
            c += ntap == 9
            lo, hi = max(c, r_lo), min(sh - c, r_hi)
            if hi > lo:
                out.append(((hi - lo) * w, li))
    return out


def _rounds(mtiles: int, ntiles: int, slots: int):
    """The kernel's rounds over a layer's tiles (tile = mt + nt·mtiles): at
    most 8 tiles, and at most ``slots`` n-tiles, each. → [(r0, r1)]."""
    total, r0, out = mtiles * ntiles, 0, []
    while r0 < total:
        r1 = min(total, r0 + WARPS, (r0 // mtiles + slots) * mtiles)
        out.append((r0, r1))
        r0 = r1
    return out


def round_span(metas, h: int, w: int, th: int) -> int:
    """The most n-tiles (32 output channels) that one round of 8 warp tiles
    spans, over every layer of every stripe of the launch: the ring slots
    with which no round has an idle warp."""
    span = 1
    for m, li in set(_layer_pixels(metas, h, w, th)):
        mtiles = -(-m // TILE_M)
        for r0, r1 in _rounds(mtiles, metas[li][2] // 32, WARPS):
            span = max(span, (r1 - 1) // mtiles - r0 // mtiles + 1)
    return span


def round_steps(metas, h: int, w: int, th: int, slots: int) -> int:
    """K-steps that the blocks of one image's stripes run in all: every
    round runs all of its layer's K-steps, however many of its warps have a
    tile. What the plan minimizes."""
    steps = 0
    for m, li in _layer_pixels(metas, h, w, th):
        ntap, cin_pad, cout_pad = metas[li]
        mtiles = -(-m // TILE_M)
        steps += len(_rounds(mtiles, cout_pad // 32, slots)) * ntap * (cin_pad // 32)
    return steps


def _fits(metas, w, th, out_size) -> bool:
    """The two buffers fit beside the smallest weight ring."""
    return sum(buffer_bytes(metas, w, th, out_size)) + STAGES * SLOT_BYTES <= SMEM_LIMIT


@functools.lru_cache(maxsize=256)
def _plan(metas, h, w, tile_h, out_size):
    """(stripe rows, buffer bytes, ring slots): ``tile_h`` if given (and <
    H), else, of the stripe heights that fit and cut the image into at most
    one stripe more than the tallest that fits, the one whose blocks run the
    fewest K-steps; the ring takes as many slots of the room left as the
    widest round spans (a narrower ring makes rounds with idle warps)."""
    if tile_h is not None and tile_h < h:
        candidates = [tile_h] if _fits(metas, w, tile_h, out_size) else []
    else:
        candidates = [th for th in range(h, 0, -1) if _fits(metas, w, th, out_size)]
        if candidates:
            most = -(-h // candidates[0]) + 1
            candidates = [th for th in candidates if -(-h // th) <= most]
    if not candidates:
        th = tile_h if tile_h is not None and tile_h < h else 1
        raise ValueError(f"fused qchain: a stripe of {th} rows of width {w} "
                         f"does not fit in {SMEM_LIMIT} bytes of shared memory")
    best = None
    for th in candidates:
        buf = tuple(buffer_bytes(metas, w, th, out_size))
        room = (SMEM_LIMIT - sum(buf)) // (STAGES * SLOT_BYTES)
        slots = min(round_span(metas, h, w, th), room)
        key = (round_steps(metas, h, w, th, slots), -th)
        if best is None or key < best[0]:
            best = (key, (th, buf, slots))
    return best[1]


def stripe_rows(metas, h: int, w: int, tile_h=None, out_size: int = 4) -> int:
    """Output rows per block (see :func:`_plan`): the whole image when it
    fits in shared memory and costs no more K-steps than stripes do."""
    return _plan(tuple(metas), h, w, tile_h, out_size)[0]


def launch_plan(x, layers, out_dtype, x2=None, tile_h=None):
    """The kernel's plan for a chain (:func:`_plan`): ([(ntap, cin_pad,
    cout_pad)] per layer, stripe rows, the two buffers' bytes, ring slots).
    Each input-channel group pads to 32, and so does every cout."""
    cin0 = _round_up(x.shape[-1], 32) + (0 if x2 is None else _round_up(x2.shape[-1], 32))
    metas = tuple((l["w"].shape[0] * l["w"].shape[1],
                   cin0 if i == 0 else _round_up(l["w"].shape[2], 32),
                   _round_up(l["w"].shape[3], 32)) for i, l in enumerate(layers))
    th, buf, slots = _plan(metas, x.shape[1], x.shape[2], tile_h, _OUT_SIZE[out_dtype])
    return list(metas), th, list(buf), slots


def _kernel_weights(layer, split):
    """The weight image of the kernel's ring: (ntap, cin_pad / 32,
    cout_pad / 32, 1024) int8, each input-channel group (split at
    ``split``) zero-padded to a multiple of 32 and cout to a multiple of
    32. Each 1024-byte slice holds one tap's 32 input x 32 output channels
    ordered [jp][g][t][e][hi][b]: output channel (2·jp + e)·8 + g, input
    channel 16·hi + 4·t + b, so that lane (g, t) of a warp finds its mma B
    registers of the 8-channel blocks 2·jp and 2·jp + 1 as one 16-byte
    load. Cached in the layer dict under ``_wk``."""
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
                   0, _round_up(cout, 32) - cout))
        for gw in groups
    ], dim=-1)
    ntap, cout_pad, cin_pad = wk.shape
    wk = (wk.reshape(ntap, cout_pad // 32, 2, 2, 8, cin_pad // 32, 2, 4, 4)
          .permute(0, 5, 1, 2, 4, 7, 3, 6, 8)
          .reshape(ntap, cin_pad // 32, cout_pad // 32, SLOT_BYTES).contiguous())
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
# the same, by launch form: row stripes (the JAX package's
# ``_fused_qchain_tiled``) or the whole image as one stripe (``_fused_qchain``)
fused_qchain.launches_by_form = {"stripes": 0, "whole_image": 0}


def _launch(x, layers, metas, out_dtype, tile_h, halo, *, x_scale, x2, x2_scale, out_xs,
            relu, library="qconv", clocks=None):
    dev = x.device
    if len(layers) > MAX_LAYERS:
        raise ValueError(f"fused qchain: at most {MAX_LAYERS} layers per launch on CUDA")
    n, h, w_, cin = x.shape
    if n > 65535:
        raise ValueError(f"fused qchain: at most 65535 images per launch, got {n}")
    split = cin if x2 is not None else None
    kmetas, th, buf, slots = launch_plan(x, layers, out_dtype, x2, tile_h)
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
        ints += [ntap, cin_pad, k_split, cout, kmetas[i][2]]
    x = x.contiguous()
    x2 = None if x2 is None else x2.contiguous()
    oxs = None
    if out_dtype == torch.int8:
        oxs = torch.as_tensor(out_xs, dtype=torch.float32, device=dev).reshape(())
    out = torch.empty((n, h, w_, metas[-1][2]), dtype=out_dtype, device=dev)
    dims = [n, h, w_, cin, 0 if x2 is None else x2.shape[-1], _KINDS[x.dtype],
            _KINDS[out_dtype], int(relu), th, halo, buf[0], buf[1], slots]
    lib = _library(library)
    with torch.cuda.device(dev):
        rc = lib.pmpu_qconv_chain(
            x.data_ptr(), None if x2 is None else x2.data_ptr(), out.data_ptr(),
            None if oxs is None else oxs.data_ptr(),
            (ctypes.c_void_p * len(ptrs))(*ptrs), (ctypes.c_int * len(ints))(*ints),
            len(layers), (ctypes.c_int * len(dims))(*dims),
            torch.cuda.current_stream(dev).cuda_stream,
            None if clocks is None else clocks.data_ptr(),
        )
    _build.check(lib, rc, f"fused_qchain (N={n}, H={h}, W={w_}, layers={ints}, th={th}, "
                          f"buffers={buf}, ring slots={slots})")
    fused_qchain.launches += 1
    fused_qchain.launches_by_form["whole_image" if th >= h else "stripes"] += 1
    del keep
    return out


CLOCK_SLOTS = 16  # kClockSlots of csrc/qconv.cu


def clock_slot_names(n_layers: int):
    """Names of the phase-clock slots that a chain of ``n_layers`` fills."""
    names = {0: "zero", 1: "load", 15: "total"}
    for l in range(n_layers):
        names.update({2 + 3 * l: f"mma{l}", 3 + 3 * l: f"epi{l}", 4 + 3 * l: f"wait{l}"})
    return names


@torch.no_grad()
def launch_build(x, layers, out_dtype, library, tile_h=None, clocks=None, **kw):
    """One launch of another build of the kernel (a library of
    ``_build.VARIANTS``, never loaded by :func:`fused_qchain`) on CUDA
    tensors, with the arguments of :func:`fused_qchain`; ``clocks``: the
    phase-clock sums of the clock build."""
    metas = [_prep_layer(l if i or l.get("xs") is not None else {**l, "xs": kw.get("x_scale")})
             for i, l in enumerate(layers)]
    halo = sum(nt == 9 for nt, _, _ in metas)
    kw = {k: kw.get(k) for k in ("x_scale", "x2", "x2_scale", "out_xs")} | {
        "relu": kw.get("relu", True)}
    return _launch(x, layers, metas, out_dtype, tile_h, halo, library=library, clocks=clocks,
                   **kw)


def fused_qchain_clocked(x, layers, out_dtype=torch.bfloat16, tile_h=None,
                         library="qconv_clocks", **kw):
    """One launch of a phase-clock build (``qconv_clocks`` or a variant of
    it) on CUDA tensors: → (output, {phase: mean cycles per warp per
    block}, blocks)."""
    n, h = x.shape[:2]
    clocks = torch.zeros(CLOCK_SLOTS, dtype=torch.int64, device=x.device)
    out = launch_build(x, layers, out_dtype, library, tile_h, clocks, **kw)
    th = launch_plan(x, layers, out_dtype, kw.get("x2"), tile_h)[1]
    blocks = n * -(-h // th)
    sums = clocks.cpu().tolist()
    warps = blocks * WARPS
    return out, {name: sums[i] / warps for i, name in clock_slot_names(len(layers)).items()}, blocks


def _library(name="qconv"):
    lib = _build.library(name)
    fn = lib.pmpu_qconv_chain
    fn.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.c_void_p, ctypes.c_void_p]
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
