"""Post-training int8 inference (counterpart of ``pmpu_tpu/models/quantized.py``).

Scheme, as in the JAX package:

* eval-mode BatchNorm folds into the preceding conv (``_fold_bn``);
* weights: symmetric per-output-channel int8 (scale = amax/127);
* activations: symmetric per-tensor int8 at a static calibrated scale
  ``xs``, or a dynamic per-call amax before calibration;
* each conv is an int32 sum of s8·s8 products with the epilogue
  ``relu(float(acc)·(xs·ws) + b)`` in f32 — on CUDA the hand-written
  conv-chain kernel (``ops/cuda/qconv.py``), on the CPU its exact plain
  version;
* float legs (transposed convs, the 1×1 head, the prior's μ/logσ head and
  the fcomb) stay in the compute dtype.

A calibrated tree runs the int8-RESIDENT forward: every encoder edge is
int8 at its consumer's scale, written by the producer's epilogue; a
DoubleConv or prior block is one kernel launch; the decoder's conv over
concat(skip, up) takes the two int8 halves at their own scales.

The tree is built from the port's own modules (weights loaded through
``train.checkpoint.load_flax_variables``). Conv layers keep the JAX layout
so the two packages compare directly: ``w`` (kh,kw,cin,cout) int8, ``ws``
and ``b`` (cout,) f32, ``xs`` a 0-d f32 tensor. Float legs keep torch
layouts (``upw`` (cin,cout,2,2), ``outc`` and ``prior_head`` OIHW; ``fcomb``
the fcomb's parameters by torch name). Activations are NHWC at every
function here. ``fake=True`` keeps f32 BN-folded weights (the
graph-replication diagnostic; its convs run in f32 with TF32 off).
The scale files of :func:`export_scales` are the JAX package's format: one
file serves both packages.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pmpu_tpu_torch.models.prob_unet import avg_pool_ceil
from pmpu_tpu_torch.models.unet import BatchNorm2d, Conv2d, _pad_to_match, to_nchw, to_nhwc
from pmpu_tpu_torch.ops.cuda.fcomb_mean import decode_samples_reference
from pmpu_tpu_torch.ops.cuda.qconv import _requant, fused_qchain

# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------


def _fold_bn(kernel, bias, bn_scale, bn_bias, mean, var, eps: float = 1e-5):
    """Fold eval-mode BatchNorm into the preceding conv (HWIO kernel):
    y = γ·(conv(x)+b−μ)/√(σ²+ε) + β."""
    g = bn_scale / torch.sqrt(var + eps)
    return kernel * g, (bias - mean) * g + bn_bias


def _quant_w(kernel, fake: bool):
    """Symmetric per-output-channel int8 weights; ``fake`` keeps f32."""
    if fake:
        return kernel.float(), torch.ones(kernel.shape[-1], device=kernel.device)
    amax = kernel.abs().amax(dim=(0, 1, 2))
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(kernel / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def _conv_nhwc(x, w_hwio, padding):
    """f32 NHWC conv with an HWIO kernel, TF32 off (cuDNN's default TF32
    would break the fake-quant path's ~1e-3 agreement)."""
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        y = F.conv2d(to_nchw(x), w_hwio.permute(3, 2, 0, 1), padding=padding)
    return to_nhwc(y)


def _qconv(x, layer, act_dtype=torch.bfloat16, collect=None):
    """Quantized 3×3/1×1 conv + folded bias + ReLU (NHWC in and out).

    The input scale is STATIC when the layer carries ``xs``, DYNAMIC
    otherwise (per-call amax, kept on the device). ``collect`` records the
    layer's input amax during a calibration run."""
    w = layer["w"]
    if w.dtype == torch.int8:
        xf = x.float()
        if collect is not None:
            collect.append(xf.abs().amax())
        xs = layer.get("xs")
        if xs is None:
            xs = torch.clamp_min(xf.abs().amax() / 127.0, 1e-12)
        return fused_qchain(xf, [layer], act_dtype, x_scale=xs)
    y = torch.relu(_conv_nhwc(x.float(), w, w.shape[0] // 2) + layer["b"])
    return y if act_dtype == torch.float32 else y.to(act_dtype)


def _qdouble(x, dc, act_dtype=torch.bfloat16, collect=None):
    x = _qconv(x, dc[0], act_dtype=torch.float32, collect=collect)
    return _qconv(x, dc[1], act_dtype=act_dtype, collect=collect)


def _fold_conv_bn(conv, bn, fake: bool):
    k, b = _fold_bn(conv.weight.detach().permute(2, 3, 1, 0), conv.bias.detach(),
                    bn.weight.detach(), bn.bias.detach(), bn.running_mean, bn.running_var,
                    bn.eps)
    w, ws = _quant_w(k, fake)
    return {"w": w, "ws": ws, "b": b.float()}


def _fold_double_conv(seq, fake: bool):
    """DoubleConv Sequential (conv, BN, ReLU, conv, BN, ReLU) → two layers."""
    return [_fold_conv_bn(seq[0], seq[1], fake), _fold_conv_bn(seq[3], seq[4], fake)]


# ---------------------------------------------------------------------------
# U-Net
# ---------------------------------------------------------------------------


def quantize_unet(unet, fake: bool = False):
    """The port's ``UNet`` module → quantized param tree on its device."""
    q: dict = {"inc": _fold_double_conv(unet.inc.double_conv, fake)}
    for i, up in enumerate(unet.up_blocks):
        q[f"down{i}"] = _fold_double_conv(
            unet.down_blocks[i].maxpool_conv[1].double_conv, fake)
        q[f"up{i}"] = {
            "upw": up.up.weight.detach(),
            "upb": up.up.bias.detach(),
            "dc": _fold_double_conv(up.conv.double_conv, fake),
        }
    q["outc"] = {"w": unet.outc.conv.weight.detach(), "b": unet.outc.conv.bias.detach()}
    return q


def _maxpool2(x):
    """2×2 VALID max pool of an NHWC tensor (odd rows/columns dropped)."""
    return to_nhwc(F.max_pool2d(to_nchw(x), 2))


def _maxpool2_int8(h):
    """2×2 VALID max pool of int8 NHWC codes: max commutes with the
    monotone quantizer, so pooling the codes pools the values."""
    n, hh, ww, c = h.shape
    h2, w2 = hh // 2, ww // 2
    return h[:, :2 * h2, :2 * w2].reshape(n, h2, 2, w2, 2, c).amax(dim=(2, 4))


def _up_conv(y, up, dtype):
    """Transposed 2×2 stride-2 conv in the compute dtype, bias added in f32."""
    y1 = F.conv_transpose2d(to_nchw(y.to(dtype)), up["upw"].to(dtype), stride=2)
    return to_nhwc(y1).float() + up["upb"]


def _head(q, y, n_classes, dtype):
    out = to_nhwc(F.conv2d(to_nchw(y.to(dtype)), q["outc"]["w"].to(dtype))).float()
    out = out + q["outc"]["b"]
    return torch.sigmoid(out) if n_classes == 1 else out


def unet_int8(q, x, num_filters, n_classes, apply_last_layer=True, dtype=torch.bfloat16,
              collect=None, collect_up=None):
    """Quantized mirror of ``UNet.forward`` (NHWC in and out). A fully
    calibrated tree runs :func:`_unet_int8_resident`; otherwise the
    dynamic/calibration path below, where ``collect``/``collect_up`` record
    the per-conv input amaxes and the per-decoder-stage up-half amaxes."""
    nf = list(num_filters)
    if collect is None and _unet_tree_resident(q, nf):
        return _unet_int8_resident(q, x, nf, n_classes, apply_last_layer, dtype)
    xs = [_qdouble(x.float(), q["inc"], act_dtype=dtype, collect=collect)]
    for i in range(len(nf) - 1):
        mark = None if collect is None else len(collect)
        xs.append(_qdouble(_maxpool2(xs[-1]), q[f"down{i}"], act_dtype=dtype, collect=collect))
        if mark is not None:
            # down{i} conv0's xs doubles as the resident skip-edge scale,
            # where it quantizes the PRE-pool tensor: calibrate on that amax
            # (VALID pooling drops odd boundary rows/columns)
            collect[mark] = xs[-2].float().abs().amax()

    y = xs[-1]
    for i in range(len(nf) - 1):
        skip = xs[len(nf) - 2 - i]
        up = q[f"up{i}"]
        y1 = _pad_to_match_nhwc(_up_conv(y, up, dtype).to(dtype), skip)
        if collect_up is not None:
            collect_up.append(y1.float().abs().amax())
        y = _qdouble(torch.cat([skip, y1.to(skip.dtype)], dim=-1), up["dc"],
                     act_dtype=dtype, collect=collect)
    if not apply_last_layer:
        return y
    return _head(q, y, n_classes, dtype)


def _pad_to_match_nhwc(x1, x2):
    """Zero-pad NHWC ``x1`` spatially to ``x2``'s H and W (int8 too)."""
    return to_nhwc(_pad_to_match(to_nchw(x1), to_nchw(x2)))


# ---------------------------------------------------------------------------
# int8-resident forward
# ---------------------------------------------------------------------------


def _enc_resident(layers) -> bool:
    return all(l.get("xs") is not None and l["w"].dtype == torch.int8 for l in layers)


def _unet_tree_resident(q, nf) -> bool:
    layers = list(_walk_unet_layers(q, nf))
    if not _enc_resident(layers):
        return False  # uncalibrated, or fake-quant (no int8 path to keep)
    return all(q[f"up{i}"].get("uxs") is not None for i in range(len(nf) - 1))


def _qconv_r(xq, xs, layers, out_xs=None, act_dtype=torch.bfloat16):
    """int8-in conv chain at input scale ``xs``: the epilogue emits int8 at
    ``out_xs`` (a resident edge) or ``act_dtype`` (a float boundary). Takes
    the chain's layer list (one launch), where JAX takes one layer."""
    out = torch.int8 if out_xs is not None else act_dtype
    return fused_qchain(xq, layers, out, x_scale=xs, out_xs=out_xs)


def _split_dec_conv(skip_q, s_skip, up_q, s_up, layers, out_xs=None,
                    act_dtype=torch.bfloat16):
    """conv(concat(skip, up)) as two int8 convs summed in f32 (each half at
    its own scale; no concat tensor exists), then the rest of the decoder's
    chain ``layers[1:]`` in the same launch."""
    out = torch.int8 if out_xs is not None else act_dtype
    return fused_qchain(skip_q, layers, out, x_scale=s_skip, x2=up_q, x2_scale=s_up,
                        out_xs=out_xs)


def _unet_int8_resident(q, x, nf, n_classes, apply_last_layer, dtype):
    L = len(nf) - 1
    # encoder: every edge int8, at the scale of its down-path consumer
    edge = q["down0"][0]["xs"]
    h = fused_qchain(x.float(), q["inc"], torch.int8, out_xs=edge)
    skips = [(h, edge)]
    for i in range(L):
        pooled = _maxpool2_int8(h)
        if i < L - 1:
            edge_out = q[f"down{i + 1}"][0]["xs"]
            h = _qconv_r(pooled, edge, q[f"down{i}"], out_xs=edge_out)
            skips.append((h, edge_out))
            edge = edge_out
        else:  # bottleneck: the consumer is the (float) transposed conv
            y = _qconv_r(pooled, edge, q[f"down{i}"], act_dtype=dtype)

    for i in range(L):
        skip_q, s_skip = skips[L - 1 - i]
        up = q[f"up{i}"]
        y1q = _pad_to_match_nhwc(_requant(_up_conv(y, up, dtype), up["uxs"]), skip_q)
        # conv1 feeds the next (float) transposed conv or the output head
        y = _split_dec_conv(skip_q, s_skip, y1q, up["uxs"], up["dc"], act_dtype=dtype)

    if not apply_last_layer:
        return y
    return _head(q, y, n_classes, dtype)


# ---------------------------------------------------------------------------
# static calibration and the scale file
# ---------------------------------------------------------------------------


def _walk_unet_layers(q, num_filters):
    """Quantized conv layers in EXACT forward order (must match collect)."""
    yield from q["inc"]
    for i in range(len(num_filters) - 1):
        yield from q[f"down{i}"]
    for i in range(len(num_filters) - 1):
        yield from q[f"up{i}"]["dc"]


def _scale(amax, margin: float, device) -> torch.Tensor:
    """``max(amax, 1e-9) · margin / 127`` in Python floats, then f32."""
    a = max(float(amax), 1e-9)
    return torch.tensor(a * margin / 127.0, dtype=torch.float32, device=device)


def _bake_scales(layers, collected, margin: float):
    layers = list(layers)
    if len(layers) != len(collected):  # fake-quant trees collect nothing
        raise ValueError(
            f"calibration mismatch: {len(layers)} layers, {len(collected)} amaxes")
    for layer, amax in zip(layers, collected):
        layer["xs"] = _scale(amax, margin, layer["w"].device)


def _bake_up_scales(q, nf, collected_up, margin: float):
    if len(collected_up) != len(nf) - 1:
        raise ValueError(f"up-scale calibration mismatch: {len(nf) - 1} stages, "
                         f"{len(collected_up)} amaxes")
    for i, amax in enumerate(collected_up):
        q[f"up{i}"]["uxs"] = _scale(amax, margin, q[f"up{i}"]["upw"].device)


def calibrate_unet(q, x, num_filters, n_classes, dtype=torch.bfloat16, margin: float = 1.25):
    """Observe per-layer input amaxes on a sample batch and bake static
    scales IN PLACE, with the decoder up-half scales ``uxs``."""
    c: list = []
    cu: list = []
    unet_int8(q, x, num_filters, n_classes, dtype=dtype, collect=c, collect_up=cu)
    _bake_scales(_walk_unet_layers(q, list(num_filters)), c, margin)
    _bake_up_scales(q, list(num_filters), cu, margin)
    return q


def _calibrated_layers(q, num_filters, probabilistic: bool):
    """Every layer carrying a static ``xs``, in the calibrators' order."""
    if probabilistic:
        return list(_walk_unet_layers(q["unet"], list(num_filters))) + list(q["prior_enc"])
    return list(_walk_unet_layers(q, list(num_filters)))


def export_scales(q, num_filters, probabilistic: bool) -> dict:
    """Calibrated static input scales → a JSON-able dict (the JAX package's
    version-2 format: architecture fingerprint, ``xs`` per conv in forward
    order, ``us`` per decoder stage, ``fcomb_xs`` when the fcomb is int8)."""
    layers = _calibrated_layers(q, num_filters, probabilistic)
    if any(l.get("xs") is None for l in layers):
        raise ValueError("tree is not calibrated (run calibrate_* first)")
    d = {
        "version": 2,
        "num_filters": [int(f) for f in num_filters],
        "probabilistic": bool(probabilistic),
        "xs": [float(l["xs"]) for l in layers],
    }
    uq = q["unet"] if probabilistic else q
    if all(uq[f"up{i}"].get("uxs") is not None for i in range(len(num_filters) - 1)):
        d["us"] = [float(uq[f"up{i}"]["uxs"]) for i in range(len(num_filters) - 1)]
    if probabilistic and "fcomb_q" in q:
        fq = q["fcomb_q"]
        if fq.get("k0_feat_xs") is not None:
            d["fcomb_xs"] = [float(fq["k0_feat_xs"])] + [float(l["xs"]) for l in fq["layers"]]
    return d


def import_scales(q, d: dict, num_filters, probabilistic: bool):
    """Bake exported scales IN PLACE (inverse of :func:`export_scales`).
    Every check runs before the tree is touched; version-1 files (no
    fingerprint) are accepted on the scale count alone."""
    layers = _calibrated_layers(q, num_filters, probabilistic)
    xs = d["xs"]
    if "num_filters" in d and list(d["num_filters"]) != [int(f) for f in num_filters]:
        raise ValueError(f"calibration file was exported for num_filters="
                         f"{d['num_filters']}; this model has {list(num_filters)}")
    if "probabilistic" in d and bool(d["probabilistic"]) != bool(probabilistic):
        raise ValueError(f"calibration file was exported for probabilistic="
                         f"{d['probabilistic']}; this model is probabilistic={probabilistic}")
    if len(xs) != len(layers):
        raise ValueError(f"calibration file has {len(xs)} scales; this architecture "
                         f"has {len(layers)} quantized convs")
    fq = q["fcomb_q"] if probabilistic and "fcomb_q" in q and "fcomb_xs" in d else None
    if fq is not None and len(d["fcomb_xs"]) != 1 + len(fq["layers"]):
        raise ValueError(f"calibration file has {len(d['fcomb_xs'])} fcomb scales; "
                         f"expected {1 + len(fq['layers'])}")
    if "us" in d and len(d["us"]) != len(num_filters) - 1:
        raise ValueError(f"calibration file has {len(d['us'])} up-half scales; this "
                         f"architecture has {len(num_filters) - 1} decoder stages")
    dev = layers[0]["w"].device

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    for layer, v in zip(layers, xs):
        layer["xs"] = f32(v)
    if "us" in d:
        uq = q["unet"] if probabilistic else q
        for i, v in enumerate(d["us"]):
            uq[f"up{i}"]["uxs"] = f32(v)
    if fq is not None:
        fx = d["fcomb_xs"]
        fq["k0_feat_xs"] = f32(fx[0])
        for layer, v in zip(fq["layers"], fx[1:]):
            layer["xs"] = f32(v)
    return q


def calibrate_probunet(q, x, net, dtype=torch.bfloat16, margin: float = 1.25):
    c: list = []
    cu: list = []
    feats, loc, _scale_ = probunet_features_prior_int8(q, x, net, dtype=dtype, collect=c,
                                                       collect_up=cu)
    _bake_scales(_calibrated_layers(q, net.num_filters, True), c, margin)
    _bake_up_scales(q["unet"], list(net.num_filters), cu, margin)
    if "fcomb_q" in q:  # calibrate the fcomb matmuls with prior-mean draws
        fc: list = []
        fcomb_decode_samples_int8(q["fcomb_q"], feats, loc[None], dtype=dtype, collect=fc)
        fq = q["fcomb_q"]
        dev = fq["k0_feat"].device
        fq["k0_feat_xs"] = _scale(fc[0], margin, dev)
        for layer, a in zip(fq["layers"], fc[1:]):
            layer["xs"] = _scale(a, margin, dev)
    return q


# ---------------------------------------------------------------------------
# Probabilistic U-Net (backbone + prior tower int8; fcomb float by default)
# ---------------------------------------------------------------------------


def _fold_encoder(encoder, fake: bool):
    """The prior ``Encoder``'s (conv, BN) pairs in order → layers."""
    convs = [m for m in encoder.layers if isinstance(m, Conv2d)]
    bns = [m for m in encoder.layers if isinstance(m, BatchNorm2d)]
    return [_fold_conv_bn(c, b, fake) for c, b in zip(convs, bns)]


def _quant_mat(m):
    """(cin, cout) matmul weight → int8 with a per-output-column scale."""
    amax = m.abs().amax(dim=0)
    sc = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    return torch.clamp(torch.round(m / sc), -127, 127).to(torch.int8), sc.float()


def _quant_fcomb(fcomb_params, no_convs_fcomb, cf):
    """fcomb parameters → int8 matmul tree: the feature half of layer 0 and
    the hidden 1×1 layers go int8; the z half and the logit layer stay float."""
    def mat(name):  # OIHW 1×1 weight → (cin, cout)
        return fcomb_params[f"{name}.weight"][:, :, 0, 0].t()

    k0 = mat("layers.0")
    feat_w, feat_sc = _quant_mat(k0[:cf])
    layers = []
    for i in range(1, no_convs_fcomb - 1):
        w, ws = _quant_mat(mat(f"layers.{2 * i}"))
        layers.append({"w": w, "ws": ws, "b": fcomb_params[f"layers.{2 * i}.bias"].float()})
    return {
        "k0_feat": feat_w,
        "k0_feat_sc": feat_sc,
        "k0_z": k0[cf:],
        "b0": fcomb_params["layers.0.bias"],
        "layers": layers,
        "last_w": mat("last_layer"),
        "last_b": fcomb_params["last_layer.bias"],
    }


def quantize_probunet(net, fake: bool = False, quantize_fcomb: bool = False):
    """The port's ``ProbabilisticUNet`` → quantized eval tree: the U-Net
    backbone and the prior encoder int8; the prior head and the fcomb
    float (``quantize_fcomb`` also makes the fcomb's hidden matmuls int8).
    The posterior is not needed at eval and is dropped."""
    fcomb = {k: v.detach() for k, v in net.fcomb_params().items()}
    q = {
        "unet": quantize_unet(net.unet, fake),
        "prior_enc": _fold_encoder(net.prior.encoder, fake),
        "prior_head": {"w": net.prior.conv_layer.weight.detach(),
                       "b": net.prior.conv_layer.bias.detach()},
        "fcomb": fcomb,
    }
    if quantize_fcomb and not fake:
        q["fcomb_q"] = _quant_fcomb(fcomb, net.no_convs_fcomb, int(net.num_filters[0]))
    return q


def probunet_features_prior_int8(q, x, net, dtype=torch.bfloat16, collect=None,
                                 collect_up=None):
    """Quantized mirror of ``ProbabilisticUNet.forward`` at eval (no
    posterior): → (unet_features, prior_loc, prior_scale)."""
    nf = list(net.num_filters)
    ncpb = net.no_convs_per_block
    feats = unet_int8(q["unet"], x, nf, net.num_classes, apply_last_layer=False,
                      dtype=dtype, collect=collect, collect_up=collect_up)
    layers = list(q["prior_enc"])
    h = x.float()
    for i in range(len(nf)):
        if i != 0:  # pool in the compute dtype
            h = to_nhwc(avg_pool_ceil(to_nchw(h.to(dtype))))
        block = layers[i * ncpb:(i + 1) * ncpb]
        if collect is None and _enc_resident(layers):
            # one launch per block: its intra-block edges stay int8 on chip
            h = fused_qchain(h, block, torch.float32)
        else:
            for layer in block:
                h = _qconv(h, layer, act_dtype=torch.float32, collect=collect)
    enc = h.mean(dim=(1, 2), keepdim=True)
    mls = F.conv2d(to_nchw(enc), q["prior_head"]["w"], q["prior_head"]["b"])[:, :, 0, 0]
    latent = mls.shape[-1] // 2
    return feats, mls[:, :latent], torch.exp(mls[:, latent:])


def _qtensor(x, static_xs, collect):
    """Per-tensor int8 quantization of an activation (static scale when
    calibrated, dynamic amax otherwise) → (int8, scale)."""
    if collect is not None:
        collect.append(x.abs().amax())
    xs = static_xs if static_xs is not None else torch.clamp_min(x.abs().amax() / 127.0, 1e-12)
    return _requant(x, xs), xs


def _mat_layer(w, ws, b):
    """A (cin, cout) int8 matmul as a 1×1 conv layer of the chain kernel."""
    return {"w": w[None, None], "ws": ws, "b": b, "xs": None}


def fcomb_decode_samples_int8(fq, unet_features, zs, dtype=torch.bfloat16, collect=None):
    """int8 factored multi-sample fcomb decode: the feature-half matmul and
    the hidden layers run as 1×1 int8 layers of the conv-chain kernel (its
    exact plain version on the CPU); the z half and the logit layer stay
    float. → (S,N,H,W,C) f32."""
    cd = dtype or torch.float32
    f = unet_features.float()
    f_i8, fxs = _qtensor(f, fq.get("k0_feat_xs"), collect)
    zero_b = torch.zeros_like(fq["k0_feat_sc"])
    fh = fused_qchain(f_i8, [_mat_layer(fq["k0_feat"], fq["k0_feat_sc"], zero_b)],
                      torch.float32, x_scale=fxs, relu=False)
    z_half = zs.float() @ fq["k0_z"] + fq["b0"]
    x = torch.relu(fh[None] + z_half[:, :, None, None, :])
    s, n, hh, ww, f0 = x.shape
    for layer in fq["layers"]:
        x_i8, xs = _qtensor(x, layer.get("xs"), collect)
        x = fused_qchain(x_i8.reshape(s * n, hh, ww, f0),
                         [_mat_layer(layer["w"], layer["ws"], layer["b"])],
                         torch.float32, x_scale=xs).reshape(s, n, hh, ww, -1)
    out = (x.to(cd).float() @ fq["last_w"].to(cd).float()).to(cd)
    return out.float() + fq["last_b"]


def fcomb_decode_samples(fcomb_params, unet_features, zs, no_convs_fcomb,
                         dtype=torch.bfloat16):
    """Float fcomb over S prior draws, the factored decode of
    ``ProbabilisticUNet.decode_samples`` taking the fcomb parameters."""
    return decode_samples_reference(unet_features, zs, fcomb_params, no_convs_fcomb, dtype)
