"""The HPU-Net's residual-block epilogues (``ops/cuda/hpu_epilogue.py``) and
the route that takes them (``models/hprob_unet.py::run_blocks``) on the CPU.

The kernels run only on the card (``chip_smoke.py::phase_hpu_epilogue`` holds
them bit-equal to ATen's passes at the stitching decoder's level-0 shapes).
Here: the plain versions against the eager ops of ``ResBlock.forward``, both
modes, C = 12 and 24, both skip kinds, NaN and −0 inputs; the route's
decision (inference of bf16 convs on a CUDA tensor whose channel periods
fit a block, and nothing else); and what the
route runs once it is taken, with its device gate opened to CPU tensors:
each conv without its bias, then the plain version. A cuDNN conv gets its
bias as a separate bf16 add, where the CPU's conv adds it before rounding,
so the routed CPU run is compared with the modules run with the bias added
as on the card."""

import re
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from benchmark.tracing import group_of
from pmpu_tpu_torch import make_task
from pmpu_tpu_torch.models import hprob_unet
from pmpu_tpu_torch.models.hprob_unet import ResBlock, _blocks
from pmpu_tpu_torch.models.unet import Conv2d
from pmpu_tpu_torch.ops.cuda import _build
from pmpu_tpu_torch.ops.cuda import hpu_epilogue as ep
from tests.test_torch_bias_bn_relu import _card_bias_forward, _OnCard, _same_bits

BF16 = torch.bfloat16


def _act(n, c, h, seed, special=False):
    """A (n,c,h,h) bf16 channels_last activation around 0; with ``special``,
    NaN, ±inf and −0 among its first values."""
    g = torch.Generator().manual_seed(seed)
    nhwc = torch.randn((n, h, h, c), generator=g).to(BF16)
    if special:
        vals = torch.tensor([float("nan"), -0.0, float("inf"), -float("inf"), -0.0, 0.0, 1e-39,
                             -1e-39], dtype=BF16)
        nhwc.view(-1)[: vals.numel()] = vals
        nhwc.view(-1)[c: c + vals.numel()] = vals
    y = nhwc.permute(0, 3, 1, 2)
    assert y.is_contiguous(memory_format=torch.channels_last)
    return y


def _bias(c, seed, neg_zero=True):
    """(c,) f32 biases; a −0 among them so that −0 + −0 reaches the ReLU."""
    b = 0.1 * torch.randn(c, generator=torch.Generator().manual_seed(seed))
    if neg_zero:
        b[1] = -0.0
    return b


# --- the plain versions ----------------------------------------------------


@pytest.mark.parametrize("c", [12, 24])
@pytest.mark.parametrize("special", [False, True], ids=["plain", "nan_negzero"])
def test_bias_relu_plain_version_is_the_eager_ops(c, special):
    """Mode 1 (after a 3×3 conv): ATen's bf16 bias add, then the next conv's
    ``F.relu``, bit for bit; NaN passes through, −0 + −0 → ReLU as
    ``clamp_min`` gives it."""
    y, b = _act(2, c, 7, seed=c, special=special), _bias(c, seed=1)
    want = F.relu(y + b.to(BF16)[:, None, None])
    got = ep.bias_relu_(y.clone(), b)
    assert _same_bits(got, want)
    assert bool(torch.isnan(got).any()) == special
    assert bool((got[~torch.isnan(got)] >= 0).all())


@pytest.mark.parametrize("c", [12, 24])
@pytest.mark.parametrize("skip", ["identity", "conv"])
@pytest.mark.parametrize("relu", [False, True], ids=["last_block", "block_followed"])
@pytest.mark.parametrize("special", [False, True], ids=["plain", "nan_negzero"])
def test_residual_plain_version_is_the_eager_ops(c, skip, relu, special):
    """Mode 2 (after the block's 1×1 conv): the conv's bias add, the skip
    (the input, or the skip conv's output plus its bias), the residual add as
    ``ResBlock.forward`` writes it, and the next block's ``F.relu``, bit for
    bit; the skip input is left as it was."""
    y, b = _act(2, c, 5, seed=c, special=special), _bias(c, seed=2)
    s = _act(2, c, 5, seed=c + 1, special=special)
    s_before = s.clone()
    skip_bias = _bias(c, seed=3) if skip == "conv" else None
    t = y + b.to(BF16)[:, None, None]
    ss = s if skip_bias is None else s + skip_bias.to(BF16)[:, None, None]
    want = ss + t
    out, r = ep.residual_(y.clone(), b, s, skip_bias, relu=relu)
    assert _same_bits(out, want)
    assert _same_bits(s, s_before)
    if relu:
        assert _same_bits(r, F.relu(want))
    else:
        assert r is None


def test_wrapper_takes_plain_path_on_cpu_and_raises_elsewhere():
    """CPU tensors run the plain versions and launch nothing; a tensor of
    another device that the kernels do not take raises (no fallback)."""
    c = 12
    y, b = _act(1, c, 4, seed=4), _bias(c, seed=5)
    before = (ep.bias_relu_.launches, ep.residual_.launches)
    assert _same_bits(ep.bias_relu_(y.clone(), b), ep.bias_relu_reference(y.clone(), b))
    out, r = ep.residual_(y.clone(), b, y, b, relu=True)
    assert _same_bits(out, ep.residual_reference(y.clone(), b, y, b)[0])
    assert (ep.bias_relu_.launches, ep.residual_.launches) == before
    meta = torch.empty((1, c, 4, 4), dtype=BF16, device="meta")
    with pytest.raises(ValueError, match="CUDA bf16 channels_last"):
        ep.bias_relu_(meta, b)
    with pytest.raises(ValueError, match="CUDA bf16 channels_last"):
        ep.residual_(meta, b, meta)


@pytest.mark.parametrize("numel,c,want", [(255 * 170 * 170 * 12, 12, True),
                                          (255 * 170 * 170 * 24, 24, True),
                                          (8 * 192, 192, True), (2048 * 8, 2048, True),
                                          (3 * 3 * 2, 2, False), (257 * 8, 257, False),
                                          (2**31 - 1 + 7, 8, False), (0, 0, False)])
def test_the_shapes_the_kernels_take(numel, c, want):
    """Whole 16-byte vectors, under 2^31 − 1 elements, a channel period of
    at most 256 vectors (C = 12 included)."""
    assert ep.takes_shape(numel, c) == want


def test_kernels_are_built_by_default_and_traced_with_the_passes_they_replace():
    """The source is in the default build; its kernels' names hold
    ``hpu_epilogue`` (what the benchmark's roofline reader looks for) and
    land in the benchmark's elementwise group, not in cuDNN's conv group."""
    assert "hpu_epilogue" in _build.SOURCES
    src = (Path(_build.CSRC) / "hpu_epilogue.cu").read_text()
    kernels = re.findall(r"__global__ void (?:__launch_bounds__\([^)]*\)\s*)?(\w+)\(", src)
    assert kernels == ["hpu_epilogue_bias_relu_kernel", "hpu_epilogue_residual_relu_kernel"]
    for name in ("(anonymous namespace)::hpu_epilogue_bias_relu_kernel(uint4*, int, int, int, "
                 "float const*)",
                 "void (anonymous namespace)::hpu_epilogue_residual_relu_kernel<true, false>("
                 "uint4*, uint4 const*, uint4*, int, int, int, float const*, float const*)"):
        assert "hpu_epilogue" in name
        assert group_of(name) == "batchnorm/relu/add elementwise"


# --- the route's decision ---------------------------------------------------


def _level(cd=BF16, cin=8, c=24, d=12, n=3):
    return _blocks(cin, c, d, n, 3, cd)


def _on_card(dtype=BF16, c=8, channels_last=True, n=2, h=6):
    x = torch.zeros((n, h, h, c), dtype=dtype).permute(0, 3, 1, 2)
    return _OnCard(x if channels_last else x.contiguous())


@pytest.mark.parametrize("c,d,takes", [(24, 12, True), (24, 20, True), (24, 2, True),
                                       (24, 36, True), (24, 255, True), (264, 12, True),
                                       (24, 257, False), (257, 12, False)])
def test_route_takes_a_channel_period_up_to_one_block(c, d, takes):
    """A thread keeps its 8 channels along the grid's stride only where the
    channel period C / gcd(C, 8) fits one block of 256 threads: the route
    admits a level exactly where every conv's output (the 3×3 convs' d, the
    1×1 and skip convs' c) has such a period, C = 12 and 20 included, and
    keeps ``ResBlock.forward`` otherwise."""
    with torch.no_grad():
        assert hprob_unet._fused(_level(c=c, d=d), _on_card()) == takes


@pytest.mark.parametrize("case", ["inference", "f32", "f32_input", "grad_on", "cpu", "cudnn_off",
                                  "nan_checks", "nchw", "not_a_resblock", "bf16_bias",
                                  "odd_vectors", "wide_period", "too_many_elements",
                                  "other_conv"])
def test_route_takes_only_inference_of_bf16_convs_on_the_card(case, monkeypatch):
    """The route is decided from the level's input and its modules alone: a
    case the kernels would not take keeps ``ResBlock.forward``."""
    blocks, x = _level(), _on_card()
    if case == "f32":
        blocks, x = _level(cd=None), _on_card(torch.float32)
    elif case == "f32_input":
        x = _on_card(torch.float32)
    elif case == "cpu":
        x = x._t
    elif case == "cudnn_off":
        monkeypatch.setattr(torch.backends.cudnn, "enabled", False)
    elif case == "nan_checks":
        monkeypatch.setattr(hprob_unet.profiling, "_nan_handle", object())
    elif case == "nchw":
        x = _on_card(channels_last=False)
    elif case == "not_a_resblock":
        blocks.append(torch.nn.Identity())
    elif case == "bf16_bias":
        blocks[1].convs[0].to(BF16)
    elif case == "odd_vectors":  # 1 × 5² × 12 is not a whole number of 16-byte vectors
        x = _on_card(n=1, h=5)
    elif case == "wide_period":  # C // gcd(C, 8) = 257 > 256
        blocks = _level(d=257)
    elif case == "too_many_elements":
        x = _OnCard(torch.empty((2**31 // (24 * 36) + 1, 8, 6, 6), dtype=BF16, device="meta")
                    .to(memory_format=torch.channels_last))
    elif case == "other_conv":
        blocks[2].convs[1].__class__ = type("OtherConv", (Conv2d,), {})
    with torch.set_grad_enabled(case == "grad_on"):
        assert hprob_unet._fused(blocks, x) == (case == "inference")


# --- what the route runs, its gate opened to the CPU -------------------------


def _open_gate(monkeypatch) -> dict:
    """Open the route's device gate to CPU tensors; returns the counts of
    the plain-version calls the route then makes."""
    fused, calls = hprob_unet._fused, {"bias_relu": 0, "residual": 0, "relu_copy": 0}
    bias_relu, residual = ep.bias_relu_reference, ep.residual_reference

    def plain_bias_relu(y, bias):
        calls["bias_relu"] += 1
        return bias_relu(y, bias)

    def plain_residual(y, bias, s, skip_bias=None, relu=False):
        calls["residual"] += 1
        calls["relu_copy"] += relu
        return residual(y, bias, s, skip_bias, relu)

    monkeypatch.setattr(hprob_unet, "_fused", lambda blocks, x: fused(blocks, _OnCard(x)))
    monkeypatch.setattr(ep, "bias_relu_reference", plain_bias_relu)
    monkeypatch.setattr(ep, "residual_reference", plain_residual)
    return calls


ARCHS = {  # tests/test_torch_hpunet.py's
    "four_levels_38": (dict(channels_per_block=(4, 8, 8, 8), down_channels_per_block=(2, 4, 4, 4),
                            latent_dims=(1, 2)), 38),
    "three_levels_22": (dict(channels_per_block=(4, 8, 8), down_channels_per_block=(2, 4, 4),
                             latent_dims=(2, 1)), 22),
}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_routed_network_is_the_eager_blocks_bit_for_bit(arch, monkeypatch):
    """The whole bf16 HPU-Net (encoder, latent and stitching decoders) of 3
    draws with every level routed: per block two bias + ReLU launches and
    one residual launch (a ReLU copy on all but a level's last block), and
    the logits bit-equal to ``ResBlock.forward`` with the bias added as on
    the card."""
    kw, size = ARCHS[arch]
    task = make_task("hpunet", n_classes=3, device="cpu", seed=11, dtype=BF16, **kw)
    net = task.net
    x = torch.rand((4, size, size, 1), generator=torch.Generator().manual_seed(12))
    with torch.no_grad():
        enc = net.encode(x)
        eps = [torch.randn((3, 4, lat, h, w), generator=torch.Generator().manual_seed(13 + k))
               for k, (lat, (h, w)) in enumerate(zip(net.latent_dims, net.latent_sizes(enc)))]
        monkeypatch.setattr(Conv2d, "forward", _card_bias_forward)  # the class head's too
        want = net(x, eps)
        calls = _open_gate(monkeypatch)
        got = net(x, eps)
    levels = len(net.encoder) + len(net.latent_blocks) + len(net.stitch_blocks)
    blocks = 3 * levels
    assert calls == {"bias_relu": 2 * blocks, "residual": blocks, "relu_copy": 2 * levels}
    assert _same_bits(got, want)


def test_a_level_of_the_published_widths_routed(monkeypatch):
    """A level-0 stitching level at its published widths (48 → 24 channels,
    down width 12): three blocks, the first with its 1×1 skip conv,
    bit-equal to the eager blocks."""
    blocks = _blocks(48, 24, 12, 3, 3, BF16).eval()
    x = _act(3, 48, 10, seed=14)
    with torch.no_grad():
        with monkeypatch.context() as m:
            m.setattr(Conv2d, "forward", _card_bias_forward)
            want = x
            for b in blocks:
                want = b(want)
        calls = _open_gate(monkeypatch)
        got = hprob_unet.run_blocks(blocks, x)
    assert calls == {"bias_relu": 6, "residual": 3, "relu_copy": 2}
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert _same_bits(got, want)


def test_cpu_inference_is_unchanged_without_the_gate():
    """Off the card the route is closed: bf16 and f32 blocks under no_grad
    on the CPU are ``ResBlock.forward`` itself, bit for bit, with no
    launch."""
    for dtype in (torch.float32, BF16):
        blocks = _blocks(8, 24, 12, 3, 3, dtype)
        x = _act(2, 8, 6, seed=15).to(dtype)
        before = (ep.bias_relu_.launches, ep.residual_.launches)
        with torch.inference_mode():
            got = hprob_unet.run_blocks(blocks, x)
            want = x
            for b in blocks:
                want = b(want)
        assert _same_bits(got, want)
        assert (ep.bias_relu_.launches, ep.residual_.launches) == before


def test_state_dict_and_parameter_count_are_unchanged():
    """Names and parameters stay: the published widths count 8,778,311
    parameters and a strict load round-trips."""
    a = make_task("hpunet", device="cpu", seed=0).net
    assert sum(p.numel() for p in a.parameters()) == 8_778_311
    sd = a.state_dict()
    assert "encoder.0.0.convs.2.bias" in sd and "encoder.0.0.skip.weight" in sd
    b = ResBlock(8, 24, 12, 3, BF16)
    assert sorted(b.state_dict()) == ["convs.0.bias", "convs.0.weight", "convs.1.bias",
                                      "convs.1.weight", "convs.2.bias", "convs.2.weight",
                                      "skip.bias", "skip.weight"]
