"""The bias + BatchNorm + ReLU epilogue (``ops/cuda/bias_bn_relu.py``) and the
route that takes it (``models/unet.py::run_layers``) on the CPU.

The kernel runs only on the card (``chip_smoke.py::phase_epilogue`` holds it
bit-equal to the three ATen passes at every conv shape of the serving
chunks). Here: the plain version is the three modules, the route's decision
(inference of a bf16 conv of a CUDA tensor, and nothing else), and what the
route runs once it is taken, with its device gate opened to CPU tensors: the
conv without its bias, then the plain version, in place of each (Conv2d,
BatchNorm2d, ReLU) triple, with each triple's own parameters. A cuDNN conv
gets its bias as a separate bf16 add, where the CPU's conv adds it before
rounding, so the routed CPU run is compared with the modules run with the
bias added as on the card."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch import nn

from benchmark.tracing import group_of
from pmpu_tpu_torch.models import unet
from pmpu_tpu_torch.models.prob_unet import Encoder, ProbabilisticUNet
from pmpu_tpu_torch.models.unet import BatchNorm2d, Conv2d, DoubleConv, Up
from pmpu_tpu_torch.ops.cuda import _build
from pmpu_tpu_torch.ops.cuda import bias_bn_relu as ep
from pmpu_tpu_torch.parallel.tensor import TPConv2d

BF16 = torch.bfloat16


def _bits(t):
    return t.view({torch.bfloat16: torch.int16, torch.float32: torch.int32}[t.dtype])


def _same_bits(a, b) -> bool:
    """Equal shapes and equal bits (NaNs with their payloads included)."""
    return a.shape == b.shape and torch.equal(_bits(a.contiguous()), _bits(b.contiguous()))


def _bn(c, seed):
    """An eval BatchNorm2d with seeded running statistics and affine terms."""
    g = torch.Generator().manual_seed(seed)
    bn = BatchNorm2d(c).eval()
    with torch.no_grad():
        bn.weight.copy_(1 + 0.1 * torch.randn(c, generator=g))
        bn.bias.copy_(0.1 * torch.randn(c, generator=g))
        bn.running_mean.copy_(0.1 * torch.randn(c, generator=g))
        bn.running_var.copy_((1 + 0.1 * torch.randn(c, generator=g)).abs())
    return bn


def _seeded(module, seed):
    """``module`` in eval mode, every BatchNorm seeded away from (1, 0, 0, 1)."""
    for i, m in enumerate(module.modules()):
        if isinstance(m, BatchNorm2d):
            m.load_state_dict(_bn(m.weight.shape[0], seed + i).state_dict())
    return module.eval()


def _conv_output(n, c, h, w, dtype, seed, nan=False):
    """A (n,c,h,w) channels_last activation such as a conv leaves: values
    around 0 (many ReLU inputs below it), a few NaNs when asked."""
    g = torch.Generator().manual_seed(seed)
    nhwc = torch.randn((n, h, w, c), generator=g)
    if nan:
        nhwc.view(-1)[:: 97] = float("nan")
    y = nhwc.permute(0, 3, 1, 2).to(dtype)
    assert y.is_contiguous(memory_format=torch.channels_last)
    return y


def _card_bias_forward(self, x, with_bias=True):
    """``Conv2d.forward`` with a bf16 conv's bias added as a pass of its own
    (cuDNN's conv, then ATen's bf16 add): the modules as the card runs them
    without the route."""
    if not with_bias or self.compute_dtype != BF16:
        return _CONV_FORWARD(self, x, with_bias)
    y = _CONV_FORWARD(self, x, with_bias=False)
    return y + self.bias.to(BF16)[:, None, None]


_CONV_FORWARD = Conv2d.forward


class _OnCard:
    """A CPU tensor as the route's decision would see it on the card."""

    is_cuda = True

    def __init__(self, t):
        self._t = t

    def __getattr__(self, name):
        return getattr(self._t, name)


def _open_gate(monkeypatch) -> list:
    """Open the route's device gate to CPU tensors; returns the list of the
    plain-version calls the route then makes (one per fused triple)."""
    fused, reference, calls = unet._fused, ep.bias_bn_relu_reference, []

    def on_card(layers, i, x):
        return fused(layers, i, _OnCard(x[0] if isinstance(x, tuple) else x))

    def plain(y, *args):
        calls.append(tuple(y.shape))
        return reference(y, *args)

    monkeypatch.setattr(unet, "_fused", on_card)
    monkeypatch.setattr(ep, "bias_bn_relu_reference", plain)
    return calls


@pytest.fixture
def routed(monkeypatch):
    return _open_gate(monkeypatch)


# --- the plain version ---------------------------------------------------


@pytest.mark.parametrize("dtype", [BF16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape,nan", [((2, 64, 17, 13), False), ((3, 1024, 3, 2), False),
                                       ((2, 128, 11, 11), True)], ids=["c64", "c1024", "nan"])
def test_plain_version_is_the_three_modules(dtype, shape, nan):
    """Bias add, eval BatchNorm2d, nn.ReLU, bit for bit; NaN inputs stay NaN
    where the modules leave them."""
    n, c, h, w = shape
    y = _conv_output(n, c, h, w, dtype, seed=c, nan=nan)
    conv_bias = 0.1 * torch.randn(c, generator=torch.Generator().manual_seed(1))
    bn = _bn(c, seed=2)
    with torch.no_grad():
        want = nn.ReLU()(bn(y + conv_bias.to(dtype)[:, None, None]))
        got = ep.bias_bn_relu_reference(y.clone(), conv_bias, bn.running_mean, bn.running_var,
                                        bn.weight, bn.bias, bn.eps)
    assert got.dtype == dtype and got.is_contiguous(memory_format=torch.channels_last)
    assert _same_bits(got, want)
    assert bool(torch.isnan(got).any()) == nan
    assert bool((got[~torch.isnan(got)] >= 0).all())


def test_wrapper_takes_plain_path_on_cpu_and_raises_elsewhere():
    """CPU tensors run the plain version and launch nothing; a tensor of
    another device that the kernel does not take raises (no fallback)."""
    c = 16
    y = _conv_output(1, c, 4, 4, BF16, seed=3)
    bn = _bn(c, seed=4)
    args = (torch.zeros(c), bn.running_mean, bn.running_var, bn.weight, bn.bias, bn.eps)
    before = ep.bias_bn_relu_.launches
    got = ep.bias_bn_relu_(y.clone(), *args)
    assert _same_bits(got, ep.bias_bn_relu_reference(y.clone(), *args))
    assert ep.bias_bn_relu_.launches == before
    assert not ep.takes(y, *args[:5])
    with pytest.raises(ValueError, match="CUDA bf16 channels_last"):
        ep.bias_bn_relu_(torch.empty((1, c, 4, 4), dtype=BF16, device="meta"), *args)


def test_kernel_is_built_by_default_and_traced_with_the_passes_it_replaces():
    """The source is in the default build; its kernel's name holds
    ``bias_bn_relu`` and lands in the benchmark's elementwise group, not in
    cuDNN's conv group."""
    assert "bias_bn_relu" in _build.SOURCES
    src = (Path(_build.CSRC) / "bias_bn_relu.cu").read_text()
    kernels = re.findall(r"__global__ void (?:__launch_bounds__\([^)]*\)\s*)?(\w+)\(", src)
    assert kernels == ["bias_bn_relu_kernel"]
    name = "(anonymous namespace)::bias_bn_relu_kernel(uint4*, int, int, float const*, " \
           "float const*, float const*, float const*, float const*, float)"
    assert group_of(name) == "batchnorm/relu/add elementwise"


# --- the route's decision ---------------------------------------------------


def _triple(cd=BF16, cout=16):
    return [Conv2d(8, cout, 3, padding=1, compute_dtype=cd), BatchNorm2d(cout).eval(), nn.ReLU()]


def _on_card(dtype=BF16, channels_last=True):
    x = torch.zeros((2, 5, 5, 8), dtype=dtype).permute(0, 3, 1, 2)
    return _OnCard(x if channels_last else x.contiguous())


@pytest.mark.parametrize("case", ["inference", "train_bn", "grad_on", "f32", "cpu", "tp_conv",
                                  "cudnn_off", "not_a_triple", "leaky_relu", "nchw",
                                  "nchw_input_channels_last_weight", "channels_not_8",
                                  "too_many_channels", "bf16_bn", "no_conv_bias",
                                  "no_running_stats", "too_many_elements", "nan_checks"])
def test_route_takes_only_inference_of_a_bf16_conv_on_the_card(case, monkeypatch):
    """The route is decided from the conv's input and the modules alone: a
    case the kernel would not take keeps the three modules here, never
    after the conv."""
    layers, x, want = _triple(), _on_card(), case in ("inference",
                                                     "nchw_input_channels_last_weight")
    if case == "train_bn":
        layers[1].train()
    elif case == "f32":
        layers, x = _triple(cd=None), _on_card(torch.float32)
    elif case == "cpu":
        x = _on_card()._t
    elif case == "tp_conv":
        layers[0].__class__ = TPConv2d
    elif case == "cudnn_off":
        monkeypatch.setattr(torch.backends.cudnn, "enabled", False)
    elif case == "not_a_triple":
        layers = layers[:2]
    elif case == "leaky_relu":
        layers[2] = nn.LeakyReLU()
    elif case in ("nchw", "nchw_input_channels_last_weight"):
        x = _on_card(channels_last=False)
        if case != "nchw":
            layers[0].to(memory_format=torch.channels_last)
    elif case == "channels_not_8":
        layers = _triple(cout=12)
    elif case == "too_many_channels":
        layers = _triple(cout=ep.MAX_CHANNELS + 8)
    elif case == "bf16_bn":
        layers[1].to(BF16)
    elif case == "no_conv_bias":
        layers[0].bias = None
    elif case == "no_running_stats":
        layers[1].running_mean = None
    elif case == "too_many_elements":
        x = _OnCard(torch.empty((2**31 // (16 * 25) + 1, 8, 5, 5), dtype=BF16, device="meta")
                    .to(memory_format=torch.channels_last))
    elif case == "nan_checks":
        monkeypatch.setattr(unet.profiling, "_nan_handle", object())
    with torch.set_grad_enabled(case == "grad_on"):
        assert unet._fused(layers, 0, x) == want
        assert unet._fused(layers, 0, (x, x)) == want  # split inputs
        assert not any(unet._fused(layers, i, x) for i in range(1, len(layers)))


# --- what the route runs, its gate opened to the CPU -------------------------


@pytest.mark.parametrize("kind", ["double_conv", "encoder", "probunet", "split_up"])
def test_inference_takes_one_epilogue_a_triple_with_its_own_parameters(kind, monkeypatch):
    """Each (Conv2d, BatchNorm2d, ReLU) triple runs as the conv without its
    bias and one epilogue with that triple's parameters: two a DoubleConv,
    two a level of the encoder, 2·(2L − 1) + 2L for the backbone and prior
    of an L-level ProbUNet; the result is the modules' with the bias added
    as on the card."""
    torch.manual_seed(5)
    g = torch.Generator().manual_seed(6)
    if kind == "double_conv":
        net, n = _seeded(DoubleConv(3, 16, BF16), 10), 2
        args = (torch.randn((2, 9, 9, 3), generator=g).permute(0, 3, 1, 2).to(BF16),)
    elif kind == "encoder":
        net, n = _seeded(Encoder(1, (8, 16, 24), dtype=BF16), 20), 6
        args = (torch.randn((2, 13, 13, 1), generator=g).permute(0, 3, 1, 2),)
    elif kind == "split_up":
        net, n = _seeded(Up(16, 8, 8, BF16, split=True), 30), 2
        args = (torch.randn((2, 5, 5, 16), generator=g).permute(0, 3, 1, 2).to(BF16),
                torch.randn((2, 11, 11, 8), generator=g).permute(0, 3, 1, 2).to(BF16))
    else:
        net, n = _seeded(ProbabilisticUNet(num_filters=(8, 16, 24), dtype=BF16), 40), 16
        args = (torch.rand((2, 12, 12, 1), generator=g),)
    with torch.no_grad():
        with monkeypatch.context() as m:
            m.setattr(Conv2d, "forward", _card_bias_forward)
            want = net(*args)
        calls = _open_gate(monkeypatch)
        got = net(*args)
    assert len(calls) == n
    if kind == "probunet":
        assert torch.equal(got.prior.loc, want.prior.loc)
        assert torch.equal(got.prior.scale, want.prior.scale)
        got, want = got.unet_features, want.unet_features
    assert _same_bits(got, want)


@pytest.mark.parametrize("mode", ["train", "grad_on"])
def test_training_and_grad_keep_the_three_modules(mode, routed):
    """Train-mode BatchNorm, or grad enabled, never takes the route: the
    output is what the modules give, unchanged."""
    net = _seeded(DoubleConv(3, 16, BF16), 50)
    x = torch.randn((4, 3, 8, 8), generator=torch.Generator().manual_seed(7)).to(
        memory_format=torch.channels_last).to(BF16)
    if mode == "train":
        net.train()
    with torch.set_grad_enabled(mode == "grad_on"):
        want = net.double_conv(x)
        got = net(x)
    assert routed == []
    assert _same_bits(got.detach(), want.detach())


def test_tensor_parallel_conv_keeps_the_three_modules(routed):
    """A ``TPConv2d`` (its own input handling) is never fused."""
    net = _seeded(DoubleConv(3, 16, BF16), 60)
    for m in net.double_conv:
        if type(m) is Conv2d:
            m.__class__ = TPConv2d
            m.tp_mesh, m.tp_head = None, False
    x = torch.randn((2, 3, 6, 6)).to(memory_format=torch.channels_last).to(BF16)
    with torch.no_grad():
        got, want = net(x), net.double_conv(x)
    assert routed == []
    assert _same_bits(got, want)


def test_cpu_inference_is_unchanged_without_the_gate():
    """Off the card the route is closed: eval under no_grad on the CPU is
    the Sequential itself, bit for bit (f32 and bf16)."""
    for dtype in (torch.float32, BF16):
        net = _seeded(ProbabilisticUNet(num_filters=(8, 16), dtype=dtype), 70)
        x = torch.rand((2, 10, 10, 1), generator=torch.Generator().manual_seed(8))
        before = ep.bias_bn_relu_.launches
        with torch.inference_mode():
            got = net.unet.inc(unet.to_nchw(x).to(dtype))
            want = net.unet.inc.double_conv(unet.to_nchw(x).to(dtype))
        assert _same_bits(got, want)
        assert ep.bias_bn_relu_.launches == before


def test_strict_state_dict_load_still_matches():
    """Names and parameters are unchanged: a strict load round-trips, and the
    reference's names (``double_conv.0`` conv, ``.1`` BatchNorm) stand."""
    a = ProbabilisticUNet(num_filters=(8, 16), dtype=BF16)
    b = ProbabilisticUNet(num_filters=(8, 16), dtype=BF16)
    sd = a.state_dict()
    assert b.load_state_dict(sd, strict=True).missing_keys == []
    assert "unet.inc.double_conv.0.bias" in sd and "unet.inc.double_conv.1.running_var" in sd
    assert "prior.encoder.layers.3.weight" in sd and "prior.encoder.layers.4.running_mean" in sd
    for k, v in b.state_dict().items():
        assert torch.equal(v, sd[k]), k


def test_conv_without_its_bias():
    """``with_bias=False`` is the same conv with no bias, whole and split."""
    conv = Conv2d(6, 8, 3, padding=1, compute_dtype=BF16)
    x = torch.randn((2, 6, 7, 7)).to(memory_format=torch.channels_last)
    w = conv.weight.to(BF16)
    assert torch.equal(conv(x, with_bias=False),
                       torch.nn.functional.conv2d(x.to(BF16), w, None, padding=1))
    xs = (x[:, :4].contiguous(memory_format=torch.channels_last),
          x[:, 4:].contiguous(memory_format=torch.channels_last))
    want = (torch.nn.functional.conv2d(xs[0].to(BF16), w[:, :4], None, padding=1)
            + torch.nn.functional.conv2d(xs[1].to(BF16), w[:, 4:], None, padding=1))
    assert torch.equal(conv.forward_split(xs, with_bias=False), want)
    assert torch.equal(conv.forward_split(xs), want + conv.bias.to(BF16)[:, None, None])


def test_int8_path_runs_no_epilogue(routed):
    """The int8 path folds BatchNorm into its conv chain and runs none of
    these modules: with the gate open, a whole int8 volume makes no
    epilogue call."""
    from pmpu_tpu_torch import VolumeEvaluator
    from pmpu_tpu_torch.train.tasks import make_task

    task = make_task("probunet", num_filters=(8, 16), dtype=BF16, device="cpu")
    ev = VolumeEvaluator(task, quantize="int8", eval_batch=8, device="cpu")
    out = ev.evaluate_volume(np.random.default_rng(9).random((8, 8, 8), dtype=np.float32))
    assert out is not None
    assert routed == []
