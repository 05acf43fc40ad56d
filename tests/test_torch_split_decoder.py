"""The port's decoder convolutions on the CPU: ``split_decoder`` against
the JAX package's split decoder (f32 within 1e-5, and each split conv in
bf16 within one bf16 ulp of JAX ``_SplitConcatConv``) and against the
port's concatenating decoder, with the same state_dict; and the exact-f32
guard: with TF32 allowed process-wide, every f32 convolution and matmul of
the model code runs with it off, and the bf16 convolutions enter no guard."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from pmpu_tpu.models import initializers as jinit
from pmpu_tpu.models.unet import UNet as JaxUNet
from pmpu_tpu.models.unet import _SplitConcatConv
from pmpu_tpu_torch import device as port_device
from pmpu_tpu_torch.models import quantized as qz
from pmpu_tpu_torch.models.unet import Conv2d, UNet, to_nchw, to_nhwc
from pmpu_tpu_torch.ops.cuda.fcomb_mean import fcomb_mean_decode_reference
from pmpu_tpu_torch.train.checkpoint import load_flax_variables
from pmpu_tpu_torch.train.tasks import make_task
from tests.test_torch_weights import _randomize_bn, port_task

NF = (4, 8, 16)


def _jax_unet(split, dtype=None, seed=0):
    net = JaxUNet(n_classes=3, num_filters=NF, dtype=dtype, split_decoder=split)
    variables = jax.jit(lambda k, x: net.init(k, x, train=False))(
        jax.random.key(seed), jnp.zeros((1, 16, 16, 1)))
    tree = jax.tree_util.tree_map(np.asarray, variables)
    return net, _randomize_bn(tree, np.random.default_rng(seed + 1))


def _port_unet(split, variables, dtype=None):
    net = UNet(1, 3, NF, dtype=dtype, split_decoder=split)
    return load_flax_variables(net, variables).eval()


def test_split_decoder_matches_jax_and_concat_f32():
    """Odd sizes (13²: the upsampled half is padded to its skip)."""
    jnet, variables = _jax_unet(True)
    x = np.random.default_rng(2).random((2, 13, 13, 1)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, x: jnet.apply(v, x, train=False))(variables, x))
    split, concat = _port_unet(True, variables), _port_unet(False, variables)
    assert sorted(split.state_dict()) == sorted(concat.state_dict())
    with torch.no_grad():
        got = split(torch.from_numpy(x)).numpy()
        ref = concat(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_split_decoder_state_dict_and_config_plumbing():
    """The probabilistic U-Net and the task take the flag; the state_dict
    names are those of the concatenating model, so checkpoints interchange."""
    kw = dict(num_filters=(4, 8), latent_dim=3, device="cpu")
    split = make_task("probunet", split_decoder=True, **kw).net
    concat = make_task("probunet", **kw).net
    assert all(u.split for u in split.unet.up_blocks)
    assert not any(u.split for u in concat.unet.up_blocks)
    assert list(split.state_dict()) == list(concat.state_dict())
    split.load_state_dict(concat.state_dict(), strict=True)


def _bf16_ulp(v):
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(v), 2.0**-126))) - 7)


@pytest.mark.parametrize("cskip,cup,hw", [(8, 8, 9), (16, 8, 12), (4, 4, 7)])
def test_split_conv_bf16_within_one_ulp_of_jax(cskip, cup, hw):
    """bf16: each partial conv rounds to bf16, the sum and the bias add in
    bf16, as JAX ``_SplitConcatConv`` does."""
    rng = np.random.default_rng(cskip + cup + hw)
    cout = 8
    k = (rng.standard_normal((3, 3, cskip + cup, cout)) * 0.2).astype(np.float32)
    b = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    skip = rng.standard_normal((2, hw, hw, cskip)).astype(np.float32)
    up = rng.standard_normal((2, hw, hw, cup)).astype(np.float32)
    jconv = _SplitConcatConv(cout, (3, 3), [(1, 1), (1, 1)], jnp.bfloat16,
                             jinit.torch_conv_default(), jinit.torch_conv_bias_default(9))
    want = np.asarray(jconv.apply({"params": {"kernel": k, "bias": b}},
                                  (jnp.asarray(skip), jnp.asarray(up))), np.float32)
    conv = Conv2d(cskip + cup, cout, 3, padding=1, compute_dtype=torch.bfloat16)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(k.transpose(3, 2, 0, 1)))
        conv.bias.copy_(torch.from_numpy(b))
        out = conv.forward_split((to_nchw(torch.from_numpy(skip)), to_nchw(torch.from_numpy(up))))
    assert out.dtype == torch.bfloat16
    got = to_nhwc(out).float().numpy()
    assert np.all(np.abs(got - want) <= _bf16_ulp(want))


class _Recorder:
    """Spies on F.conv2d and F.conv_transpose2d: (name, dtype, cuDNN's
    allow_tf32 at the call)."""

    def __init__(self, monkeypatch):
        self.calls = []
        for name in ("conv2d", "conv_transpose2d"):
            monkeypatch.setattr(F, name, self._spy(name, getattr(F, name)))

    def _spy(self, name, fn):
        def spy(x, *args, **kwargs):
            self.calls.append((name, x.dtype, torch.backends.cudnn.allow_tf32))
            return fn(x, *args, **kwargs)
        return spy

    def f32(self):
        return [c for c in self.calls if c[1] == torch.float32]


def test_f32_convolutions_run_without_tf32(monkeypatch):
    """PyTorch's default lets cuDNN use TF32; every f32 conv of the float
    model and of the int8 path's float legs runs with it off, and the
    setting is restored after."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    rec = _Recorder(monkeypatch)
    x = torch.rand(2, 12, 12, 1)
    task = port_task("probunet")
    with torch.no_grad():
        task.net(x)
        make_task("unet", n_classes=3, num_filters=(4, 8), split_decoder=True,
                  device="cpu").net(x)
        q = qz.quantize_probunet(task.net)
        feats = qz.probunet_features_prior_int8(q, x, task.net, dtype=torch.float32)[0]
        qz._head(q["unet"], feats, 3, torch.float32)
        qz._up_conv(torch.rand(2, 6, 6, 8), q["unet"]["up0"], torch.float32)
        fake = qz.quantize_unet(task.net.unet, fake=True)
        qz.unet_int8(fake, x, (4, 8), 3, dtype=torch.float32)
    names = {c[0] for c in rec.f32()}
    assert names == {"conv2d", "conv_transpose2d"} and len(rec.f32()) > 20
    assert all(flag is False for _, _, flag in rec.f32()), rec.f32()
    assert torch.backends.cudnn.allow_tf32 is True


def test_bf16_convolutions_enter_no_guard(monkeypatch):
    """A bf16 U-Net enters no exact-f32 context; the probabilistic U-Net
    enters one a forward, for the prior's f32 head."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    entered = []
    exact = port_device.exact_f32

    def counting():
        entered.append(1)
        return exact()

    monkeypatch.setattr(port_device, "exact_f32", counting)
    rec = _Recorder(monkeypatch)
    x = torch.rand(2, 12, 12, 1)
    with torch.no_grad():
        for split in (False, True):
            make_task("unet", n_classes=3, num_filters=(4, 8), dtype=torch.bfloat16,
                      split_decoder=split, device="cpu").net(x)
        assert entered == []
        port_task("probunet", dtype=torch.bfloat16).net(x)
    assert entered == [1]
    bf16 = [c for c in rec.calls if c[1] == torch.bfloat16]
    assert len(bf16) > 20 and all(flag is True for _, _, flag in bf16)
    assert rec.f32() == [("conv2d", torch.float32, False)]


class _MatmulPrecision(TorchFunctionMode):
    """Records the f32 matmul precision at every matmul."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in (torch.matmul, torch.Tensor.__matmul__, torch.Tensor.matmul):
            self.seen.append(torch.get_float32_matmul_precision())
        return func(*args, **(kwargs or {}))


def test_f32_matmuls_run_at_highest_precision():
    """Under ``set_float32_matmul_precision("high")`` (TF32 in cuBLAS) the
    fcomb's plain decode and the int8 fcomb's float matmuls run at
    "highest"; the process setting is restored."""
    task = port_task("probunet")
    params = task.net.fcomb_params()
    feats, zs = torch.rand(2, 6, 6, 4), torch.rand(3, 2, 3)
    q = qz.quantize_probunet(task.net, quantize_fcomb=True)
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        with _MatmulPrecision() as spy, torch.no_grad():
            for dtype in (torch.float32, torch.bfloat16):
                fcomb_mean_decode_reference(feats, zs, params, 4, dtype)
            qz.fcomb_decode_samples_int8(q["fcomb_q"], feats, zs, dtype=torch.float32)
        assert len(spy.seen) > 10 and set(spy.seen) == {"highest"}
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(before)
