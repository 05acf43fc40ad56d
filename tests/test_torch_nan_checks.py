"""``--nan-checks`` in the port (``utils/profiling.py::enable_nan_checks``)
against the JAX package's ``jax_debug_nans`` on the CPU: a NaN in the
input raises ``FloatingPointError`` in the JAX train loss and in the
port's train step (naming the module whose output first holds it); a clean
step is bit-equal with the checks on and off; ``train_net`` trains with the
flag and turns the checks off again when it ends. Also ``scope``, the
other debug hook of ``utils/profiling.py`` this slice ports."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmpu_tpu.train.tasks import make_task as jax_make_task
from pmpu_tpu.utils.profiling import enable_nan_checks as jax_nan_checks
from pmpu_tpu_torch.config import Config
from pmpu_tpu_torch.data import sampler as tsm
from pmpu_tpu_torch.data.index_map import build_index_map
from pmpu_tpu_torch.data.volumes import VolumeStore, make_view_stacks
from pmpu_tpu_torch.train import loop, steps
from pmpu_tpu_torch.train.checkpoint import flax_variables
from pmpu_tpu_torch.train.tasks import make_task
from pmpu_tpu_torch.utils import profiling

CUBE, NF = 12, (4, 8)


def _data(nan=False):
    rng = np.random.default_rng(4)
    img = rng.random((2, CUBE, CUBE, CUBE)).astype(np.float32)
    lbl = np.zeros((2, CUBE, CUBE, CUBE), np.int32)
    lbl[:, 3:9, 2:10, 4:9] = rng.integers(0, 3, size=(2, 6, 8, 5))
    if nan:
        img[:, :, :, 6] = np.nan  # every view's planes through x = 6 hold one
    return img, lbl


def _port_step(name, nan):
    task = make_task(name, n_classes=3, num_filters=NF, device="cpu", train=True, seed=1)
    state = steps.create_train_state(task, momentum=0.9)
    img, lbl = _data(nan)
    triples = torch.from_numpy(build_index_map(lbl)[::5][:2].copy())
    vt_i, vt_l = (torch.from_numpy(make_view_stacks(a)) for a in (img, lbl))
    step = steps.make_train_step(task, acc_steps=1, sampler=tsm.sample_batch_vt)
    return step, state, (vt_i, vt_l, triples, 0.05)


@pytest.mark.parametrize("name", ["unet", "probunet"])
def test_nan_in_the_input_raises_in_both_packages(name):
    img, lbl = _data(nan=True)
    jtask = jax_make_task(name, n_classes=3, num_filters=NF)
    x = jnp.asarray(img[0, 3:5, :, :, None])  # 2 view-0 planes, a NaN column each
    m = jnp.asarray(lbl[0, 3:5, :, :, None])
    step, state, args = _port_step(name, nan=True)
    variables = flax_variables(state.net)  # the port's weights as a flax tree
    # eagerly: jax_debug_nans raises at the first primitive that makes a NaN
    grad = jax.value_and_grad(
        lambda p: jtask.train_loss(p, variables["batch_stats"], x, m, jax.random.key(1)),
        has_aux=True)
    jax_nan_checks(True)
    try:
        with pytest.raises(FloatingPointError):
            grad(variables["params"])
    finally:
        jax_nan_checks(False)

    profiling.enable_nan_checks()
    try:
        with pytest.raises(FloatingPointError, match=r"NaN in the output of \w+"):
            step(state, *args)
    finally:
        profiling.enable_nan_checks(False)
    # off again: the same step runs through (its loss is NaN)
    step, state, args = _port_step(name, nan=True)
    _, metrics = step(state, *args)
    assert torch.isnan(metrics["loss"])


@pytest.mark.parametrize("name", ["unet", "probunet"])
def test_clean_step_is_bit_equal_with_the_checks_on(name):
    step, state, args = _port_step(name, nan=False)
    step_on, state_on, _ = _port_step(name, nan=False)  # the same seeded weights
    eps = torch.randn((2, 6), generator=torch.Generator().manual_seed(3))
    eps = eps if name == "probunet" else None
    _, off = step(state, *args, eps)
    profiling.enable_nan_checks()
    try:
        _, on = step_on(state_on, *args, eps)
    finally:
        profiling.enable_nan_checks(False)
    assert {k: float(v) for k, v in off.items()} == {k: float(v) for k, v in on.items()}
    for (n, a), b in zip(state.net.state_dict().items(), state_on.net.state_dict().values()):
        assert torch.equal(a, b), n
    assert not torch.is_anomaly_enabled() and profiling._nan_handle is None


def test_train_net_trains_with_nan_checks_and_raises_on_a_nan(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = Config(net="probunet", num_filters=NF, epochs=1, batchsize=2, nan_checks=True,
                 checkpoint_dir=str(tmp_path / "ck"), save_cp=False)
    loop.check_ported(cfg)
    _, _, history = loop.train_net(cfg, VolumeStore.from_arrays(*_data()), device="cpu")
    assert np.isfinite(history["train_loss"][0])
    assert profiling._nan_handle is None and not torch.is_anomaly_enabled()
    with pytest.raises(FloatingPointError, match="NaN in the output of"):
        loop.train_net(cfg, VolumeStore.from_arrays(*_data(nan=True)), device="cpu")
    assert profiling._nan_handle is None and not torch.is_anomaly_enabled()


def test_scope_labels_a_region_of_a_trace(tmp_path):
    """``scope`` (JAX ``jax.named_scope``) names a region of a
    ``torch.profiler`` trace, and does nothing outside one."""
    with profiling.scope("outside"):
        torch.ones(2).sum()
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.scope("serve_batch"):
            torch.ones(4).cumsum(0)
    assert "serve_batch" in {e.key for e in prof.key_averages()}
    assert (tmp_path / "trace.json").exists()
