"""The port's training loop, checkpoints and train CLI on the CPU: a
checkpoint the port writes loads in the JAX package's
``load_for_inference`` with every tensor equal, a JAX training checkpoint
resumes in the port (weights, BatchNorm statistics, plateau and step; the
momentum starts fresh), a port checkpoint resumes its momentum and
generator, SIGTERM-style interrupts write ``INTERRUPTED.pth``, and the CLI
trains on a tiny NIfTI tree."""

import logging
import os
import pathlib
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmpu_tpu.config import Config as JaxConfig
from pmpu_tpu.train import checkpoint as jax_ckpt
from pmpu_tpu.train.schedule import ReduceLROnPlateau as JaxPlateau
from pmpu_tpu.train.steps import TrainState as JaxState
from pmpu_tpu.train.steps import make_optimizer as jax_optimizer
from pmpu_tpu_torch.config import Config
from pmpu_tpu_torch.data import nifti
from pmpu_tpu_torch.data.volumes import VolumeStore
from pmpu_tpu_torch.train import checkpoint as ckpt
from pmpu_tpu_torch.train import steps
from pmpu_tpu_torch.train.__main__ import main as train_main
from pmpu_tpu_torch.train.loop import train_net
from pmpu_tpu_torch.train.tasks import make_task

NF = (4, 8)


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    """The loop runs with the writer's in-memory fallback, its path where
    tensorboard is not installed (importing tensorboard costs about 20 s)."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def _arrays(n=3, s=16, seed=0):
    rng = np.random.default_rng(seed)
    lbl = np.zeros((n, s, s, s), np.int32)
    lbl[:, 4:10, 5:11, 4:9] = 1
    lbl[:, 6:8, 6:9, 5:7] = 2
    img = (rng.random((n, s, s, s)) * 0.2 + 0.6 * (lbl > 0)).astype(np.float32)
    return img, lbl


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _assert_trees_equal(got, want):
    got, want = dict(_flat(got)), dict(_flat(want))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg="/".join(k))


@pytest.mark.parametrize("name,layout", [("probunet", "view_stacks"), ("unet", "plain")])
def test_port_checkpoint_loads_in_jax(name, layout, tmp_path, monkeypatch):
    """One epoch on the CPU; the epoch checkpoint and the final model load
    in the JAX package's ``load_for_inference`` (and the port's) with the
    port's weights and BatchNorm statistics exactly."""
    monkeypatch.chdir(tmp_path)
    cfg = Config(net=name, num_filters=NF, epochs=1, batchsize=2, checkpoint_dir="ck",
                 view_stacks=layout == "view_stacks", seed=3)
    state, task, history = train_net(cfg, VolumeStore.from_arrays(*_arrays()), device="cpu")
    assert len(history["train_loss"]) == 1 and np.isfinite(history["train_loss"][0])
    assert len(history["val_loss"]) == 1 and np.isfinite(history["val_loss"][0])
    want = ckpt.flax_variables(task.net)
    for f in (f"{name}_checkpoint0.pt", f"{name}_model.pt"):
        path = str(tmp_path / "ck" / f)
        jtask, variables, jcfg = jax_ckpt.load_for_inference(path, JaxConfig())
        assert jtask.name == name and tuple(jcfg.num_filters) == NF
        _assert_trees_equal(jax.tree_util.tree_map(np.asarray, variables), want)
        ptask, _ = ckpt.load_for_inference(path, Config(), device="cpu")
        _assert_trees_equal(ckpt.flax_variables(ptask.net), want)
        # the JAX package's own reader: numpy arrays and builtins only
        with open(path, "rb") as fh:
            payload = pickle.load(fh)
        assert payload["rng_key"] is None and payload["opt_state"] is None
        assert payload["step"] == state.step > 0


def test_jax_checkpoint_resumes_in_the_port(tmp_path, monkeypatch, caplog):
    """A checkpoint of the JAX package's ``save_checkpoint`` (a JAX train
    state, optax momentum and PRNG key included) resumes in the port."""
    monkeypatch.chdir(tmp_path)
    tree = ckpt.flax_variables(make_task("probunet", num_filters=NF, device="cpu", seed=8).net)
    tree = jax.tree_util.tree_map(lambda a: a * 1.5 + 0.25, tree)  # not the port's init
    tx = jax_optimizer()
    jstate = JaxState(params=tree["params"], batch_stats=tree["batch_stats"],
                      opt_state=tx.init(tree["params"]), step=jnp.asarray(7, jnp.int32))
    plateau = JaxPlateau(lr=0.004, mode="min", factor=0.5, patience=3, best=12.5,
                         num_bad_epochs=2)
    jax_ckpt.save_checkpoint("jax.pt", jstate, plateau, jax.random.key(9))
    cfg = Config(net="probunet", num_filters=NF, epochs=0, load="jax.pt", checkpoint_dir="ck")
    with caplog.at_level(logging.INFO):
        state, task, _ = train_net(cfg, VolumeStore.from_arrays(*_arrays()), device="cpu")
    assert "momentum starts fresh" in caplog.text
    assert state.step == 7 and not state.optimizer.state
    want = jax.tree_util.tree_map(np.asarray, {"params": jstate.params,
                                               "batch_stats": jstate.batch_stats})
    _assert_trees_equal(ckpt.flax_variables(task.net), want)
    saved = ckpt.load_checkpoint(str(tmp_path / "ck" / "probunet_model.pt"))
    assert saved["plateau"] == plateau.state_dict() and saved["step"] == 7


def _trained_state(seed):
    task = make_task("probunet", num_filters=NF, device="cpu", train=True, seed=seed)
    state = steps.create_train_state(task, seed=seed)
    img, lbl = _arrays(2, 16, seed)
    rows = torch.tensor([[0, 0, 5], [1, 2, 6], [0, 1, 7], [1, 0, 6]])
    steps.make_train_step(task, acc_steps=2)(state, torch.from_numpy(img),
                                             torch.from_numpy(lbl), rows, 0.01)
    return task, state


def test_port_checkpoint_resumes_momentum_and_generator(tmp_path):
    task, state = _trained_state(1)
    ckpt.save_checkpoint(str(tmp_path / "a.pt"), state)
    fresh_task, fresh = _trained_state(2)
    payload = ckpt.restore_train_state(str(tmp_path / "a.pt"), fresh)
    assert payload["extra"] == {} and fresh.step == state.step == 1
    for a, b in zip(task.net.state_dict().values(), fresh_task.net.state_dict().values()):
        assert torch.equal(a, b)
    names = dict(fresh_task.net.named_parameters())
    want = {n: state.optimizer.state[p]["momentum_buffer"]
            for n, p in task.net.named_parameters() if p in state.optimizer.state}
    assert want and len(fresh.optimizer.state) == len(want)
    for n, buf in want.items():
        assert torch.equal(fresh.optimizer.state[names[n]]["momentum_buffer"], buf), n
    assert torch.equal(fresh.generator.get_state(), state.generator.get_state())


@pytest.mark.parametrize("name", ["unet", "probunet"])
def test_flax_tree_round_trip(name):
    kw = {"latent_dim": 3, "no_convs_fcomb": 3} if name == "probunet" else {}
    task = make_task(name, num_filters=(4, 8, 16), device="cpu", seed=5, **kw)
    sd = {k: v.numpy() for k, v in task.net.state_dict().items()}
    tree = ckpt.flax_variables(task.net)
    back = ckpt.flax_to_state_dict(tree, ckpt.module_name_pairs(task.net))
    assert sorted(back) == sorted(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k], sd[k], err_msg=k)
    _assert_trees_equal(ckpt.state_dict_to_flax(back, ckpt.module_name_pairs(task.net)), tree)
    with pytest.raises(ValueError, match="does not have"):
        ckpt.state_dict_to_flax({**sd, "extra.weight": sd[next(iter(sd))]},
                                ckpt.module_name_pairs(task.net))


def test_interrupt_writes_interrupted_pth(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    calls = {"n": 0}

    def flag():
        calls["n"] += 1
        return calls["n"] > 3  # after two train steps

    cfg = Config(net="unet", num_filters=NF, epochs=1, batchsize=2, checkpoint_dir="ck")
    with pytest.raises(KeyboardInterrupt):
        train_net(cfg, VolumeStore.from_arrays(*_arrays()), interrupt_flag=flag, device="cpu")
    payload = ckpt.load_checkpoint("INTERRUPTED.pth")
    assert payload["step"] == 3 and payload["extra"]["model_config"]["net"] == "unet"
    assert not os.path.exists("ck/unet_model.pt")


def _nifti_tree(root: pathlib.Path):
    img, lbl = _arrays(3, 16, 7)
    for i in range(3):
        nifti.save(str(root / "images" / f"scan{i}.nii"), img[i])
        nifti.save(str(root / "labels" / f"scan{i}.nii"), lbl[i].astype(np.float32))


def test_train_cli(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    _nifti_tree(tmp_path / "DATA")
    argv = ["-m", "probunet", "-d", "DATA", "--num-filters", "4,8", "-e", "2", "-b", "8",
            "--checkpoint-every", "2", "--checkpoint-dir", "out", "--train-views", "0,2",
            "--device", "cpu"]
    assert train_main(argv) == 0
    assert sorted(os.listdir("out")) == ["probunet_checkpoint1.pt", "probunet_model.pt"]
    payload = ckpt.load_checkpoint("out/probunet_model.pt")
    assert payload["extra"]["model_config"] == {
        "net": "probunet", "n_channels": 1, "n_classes": 3, "num_filters": [4, 8],
        "latent_dim": 6, "no_convs_fcomb": 4, "beta": 10.0}
    assert payload["plateau"]["lr"] == 0.001 and payload["step"] > 0


@pytest.mark.parametrize("flags,world,error,named", [
    (["--async-checkpoints"], "1", NotImplementedError, "--async-checkpoints"),
    # --rss-limit-mb is ported in a world: the CLI goes on to join it (and
    # fails there, as torchrun's other variables are missing)
    (["--rss-limit-mb", "100", "--data-parallel"], "2", RuntimeError, "WORLD_SIZE is set but"),
    (["--rss-limit-mb", "1", "--async-checkpoints"], "2", NotImplementedError,
     r"ported\): --async-checkpoints$"),
    (["--nan-checks", "--async-checkpoints"], "1", NotImplementedError,
     r"ported\): --async-checkpoints$"),
])
def test_train_cli_refuses_unported_flags(flags, world, error, named, monkeypatch):
    """Refused before the CLI joins a world (``WORLD_SIZE`` is torchrun's);
    an accepted flag reaches the join."""
    monkeypatch.setenv("WORLD_SIZE", world)
    for k in ("RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(error, match=named):
        train_main(["-d", "no-such-dir", "--device", "cpu", *flags])


@pytest.mark.parametrize("flags", [
    ["--augment", "--elastic-alpha", "4"], ["--stream"], ["--num-views", "6"],
    ["--num-views", "6", "--no-view-stacks"], ["--remat"], ["--rss-limit-mb", "100"],
    ["--nan-checks"], ["--sharded-volumes"], ["--data-parallel"],
])
def test_train_cli_accepts_ported_flags(flags):
    """Flags ported since the first training slice pass ``check_ported``:
    the CLI goes on to read the (missing) data directory."""
    with pytest.raises(FileNotFoundError):
        train_main(["-d", "no-such-dir", "--device", "cpu", *flags])
