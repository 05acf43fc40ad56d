"""The port's multi-process training on the CPU (gloo worlds of 1, 2 and 4,
``tests/torch_dist_worker.py``) against the JAX package on its 8-device CPU
mesh (``tests/conftest.py``):

* the data-parallel step (``make_dp_train_step``) in worlds of 2 and 4
  against JAX's ``make_dp_train_step`` on a mesh of as many devices: the
  U-Net with 3 weighted classes, with 1 class, with the ``ce+dice`` loss,
  and the probabilistic U-Net with JAX's eps injected, at ``acc_steps`` 1
  and 4, microbatches split unevenly and smaller than the world (a rank
  with no rows). Two steps; the loss terms within rtol 1e-5, the
  parameters and BatchNorm statistics within rtol 1e-5 / atol 1e-5 (as
  ``tests/test_torch_train_step.py`` holds the one-device step), every
  rank's state bit-equal to rank 0's;
* in a world of 1 the data-parallel step and the host-local step are
  bit-equal to the one-process ``make_train_step`` (the synchronized
  BatchNorm computes its moments in the plain order, so autograd sums the
  same terms in the same order), with augmentation and drawn eps too; in a
  world of 2 the data-parallel step with augmentation and drawn eps is
  within 1e-5 of that one-process step;
* ``train_net`` in a world of 2 with ``--sharded-volumes`` and with
  ``--data-parallel`` (1 epoch): equal histories on both ranks, the
  checkpoints written by rank 0 alone and loaded by the JAX package's
  ``load_for_inference`` with rank 0's (and rank 1's) variables exactly;
  the guards raising as JAX's do; an interrupt on rank 1 stopping both
  ranks after the same step, with ``INTERRUPTED.pth`` from rank 0;
* the train CLI in a world of 2 processes given torchrun's environment.
"""

import functools
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmpu_tpu.config import Config as JaxConfig
from pmpu_tpu.data import sampler as jsm
from pmpu_tpu.parallel import make_dp_train_step as jax_dp_step
from pmpu_tpu.parallel import make_mesh as jax_mesh
from pmpu_tpu.parallel import shard_state
from pmpu_tpu.train import checkpoint as jax_ckpt
from pmpu_tpu.train.steps import TrainState as JaxState
from pmpu_tpu.train.steps import make_optimizer as jax_optimizer
from pmpu_tpu.train.tasks import make_task as jax_make_task
from pmpu_tpu_torch.data import nifti
from pmpu_tpu_torch.data.index_map import build_index_map
from pmpu_tpu_torch.data.volumes import make_view_stacks
import pmpu_tpu_torch.parallel.mesh as mesh_mod
from pmpu_tpu_torch.config import Config
from pmpu_tpu_torch.data.volumes import VolumeStore
from pmpu_tpu_torch.parallel import Mesh, data_sharding, make_mesh, replicated
from pmpu_tpu_torch.train.loop import train_net
from pmpu_tpu_torch.train.checkpoint import (
    flax_to_state_dict,
    flax_variables,
    load_flax_variables,
    module_name_pairs,
)
from pmpu_tpu_torch.train.tasks import make_task
from tests.test_torch_weights import _randomize_bn
from tests.torch_dist_worker import run_world

ROOT = pathlib.Path(__file__).resolve().parents[1]
NF, LATENT, CUBE = (4, 8), 3, 16
LRS = (0.05, 0.02)
W3 = (0.5, 1.0, 2.0)

# id: (world, net, task kwargs, acc_steps, batch, layout)
DP_CASES = {
    "w2-unet3-weighted-acc1": (2, "unet", dict(n_classes=3, class_weights=W3), 1, 4, "vt"),
    "w2-unet1-acc4": (2, "unet", dict(n_classes=1), 4, 8, "plain"),
    "w2-unet3-ce+dice": (2, "unet", dict(n_classes=3, loss_type="ce+dice"), 1, 6, "vt"),
    "w2-prob-acc1-uneven": (2, "probunet", dict(n_classes=3), 1, 6, "vt"),
    "w2-prob-acc4-empty-rank": (2, "probunet", dict(n_classes=3), 4, 4, "plain"),
    "w4-unet3-weighted-acc4-empty-ranks": (4, "unet", dict(n_classes=3, class_weights=W3), 4,
                                           8, "vt"),
    "w4-unet1-acc4-uneven": (4, "unet", dict(n_classes=1), 4, 12, "plain"),
    "w4-prob-acc1": (4, "probunet", dict(n_classes=3), 1, 8, "vt"),
}


def _data(n=4):
    rng = np.random.default_rng(21)
    img = rng.random((n, CUBE, CUBE, CUBE)).astype(np.float32)
    lbl = np.zeros((n, CUBE, CUBE, CUBE), np.int32)
    lbl[:, 3:12, 4:13, 2:11] = rng.integers(0, 3, size=(n, 9, 9, 9))
    return img, lbl


def _kw(name, kw):
    return dict(num_filters=NF, **kw, **({"latent_dim": LATENT} if name == "probunet" else {}))


@functools.lru_cache(maxsize=None)
def _weights(name, kw_items):
    """The port's init of the task, BatchNorm randomized: (state_dict of
    numpy arrays, flax variables, the port task)."""
    task = make_task(name, **_kw(name, dict(kw_items)), device="cpu", train=True, seed=0)
    variables = _randomize_bn(flax_variables(task.net), np.random.default_rng(100))
    load_flax_variables(task.net, variables)
    sd = {k: v.numpy().copy() for k, v in task.net.state_dict().items()}
    return sd, variables, task


def _plan(case_id):
    """Per step: the global triples, the JAX key and the eps it draws, one
    (micro, latent) a microbatch."""
    _, name, _, acc, batch, _ = DP_CASES[case_id]
    index = build_index_map(_data()[1], filter=True)
    rng = np.random.default_rng(sum(map(ord, case_id)))
    triples = [index[rng.choice(len(index), batch, replace=False)] for _ in LRS]
    keys = [jax.random.key(100 + k) for k in range(len(LRS))]
    eps = [np.stack([np.asarray(jax.random.normal(sk, (batch // acc, LATENT)))
                     for sk in jax.random.split(key, acc)]) for key in keys]
    return triples, keys, eps if name == "probunet" else None


def _stacks(layout):
    img, lbl = _data()
    return (make_view_stacks(img), make_view_stacks(lbl)) if layout == "vt" else (img, lbl)


def _dp_case(case_id):
    _, name, kw, acc, _, layout = DP_CASES[case_id]
    sd = _weights(name, tuple(kw.items()))[0]
    triples, _, eps = _plan(case_id)
    images, labels = _stacks(layout)
    return dict(kind="step", mode="dp", name=name, kw=_kw(name, kw), state_dict=sd,
                images=images, labels=labels, layout=layout, triples=triples, eps=eps,
                lrs=LRS, acc=acc)


def _world_results(world, tmp_path_factory):
    ids = [i for i, c in DP_CASES.items() if c[0] == world]
    res = run_world(world, [_dp_case(i) for i in ids], tmp_path_factory.mktemp(f"dp{world}"))
    return {i: [r[k] for r in res] for k, i in enumerate(ids)}


@pytest.fixture(scope="module")
def dp_worlds(tmp_path_factory):
    return {w: _world_results(w, tmp_path_factory) for w in (2, 4)}


def _jax_dp(case_id):
    """JAX's data-parallel step on a mesh of ``world`` CPU devices: the
    metrics of each step and the final variables."""
    world, name, kw, acc, _, layout = DP_CASES[case_id]
    _, variables, _ = _weights(name, tuple(kw.items()))
    jtask = jax_make_task(name, **_kw(name, kw))
    triples, keys, _ = _plan(case_id)
    tx = jax_optimizer(momentum=0.9, clip=0.1, lr=LRS[0])
    jstate = JaxState(params=variables["params"], batch_stats=variables["batch_stats"],
                      opt_state=tx.init(variables["params"]), step=jnp.zeros((), jnp.int32))
    step, st_sh = jax_dp_step(jtask, tx, jax_mesh(data=world), acc_steps=acc,
                              sampler=jsm.sample_batch_vt if layout == "vt" else jsm.sample_batch)(
        jstate)
    jstate = shard_state(jstate, st_sh)
    images, labels = (jnp.asarray(a) for a in _stacks(layout))
    metrics = []
    for trip, key, lr in zip(triples, keys, LRS):
        jstate, m = step(jstate, images, labels, jnp.asarray(trip), key, lr)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, jax.tree_util.tree_map(
        np.asarray, {"params": jstate.params, "batch_stats": jstate.batch_stats})


def assert_state_close(got_sd, want_variables, net):
    want = flax_to_state_dict(want_variables, module_name_pairs(net))
    assert set(got_sd) == set(want)
    for n in want:
        np.testing.assert_allclose(got_sd[n], want[n], rtol=1e-5, atol=1e-5, err_msg=n)


def assert_metrics_close(got, want):
    for g, w in zip(got, want, strict=True):
        assert set(g) == set(w) | {"stop"} and g["stop"] == 0.0
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("case_id", list(DP_CASES))
def test_dp_step_matches_jax(case_id, dp_worlds):
    world, name, kw, _, _, _ = DP_CASES[case_id]
    ranks = dp_worlds[world][case_id]
    assert len(ranks) == world
    want_metrics, want_vars = _jax_dp(case_id)
    net = _weights(name, tuple(kw.items()))[2].net
    assert_metrics_close(ranks[0]["metrics"], want_metrics)
    assert_state_close(ranks[0]["state"], want_vars, net)
    for r in ranks[1:]:  # every rank holds the same state and metrics
        assert r["metrics"] == ranks[0]["metrics"]
        for k, v in ranks[0]["state"].items():
            np.testing.assert_array_equal(r["state"][k], v, err_msg=k)
        for k, v in ranks[0]["momentum"].items():
            np.testing.assert_array_equal(r["momentum"][k], v, err_msg=k)
        np.testing.assert_array_equal(r["generator"], ranks[0]["generator"])


def _drawn_case(mode, name="probunet", acc=4, batch=8, augment=True):
    """A step that draws its eps and augmentation from the state's
    generator (seed 7)."""
    kw = dict(n_classes=3)
    sd = _weights(name, tuple(kw.items()))[0]
    index = build_index_map(_data()[1], filter=True)
    rng = np.random.default_rng(5)
    img, lbl = _data()
    return dict(kind="step", mode=mode, name=name, kw=_kw(name, kw), state_dict=sd,
                images=img if mode == "hostlocal" else make_view_stacks(img),
                labels=lbl if mode == "hostlocal" else make_view_stacks(lbl),
                layout="plain" if mode == "hostlocal" else "vt",
                triples=[index[rng.choice(len(index), batch, replace=False)] for _ in LRS],
                lrs=LRS, acc=acc, seed=7, augment=augment)


@pytest.fixture(scope="module")
def drawn_worlds(tmp_path_factory):
    one = run_world(1, [_drawn_case("dp"), _drawn_case("plain"),
                        _drawn_case("hostlocal", name="unet", acc=1, batch=4, augment=False),
                        _drawn_case("plain", name="unet", acc=1, batch=4, augment=False)],
                    tmp_path_factory.mktemp("drawn1"))[0]
    two = run_world(2, [_drawn_case("dp")], tmp_path_factory.mktemp("drawn2"))
    return one, two


@pytest.mark.parametrize("pair", ["dp", "hostlocal"])
def test_world_of_1_steps_equal_the_plain_step(pair, drawn_worlds):
    """World 1: the data-parallel step (probunet, 4 microbatches of 2,
    augmentation and eps drawn from the generator) and the host-local step
    (U-Net on the plain stack) bit-equal to ``make_train_step``."""
    one = drawn_worlds[0]
    got, want = (one[0], one[1]) if pair == "dp" else (one[2], one[3])
    assert [{k: v for k, v in m.items() if k != "stop"} for m in got["metrics"]] == \
        want["metrics"]
    for k, v in want["state"].items():
        np.testing.assert_array_equal(got["state"][k], v, err_msg=k)
    for k, v in want["momentum"].items():
        np.testing.assert_array_equal(got["momentum"][k], v, err_msg=k)
    np.testing.assert_array_equal(got["generator"], want["generator"])


def test_world_of_2_dp_step_takes_its_rows_of_the_draws(drawn_worlds):
    """World 2: each rank takes its rows of the global augmentation draws and
    eps, so the step equals the one-process step within 1e-5."""
    one, two = drawn_worlds
    want = one[1]
    for r in (rank[0] for rank in two):
        for g, w in zip(r["metrics"], want["metrics"]):
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=k)
        for k, v in want["state"].items():
            np.testing.assert_allclose(r["state"][k], v, rtol=1e-5, atol=1e-5, err_msg=k)
        np.testing.assert_array_equal(r["generator"], want["generator"])


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _scans(n=4, s=CUBE, seed=0):
    rng = np.random.default_rng(seed)
    lbl = np.zeros((n, s, s, s), np.int32)
    lbl[:, 4:10, 5:11, 4:9] = 1
    lbl[:, 6:8, 6:9, 5:7] = 2
    img = (rng.random((n, s, s, s)) * 0.2 + 0.6 * (lbl > 0)).astype(np.float32)
    return img, lbl


def _train_case(cwd, data=None, interrupt=None, **cfg):
    base = dict(net="probunet", num_filters=NF, epochs=1, checkpoint_dir="ck", seed=3,
                train_views=(0,))
    return dict(kind="train_net", cwd=str(cwd), data=data or _scans(),
                cfg={**base, **cfg}, interrupt=interrupt)


GUARDS = {
    "views": (dict(sharded_volumes=True, num_views=6, batchsize=4),
              "--sharded-volumes requires the 3 standard views"),
    "stream": (dict(sharded_volumes=True, stream=True, batchsize=4), "mutually exclusive"),
    "volumes": (dict(sharded_volumes=True, batchsize=4, data=3),
                "3 volumes not divisible by 2 ranks"),
    "batch": (dict(sharded_volumes=True, batchsize=3),
              "batch 3 not divisible by 2 shards"),
    "zero-steps": (dict(sharded_volumes=True, batchsize=400), "smallest shard has"),
    "dp-stream": (dict(data_parallel=True, stream=True, batchsize=4),
                  "--stream is not supported with --data-parallel"),
}


@pytest.fixture(scope="module")
def train_world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train2")
    cases = [_train_case(tmp / "sv", sharded_volumes=True, batchsize=4),
             _train_case(tmp / "dp", data_parallel=True, batchsize=8)]
    for name, (cfg, _) in GUARDS.items():
        cfg = dict(cfg)
        n = cfg.pop("data", 4)
        cases.append(_train_case(tmp / name, data=_scans(n), **cfg))
    cases.append(_train_case(tmp / "interrupt", data_parallel=True, batchsize=4, epochs=2,
                             interrupt=(1, 3)))
    return tmp, run_world(2, cases, tmp / "io", timeout=300)


@pytest.mark.parametrize("which,flag", [(0, "sharded_volumes"), (1, "data_parallel")])
def test_train_net_in_a_world_of_2(which, flag, train_world):
    tmp, ranks = train_world
    r0, r1 = ranks[0][which], ranks[1][which]
    assert "error" not in r0 and "error" not in r1, (r0.get("error"), r1.get("error"))
    h0, h1 = r0["history"], r1["history"]
    for k in ("train_loss", "val_loss", "val_dice"):
        assert h0[k] == h1[k], k
    assert len(h0["train_loss"]) == 1 and np.isfinite(h0["train_loss"][0])
    assert np.isfinite(h0["val_loss"][0]) and r0["steps"] == r1["steps"] > 0
    d = tmp / ("sv" if flag == "sharded_volumes" else "dp")
    assert r0["written"] == ["ck/probunet_checkpoint0.pt", "ck/probunet_model.pt"]
    assert r1["written"] == []
    assert sorted(os.listdir(d / "ck")) == ["probunet_checkpoint0.pt", "probunet_model.pt"]
    jtask, variables, jcfg = jax_ckpt.load_for_inference(str(d / "ck" / "probunet_model.pt"),
                                                         JaxConfig())
    assert jtask.name == "probunet" and tuple(jcfg.num_filters) == NF
    got = dict(_flat(jax.tree_util.tree_map(np.asarray, variables)))
    for r in (r0, r1):
        want = dict(_flat(r["variables"]))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg="/".join(k))


@pytest.mark.parametrize("guard", list(GUARDS))
def test_train_net_guards_in_a_world_of_2(guard, train_world):
    """Each guard raises ValueError on both ranks, with JAX's message."""
    _, ranks = train_world
    i = 2 + list(GUARDS).index(guard)
    for r in ranks:
        assert r[i].get("error", "").startswith("ValueError"), r[i].get("error")
        assert GUARDS[guard][1] in r[i]["error"]


def test_interrupt_on_one_rank_stops_both(train_world):
    """Rank 1's flag turns on at its third poll: the step's all-reduce
    carries it, both ranks stop after the same step, rank 0 writes
    INTERRUPTED.pth."""
    tmp, ranks = train_world
    r0, r1 = ranks[0][-1], ranks[1][-1]
    assert r0.get("interrupted") and r1.get("interrupted")
    assert r0["steps"] == r1["steps"] and 2 <= r0["steps"] <= 4
    assert r0["written"] == ["INTERRUPTED.pth"] and r1["written"] == []
    assert (tmp / "interrupt" / "INTERRUPTED.pth").exists()


@pytest.mark.parametrize("flag", ["sharded_volumes", "data_parallel"])
def test_train_net_without_a_process_group(flag, tmp_path, monkeypatch):
    """Either flag in a plain process (one card, ``--device cpu``, no
    torchrun): a world of 1 with no process group, as JAX's mesh of one
    device; the host-local steps run no collective."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    assert not torch.distributed.is_initialized()
    cfg = Config(net="probunet", num_filters=NF, epochs=1, batchsize=4, checkpoint_dir="ck",
                 seed=3, train_views=(0,), **{flag: True})
    _, _, history = train_net(cfg, VolumeStore.from_arrays(*_scans()), device="cpu")
    assert np.isfinite(history["train_loss"]).all() and np.isfinite(history["val_loss"]).all()
    assert len(history["train_loss"]) == 1 and len(history["val_dice"]) == 1
    assert sorted(os.listdir(tmp_path / "ck")) == ["probunet_checkpoint0.pt",
                                                   "probunet_model.pt"]


def test_train_cli_in_a_world_of_2(tmp_path):
    """``python -m pmpu_tpu_torch.train --data-parallel --device cpu`` as two
    processes given torchrun's environment (gloo): both exit 0, and rank 0
    alone writes the checkpoints."""
    img, lbl = _scans(2)
    for i in range(2):
        nifti.save(str(tmp_path / "DATA" / "images" / f"scan{i}.nii"), img[i])
        nifti.save(str(tmp_path / "DATA" / "labels" / f"scan{i}.nii"), lbl[i].astype(np.float32))
    from pmpu_tpu_torch.parallel.mesh import free_port

    port = str(free_port())
    procs = []
    for rank in range(2):
        env = {**os.environ, "RANK": str(rank), "LOCAL_RANK": str(rank), "WORLD_SIZE": "2",
               "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": port, "OMP_NUM_THREADS": "1",
               "PYTHONPATH": str(ROOT)}
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "pmpu_tpu_torch.train", "-m", "unet", "-d", "DATA",
             "--num-filters", "4,8", "-e", "1", "-b", "4", "--train-views", "0",
             "--checkpoint-dir", f"ck{rank}", "--data-parallel", "--device", "cpu"],
            cwd=tmp_path, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-4000:]
    assert "rank 1 of 2" in outs[1][1] and "data parallel over 2 ranks" in outs[0][1]
    assert sorted(os.listdir(tmp_path / "ck0")) == ["unet_checkpoint0.pt", "unet_model.pt"]
    assert os.listdir(tmp_path / "ck1") == []


def test_mesh_and_row_blocks(monkeypatch):
    """``make_mesh`` checks its arguments as JAX's does; ``model=2`` on a
    world of 2 is a 1×2 mesh with this rank's data column and model row;
    ``data_sharding`` splits as ``torch.tensor_split``."""
    assert make_mesh() == Mesh(1, 1)  # no process group: a world of 1
    monkeypatch.setattr(mesh_mod, "world", lambda: (0, 4))  # rank 0 of a world of 4
    assert make_mesh() == Mesh(4, 1) and make_mesh(2).shape == {"data": 2, "model": 1}
    with pytest.raises(ValueError, match="exceeds 4 ranks"):
        make_mesh(8)
    with pytest.raises(ValueError, match="not divisible by model=3"):
        make_mesh(model=3)
    monkeypatch.setattr(mesh_mod, "world", lambda: (1, 2))  # rank 1 of a world of 2
    monkeypatch.setattr(torch.distributed, "new_group", tuple)
    mesh = make_mesh(model=2)
    assert mesh == Mesh(1, 2) and mesh.shape == {"data": 1, "model": 2}
    assert (mesh.data_index, mesh.model_index) == (0, 1)
    assert mesh.data_group == (1,) and mesh.model_group == (0, 1)
    monkeypatch.undo()
    rows = torch.arange(30)
    for world in (1, 2, 3, 4, 7):
        for n in (0, 1, 2, 5, 12, 30):
            mesh = Mesh(world)
            want = torch.tensor_split(rows[:n], world)
            got = [rows[:n][data_sharding(mesh, n, r)] for r in range(world)]
            assert all(torch.equal(a, b) for a, b in zip(got, want)), (world, n)
    net = torch.nn.Linear(2, 2)
    assert replicated(net) is net  # no process group: nothing to broadcast
