"""The port's per-rank sharded data and host-local steps on the CPU against
the JAX package (``pmpu_tpu/parallel/hostdata.py``, ``sharding.py``):

* ``host_volume_names``, ``global_cube``, ``load_host_store`` and
  ``ShardedTripleBatcher`` (training and ``pad=True`` rows, the zero weight
  of a shard with no rows, the epoch batches of one seed) equal to JAX's,
  bit for bit;
* the host-local train step in a world of 2 (gloo,
  ``tests/torch_dist_worker.py``) against ``make_hostlocal_dp_train_step``
  on a 2-device mesh: the U-Net (no randomness) and the probabilistic U-Net
  with each shard's eps rebuilt from JAX's folded and split keys; two steps,
  the loss terms within rtol 1e-5, the parameters and BatchNorm statistics
  within rtol 1e-5 / atol 1e-5, both ranks' states bit-equal;
* the host-local eval step against ``make_hostlocal_eval_step`` with one
  shard made only of pad rows (weight 0): loss and Dice within rtol 1e-5,
  each rank's predictions against its block of JAX's;
* ``make_global_batch``: the ranks' rows in rank order on every rank.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from pmpu_tpu.data import nifti as jax_nifti
from pmpu_tpu.parallel import hostdata as jhd
from pmpu_tpu.parallel import make_hostlocal_dp_train_step as jax_hostlocal_step
from pmpu_tpu.parallel import make_mesh as jax_mesh
from pmpu_tpu.parallel.sharding import make_hostlocal_eval_step as jax_hostlocal_eval
from pmpu_tpu.train.steps import TrainState as JaxState
from pmpu_tpu.train.steps import make_optimizer as jax_optimizer
from pmpu_tpu.train.tasks import make_task as jax_make_task
from pmpu_tpu_torch.data.index_map import build_index_map
from pmpu_tpu_torch.parallel import hostdata as thd
from pmpu_tpu_torch.train.checkpoint import flax_variables, load_flax_variables
from pmpu_tpu_torch.train.tasks import make_task
from tests.test_torch_parallel import assert_metrics_close, assert_state_close
from tests.test_torch_weights import _randomize_bn
from tests.torch_dist_worker import run_world

NF, LATENT, CUBE, WORLD = (4, 8), 3, 16, 2
LRS = (0.05, 0.02)


def test_host_volume_names_match_jax():
    names = [f"image{i}.nii" for i in (3, 10, 0, 7, 1, 2, 9)]
    for pc in (1, 2, 3, 4):
        for pi in range(pc):
            assert thd.host_volume_names(names, pi, pc) == jhd.host_volume_names(names, pi, pc)
    assert thd.host_volume_names(names) == sorted(names)  # no world: every volume


def test_global_cube_and_host_stores_match_jax(tmp_path):
    rng = np.random.default_rng(5)
    (tmp_path / "images").mkdir()
    (tmp_path / "labels").mkdir()
    for i, s in enumerate([(8, 8, 8), (12, 10, 9), (8, 8, 8), (9, 11, 8), (8, 8, 8)]):
        jax_nifti.save(tmp_path / "images" / f"image{i}.nii", rng.random(s).astype(np.float32))
        jax_nifti.save(tmp_path / "labels" / f"image{i}.nii",
                       rng.integers(0, 3, s).astype(np.float32))
    imgs, lbls = str(tmp_path / "images"), str(tmp_path / "labels")
    assert thd.global_cube(imgs) == jhd.global_cube(imgs) == 12
    assert thd.global_cube(imgs, ["image0.nii", "image2.nii"]) == 8
    for pc in (1, 2, 3):
        for pi in range(pc):
            got, want = thd.load_host_store(imgs, lbls, pi, pc), jhd.load_host_store(
                imgs, lbls, pi, pc)
            assert got.ids == want.ids and got.cube == want.cube == 12
            np.testing.assert_array_equal(got.images, want.images)
            np.testing.assert_array_equal(got.labels, want.labels)
    with pytest.raises(ValueError, match="no volumes"):
        thd.load_host_store(imgs, lbls, 5, 6)


def _triples(seed=0, n_volumes=4, skip=()):
    rng = np.random.default_rng(seed)
    lbl = np.zeros((n_volumes, 12, 12, 12), np.int32)
    lbl[:, 3:9, 2:10, 4:8] = rng.integers(0, 3, (n_volumes, 6, 8, 4))
    for v in skip:
        lbl[v] = 0
    return build_index_map(lbl, filter=True)


@pytest.mark.parametrize("pad", [False, True])
@pytest.mark.parametrize("n_shards,skip", [(1, ()), (2, ()), (4, ()), (2, (2, 3)),
                                           (4, (1,))])
def test_sharded_triple_batcher_matches_jax(pad, n_shards, skip):
    """Rows, real-row weights (0 for a shard whose volumes have no rows),
    step counts and two epochs of batches for one seed: bit-equal."""
    tr = _triples(n_shards, skip=skip)
    got = thd.ShardedTripleBatcher(tr, 4, n_shards, pad=pad)
    want = jhd.ShardedTripleBatcher(tr, 4, n_shards, pad=pad)
    np.testing.assert_array_equal(got.shard_real_rows, want.shard_real_rows)
    if skip and pad:
        assert (got.shard_real_rows == 0).any()
    for g, w in zip(got.shard_rows, want.shard_rows, strict=True):
        np.testing.assert_array_equal(g, w)
    for per_shard in (1, 3, 7):
        if not pad and skip:
            continue  # a shard without rows: no training steps
        assert got.steps_per_epoch(per_shard) == want.steps_per_epoch(per_shard)
        rg, rw = np.random.default_rng(9), np.random.default_rng(9)
        for _ in range(2):
            bg = list(got.epoch_batches(per_shard, rg))
            bw = list(want.epoch_batches(per_shard, rw))
            assert len(bg) == len(bw)
            for a, b in zip(bg, bw):
                assert a.dtype == np.int32 and a.shape == (n_shards * per_shard, 3)
                np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="not divisible"):
        thd.ShardedTripleBatcher(tr, 4, 3)


def _data():
    rng = np.random.default_rng(31)
    img = rng.random((4, CUBE, CUBE, CUBE)).astype(np.float32)
    lbl = np.zeros((4, CUBE, CUBE, CUBE), np.int32)
    lbl[:, 3:12, 4:13, 2:11] = rng.integers(0, 3, size=(4, 9, 9, 9))
    return img, lbl


def _kw(name):
    return dict(n_classes=3, num_filters=NF, **({"latent_dim": LATENT} if name == "probunet"
                                                else {}))


@functools.lru_cache(maxsize=None)
def _weights(name):
    task = make_task(name, **_kw(name), device="cpu", train=True, seed=0)
    variables = _randomize_bn(flax_variables(task.net), np.random.default_rng(101))
    load_flax_variables(task.net, variables)
    return {k: v.numpy().copy() for k, v in task.net.state_dict().items()}, variables, task


STEP_CASES = {"unet-acc1": ("unet", 1, 2), "prob-acc1": ("probunet", 1, 2),
              "prob-acc2": ("probunet", 2, 4)}  # (net, acc_steps, rows a shard)


@functools.lru_cache(maxsize=None)
def _step_plan(case_id):
    """Per step: the shard-ordered global rows with local scan ids (from
    ``ShardedTripleBatcher``), the JAX key, and each shard's eps rebuilt from
    JAX's key folded by the shard index and split by microbatch."""
    name, acc, per_shard = STEP_CASES[case_id]
    bat = thd.ShardedTripleBatcher(build_index_map(_data()[1], filter=True), 4, WORLD)
    batches = list(bat.epoch_batches(per_shard, np.random.default_rng(4)))[:len(LRS)]
    keys = [jax.random.key(200 + k) for k in range(len(LRS))]
    eps = [[np.stack([np.asarray(jax.random.normal(sk, (per_shard // acc, LATENT)))
                      for sk in jax.random.split(jax.random.fold_in(key, r), acc)])
            for r in range(WORLD)] for key in keys]
    return batches, keys, eps if name == "probunet" else None


def _eval_plan():
    """A validation batch of 3 rows a shard where shard 1's volumes have no
    rows (pad=True: its block is the sentinel row), weights from
    ``shard_real_rows``; the eps pair of each shard."""
    lbl = _data()[1]
    rows = build_index_map(lbl, filter=True)
    rows = rows[rows[:, 0] < 2][::9]  # volumes 0 and 1: shard 0's
    bat = thd.ShardedTripleBatcher(rows, 4, WORLD, pad=True)
    assert bat.shard_real_rows[1] == 0
    triples = next(bat.epoch_batches(3, np.random.default_rng(0)))
    key = jax.random.key(7)
    eps = []
    for r in range(WORLD):
        kr = jax.random.fold_in(key, r)
        eps.append(tuple(np.asarray(jax.random.normal(k, (3, LATENT)))
                         for k in (kr, jax.random.fold_in(kr, 1))))
    return triples, bat.shard_real_rows, key, eps


@pytest.fixture(scope="module")
def hostlocal_world(tmp_path_factory):
    img, lbl = _data()
    cases = []
    for case_id, (name, acc, _) in STEP_CASES.items():
        triples, _, eps = _step_plan(case_id)
        cases.append(dict(kind="step", mode="hostlocal", name=name, kw=_kw(name),
                          state_dict=_weights(name)[0], images=img, labels=lbl,
                          triples=triples, eps=eps, lrs=LRS, acc=acc))
    triples, weights, _, eps = _eval_plan()
    cases.append(dict(kind="eval", name="probunet", kw=_kw("probunet"),
                      state_dict=_weights("probunet")[0], images=img, labels=lbl,
                      triples=triples, weights=weights, eps=eps))
    rows = [np.arange(6, dtype=np.int32).reshape(2, 3) + 10 * r for r in range(WORLD)]
    cases.append(dict(kind="global_batch", rows=rows))
    return run_world(WORLD, cases, tmp_path_factory.mktemp("hostlocal"))


def _jax_state(variables, tx=None):
    return JaxState(params=variables["params"], batch_stats=variables["batch_stats"],
                    opt_state=None if tx is None else tx.init(variables["params"]),
                    step=jnp.zeros((), jnp.int32))


@pytest.mark.parametrize("case_id", list(STEP_CASES))
def test_hostlocal_step_matches_jax(case_id, hostlocal_world):
    name, acc, _ = STEP_CASES[case_id]
    sd, variables, task = _weights(name)
    mesh = jax_mesh(data=WORLD)
    dat = NamedSharding(mesh, P("data"))
    tx = jax_optimizer(momentum=0.9, clip=0.1, lr=LRS[0])
    step = jax_hostlocal_step(jax_make_task(name, **_kw(name)), tx, mesh, acc_steps=acc)
    jstate = _jax_state(variables, tx)
    img, lbl = (jax.device_put(a, dat) for a in _data())
    triples, keys, _ = _step_plan(case_id)
    metrics = []
    for trip, key, lr in zip(triples, keys, LRS):
        jstate, m = step(jstate, img, lbl, jax.device_put(trip, dat), key, lr)
        metrics.append({k: float(v) for k, v in m.items()})
    want = jax.tree_util.tree_map(np.asarray, {"params": jstate.params,
                                               "batch_stats": jstate.batch_stats})
    i = list(STEP_CASES).index(case_id)
    r0, r1 = hostlocal_world[0][i], hostlocal_world[1][i]
    assert_metrics_close(r0["metrics"], metrics)
    assert_state_close(r0["state"], want, task.net)
    assert r1["metrics"] == r0["metrics"]
    for k, v in r0["state"].items():
        np.testing.assert_array_equal(r1["state"][k], v, err_msg=k)


def test_hostlocal_eval_step_weighs_a_pad_shard_zero(hostlocal_world):
    _, variables, _ = _weights("probunet")
    mesh = jax_mesh(data=WORLD)
    dat = NamedSharding(mesh, P("data"))
    triples, weights, key, _ = _eval_plan()
    loss, dice, preds, _, _ = jax_hostlocal_eval(jax_make_task("probunet", **_kw("probunet")),
                                                 mesh)(
        _jax_state(variables), *(jax.device_put(a, dat) for a in _data()),
        jax.device_put(triples, dat), jax.device_put(weights, dat), key)
    preds = np.asarray(preds)
    i = len(STEP_CASES)
    for r in range(WORLD):
        got = hostlocal_world[r][i]
        np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-5)
        np.testing.assert_allclose(got["dice"], np.asarray(dice), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["preds"], preds[3 * r:3 * (r + 1)], rtol=1e-5,
                                   atol=1e-5)


def test_make_global_batch_gathers_in_rank_order(hostlocal_world):
    want = np.concatenate([np.arange(6, dtype=np.int32).reshape(2, 3) + 10 * r
                           for r in range(WORLD)])
    for r in range(WORLD):
        np.testing.assert_array_equal(hostlocal_world[r][-1], want)
    rows = np.arange(6).reshape(3, 2)
    np.testing.assert_array_equal(thd.make_global_batch(rows), rows)  # no world
