"""The port's tensor parallelism over the mesh's ``model`` axis on the CPU
(gloo worlds of 2 and 4 ranks, ``tests/torch_dist_worker.py``, one world a
size for the module, each rank on 1 intra-op thread) against the JAX
package on its 8-device CPU mesh (``tests/conftest.py``):

* the sharding rule: ``param_spec`` and ``make_param_shardings`` equal to
  JAX's ``make_param_shardings`` leaf by leaf, on
  ``tests/test_parallel.py``'s three leaves in torch layout and on the
  full-width probunet tree at ``model`` 2 and 4 and ``min_channels`` 8, 16
  and 64; ``make_state_shardings`` mirrors the parameters on the momentum;
* the mesh: rank r at data index r // model and model index r % model, the
  data columns then the model rows made once, the rows of a batch split by
  data index; the host-local steps refusing ``model > 1`` by name;
* the data×model train step on meshes of (data, model) = (1, 2) and
  (2, 2) at ``min_channels=8`` (and one case a mesh at 4, where the
  transposed convs' biases are sharded too) against JAX's
  ``make_dp_train_step`` on ``make_mesh(data, model=2)``: the U-Net and
  the probabilistic U-Net, the
  plain and the view-stack layout, ``acc_steps`` 1 and 2, three steps with
  JAX's eps injected; the metrics within rtol 1e-5 and the gathered
  parameters and BatchNorm statistics within rtol 1e-5 and atol
  ``STATE_ATOL`` (1e-5, as ``tests/test_torch_parallel.py`` holds the
  data-parallel step over two steps, for the U-Net; 5e-5 for the
  probabilistic U-Net, see there); every
  rank's metrics and gathered state equal, each rank's tensors its block of
  them; the first step's gradients before the clip against the
  one-process step's: each tensor within 1e-3 of its max |gradient| and
  all within 1e-5 in relative L2, which a gradient summed twice or not at
  all over the model row (off by a factor) cannot meet;
* ``shard_state`` then ``gather_state`` bit-equal to the whole state;
  ``gather_state`` → ``save_checkpoint`` → ``restore_train_state`` →
  ``shard_state`` → one more step bit-equal to the step without the round
  trip (the dryrun's checkpoint leg in the port's format);
* ``VolumeEvaluator`` on a 1×2 and a 2×2 mesh bit-equal to one process
  (3 views with GED and the batched path, int8, 6 views), and in mean_z
  mode on 1×2 against JAX's ``VolumeEvaluator(mesh=make_mesh(data=4,
  model=2))`` at ``tests/test_torch_eval_parallel.py``'s tolerance.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmpu_tpu.data import sampler as jsm
from pmpu_tpu.inference import engine as jax_engine
from pmpu_tpu.parallel import make_dp_train_step as jax_dp_step
from pmpu_tpu.parallel import make_mesh as jax_mesh
from pmpu_tpu.parallel import make_param_shardings as jax_param_shardings
from pmpu_tpu.parallel import shard_state as jax_shard_state
from pmpu_tpu.train import checkpoint as jax_ckpt
from pmpu_tpu.train.steps import TrainState as JaxState
from pmpu_tpu.train.steps import make_optimizer as jax_optimizer
from pmpu_tpu.train.tasks import make_task as jax_make_task
import pmpu_tpu_torch.parallel.mesh as mesh_mod
from pmpu_tpu_torch.data import sampler as tsm
from pmpu_tpu_torch.data.index_map import build_index_map
from pmpu_tpu_torch.models import ProbabilisticUNet
from pmpu_tpu_torch.parallel import (
    Mesh,
    data_sharding,
    make_dp_train_step,
    make_hostlocal_dp_train_step,
    make_hostlocal_eval_step,
    make_mesh,
    make_param_shardings,
    make_state_shardings,
    param_spec,
)
from pmpu_tpu_torch.train import steps
from pmpu_tpu_torch.train.checkpoint import flax_to_state_dict, module_name_pairs
from pmpu_tpu_torch.train.tasks import make_task
from tests.test_torch_eval_parallel import IMG, LBL, SAMPLED, _assert_equal, _one_process
from tests.test_torch_eval_parallel import _case as _eval_case
from tests.test_torch_eval_parallel import _state_dict as _eval_state_dict
from tests.test_torch_eval_parallel import KW as EVAL_KW
from tests.test_torch_parallel import (
    LATENT,
    _data,
    _kw,
    _stacks,
    _weights,
    assert_metrics_close,
)
from tests.torch_dist_worker import _pre_clip_grads, run_world

MIN = 8
LRS = (0.05, 0.02, 0.01)
# atol of the gathered state against JAX's after the three steps. Measured
# max |diff| (on the CPU): the U-Net 2.4e-7; the probabilistic U-Net 2.3e-5
# (2x2-prob-vt-acc2, the posterior encoder's deepest conv), where the
# port's one-process step is itself 1.5e-5 from JAX's one-device step on the
# same plan (f32 sums in another order over three clipped steps) and JAX's
# 2x2 step 3.4e-6 from it; 5e-5 is about twice the largest reading
STATE_ATOL = {"unet": 1e-5, "probunet": 5e-5}
KW = {"unet": dict(n_classes=3), "probunet": dict(n_classes=3)}

# id: ((data, model), net, acc_steps, layout, min_channels); a batch of 8;
# each pair of (net, layout, acc_steps) values on each mesh at MIN, where
# every transposed conv's bias (4 wide) is replicated; at min_channels 4
# those biases are sharded too (``TPConvTranspose2d`` adds its block before
# the reduction), and so is every 4-wide tensor
TP_CASES = {
    "1x2-unet-plain-acc1": ((1, 2), "unet", 1, "plain", MIN),
    "1x2-unet-vt-acc2": ((1, 2), "unet", 2, "vt", MIN),
    "1x2-prob-plain-acc2": ((1, 2), "probunet", 2, "plain", MIN),
    "1x2-prob-vt-acc1": ((1, 2), "probunet", 1, "vt", MIN),
    "1x2-prob-plain-acc1-min4": ((1, 2), "probunet", 1, "plain", 4),
    "2x2-unet-plain-acc2": ((2, 2), "unet", 2, "plain", MIN),
    "2x2-unet-vt-acc1": ((2, 2), "unet", 1, "vt", MIN),
    "2x2-prob-plain-acc1": ((2, 2), "probunet", 1, "plain", MIN),
    "2x2-prob-vt-acc2": ((2, 2), "probunet", 2, "vt", MIN),
    "2x2-unet-vt-acc2-min4": ((2, 2), "unet", 2, "vt", 4),
}
BATCH = 8
# the case of each world that also takes the checkpoint leg
RESUME = {2: "1x2-prob-vt-acc1", 4: "2x2-unet-plain-acc2"}


# ---------------------------------------------------------------------------
# the sharding rule
# ---------------------------------------------------------------------------

def _torch_spec(spec, ndim) -> tuple:
    """A JAX spec of an exported leaf in torch layout: a kernel's axes move
    as ``export_torch_state_dict``'s ``transpose(3, 2, 0, 1)`` moves them."""
    axes = tuple(spec) + (None,) * (ndim - len(spec))
    if ndim == 4:
        axes = tuple(axes[i] for i in (3, 2, 0, 1))
    return () if all(a is None for a in axes) else axes


def test_param_spec_on_the_three_leaves():
    """``tests/test_parallel.py:31-40``'s leaves, exported: the wide kernel
    sharded on dim 0, the narrow one and nothing else replicated, the bias
    sharded; as JAX's specs moved to torch layout."""
    jmesh = jax_mesh(data=4, model=2)
    params = {"wide": np.zeros((3, 3, 32, 64), np.float32),
              "narrow": np.zeros((3, 3, 4, 8), np.float32),
              "bias": np.zeros((64,), np.float32)}
    want = jax_param_shardings(params, jmesh, min_channels=64)
    sd = {k: np.transpose(v, (3, 2, 0, 1)) if v.ndim == 4 else v for k, v in params.items()}
    got = make_param_shardings(sd, Mesh(4, 2), min_channels=64)
    assert got == {"wide": ("model", None, None, None), "narrow": (), "bias": ("model",)}
    for k, v in sd.items():
        assert got[k] == _torch_spec(want[k].spec, v.ndim) == param_spec(v.shape, 2, 64), k


@functools.lru_cache(maxsize=None)
def _full_width_shapes():
    """The full-width probunet's state_dict shapes (a meta-device module)."""
    with torch.device("meta"):
        net = ProbabilisticUNet()
    return {k: tuple(v.shape) for k, v in net.state_dict().items()}, module_name_pairs(net)


@pytest.mark.parametrize("model", [2, 4])
@pytest.mark.parametrize("min_channels", [8, 16, 64])
def test_param_shardings_match_jax_on_the_full_width_tree(model, min_channels):
    """Every tensor of the exported full-width probunet (64..1024, latent 6,
    fcomb depth 4): the port's spec is JAX's ``make_param_shardings`` spec
    of its leaf, moved to torch layout."""
    shapes, pairs = _full_width_shapes()
    zeros = {k: np.broadcast_to(np.float32(0), s) for k, s in shapes.items()}
    # the JAX tree of these shapes (kernels HWIO, transposed kernels (kh, kw, cout, cin))
    tree = {"params": {}, "batch_stats": {}}
    for flax_path, prefix, kind in pairs:
        if kind in ("conv", "deconv"):
            leaves = {("params", "kernel"): np.transpose(zeros[f"{prefix}.weight"], (2, 3, 1, 0)),
                      ("params", "bias"): zeros[f"{prefix}.bias"]}
        else:
            leaves = {("params", "scale"): zeros[f"{prefix}.weight"],
                      ("params", "bias"): zeros[f"{prefix}.bias"],
                      ("batch_stats", "mean"): zeros[f"{prefix}.running_mean"],
                      ("batch_stats", "var"): zeros[f"{prefix}.running_var"]}
        for (root, leaf), v in leaves.items():
            node = tree[root]
            for k in flax_path:
                node = node.setdefault(k, {})
            node[leaf] = v
    jmesh = jax_mesh(data=8 // model, model=model)
    # each JAX spec as a marker of its leaf's rank, 2 long on each sharded axis,
    # exported like the tensors themselves

    def marker(leaf, sharding):
        axes = tuple(sharding.spec) + (None,) * (leaf.ndim - len(sharding.spec))
        return np.broadcast_to(np.float32(0), tuple(2 if a == "model" else 1 for a in axes))

    specs = {root: jax.tree_util.tree_map(marker, tree[root],
                                          jax_param_shardings(tree[root], jmesh, min_channels))
             for root in ("params", "batch_stats")}
    want = {k: () if max(m.shape) == 1 else tuple("model" if d == 2 else None for d in m.shape)
            for k, m in flax_to_state_dict(specs, pairs).items()}
    got = make_param_shardings(zeros, Mesh(8 // model, model), min_channels)
    assert got.keys() == want.keys() == shapes.keys()
    assert got == want
    sharded = [k for k, v in got.items() if v]
    assert sharded and (min_channels < 64 or "unet.outc.conv.weight" not in sharded)


def test_state_shardings_mirror_the_parameters():
    """Each momentum buffer's spec is its parameter's; a sharded state is
    refused."""
    task = make_task("probunet", **_kw("probunet", KW["probunet"]), device="cpu", train=True)
    state = steps.create_train_state(task)
    sh = make_state_shardings(state, Mesh(1, 2), MIN)
    names = [n for n, p in task.net.named_parameters() if p.requires_grad]
    assert list(sh.momentum) == names
    assert all(sh.momentum[n] == sh.net[n] for n in names)
    assert sh.net == make_param_shardings(task.net.state_dict(), Mesh(1, 2), MIN)
    assert sh.net["unet.inc.double_conv.0.weight"] == ()  # 4 channels
    assert sh.net["unet.down_blocks.0.maxpool_conv.1.double_conv.0.weight"][0] == "model"
    task.net.tp_layout = (Mesh(1, 2), MIN)
    with pytest.raises(ValueError, match="takes the whole state"):
        make_state_shardings(state, Mesh(1, 2), MIN)


# ---------------------------------------------------------------------------
# the mesh and the guards
# ---------------------------------------------------------------------------

def test_mesh_layout_and_groups(monkeypatch):
    """Rank r of a world of 8 on a 4×2 mesh: data index r // 2, model index
    r % 2; every rank makes the 2 data columns, then the 4 model rows, and
    keeps its own; model index 0 and 1 of a data index get the same rows."""
    made = []
    monkeypatch.setattr(torch.distributed, "new_group", lambda ranks: made.append(ranks) or
                        tuple(ranks))
    for rank in range(8):
        monkeypatch.setattr(mesh_mod, "world", lambda r=rank: (r, 8))
        made.clear()
        mesh = make_mesh(model=2)
        assert mesh == Mesh(4, 2) and mesh.shape == {"data": 4, "model": 2}
        assert (mesh.data_index, mesh.model_index) == (rank // 2, rank % 2)
        assert made == [[0, 2, 4, 6], [1, 3, 5, 7], [0, 1], [2, 3], [4, 5], [6, 7]]
        assert mesh.data_group == tuple(range(rank % 2, 8, 2))
        assert mesh.model_group == (rank - rank % 2, rank - rank % 2 + 1)
        assert data_sharding(mesh, 10) == data_sharding(Mesh(4), 10, rank // 2)
    monkeypatch.setattr(mesh_mod, "world", lambda: (5, 8))
    made.clear()
    mesh = make_mesh(data=2, model=4)
    assert (mesh.data_index, mesh.model_index) == (1, 1) and len(made) == 6
    assert mesh.groups.model == (4, 5, 6, 7) and mesh.groups.data == (1, 5)
    monkeypatch.setattr(mesh_mod, "world", lambda: (0, 2))
    assert make_mesh(model=1) == Mesh(2) and make_mesh().groups is None


@pytest.mark.parametrize("make", [make_hostlocal_dp_train_step, make_hostlocal_eval_step])
def test_hostlocal_steps_refuse_a_model_axis(make):
    task = make_task("unet", num_filters=(4, 8), device="cpu", train=True)
    with pytest.raises(NotImplementedError, match="model=2: the host-local steps run on a mesh "
                                                  "of model=1"):
        make(task, Mesh(1, 2))


@pytest.mark.parametrize("layout", [None, (Mesh(2, 2), MIN)], ids=["whole", "other_mesh"])
def test_dp_step_wants_the_sharded_state(layout):
    """A network that is whole, or channel-sharded over another mesh, is
    refused on a mesh of ``model > 1``."""
    task = make_task("unet", num_filters=(4, 8), device="cpu", train=True)
    if layout is not None:
        task.net.tp_layout = layout
    with pytest.raises(ValueError, match="the network is not channel-sharded over it"):
        make_dp_train_step(task, Mesh(1, 2))


# ---------------------------------------------------------------------------
# the train step and the evaluator in worlds of 2 and 4
# ---------------------------------------------------------------------------

def _plan(case_id):
    """Per step: the triples, the JAX key and the eps it draws, one (micro,
    latent) a microbatch; the eps of the checkpoint leg's extra step."""
    _, name, acc, _, _ = TP_CASES[case_id]
    index = build_index_map(_data()[1], filter=True)
    rng = np.random.default_rng(sum(map(ord, case_id)))
    triples = [index[rng.choice(len(index), BATCH, replace=False)] for _ in LRS]
    keys = [jax.random.key(200 + k) for k in range(len(LRS))]
    eps = [np.stack([np.asarray(jax.random.normal(sk, (BATCH // acc, LATENT)))
                     for sk in jax.random.split(key, acc)]) for key in keys]
    extra = rng.standard_normal((acc, BATCH // acc, LATENT)).astype(np.float32)
    prob = name == "probunet"
    return triples, keys, eps if prob else None, extra if prob else None


def _tp_case(case_id, tmp):
    mesh, name, acc, layout, min_channels = TP_CASES[case_id]
    triples, _, eps, extra = _plan(case_id)
    images, labels = _stacks(layout)
    case = dict(kind="tp_step", name=name, kw=_kw(name, KW[name]),
                state_dict=_weights(name, tuple(KW[name].items()))[0], images=images,
                labels=labels, layout=layout, triples=triples, eps=eps, lrs=LRS, acc=acc,
                mesh=mesh, min_channels=min_channels, cwd=str(tmp / case_id))
    if case_id in RESUME.values():
        case["resume"] = {"eps": extra}
    return case


def _eval_cases(mesh, tmp):
    """The evaluator cases of a world on ``mesh``: {id: case}."""
    cases = {
        "views3": _eval_case("probunet", tmp / "views3", [
            ("volume", (IMG[0], LBL[0], 5)), ("ged", (IMG[1], LBL[1], 4, 11)),
            ("batched", (IMG, LBL, 7, None, None))], **SAMPLED),
        "int8": _eval_case("unet", tmp / "int8", [("volume", (IMG[0], LBL[0], 0))],
                           quantize="int8", calibration="scales.json", eval_batch=16),
        "views6": _eval_case("probunet", tmp / "views6", [("volume", (IMG[2], LBL[2], 1))],
                             num_views=6, n_samples=2, eval_batch=40),
    }
    if mesh == (1, 2):
        cases["mean_z"] = {**_eval_case("probunet", tmp / "mean_z", [
            ("volume", (IMG[0], LBL[0], 0))], eval_batch=20, mean_z=True),
            "state_dict": _eval_state_dict("probunet", seed=4)}
    for c in cases.values():
        c["mesh"] = mesh
    return cases


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{world: ({case id: [each rank's result]}, {eval id: case})}."""
    out = {}
    for world, mesh in ((2, (1, 2)), (4, (2, 2))):
        tmp = tmp_path_factory.mktemp(f"tp{world}")
        ids = [i for i, c in TP_CASES.items() if c[0] == mesh]
        evals = _eval_cases(mesh, tmp)
        cases = [_tp_case(i, tmp) for i in ids] + list(evals.values())
        ranks = run_world(world, cases, tmp / "io", timeout=300)
        results = {k: [r[j] for r in ranks] for j, k in enumerate(ids + list(evals))}
        out[world] = (results, evals)
    return out


def _ranks(worlds, case_id):
    world = 2 if TP_CASES[case_id][0] == (1, 2) else 4
    return worlds[world][0][case_id]


def _jax_tp(case_id):
    """JAX's step on ``make_mesh(data, model=2)`` of the CPU devices at
    the case's ``min_channels``: the metrics of each step and the final
    variables."""
    (data, model), name, acc, layout, min_channels = TP_CASES[case_id]
    _, variables, _ = _weights(name, tuple(KW[name].items()))
    jtask = jax_make_task(name, **_kw(name, KW[name]))
    triples, keys, _, _ = _plan(case_id)
    tx = jax_optimizer(momentum=0.9, clip=0.1, lr=LRS[0])
    jstate = JaxState(params=variables["params"], batch_stats=variables["batch_stats"],
                      opt_state=tx.init(variables["params"]), step=jnp.zeros((), jnp.int32))
    step, st_sh = jax_dp_step(jtask, tx, jax_mesh(data=data, model=model), acc_steps=acc,
                              min_channels=min_channels,
                              sampler=jsm.sample_batch_vt if layout == "vt" else jsm.sample_batch)(
        jstate)
    jstate = jax_shard_state(jstate, st_sh)
    images, labels = (jnp.asarray(a) for a in _stacks(layout))
    metrics = []
    for trip, key, lr in zip(triples, keys, LRS):
        jstate, m = step(jstate, images, labels, jnp.asarray(trip), key, lr)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, jax.tree_util.tree_map(
        np.asarray, {"params": jstate.params, "batch_stats": jstate.batch_stats})


def _one_process_grads(case_id):
    """The first step's gradients before the clip of the one-process port
    step (``make_train_step``) on the case's weights, rows and eps."""
    _, name, acc, layout, _ = TP_CASES[case_id]
    sd = _weights(name, tuple(KW[name].items()))[0]
    task = make_task(name, **_kw(name, KW[name]), device="cpu", train=True, seed=0)
    task.net.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    state = steps.create_train_state(task, momentum=0.9)
    sampler = tsm.sample_batch_vt if layout == "vt" else tsm.sample_batch
    step = steps.make_train_step(task, acc_steps=acc, sampler=sampler)
    triples, _, eps, _ = _plan(case_id)
    images, labels = (torch.from_numpy(a) for a in _stacks(layout))
    with _pre_clip_grads(state) as grads:
        step(state, images, labels, torch.from_numpy(triples[0]), LRS[0],
             None if eps is None else torch.from_numpy(eps[0]))
    return {k: g.numpy() for k, g in grads.items()}


@pytest.mark.parametrize("case_id", list(TP_CASES))
def test_tp_step_matches_jax(case_id, worlds):
    (_, model), name, _, _, min_channels = TP_CASES[case_id]
    ranks = _ranks(worlds, case_id)
    want_metrics, want_vars = _jax_tp(case_id)
    net = _weights(name, tuple(KW[name].items()))[2].net
    assert_metrics_close(ranks[0]["metrics"], want_metrics)
    want_sd = flax_to_state_dict(want_vars, module_name_pairs(net))
    assert ranks[0]["state"].keys() == want_sd.keys()
    for k, v in want_sd.items():
        np.testing.assert_allclose(ranks[0]["state"][k], v, rtol=1e-5, atol=STATE_ATOL[name],
                                   err_msg=k)
    specs = ranks[0]["specs"]
    assert specs == {k: v for k, v in make_param_shardings(
        ranks[0]["state"], Mesh(len(ranks) // model, model), min_channels).items() if v}
    up_biases = [k for k in ranks[0]["state"] if k.endswith(".up.bias")]
    assert up_biases and all((k in specs) == (min_channels == 4) for k in up_biases)
    for r, got in enumerate(ranks):
        assert got["metrics"] == ranks[0]["metrics"], r
        np.testing.assert_array_equal(got["generator"], ranks[0]["generator"])
        for key in ("state", "momentum", "grads"):
            for k, v in ranks[0][key].items():
                np.testing.assert_array_equal(got[key][k], v, err_msg=f"rank {r} {key} {k}")
        for k, v in got["state"].items():  # this rank's tensors: its blocks of the whole
            n = v.shape[0] // model
            want = v[(r % model) * n:(r % model + 1) * n] if k in specs else v
            np.testing.assert_array_equal(got["local"][k], want, err_msg=f"rank {r} {k}")
    want = _one_process_grads(case_id)
    got = ranks[0]["grads"]
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert np.abs(got[k] - w).max() <= 1e-3 * np.abs(w).max(), k
    flat = [np.concatenate([d[k].ravel() for k in sorted(want)]) for d in (got, want)]
    assert np.linalg.norm(flat[0] - flat[1]) <= 1e-5 * np.linalg.norm(flat[1])


@pytest.mark.parametrize("case_id", list(TP_CASES))
def test_shard_then_gather_is_the_whole_state(case_id, worlds):
    """``gather_state(shard_state(whole))`` is ``whole`` bit for bit (after
    three steps: the momentum buffers too)."""
    for got in _ranks(worlds, case_id):
        for key in ("state", "momentum"):
            assert got["round_trip"][key].keys() == got[key].keys()
            for k, v in got[key].items():
                np.testing.assert_array_equal(got["round_trip"][key][k], v, err_msg=k)


@pytest.mark.parametrize("world", sorted(RESUME))
def test_checkpoint_round_trip_then_one_more_step(world, worlds):
    """The dryrun's checkpoint leg in the port's format: the gathered state
    written and read back, sharded again, then one more step: bit-equal to
    that step taken without the round trip, on every rank."""
    for got in worlds[world][0][RESUME[world]]:
        nxt, res = got["next"], got["resumed"]
        assert res["metrics"] == nxt["metrics"] and res["step"] == nxt["step"] == len(LRS) + 1
        for key in ("state", "momentum"):
            assert res[key].keys() == nxt[key].keys()
            for k, v in nxt[key].items():
                np.testing.assert_array_equal(res[key][k], v, err_msg=k)


@pytest.mark.parametrize("world,name", [(2, "views3"), (2, "int8"), (2, "views6"),
                                        (4, "views3")])
def test_evaluator_on_a_model_axis_is_one_process(world, name, worlds):
    """Every rank of the 1×2 (and 2×2) mesh, bit-equal to one process."""
    results, evals = worlds[world]
    want = _one_process(evals[name])
    for r, got in enumerate(results[name]):
        _assert_equal(got, want, f"{name} rank {r}")


def test_evaluator_on_1x2_matches_jax_4x2_mean_z(worlds):
    """mean_z on the port's 1×2 mesh against JAX's ``VolumeEvaluator`` on a
    4×2 mesh of its CPU devices with the same weights: argmax and Dice
    equal, fused and per-view probabilities within 1e-5."""
    results, evals = worlds[2]
    case = evals["mean_z"]
    variables = jax_ckpt.import_torch_state_dict(
        {k: torch.from_numpy(v) for k, v in case["state_dict"].items()}, "probunet",
        num_filters=(4, 8), no_convs_fcomb=4)
    jtask = jax_make_task("probunet", **EVAL_KW["probunet"], no_convs_fcomb=4)
    jev = jax_engine.VolumeEvaluator(jtask, eval_batch=20, mean_z=True,
                                     mesh=jax_mesh(data=4, model=2))
    want = jev.evaluate_volume(jax.tree_util.tree_map(jnp.asarray, variables), IMG[0], LBL[0])
    for r in results["mean_z"]:
        got = r[0]
        np.testing.assert_array_equal(got["argmax"], want["argmax"])
        np.testing.assert_allclose(got["fused"], np.asarray(want["fused"]), rtol=0, atol=1e-5)
        for g, w in zip(got["views"], want["views"]):
            np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-5)
        np.testing.assert_array_equal(got["dice"], want["dice"])
