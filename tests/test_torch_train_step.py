"""The port's train step on the CPU against the JAX package's jitted step,
with the same weights (BatchNorm statistics randomized), the same batches
and the JAX step's own posterior eps injected: two f32 steps of the U-Net
and the probabilistic U-Net, at ``acc_steps`` 1 (batch 2) and 4 (batch 8),
from the view stacks and from the plain stack.

Compared: each step's loss terms (rtol 1e-5); the averaged gradients before
the clip, all together within 1e-5 in relative L2 norm and each tensor
within 1e-3 of its max |gradient| (conv sums run in another order in the
two frameworks, and a sum of many terms of both signs cancels: the
posterior's first BatchNorm bias gradient, 0.97 at a step where it is 24
at the other, differs by 1.9e-4 of itself; most tensors by 3e-6); the
parameters and BatchNorm statistics after the two steps (rtol 1e-5, atol
1e-5: about 1e-3 of the most a parameter can move in two clipped steps,
lr·0.1·(1 + momentum)); and the BatchNorm-fed conv biases, bit-equal to
their init in both packages. The plateau scheduler makes JAX's decisions
on a scripted metric sequence."""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmpu_tpu.data import sampler as jsm
from pmpu_tpu.data.index_map import build_index_map
from pmpu_tpu.data.volumes import make_view_stacks
from pmpu_tpu.train.schedule import ReduceLROnPlateau as JaxPlateau
from pmpu_tpu.train.steps import TrainState as JaxState
from pmpu_tpu.train.steps import make_eval_step as jax_eval_step
from pmpu_tpu.train.steps import make_optimizer as jax_optimizer
from pmpu_tpu.train.steps import make_train_step as jax_train_step
from pmpu_tpu.train.steps import mask_inert_bn_biases as jax_mask
from pmpu_tpu_torch.data import sampler as tsm
from pmpu_tpu_torch.train import steps
from pmpu_tpu_torch.train.checkpoint import flax_to_state_dict, flax_variables, module_name_pairs
from pmpu_tpu_torch.train.checkpoint import load_flax_variables
from pmpu_tpu_torch.train.schedule import ReduceLROnPlateau
from pmpu_tpu_torch.train.tasks import make_task
from pmpu_tpu.train.tasks import make_task as jax_make_task
from tests.test_torch_weights import _randomize_bn

NF, LATENT, CUBE = (4, 8), 3, 16
LRS = (0.05, 0.02)


def _data():
    rng = np.random.default_rng(21)
    img = rng.random((3, CUBE, CUBE, CUBE)).astype(np.float32)
    lbl = np.zeros((3, CUBE, CUBE, CUBE), np.int32)
    lbl[:, 3:12, 4:13, 2:11] = rng.integers(0, 3, size=(3, 9, 9, 9))
    return img, lbl


def _kw(name, n_classes):
    return dict(n_classes=n_classes, num_filters=NF,
                **({"latent_dim": LATENT} if name == "probunet" else {}))


@functools.lru_cache(maxsize=None)
def _jax_task(name, n_classes):
    """The JAX task and its jitted microbatch gradient, made once a module
    (every case's microbatch is 2 slices, so one compilation serves all)."""
    task = jax_make_task(name, **_kw(name, n_classes))

    @jax.jit
    def one(p, bs, img, msk, k):
        return jax.value_and_grad(lambda q: task.train_loss(jax_mask(q), bs, img, msk, k),
                                  has_aux=True)(p)

    return task, one


def _tasks(name, n_classes):
    """The port's training task and the JAX task with the same weights (the
    port's init, BatchNorm randomized), and those weights as a flax tree."""
    task = make_task(name, **_kw(name, n_classes), device="cpu", train=True, seed=0)
    variables = _randomize_bn(flax_variables(task.net), np.random.default_rng(100))
    load_flax_variables(task.net, variables)
    return _jax_task(name, n_classes)[0], task, variables


def _jax_grads(task, params, bstats, images, labels, triples, key, acc, sampler):
    """The averaged gradient of the JAX step (``build_step_fn``'s body)."""
    micro = triples.shape[0] // acc
    keys = jax.random.split(key, acc)
    one = _jax_task(task.name, task.n_classes)[1]
    total = None
    for i in range(acc):
        img, msk = sampler(images, labels, triples[i * micro:(i + 1) * micro])
        (_, (bstats, _)), g = one(params, bstats, img, msk, keys[i])
        total = g if total is None else jax.tree_util.tree_map(jnp.add, total, g)
    return jax.tree_util.tree_map(lambda g: np.asarray(g / acc), total)


CASES = [("unet", 1, "vt"), ("unet", 4, "plain"), ("probunet", 1, "plain"),
         ("probunet", 4, "vt")]


@pytest.mark.parametrize("name,acc,layout", CASES)
def test_train_steps_match_jax(name, acc, layout, monkeypatch):
    n_classes = 1 if name == "unet" else 3
    jtask, task, variables = _tasks(name, n_classes)
    state = steps.create_train_state(task, momentum=0.9)
    inert = {id(b) for b in steps.inert_bn_biases(task.net)}
    names = {p: n for n, p in task.net.named_parameters()}
    init = {n: p.detach().clone() for n, p in task.net.named_parameters()}

    img, lbl = _data()
    if layout == "vt":
        img, lbl = make_view_stacks(img), make_view_stacks(lbl)
        jsampler, tsampler = jsm.sample_batch_vt, tsm.sample_batch_vt
    else:
        jsampler, tsampler = jsm.sample_batch, tsm.sample_batch
    index = build_index_map(_data()[1], filter=True)
    batch = 2 if acc == 1 else 8
    rng = np.random.default_rng(3)

    tx = jax_optimizer(momentum=0.9, clip=0.1, lr=LRS[0])
    jstate = JaxState(params=variables["params"], batch_stats=variables["batch_stats"],
                      opt_state=tx.init(variables["params"]), step=jnp.zeros((), jnp.int32))
    jstep = jax_train_step(task=jtask, tx=tx, acc_steps=acc, donate=False, sampler=jsampler)
    tstep = steps.make_train_step(task, acc_steps=acc, sampler=tsampler)

    grads_seen = []
    clip = torch.nn.utils.clip_grad_value_

    def spy(params, value):
        grads_seen.append({names[p]: (None if p.grad is None else p.grad.clone()) for p in params})
        return clip(params, value)

    monkeypatch.setattr(torch.nn.utils, "clip_grad_value_", spy)
    pairs = module_name_pairs(task.net)
    ji, jl = jnp.asarray(img), jnp.asarray(lbl)
    ti, tl = torch.from_numpy(img), torch.from_numpy(lbl)
    for k, lr in enumerate(LRS):
        triples = index[rng.choice(len(index), batch, replace=False)]
        key = jax.random.key(100 + k)
        eps = torch.from_numpy(np.stack([
            np.asarray(jax.random.normal(sk, (batch // acc, LATENT)))
            for sk in jax.random.split(key, acc)]))
        want_g = _jax_grads(jtask, jstate.params, jstate.batch_stats, ji, jl,
                            jnp.asarray(triples), key, acc, jsampler)
        jstate, jm = jstep(jstate, ji, jl, jnp.asarray(triples), key, lr)
        state, tm = tstep(state, ti, tl, torch.from_numpy(triples), lr,
                          eps if name == "probunet" else None)
        assert set(tm) == set(jm)
        for m in jm:
            np.testing.assert_allclose(float(tm[m]), float(jm[m]), rtol=1e-5, err_msg=m)
        # gradients before the clip, in torch layout
        want = flax_to_state_dict({"params": want_g, "batch_stats": variables["batch_stats"]},
                                  pairs)
        sq_err = sq_norm = 0.0
        for n, g in grads_seen[-1].items():
            w = want[n]
            if g is None:
                assert not np.any(w), n  # an inert bias or an unused head
                continue
            d = g.numpy().astype(np.float64) - w
            sq_err, sq_norm = sq_err + np.sum(d * d), sq_norm + np.sum(np.square(w, dtype=float))
            err = np.abs(d).max()
            assert err <= 1e-3 * max(np.abs(w).max(), 1e-12), (n, err, np.abs(w).max())
        assert np.sqrt(sq_err / sq_norm) <= 1e-5
    assert state.step == 2
    got_sd = flax_to_state_dict(flax_variables(task.net), pairs)
    want_sd = flax_to_state_dict(jax.tree_util.tree_map(
        np.asarray, {"params": jstate.params, "batch_stats": jstate.batch_stats}), pairs)
    for n in want_sd:
        np.testing.assert_allclose(got_sd[n], want_sd[n], rtol=1e-5, atol=1e-5, err_msg=n)
    # the BatchNorm-fed conv biases stay at their init, in both packages
    init_sd = flax_to_state_dict(variables, pairs)
    n_inert = 0
    for p in task.net.parameters():
        if id(p) in inert:
            n_inert += 1
            assert torch.equal(p, init[names[p]]), names[p]
            np.testing.assert_array_equal(want_sd[names[p]], init_sd[names[p]])
            assert not p.requires_grad
    # 2 convs a DoubleConv: inc, 1 down, 1 up (+ 2 blocks x 2 convs x 2 encoders)
    assert n_inert == (6 if name == "unet" else 14)


@pytest.mark.parametrize("name", ["unet", "probunet"])
def test_eval_step_matches_jax(name):
    """The validation step (BatchNorm on running statistics): the loss,
    per-class Dice, predictions and batch against the JAX eval step, with
    its posterior and prior eps injected (rtol 1e-5 / atol 1e-5)."""
    n_classes = 1 if name == "unet" else 3
    jtask, task, variables = _tasks(name, n_classes)
    state = steps.create_train_state(task)
    img, lbl = _data()
    vt_i, vt_l = make_view_stacks(img), make_view_stacks(lbl)
    triples = build_index_map(lbl)[::7][:6]
    key = jax.random.key(5)
    jstate = JaxState(params=variables["params"], batch_stats=variables["batch_stats"],
                      opt_state=None, step=0)
    want = jax_eval_step(jtask, sampler=jsm.sample_batch_vt)(
        jstate, jnp.asarray(vt_i), jnp.asarray(vt_l), jnp.asarray(triples), key)
    eps = tuple(torch.from_numpy(np.asarray(jax.random.normal(k, (len(triples), LATENT))))
                for k in (key, jax.random.fold_in(key, 1)))
    got = steps.make_eval_step(task, sampler=tsm.sample_batch_vt)(
        state, torch.from_numpy(vt_i), torch.from_numpy(vt_l), torch.from_numpy(triples),
        eps if name == "probunet" else None)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    assert task.net.training  # the eval step leaves the net in train mode


@pytest.mark.parametrize("name,n_classes", [("unet", 1), ("probunet", 1), ("probunet", 3)])
def test_predict_matches_jax(name, n_classes):
    """``predict``: eval-mode BatchNorm, a prior draw (JAX's eps injected)
    decoded, sigmoid probs for 1 class (rtol 1e-5 / atol 1e-6)."""
    jtask, task, variables = _tasks(name, n_classes)
    x = np.random.default_rng(8).random((3, CUBE, CUBE, 1)).astype(np.float32)
    key = jax.random.key(6)
    want = jtask.predict(variables, jnp.asarray(x), key=key)
    eps = torch.from_numpy(np.asarray(jax.random.normal(key, (3, LATENT))))
    got = task.predict(torch.from_numpy(x), eps=eps if name == "probunet" else None)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    assert task.net.training


def test_step_draws_from_the_generator_without_eps():
    """Without eps the posterior eps is ``randn(loc.shape)`` from the state's
    generator: the step equals, bit for bit, a step given those draws."""
    img, lbl = _data()
    vt_i, vt_l = torch.from_numpy(make_view_stacks(img)), torch.from_numpy(make_view_stacks(lbl))
    triples = torch.from_numpy(build_index_map(lbl)[:8])
    g = torch.Generator().manual_seed(5)
    eps = [torch.randn((2, LATENT), generator=g) for _ in range(4)]  # one draw a microbatch
    out = []
    for seed, e in ((5, None), (9, eps)):
        task = make_task("probunet", num_filters=NF, latent_dim=LATENT, device="cpu", train=True)
        state = steps.create_train_state(task, seed=seed)
        before = state.generator.get_state()
        steps.make_train_step(task, acc_steps=4, sampler=tsm.sample_batch_vt)(
            state, vt_i, vt_l, triples, 0.01, e)
        assert torch.equal(state.generator.get_state(), before) == (e is not None)
        out.append(task.net.state_dict())
    for k in out[0]:
        assert torch.equal(out[0][k], out[1][k]), k


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_runs_with_tf32_off_in_every_dtype(dtype, monkeypatch):
    """Every microbatch's backward pass runs inside ``exact_f32``, in a bf16
    step too: its μ/log σ heads are f32 convs, whose cuDNN backward would
    otherwise take TF32 on the card."""
    exact, flags = steps.exact_f32, []

    @contextlib.contextmanager
    def recording():
        with exact():
            flags.append(torch.backends.cudnn.allow_tf32)
            yield

    monkeypatch.setattr(steps, "exact_f32", recording)
    img, lbl = _data()
    task = make_task("probunet", num_filters=NF, latent_dim=LATENT, dtype=dtype, device="cpu",
                     train=True)
    state = steps.create_train_state(task)
    steps.make_train_step(task, acc_steps=2)(
        state, torch.from_numpy(img), torch.from_numpy(lbl),
        torch.from_numpy(build_index_map(lbl)[:4]), 0.01)
    assert flags == [False, False]
    assert task.net.prior.conv_layer.weight.grad is not None


def test_create_train_state_needs_a_training_task():
    task = make_task("unet", num_filters=NF, device="cpu")
    with pytest.raises(ValueError, match="train=True"):
        steps.create_train_state(task)


def test_plateau_decisions_match_jax():
    seq = [1.0, 0.9, 0.95, 0.9, 0.89995, 0.91, 0.92, 0.5, 0.6, 0.6, 0.6, 0.6, 0.4, 0.41]
    for mode in ("min", "max"):
        got = ReduceLROnPlateau(lr=0.1, mode=mode, factor=0.5, patience=2, min_lr=0.01)
        want = JaxPlateau(lr=0.1, mode=mode, factor=0.5, patience=2, min_lr=0.01)
        for i, m in enumerate(seq):
            assert got.step(m) == want.step(m), (mode, i)
            assert got.state_dict() == want.state_dict()
        again = ReduceLROnPlateau.from_state_dict(got.state_dict())
        assert again == got and JaxPlateau.from_state_dict(got.state_dict()) == want
