"""The port's augmentation (``pmpu_tpu_torch.data.augment``) on the CPU
against the JAX package's ``augment_batch``, with JAX's draws injected
(``jax_draws``: the eight draws of ``augment_batch`` :89-127 from its key):
flips, 90° rotations and the nearest mask warp bit-equal; the cubic
resize of the elastic field within 1e-6 of ``jax.image.resize`` (the same
weight matrices bit for bit; the products summed in another order); the
whole image batch within 1e-5 and the masks bit-equal. Then one U-Net and
one probabilistic U-Net train step with ``augment`` against the JAX step,
its eps and draws injected (``step_parity``, the tolerances of
``tests/test_torch_train_step.py``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmpu_tpu.data import augment as ja
from pmpu_tpu.data import sampler as jsm
from pmpu_tpu.data.index_map import build_index_map
from pmpu_tpu.data.volumes import make_view_stacks
from pmpu_tpu.train.steps import TrainState as JaxState
from pmpu_tpu.train.steps import make_optimizer as jax_optimizer
from pmpu_tpu.train.steps import make_train_step as jax_train_step
from pmpu_tpu_torch.data import augment as ta
from pmpu_tpu_torch.data import sampler as tsm
from pmpu_tpu_torch.train import steps
from pmpu_tpu_torch.train.checkpoint import flax_to_state_dict, flax_variables, module_name_pairs
from tests.test_torch_train_step import LATENT, LRS, _data, _jax_task, _tasks

B, H = 6, 16


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    imgs = rng.random((B, H, H, 1)).astype(np.float32)
    imgs[0] -= 0.5  # negative values through the gamma's sign(x)
    return imgs, rng.integers(0, 3, (B, H, H, 1)).astype(np.int32)


def jax_draws(key, shape, cfg) -> dict:
    """The draws of JAX's ``augment_batch(imgs, msks, key, cfg)`` in the
    port's ``draw_augment`` layout."""
    b, h, w, _ = shape
    keys = jax.random.split(key, 8)
    d = {}
    if cfg.flip:
        d["flip_h"] = jax.random.bernoulli(keys[0], 0.5, (b, 1, 1, 1))
        d["flip_w"] = jax.random.bernoulli(keys[1], 0.5, (b, 1, 1, 1))
    if cfg.rot90 and h == w:
        d["k"] = jax.random.randint(keys[2], (b,), 0, 4)
    if cfg.elastic_alpha > 0:
        d["field"] = jax.random.normal(keys[3], (b, cfg.elastic_grid, cfg.elastic_grid, 2))
    for name, i, a in (("scale", 4, cfg.intensity_scale), ("shift", 5, cfg.intensity_shift),
                       ("gamma", 6, cfg.gamma)):
        if a > 0:
            d[name] = jax.random.uniform(keys[i], (b, 1, 1, 1), minval=-a, maxval=a)
    if cfg.noise_std > 0:
        d["noise"] = jax.random.normal(keys[7], shape)
    per_sample = {"flip_h", "flip_w", "scale", "shift", "gamma"}
    return {k: torch.from_numpy(np.array(v)).reshape((b,) if k in per_sample else v.shape)
            for k, v in d.items()}


def _both(cfg_kw, seed=0):
    """(JAX's augmented batch, the port's with JAX's draws)."""
    imgs, msks = _batch(seed)
    jcfg, tcfg = ja.AugmentConfig(**cfg_kw), ta.AugmentConfig(**cfg_kw)
    key = jax.random.key(seed + 3)
    want = ja.augment_batch(jnp.asarray(imgs), jnp.asarray(msks), key, jcfg)
    got = ta.augment_batch(torch.from_numpy(imgs), torch.from_numpy(msks), None, tcfg,
                           jax_draws(key, imgs.shape, jcfg))
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


OFF = dict(flip=False, rot90=False, intensity_scale=0.0, intensity_shift=0.0, gamma=0.0,
           noise_std=0.0)


@pytest.mark.parametrize("only", ["flip", "rot90"])
def test_geometry_transforms_bit_equal(only):
    for seed in range(3):
        (wi, wm), (gi, gm) = _both({**OFF, only: True}, seed)
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gm, wm)
        assert gi.dtype == np.float32 and gm.dtype == np.int32


def test_elastic_warp_masks_bit_equal_and_images_close():
    """The elastic warp alone (alpha 4): nearest mask warp bit-equal, the
    bilinear image warp within 1e-6 (the field's resize differs by an ulp)."""
    (wi, wm), (gi, gm) = _both({**OFF, "elastic_alpha": 4.0})
    np.testing.assert_array_equal(gm, wm)
    np.testing.assert_allclose(gi, wi, rtol=0, atol=1e-6)


@pytest.mark.parametrize("size", [8, 16, 128])
def test_cubic_resize_matches_jax_image_resize(size):
    """JAX's cubic resize (Keys a = −0.5, half-pixel centres, normalized
    edge weights): the weight matrix bit-equal to JAX's, the resized unit
    normal field within 1e-6 (two products in another summation order)."""
    from jax._src.image import scale

    field = np.array(jax.random.normal(jax.random.key(9), (3, 4, 4, 2)))
    want = np.asarray(jax.image.resize(jnp.asarray(field), (3, size, size, 2), method="cubic"))
    got = ta.cubic_resize(torch.from_numpy(field), size, size).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    w = scale.compute_weight_mat(4, size, size / 4, 0.0, scale._fill_keys_cubic_kernel, True)
    np.testing.assert_array_equal(ta._cubic_weights(4, size).numpy(), np.asarray(w))


def test_whole_augmentation_matches_jax():
    """All transforms, elastic alpha 4: images within 1e-5, masks equal."""
    for seed in range(2):
        (wi, wm), (gi, gm) = _both({"elastic_alpha": 4.0}, seed)
        np.testing.assert_array_equal(gm, wm)
        np.testing.assert_allclose(gi, wi, rtol=0, atol=1e-5)


def test_draws_come_from_the_generator():
    """Without ``draws`` the batch is the one ``draw_augment`` gives from
    the same generator state; its draws have the documented shapes."""
    imgs, msks = (torch.from_numpy(a) for a in _batch())
    cfg = ta.AugmentConfig(elastic_alpha=2.0)
    d = ta.draw_augment(imgs.shape, cfg, torch.Generator().manual_seed(4))
    assert {k: tuple(v.shape) for k, v in d.items()} == {
        "flip_h": (B,), "flip_w": (B,), "k": (B,), "field": (B, 4, 4, 2), "scale": (B,),
        "shift": (B,), "gamma": (B,), "noise": (B, H, H, 1)}
    assert d["flip_h"].dtype == torch.bool and 0 <= int(d["k"].min()) <= int(d["k"].max()) < 4
    assert float(d["gamma"].abs().max()) <= 0.1
    a = ta.augment_batch(imgs, msks, torch.Generator().manual_seed(4), cfg)
    b = ta.augment_batch(imgs, msks, None, cfg, d)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _jax_grads(jtask, params, bstats, images, labels, triples, key, acc, sampler, aug):
    """The averaged gradient of JAX's step body, the augmentation included."""
    micro = triples.shape[0] // acc
    one = _jax_task(jtask.name, jtask.n_classes)[1]
    total = None
    for i, k in enumerate(jax.random.split(key, acc)):
        img, msk = sampler(images, labels, triples[i * micro:(i + 1) * micro])
        if aug is not None:
            img, msk = ja.augment_batch(img, msk, jax.random.fold_in(k, 7), aug)
        (_, (bstats, _)), g = one(params, bstats, img, msk, k)
        total = g if total is None else jax.tree_util.tree_map(jnp.add, total, g)
    return jax.tree_util.tree_map(lambda g: np.asarray(g / acc), total)


def step_parity(name, acc, img, lbl, index, jsampler, tsampler, augment=None, batch=None):
    """Two steps of the port's ``make_train_step`` against JAX's
    ``make_train_step`` from the same weights on the same (numpy) stacks,
    JAX's eps and augmentation draws injected: the loss terms (rtol 1e-5),
    the pre-clip gradients (1e-5 relative L2, each tensor within 1e-3 of
    its max |gradient|), the parameters and BatchNorm statistics after
    (rtol 1e-5, atol 1e-5), as ``tests/test_torch_train_step.py`` holds
    them."""
    n_classes = 1 if name == "unet" else 3
    jtask, task, variables = _tasks(name, n_classes)
    state = steps.create_train_state(task, momentum=0.9)
    names = {p: n for n, p in task.net.named_parameters()}
    jaug = None if augment is None else ja.AugmentConfig(**dataclasses.asdict(augment))
    tx = jax_optimizer(momentum=0.9, clip=0.1, lr=LRS[0])
    jstate = JaxState(params=variables["params"], batch_stats=variables["batch_stats"],
                      opt_state=tx.init(variables["params"]), step=jnp.zeros((), jnp.int32))
    jstep = jax_train_step(task=jtask, tx=tx, acc_steps=acc, donate=False, sampler=jsampler,
                           augment=jaug)
    tstep = steps.make_train_step(task, acc_steps=acc, sampler=tsampler, augment=augment)
    grads_seen, clip = [], torch.nn.utils.clip_grad_value_

    def spy(params, value):
        grads_seen.append({names[p]: None if p.grad is None else p.grad.clone()
                           for p in params})
        return clip(params, value)

    pairs = module_name_pairs(task.net)
    ji, jl = jnp.asarray(img), jnp.asarray(lbl)
    ti, tl = torch.from_numpy(np.array(img)), torch.from_numpy(np.array(lbl))
    batch = batch or (2 if acc == 1 else 8)
    micro = batch // acc
    rng = np.random.default_rng(3)
    s = img.shape[-1]
    torch.nn.utils.clip_grad_value_ = spy
    try:
        for k, lr in enumerate(LRS):
            triples = index[rng.choice(len(index), batch, replace=False)]
            key = jax.random.key(100 + k)
            subs = jax.random.split(key, acc)
            eps = torch.from_numpy(np.stack([np.asarray(jax.random.normal(sk, (micro, LATENT)))
                                             for sk in subs]))
            draws = None if jaug is None else [
                jax_draws(jax.random.fold_in(sk, 7), (micro, s, s, 1), jaug) for sk in subs]
            want_g = _jax_grads(jtask, jstate.params, jstate.batch_stats, ji, jl,
                                jnp.asarray(triples), key, acc, jsampler, jaug)
            jstate, jm = jstep(jstate, ji, jl, jnp.asarray(triples), key, lr)
            state, tm = tstep(state, ti, tl, torch.from_numpy(triples), lr,
                              eps if name == "probunet" else None, draws)
            assert set(tm) == set(jm)
            for m in jm:
                np.testing.assert_allclose(float(tm[m]), float(jm[m]), rtol=1e-5, err_msg=m)
            want = flax_to_state_dict({"params": want_g,
                                       "batch_stats": variables["batch_stats"]}, pairs)
            sq_err = sq_norm = 0.0
            for n, g in grads_seen[-1].items():
                w = want[n]
                if g is None:
                    assert not np.any(w), n
                    continue
                d = g.numpy().astype(np.float64) - w
                sq_err += np.sum(d * d)
                sq_norm += np.sum(np.square(w, dtype=float))
                assert np.abs(d).max() <= 1e-3 * max(np.abs(w).max(), 1e-12), n
            assert np.sqrt(sq_err / sq_norm) <= 1e-5
    finally:
        torch.nn.utils.clip_grad_value_ = clip
    got_sd = flax_to_state_dict(flax_variables(task.net), pairs)
    want_sd = flax_to_state_dict(jax.tree_util.tree_map(
        np.asarray, {"params": jstate.params, "batch_stats": jstate.batch_stats}), pairs)
    for n in want_sd:
        np.testing.assert_allclose(got_sd[n], want_sd[n], rtol=1e-5, atol=1e-5, err_msg=n)


@pytest.mark.parametrize("name,acc", [("unet", 1), ("probunet", 4)])
def test_augmented_steps_match_jax(name, acc):
    img, lbl = _data()
    vt_i, vt_l = make_view_stacks(img), make_view_stacks(lbl)
    step_parity(name, acc, vt_i, vt_l, build_index_map(lbl, filter=True), jsm.sample_batch_vt,
                tsm.sample_batch_vt, augment=ta.AugmentConfig(elastic_alpha=4.0))
