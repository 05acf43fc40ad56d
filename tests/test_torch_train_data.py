"""The port's training data layout on the CPU against the JAX package,
exactly: the index map, the view stacks, the samplers (the view-stack one
is the gather-normalize kernel's plain version here), the train/val split
and the epoch order of the loop."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmpu_tpu.data import index_map as jim
from pmpu_tpu.data import sampler as jsm
from pmpu_tpu.data.volumes import make_view_stacks as jax_view_stacks
from pmpu_tpu.ops.pallas.slice_gather import pallas_sample_batch
from pmpu_tpu.train.loop import split_indices as jax_split
from pmpu_tpu_torch.config import Config
from pmpu_tpu_torch.data import index_map as tim
from pmpu_tpu_torch.data import sampler as tsm
from pmpu_tpu_torch.data.volumes import VolumeStore, make_view_stacks
from pmpu_tpu_torch.train import loop

RNG = np.random.default_rng(5)


def _data(n=3, s=12):
    """Seeded images (one all-zero volume, negative values) and labels with
    empty planes in every view."""
    img = RNG.normal(size=(n, s, s, s)).astype(np.float32)
    img[1] = 0.0
    lbl = np.zeros((n, s, s, s), np.int32)
    lbl[:, 3:8, 2:9, 4:7] = RNG.integers(0, 3, size=(n, 5, 7, 3))
    lbl[2, 0, 0, 0] = 2
    return img, lbl


@pytest.mark.parametrize("flt", [True, False])
def test_index_map_equals_jax(flt):
    _, lbl = _data()
    np.testing.assert_array_equal(tim.nonempty_table(lbl), jim.nonempty_table(lbl))
    got, want = tim.build_index_map(lbl, filter=flt), jim.build_index_map(lbl, filter=flt)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    table = RNG.random((2, 5, 7)) > 0.5
    np.testing.assert_array_equal(tim.build_index_map_from_table(table, flt),
                                  jim.build_index_map_from_table(table, flt))


def test_view_stacks_equal_jax():
    img, lbl = _data()
    for a in (img, lbl):
        got, want = make_view_stacks(a), jax_view_stacks(a)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def _bits(a):
    return np.asarray(a).view(np.int32)


def test_samplers_equal_jax():
    """Every (scan, view, slice) of 3 scans of 12³, in a shuffled order with
    repeats: sample_batch and sample_batch_vt bit for bit against JAX
    (sample_batch_vt also against the Pallas kernel in interpret mode)."""
    img, lbl = _data()
    index = jim.build_index_map(lbl, filter=False)
    triples = index[np.concatenate([RNG.permutation(len(index)), [0, 0, 5]])]
    want_i, want_l = jsm.sample_batch(jnp.asarray(img), jnp.asarray(lbl), jnp.asarray(triples))
    got_i, got_l = tsm.sample_batch(torch.from_numpy(img), torch.from_numpy(lbl),
                                    torch.from_numpy(triples))
    assert got_i.shape == want_i.shape == (len(triples), 12, 12, 1)
    assert got_i.dtype == torch.float32 and got_l.dtype == torch.int32
    np.testing.assert_array_equal(_bits(got_i.numpy()), _bits(want_i))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))

    vt_i, vt_l = make_view_stacks(img), make_view_stacks(lbl)
    jvt = jsm.sample_batch_vt(jnp.asarray(vt_i), jnp.asarray(vt_l), jnp.asarray(triples))
    pal = pallas_sample_batch(jnp.asarray(vt_i), jnp.asarray(vt_l), jnp.asarray(triples),
                              interpret=True)
    gi, gl = tsm.sample_batch_vt(torch.from_numpy(vt_i), torch.from_numpy(vt_l),
                                 torch.from_numpy(triples))
    for wi, wl in (jvt, pal, (want_i, want_l)):
        np.testing.assert_array_equal(_bits(gi.numpy()), _bits(wi))
        np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))


@pytest.mark.parametrize("n,val", [(0, 10.0), (7, 10.0), (120, 10.0), (120, 0.0), (33, 25.0)])
def test_split_indices_equal_jax(n, val):
    got = loop.split_indices(n, val / 100.0, np.random.default_rng(3))
    want = jax_split(n, val / 100.0, np.random.default_rng(3))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_loop_walks_the_jax_split_and_epoch_order(monkeypatch, tmp_path):
    """The rows the port's loop hands its train and eval steps, over 2
    epochs, are those of the JAX loop's numpy stream: ``default_rng(seed)``
    → split_indices → one permutation an epoch, ``per_step`` rows a step,
    validation in split order."""
    img, lbl = _data(3, 12)
    cfg = Config(net="unet", num_filters=(4, 8), epochs=2, batchsize=6, seed=11, val=20.0,
                 save_cp=False, checkpoint_dir=str(tmp_path))
    seen = {"train": [], "val": []}

    def spy(kind, make):
        def wrapped(task, *a, **k):
            step = make(task, *a, **k)

            def run(state, images, labels, triples, *rest, **kw):
                seen[kind].append(triples.numpy().copy())
                return step(state, images, labels, triples, *rest, **kw)
            return run
        return wrapped

    monkeypatch.setattr(loop, "make_train_step", spy("train", loop.make_train_step))
    monkeypatch.setattr(loop, "make_eval_step", spy("val", loop.make_eval_step))
    loop.train_net(cfg, VolumeStore.from_arrays(img, lbl), device="cpu")

    index = jim.build_index_map(lbl, filter=True)
    rng = np.random.default_rng(11)
    train_idx, val_idx = jax_split(len(index), 0.2, rng)
    per_step = 4  # batch 6 > 4: 4 microbatches of 6 // 4 = 1 row
    want_train, want_val = [], []
    for _ in range(2):
        order = rng.permutation(len(train_idx))
        want_train += [index[train_idx[order[i * per_step:(i + 1) * per_step]]]
                       for i in range(len(order) // per_step)]
        want_val += [index[val_idx[i * per_step:(i + 1) * per_step]]
                     for i in range(max(len(val_idx) // per_step, 1))]
    assert len(seen["train"]) == len(want_train) > 0
    for got, want in zip(seen["train"] + seen["val"], want_train + want_val):
        np.testing.assert_array_equal(got, want)
    assert len(seen["val"]) == len(want_val)
