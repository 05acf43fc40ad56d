"""The port's ``--stream`` data path (``pmpu_tpu_torch.data.pipeline``) on
the CPU against the JAX package: ``gather_host_batch`` bit-equal to JAX's
on the f32, bf16 and uint8 wires; ``PrefetchPipeline`` yields the resident
gather's batches (through ``sample_rows``) in order and in full, a short
last batch included, raises a producer's error in the consumer and stops
its producer when the consumer stops early; the train loop picks JAX's
wire dtypes; a ``--stream`` step equals the resident step bit for bit."""

import sys
import threading

import ml_dtypes
import numpy as np
import pytest
import torch

from pmpu_tpu.data.pipeline import gather_host_batch as jax_gather
from pmpu_tpu_torch.config import Config
from pmpu_tpu_torch.data import pipeline
from pmpu_tpu_torch.data.index_map import build_index_map
from pmpu_tpu_torch.data.sampler import sample_batch_vt, sample_rows
from pmpu_tpu_torch.data.volumes import VolumeStore, make_view_stacks
from pmpu_tpu_torch.train import loop, steps
from pmpu_tpu_torch.train.tasks import make_task

S = 12


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def _store(seed=0, n=3):
    """Seeded scans with negative values, an all-zero plane and labels up
    to 2."""
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(n, S, S, S)).astype(np.float32)
    img[1, :, 4, :] = 0.0
    lbl = np.zeros((n, S, S, S), np.int32)
    lbl[:, 2:9, 3:10, 1:8] = rng.integers(0, 3, (n, 7, 7, 7))
    return VolumeStore.from_arrays(img, lbl)


def _rows(store, b, seed):
    index = build_index_map(store.labels, filter=False)
    return index[np.random.default_rng(seed).choice(len(index), b, replace=False)]


@pytest.mark.parametrize("wire", ["f32", "bf16", "uint8"])
def test_gather_host_batch_bit_equal_to_jax(wire):
    store = _store()
    rows = np.concatenate([_rows(store, 20, 1), [[1, 1, 4]]]).astype(np.int32)  # a zero plane
    tdt, jdt = {"f32": (torch.float32, np.float32), "bf16": (torch.bfloat16, ml_dtypes.bfloat16),
                "uint8": (torch.float32, np.float32)}[wire]
    mt, mj = (torch.uint8, np.uint8) if wire == "uint8" else (torch.int32, np.int32)
    gi, gl = pipeline.gather_host_batch(store.images, store.labels, rows, tdt, mt)
    wi, wl = jax_gather(store.images, store.labels, rows, image_dtype=jdt, mask_dtype=mj)
    assert gi.dtype == tdt and gl.dtype == mt and gi.shape == (21, S, S, 1)
    bits = (lambda t: t.view(torch.int16).numpy()) if wire == "bf16" else (lambda t: t.numpy())
    np.testing.assert_array_equal(bits(gi), wi.view(np.int16) if wire == "bf16" else wi)
    np.testing.assert_array_equal(gl.numpy(), wl)


def test_pipeline_yields_the_resident_batches():
    """Every batch, in order, the last one short: through ``sample_rows``
    bit-equal to ``sample_batch_vt`` on the view stacks."""
    store = _store(2)
    vt_i = torch.from_numpy(make_view_stacks(store.images))
    vt_l = torch.from_numpy(make_view_stacks(store.labels))
    batches = [_rows(store, 8, k) for k in range(6)] + [_rows(store, 3, 9)]
    pipe = pipeline.PrefetchPipeline(store, depth=2, device="cpu")
    got = list(pipe.iterate(batches))
    assert len(got) == len(batches)
    for rows, (imgs, lbls) in zip(batches, got):
        n = len(rows)
        ti, tl = sample_rows(imgs, lbls, torch.arange(n)[:, None].expand(n, 3))
        want_i, want_l = sample_batch_vt(vt_i, vt_l, torch.from_numpy(rows))
        assert torch.equal(ti, want_i) and torch.equal(tl, want_l)


def test_pipeline_raises_the_producers_error(monkeypatch):
    store = _store()
    real = pipeline.gather_host_batch
    calls = {"n": 0}

    def failing(*a, **k):
        calls["n"] += 1
        if calls["n"] == 3:
            raise OSError("disk gone")
        return real(*a, **k)

    monkeypatch.setattr(pipeline, "gather_host_batch", failing)
    seen = []
    with pytest.raises(OSError, match="disk gone"):
        for batch in pipeline.PrefetchPipeline(store, device="cpu").iterate(
                [_rows(store, 4, k) for k in range(5)]):
            seen.append(batch)
    assert len(seen) == 2


def test_pipeline_stops_its_producer_when_closed():
    store = _store()
    before = {t.ident for t in threading.enumerate()}
    it = pipeline.PrefetchPipeline(store, depth=1, device="cpu").iterate(
        [_rows(store, 4, k % 3) for k in range(50)])
    next(it)
    it.close()
    assert not [t for t in threading.enumerate()
                if t.name == "prefetch" and t.ident not in before and t.is_alive()]


@pytest.mark.parametrize("bf16,augment,negative,want", [
    (True, False, False, (torch.bfloat16, torch.uint8)),
    (True, True, False, (torch.float32, torch.uint8)),
    (False, False, False, (torch.float32, torch.uint8)),
    (True, False, True, (torch.bfloat16, torch.int32)),
])
def test_stream_wires_follow_jax(bf16, augment, negative, want, monkeypatch, tmp_path):
    """bf16 images only under bf16 compute without augmentation, uint8
    masks only for labels in [0, 256) (``pmpu_tpu/train/loop.py:322-323``)."""
    monkeypatch.chdir(tmp_path)
    store = _store()
    if negative:
        store.labels[0, 0, 0, 0] = -1
    made = []
    real = pipeline.PrefetchPipeline

    def spy(st, **kw):
        made.append((kw["image_dtype"], kw["mask_dtype"]))
        return real(st, **kw)

    monkeypatch.setattr(loop, "PrefetchPipeline", spy)
    cfg = Config(net="unet", num_filters=(4, 8), epochs=1, batchsize=4, stream=True, bf16=bf16,
                 augment=augment, save_cp=False, checkpoint_dir="ck")
    _, _, history = loop.train_net(cfg, store, device="cpu")
    assert made == [want] and np.isfinite(history["train_loss"][0])


def test_stream_step_equals_the_resident_step():
    """The f32 wire: one step from a streamed batch is the resident step,
    bit for bit (the same batch, the same eps)."""
    store = _store(3)
    rows = _rows(store, 8, 4)
    vt_i = torch.from_numpy(make_view_stacks(store.images))
    vt_l = torch.from_numpy(make_view_stacks(store.labels))
    (imgs, lbls), = pipeline.PrefetchPipeline(store, device="cpu").iterate([rows])
    out = []
    for sampler, args in ((sample_batch_vt, (vt_i, vt_l, torch.from_numpy(rows))),
                          (sample_rows, (imgs, lbls, torch.arange(8)[:, None].expand(8, 3)))):
        task = make_task("probunet", num_filters=(4, 8), device="cpu", train=True, seed=4)
        state = steps.create_train_state(task, seed=5)
        _, m = steps.make_train_step(task, acc_steps=4, sampler=sampler)(state, *args, 0.05)
        out.append((m, task.net.state_dict()))
    (m0, sd0), (m1, sd1) = out
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert all(torch.equal(sd0[k], sd1[k]) for k in sd0)
