"""The port's k-view oblique training, ``--remat``, the bounded-RSS re-exec
and the refusals of the train CLI, on the CPU against the JAX package.

* ``make_oblique_view_stacks``: labels and the nonempty table bit-equal to
  JAX's; images bit-equal to JAX's unfused ``oblique_plane`` (the port's
  plain version keeps its operation order) and within 2e-6 of JAX's jitted
  precompute, whose own test holds it to its on-the-fly sampler at that
  tolerance (``tests/test_oblique_training.py:118``; 1.4e-6 is seen here).
* ``make_oblique_sampler`` and ``oblique_nonempty_table`` against JAX's;
  ``sample_batch_vt`` on the (V,N,S,S,S) stacks bit-equal to the port's
  on-the-fly oblique sampler.
* One probabilistic U-Net step on 2 oblique views against the JAX step,
  its eps injected (``test_torch_augment.step_parity``).
* A ``--remat`` step bit-equal to a plain step (loss, parameters, momentum,
  BatchNorm statistics updated once).
* ``_resume_argv`` equal to root ``train.py``'s; the train CLI re-executes
  itself for the remaining epochs under ``--rss-limit-mb``; ``check_ported``
  accepts every ported flag and refuses exactly the four still unported
  (the CLI's refusals: ``tests/test_torch_train_loop.py``).
"""

import importlib
import os
import signal
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmpu_tpu.data import sampler as jsm
from pmpu_tpu_torch.config import Config
from pmpu_tpu_torch.data import sampler as tsm
from pmpu_tpu_torch.data.augment import AugmentConfig
from pmpu_tpu_torch.data.index_map import build_index_map_from_table
from pmpu_tpu_torch.data.volumes import VolumeStore
from pmpu_tpu_torch.train import checkpoint as ckpt
from pmpu_tpu_torch.train import loop, steps
from pmpu_tpu_torch.train.__main__ import _resume_argv
from pmpu_tpu_torch.train.__main__ import main as train_main
from pmpu_tpu_torch.train.tasks import make_task
from tests.test_torch_augment import step_parity
from tests.test_torch_train_loop import _nifti_tree

S = 12


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    """The loop's writer falls back to memory (importing tensorboard costs
    about 20 s)."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def _scans(n=2, s=S, seed=0):
    """Seeded images and labels whose foreground reaches the cube's faces,
    so that some oblique planes leave the cube."""
    rng = np.random.default_rng(seed)
    img = rng.random((n, s, s, s)).astype(np.float32)
    lbl = np.zeros((n, s, s, s), np.int32)
    lbl[:, 2:s - 1, 1:s - 3, 3:s] = rng.integers(0, 3, (n, s - 3, s - 4, s - 3))
    return img, lbl


def _bases(k):
    return np.stack([jsm.view_basis(a) for a in jsm.fibonacci_views(k)])


@pytest.mark.parametrize("k", [2, 5])
def test_view_stacks_match_jax(k):
    img, lbl = _scans()
    bases = _bases(k)
    vi, vl, table = tsm.make_oblique_view_stacks(img, lbl, bases)
    ji, jl, jtable = jsm.make_oblique_view_stacks(img, lbl, bases)
    assert vi.shape == (k, 2, S, S, S) and vi.dtype == torch.float32
    assert vl.dtype == torch.int32 and table.dtype == bool and table.shape == (2, k, S)
    np.testing.assert_array_equal(vl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(table, jtable)
    np.testing.assert_allclose(vi.numpy(), np.asarray(ji), rtol=0, atol=2e-6)
    offsets = np.arange(S, dtype=np.float32) - (S - 1) / 2.0
    for v in range(k):
        for i in (0, S // 2, S - 1):
            want = jsm.oblique_plane(jnp.asarray(img[1]), jnp.asarray(bases[v]), offsets[i])
            np.testing.assert_array_equal(vi[v, 1, i].numpy(), np.asarray(want))
    assert table.any() and not table.all()


def test_oblique_sampler_and_table_match_jax():
    img, lbl = _scans(3, seed=1)
    bases = _bases(3 + 1)
    rng = np.random.default_rng(2)
    rows = np.stack([rng.integers(0, 3, 40), rng.integers(0, 4, 40), rng.integers(0, S, 40)],
                    axis=1).astype(np.int32)
    ji, jl = jsm.make_oblique_sampler(bases)(jnp.asarray(img), jnp.asarray(lbl),
                                             jnp.asarray(rows))
    ti, tl = tsm.make_oblique_sampler(bases)(torch.from_numpy(img), torch.from_numpy(lbl),
                                             torch.from_numpy(rows))
    assert ti.shape == (40, S, S, 1) and ti.dtype == torch.float32 and tl.dtype == torch.int32
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tsm.oblique_nonempty_table(lbl, bases),
                                  jsm.oblique_nonempty_table(lbl, bases))
    # the training loop passes the uploaded labels: the same table from a tensor
    np.testing.assert_array_equal(tsm.oblique_nonempty_table(torch.from_numpy(lbl), bases),
                                  jsm.oblique_nonempty_table(lbl, bases))
    # the view-stack gather gives the on-the-fly sampler's batch bit for bit
    vi, vl, _ = tsm.make_oblique_view_stacks(img, lbl, bases)
    si, sl = tsm.sample_batch_vt(vi, vl, torch.from_numpy(rows))
    assert torch.equal(si, ti) and torch.equal(sl, tl)


def test_normalize_slice_and_sample_rows_match_jax():
    rng = np.random.default_rng(4)
    planes = rng.normal(size=(5, 7, 7)).astype(np.float32)
    planes[2] = 0.0
    planes[3] = -np.abs(planes[3])  # max < 0: divided by a negative max, as in JAX
    got = tsm.normalize_slice(torch.from_numpy(planes)).numpy()
    for p, g in zip(planes, got):
        np.testing.assert_array_equal(g, np.asarray(jsm.normalize_slice(jnp.asarray(p))))
    imgs = rng.random((6, 7, 7, 1)).astype(np.float32)
    msks = rng.integers(0, 3, (6, 7, 7, 1)).astype(np.uint8)
    rows = np.array([[4, 0, 0], [1, 0, 0], [4, 2, 9]], np.int32)
    ti, tl = tsm.sample_rows(torch.from_numpy(imgs).to(torch.bfloat16), torch.from_numpy(msks),
                             torch.from_numpy(rows))
    ji, jl = jsm.sample_rows(jnp.asarray(imgs, jnp.bfloat16), jnp.asarray(msks),
                             jnp.asarray(rows))
    assert ti.dtype == torch.float32 and tl.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


def test_oblique_step_matches_jax():
    """One probunet step, 4 microbatches of 2, on 2 oblique views' stacks
    (JAX's precomputed stacks fed to both packages)."""
    img, lbl = _scans(3, 16, seed=5)
    ji, jl, table = jsm.make_oblique_view_stacks(img, lbl, _bases(2))
    index = _index_like_jax(table)
    step_parity("probunet", 4, np.asarray(ji), np.asarray(jl), index, jsm.sample_batch_vt,
                tsm.sample_batch_vt)


def _index_like_jax(table):
    from pmpu_tpu.data.index_map import build_index_map_from_table as jax_index

    got = build_index_map_from_table(table, filter=True)
    np.testing.assert_array_equal(got, jax_index(table, filter=True))
    return got


@pytest.mark.parametrize("name", ["unet", "probunet"])
def test_remat_step_bit_equal_to_plain(name):
    """``remat=True`` (with augmentation, 2 microbatches, 2 steps): the
    loss terms, parameters, momentum buffers and BatchNorm running
    statistics bit-equal to the plain step's; the statistics moved, once a
    microbatch (a second update in the recompute would change them)."""
    img, lbl = _scans(2, 16, seed=6)
    vi, vl, table = tsm.make_oblique_view_stacks(img, lbl, _bases(2))
    rows = torch.from_numpy(build_index_map_from_table(table)[::5][:8])
    out = []
    for remat in (False, True):
        task = make_task(name, num_filters=(4, 8), device="cpu", train=True, seed=1)
        before = {k: v.clone() for k, v in task.net.state_dict().items() if "running" in k}
        state = steps.create_train_state(task, seed=2)
        step = steps.make_train_step(task, acc_steps=2, sampler=tsm.sample_batch_vt,
                                     augment=AugmentConfig(elastic_alpha=3.0), remat=remat)
        metrics = [step(state, vi, vl, rows, 0.05)[1] for _ in range(2)]
        momentum = [state.optimizer.state[p]["momentum_buffer"] for p in state.params
                    if p in state.optimizer.state]
        out.append((task.net.state_dict(), metrics, momentum, state.generator.get_state()))
        assert all(not torch.equal(before[k], task.net.state_dict()[k]) for k in before)
    (sd0, m0, mo0, g0), (sd1, m1, mo1, g1) = out
    for k in sd0:
        assert torch.equal(sd0[k], sd1[k]), k
    for a, b in zip(m0, m1):
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert len(mo0) == len(mo1) > 0 and torch.equal(g0, g1)
    assert all(torch.equal(a, b) for a, b in zip(mo0, mo1))


def test_running_stats_frozen_restores_the_class_flag():
    task = make_task("unet", num_filters=(4, 8), device="cpu", train=True)
    bns = [m for m in task.net.modules() if type(m).__name__ == "BatchNorm2d"]
    with steps.running_stats_frozen(task.net):
        assert not any(m.update_running for m in bns)
        stats = {k: v.clone() for k, v in task.net.state_dict().items() if "running" in k}
        task.net(torch.rand(2, 16, 16, 1))
        assert all(torch.equal(v, task.net.state_dict()[k]) for k, v in stats.items())
    assert all(m.update_running and "update_running" not in vars(m) for m in bns)


@pytest.mark.parametrize("argv", [
    ["train.py", "-m", "probunet", "-d", "D", "-e", "5"],
    ["train.py", "-d", "D", "--epochs=5", "-f", "old.pt", "--epoch-offset", "2"],
    ["train.py", "--load=old.pt", "-e", "9", "--epoch-offset=1", "-b", "4"],
    ["train.py"],
])
def test_resume_argv_equals_root_train_py(argv):
    root_train = importlib.import_module("train")
    for offset in (None, 3):
        assert (_resume_argv(argv, "ck/x_rss_resume.pt", 2, epoch_offset=offset)
                == root_train._resume_argv(argv, "ck/x_rss_resume.pt", 2, epoch_offset=offset))


def test_rss_limit_reexecs_for_the_remaining_epochs(tmp_path, monkeypatch):
    """``--rss-limit-mb 1`` with 6 oblique views: after epoch 1 the CLI
    writes the resume checkpoint and calls ``execv`` (captured here) with
    ``-m pmpu_tpu_torch.train``, ``-f`` on it, ``-e 1`` and ``--epoch-offset
    1``, SIGINT blocked; the re-executed arguments run epoch 2 from that
    state (step count carried) and write its checkpoint and the model."""
    monkeypatch.chdir(tmp_path)
    _nifti_tree(tmp_path / "DATA")
    calls = []

    class Execd(Exception):
        pass

    def fake_execv(path, args):
        calls.append((path, args, signal.SIGINT in signal.pthread_sigmask(signal.SIG_BLOCK, [])))
        raise Execd

    monkeypatch.setattr(os, "execv", fake_execv)
    argv = ["-m", "unet", "-d", "DATA", "--num-filters", "4,8", "-e", "2", "-b", "16",
            "--num-views", "6", "--train-views", "0", "--rss-limit-mb", "1",
            "--checkpoint-dir", "ck", "--device", "cpu"]
    try:
        with pytest.raises(Execd):
            train_main(argv)
    finally:
        signal.pthread_sigmask(signal.SIG_UNBLOCK, {signal.SIGINT})
    (path, args, blocked), = calls
    assert path == sys.executable and blocked
    assert args[:3] == [sys.executable, "-m", "pmpu_tpu_torch.train"]
    assert args[3:] == _resume_argv(argv, os.path.join("ck", "unet_rss_resume.pt"), 1, 1)
    first = ckpt.load_checkpoint("ck/unet_rss_resume.pt")
    assert sorted(os.listdir("ck")) == ["unet_checkpoint0.pt", "unet_rss_resume.pt"]
    signal.pthread_sigmask(signal.SIG_BLOCK, {signal.SIGINT})
    assert train_main(args[3:]) == 0  # unblocks SIGINT first
    assert signal.SIGINT not in signal.pthread_sigmask(signal.SIG_BLOCK, [])
    assert sorted(os.listdir("ck")) == ["unet_checkpoint0.pt", "unet_checkpoint1.pt",
                                        "unet_model.pt", "unet_rss_resume.pt"]
    assert ckpt.load_checkpoint("ck/unet_model.pt")["step"] == 2 * first["step"]


@pytest.mark.parametrize("layout", ["view_stacks", "plain"])
def test_oblique_training_loop(layout, tmp_path, monkeypatch):
    """``train_net`` with 2 oblique views, with view stacks and without
    (the on-the-fly sampler), one epoch on the CPU on the second view's
    planes: finite losses."""
    monkeypatch.chdir(tmp_path)
    img, lbl = _scans(3, 16, seed=7)
    cfg = Config(net="probunet", num_filters=(4, 8), epochs=1, batchsize=8, num_views=2,
                 view_stacks=layout == "view_stacks", train_views=(1,), checkpoint_dir="ck",
                 save_cp=False)
    _, _, history = loop.train_net(cfg, VolumeStore.from_arrays(img, lbl), device="cpu")
    assert np.isfinite(history["train_loss"][0]) and np.isfinite(history["val_loss"][0])


def test_check_ported_accepts_the_rest():
    cfg = Config(num_views=6, view_stacks=False, stream=True, augment=True, elastic_alpha=4.0,
                 remat=True, rss_limit_mb=100.0, data_parallel=True, nan_checks=True)
    # --rss-limit-mb in a world of any size too: every rank re-executes
    loop.check_ported(cfg)
    loop.check_ported(Config(sharded_volumes=True, data_parallel=True, nan_checks=True))
    every = Config(sharded_volumes=True, async_checkpoints=True, nan_checks=True,
                   data_parallel=True, rss_limit_mb=1.0)
    with pytest.raises(NotImplementedError) as e:
        loop.check_ported(every)
    assert str(e.value).count("--") == 1 and str(e.value).endswith("--async-checkpoints")
