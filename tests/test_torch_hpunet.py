"""The Hierarchical Probabilistic U-Net (``models/hprob_unet.py``) on the
port's serving path, on the CPU in float32 with seeded random weights,
against the plain reference of the benchmark (``benchmark/reference/hpunet.py``:
each draw runs the whole prior core, encoder included).

The sizes keep every kind of part: 4 levels on 38² slices (38, 19, 9, 4) with
2 latent levels (4², 9²), so that both ×2 maps of the latent decoder (8 and
18) are zero-padded to their skips (9 and 19), and a stitching level; and 3
levels on 22² with both levels latent (no stitching level; 10 padded to 11).

Tolerances: the program and the reference compute the same f32 arithmetic in
another order (channels_last convs against contiguous ones, batched draws
against one at a time), which moves a logit of magnitude up to about 5 by a
few 1e-6 here: logits are held to 2e-5, probabilities, which softmax
contracts, to 1e-5.
"""

import types

import numpy as np
import pytest
import torch

from benchmark.reference import hpunet as ref_hpunet
from pmpu_tpu_torch import VolumeEvaluator, make_task
from pmpu_tpu_torch.config import Config
from pmpu_tpu_torch.inference.engine import chunk_generator, derive_seed
from pmpu_tpu_torch.ops.metrics import generalized_energy_distance

LOGIT_TOL = 2e-5
PROB_TOL = 1e-5
ARCHS = {
    "four_levels_38": (dict(channels_per_block=(4, 8, 8, 8), down_channels_per_block=(2, 4, 4, 4),
                            latent_dims=(1, 2)), 38),
    "three_levels_22": (dict(channels_per_block=(4, 8, 8), down_channels_per_block=(2, 4, 4),
                             latent_dims=(2, 1)), 22),
}
SAMPLES = 3


def _pair(arch, seed=3):
    """The program's task and the reference holding its weights."""
    kw, _ = ARCHS[arch]
    task = make_task("hpunet", n_classes=3, device="cpu", seed=seed, **kw)
    ref = ref_hpunet.THierarchicalProbUNet(1, 3, kw["channels_per_block"],
                                           kw["down_channels_per_block"], 3, 3, kw["latent_dims"])
    ref.load_state_dict(task.net.state_dict())
    return task, ref.eval()


def _slices(n, size, seed=0):
    return torch.rand((n, size, size, 1), generator=torch.Generator().manual_seed(seed))


def _volume(size, seed):
    """A (size³) f32 volume ≥ 0 with a brighter block."""
    rng = np.random.default_rng(seed)
    vol = rng.random((size,) * 3).astype(np.float32) * 0.3
    vol[size // 4:3 * size // 4, size // 3:2 * size // 3, size // 4:size // 2] += 0.6
    return vol


def _ref_cfg(samples=SAMPLES):
    return {"views": 3, "wire": "float32", "num_classes": 3, "prior_samples": samples}


@pytest.mark.parametrize("arch", sorted(ARCHS))
@torch.no_grad()
def test_per_draw_logits_match_the_reference(arch):
    """Given ε, the program's batched decode of 3 draws against the
    reference's whole prior core and stitching decoder run once a draw."""
    task, ref = _pair(arch)
    size = ARCHS[arch][1]
    x = _slices(4, size)
    eps = ref_hpunet.draw_eps(ref, torch.Generator().manual_seed(1), SAMPLES, 4, size)
    got = task.net(x, eps)
    want = torch.stack([ref(x.permute(0, 3, 1, 2), [e[s] for e in eps])
                        for s in range(SAMPLES)]).permute(0, 1, 3, 4, 2)
    assert got.shape == (SAMPLES, 4, size, size, 3) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=LOGIT_TOL)
    assert (want[0] - want[1]).abs().max() > 100 * LOGIT_TOL  # the draws matter


@pytest.mark.parametrize("arch", sorted(ARCHS))
@torch.no_grad()
def test_mean_z_decodes_mu_as_the_reference(arch):
    task, ref = _pair(arch)
    size = ARCHS[arch][1]
    x = _slices(3, size, seed=4)
    got = task.net(x, None)
    assert got.shape[0] == 1
    want = ref(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    torch.testing.assert_close(got[0], want, rtol=0, atol=LOGIT_TOL)
    ev = VolumeEvaluator(task, mean_z=True, device="cpu")
    torch.testing.assert_close(ev._model_logits(x), want, rtol=0, atol=LOGIT_TOL)


@torch.no_grad()
def test_the_encoder_runs_once_for_all_draws():
    """The evaluator's decode of 3 draws runs the encoder once (its maps are
    read by every draw, not recomputed) and equals the program's own
    one-draw-at-a-time decode, each draw with its own encoder pass."""
    task, _ = _pair("four_levels_38")
    net, x = task.net, _slices(4, 38, seed=2)
    calls = []
    hook = net.encoder[0][0].register_forward_hook(lambda *a: calls.append(1))
    try:
        ev = VolumeEvaluator(task, n_samples=SAMPLES, device="cpu")
        got = ev._model_logits(x, chunk_generator(torch.device("cpu"), 7, 0), per_sample=True)
    finally:
        hook.remove()
    assert len(calls) == 1
    eps = ref_hpunet.draw_eps(net, chunk_generator(torch.device("cpu"), 7, 0), SAMPLES, 4, 38)
    one_by_one = torch.cat([net(x, [e[s:s + 1] for e in eps]) for s in range(SAMPLES)])
    torch.testing.assert_close(got, one_by_one, rtol=0, atol=LOGIT_TOL)


@pytest.mark.parametrize("arch", sorted(ARCHS))
@torch.no_grad()
def test_evaluator_fused_probs_match_the_reference(arch):
    """One volume (``evaluate_volume``) and two together
    (``evaluate_volumes_batched``, volume j with ``derive_seed(seed, j)``)
    under one seed, against the reference's fused probabilities of the same
    planes, chunk plan and draws."""
    task, ref = _pair(arch)
    size = ARCHS[arch][1]
    ev = VolumeEvaluator(task, n_samples=SAMPLES, input_dtype="float32", device="cpu")
    vols = [_volume(size, 10 + j) for j in range(2)]
    one = ev.evaluate_volume(vols[0], seed=5)["fused"]
    want = ref_hpunet.fused_probs(ref, vols[0], _ref_cfg(), 5)
    torch.testing.assert_close(one, want, rtol=0, atol=PROB_TOL)
    both = ev.evaluate_volumes_batched(np.stack(vols), seed=5)["fused"]
    for j, vol in enumerate(vols):
        want = ref_hpunet.fused_probs(ref, vol, _ref_cfg(), derive_seed(5, j))
        torch.testing.assert_close(both[j], want, rtol=0, atol=PROB_TOL)


@torch.no_grad()
def test_per_sample_logits_and_ged():
    """``per_sample`` gives each draw's logits, as the reference's forward of
    that draw, and their mean is the mean path's; GED reads the per-sample
    fused volumes' argmaxes."""
    task, ref = _pair("four_levels_38")
    ev = VolumeEvaluator(task, n_samples=SAMPLES, input_dtype="float32", device="cpu")
    vol = torch.from_numpy(_volume(38, 3))
    from pmpu_tpu_torch.inference.fusion import normalize_slabs, view_slabs

    slabs = view_slabs(vol[None])[0]
    per = ev._chunked_logits(slabs, seed=9, per_sample=True)
    assert per.shape == (SAMPLES, 3 * 38, 38, 38, 3)
    torch.testing.assert_close(per.mean(0), ev._chunked_logits(slabs, seed=9), rtol=0,
                               atol=LOGIT_TOL)
    x = normalize_slabs(slabs)[:, None]  # one chunk of 114 planes
    eps = ref_hpunet.draw_eps(ref, chunk_generator(torch.device("cpu"), 9, 0), SAMPLES,
                              x.shape[0], 38)
    for s in range(SAMPLES):
        want = ref(x, [e[s] for e in eps]).permute(0, 2, 3, 1)
        torch.testing.assert_close(per[s], want, rtol=0, atol=LOGIT_TOL)
    truth = (vol > 0.5).long()
    ged = ev.ged_volume(vol.numpy(), truth.numpy(), n_ged_samples=2, seed=4)
    ev2 = VolumeEvaluator(task, n_samples=2, device="cpu")
    samples = ev2._predict_volume(vol, 4, per_sample=True)[-1].argmax(-1)
    want = float(generalized_energy_distance(samples, truth[None], 3))
    assert ged == pytest.approx(want) and ged > 0


def test_residual_block_is_the_published_form():
    """``unet_utils.res_block`` with 3 convs: 3×3 to d, 3×3 to d, 1×1 to c,
    the skip a 1×1 conv only where the channel count changes; the published
    widths hold 8,778,311 parameters."""
    from pmpu_tpu_torch.models.hprob_unet import HierarchicalProbUNet, ResBlock

    block = ResBlock(6, 8, 4)
    shapes = [tuple(c.weight.shape) for c in block.convs]
    assert shapes == [(4, 6, 3, 3), (4, 4, 3, 3), (8, 4, 1, 1)]
    assert tuple(block.skip.weight.shape) == (8, 6, 1, 1)
    assert ResBlock(8, 8, 4).skip is None
    with torch.device("meta"):
        net = HierarchicalProbUNet()
    assert sum(p.numel() for p in net.parameters()) == 8_778_311


def test_refusals():
    """No int8 path, no multi-rank path, no batched store evaluation (its
    memory guard is the probunet's), no training."""
    from pmpu_tpu_torch.train import __main__ as train_cli
    from pmpu_tpu_torch.train.loop import check_ported

    task, _ = _pair("three_levels_22")
    with pytest.raises(ValueError, match="int8"):
        VolumeEvaluator(task, quantize="int8", device="cpu")
    with pytest.raises(ValueError, match="one rank"):
        VolumeEvaluator(task, mesh=types.SimpleNamespace(size=2), device="cpu")
    with pytest.raises(ValueError, match="memory guard"):
        VolumeEvaluator(task, device="cpu").evaluate_store_batched([])
    with pytest.raises(NotImplementedError, match="GECO"):
        make_task("hpunet", device="cpu", train=True, **ARCHS["three_levels_22"][0])
    with pytest.raises(NotImplementedError, match="GECO"):
        check_ported(Config(net="hpunet"))
    with pytest.raises(SystemExit) as e:
        train_cli.main(["-m", "hpunet", "-d", "nowhere", "--device", "cpu"])
    assert e.value.code == 2


def test_task_kwargs_map_num_filters_to_the_widths():
    """No ``num_filters``: each model's own widths; given, the hpunet takes
    them as they are, the probunet's default widths included."""
    assert "channels_per_block" not in Config(net="hpunet").task_kwargs()
    kw = Config(net="hpunet", num_filters=(4, 8, 8)).task_kwargs()
    assert kw["channels_per_block"] == (4, 8, 8) and "num_filters" not in kw
    wide = (64, 128, 256, 512, 1024)
    assert Config(net="hpunet", num_filters=wide).task_kwargs()["channels_per_block"] == wide
    assert Config(net="probunet").task_kwargs()["num_filters"] == wide
    task = make_task("hpunet", device="cpu", **Config(net="hpunet").task_kwargs())
    assert task.net.channels_per_block == (24, 48, 96, 192, 192, 192, 192, 192)
    assert task.net.latent_dims == (1, 1, 1, 1) and task.is_probabilistic


def _nifti_tree(root, n=2, size=16):
    from pmpu_tpu_torch.data import nifti

    for sub in ("images", "labels"):
        (root / sub).mkdir(parents=True)
    for i in range(n):
        vol = _volume(size, 20 + i)
        nifti.save(str(root / "images" / f"image{i}.nii"), vol)
        nifti.save(str(root / "labels" / f"image{i}.nii"), (vol > 0.5).astype(np.float32))
    return root


def test_eval_and_predict_clis_take_hpunet(tmp_path, monkeypatch, capsys):
    """``-m hpunet`` with its widths from ``--num-filters`` (5 levels on
    16³ cubes: 16 … 1, the 4 default latent levels), untrained weights: the
    eval CLI's report and GED line, the predict CLI's pipelined stream."""
    from pmpu_tpu_torch.eval import main as eval_main
    from pmpu_tpu_torch.predict import main as predict_main

    data = _nifti_tree(tmp_path / "data")
    monkeypatch.chdir(tmp_path)
    widths = ("--num-filters", "4,8,8,8,8", "--eval-samples", "2")
    assert eval_main(["-m", "hpunet", "-d", str(data), *widths, "--ged", "2",
                      "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "GED^2 (2 samples)" in out and "avg volume: mean=" in out
    assert predict_main(["-m", "hpunet", "-i", str(data / "images"), "-o", str(tmp_path / "segs"),
                         *widths, "--device", "cpu"]) == 0
    assert sorted(p.name for p in (tmp_path / "segs").iterdir()) == ["image0.nii", "image1.nii"]


@torch.no_grad()
def test_spans_inside_the_model_span():
    """Under ``torch.profiler`` each chunk of a served volume carries one
    ``hpu_encoder``, ``hpu_latents`` and ``hpu_stitch``, in that order, each
    inside the volume's ``model`` span; eval_batch 38 cuts the 114 planes
    into 3 chunks."""
    from torch.profiler import ProfilerActivity, profile

    task, _ = _pair("four_levels_38")
    ev = VolumeEvaluator(task, n_samples=2, eval_batch=38, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ev.predict_volumes_pipelined(iter([_volume(38, 1)]), seed=2)
    spans = {}
    for e in prof.events():
        spans.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    (model,) = spans["model"]
    names = ("hpu_encoder", "hpu_latents", "hpu_stitch")
    assert [len(spans[n]) for n in names] == [3, 3, 3]
    for k in range(3):
        chunk = [sorted(spans[n])[k] for n in names]
        assert all(model[0] <= a <= b <= model[1] for a, b in chunk)
        assert chunk[0][1] <= chunk[1][0] and chunk[1][1] <= chunk[2][0]
