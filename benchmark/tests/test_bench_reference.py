"""The plain reference agrees with the port at a small size on the CPU,
with the same weights, scans and draws: whole-volume inference on the 3 axis
views and on 6 oblique views (fused probabilities), and three train steps
(losses, clipped gradients, weights)."""

import pytest
import torch

from benchmark import inputs
from benchmark.reference import infer as R
from benchmark.reference import train as RT

CFG = dict(cube=16, num_filters=[4, 8, 16], input_channels=1, latent_dim=6, num_classes=3,
           prior_samples=5, no_convs_fcomb=4, wire="uint8")


def _reference(cfg):
    net = inputs.reference_model(cfg, "cpu")
    net.load_state_dict(inputs.make_weights(cfg, 5, "cpu"), strict=False)
    return net


@pytest.mark.parametrize("views", [3, 6])
def test_inference_agrees_with_the_port(views):
    from pmpu_tpu_torch import VolumeEvaluator, make_task
    from pmpu_tpu_torch.inference.engine import derive_seed
    from pmpu_tpu_torch.inference.fusion import make_view_bases

    cfg = dict(CFG, views=views)
    task = make_task("probunet", num_filters=cfg["num_filters"], device="cpu", seed=0)
    task.net.load_state_dict(inputs.make_weights(cfg, 5, "cpu"))
    ev = VolumeEvaluator(task, n_samples=5, num_views=views, input_dtype="uint8", device="cpu")
    ref = _reference(cfg).eval()
    vols = inputs.make_scans(2, 5, (10, 16, 16), 16, "cpu")[0].numpy()
    assert R.derive_seed(7, 3) == derive_seed(7, 3)
    assert (R.view_bases(6) == make_view_bases(6)).all()
    for j, vol in enumerate(vols):
        seed = derive_seed(11, j)
        out = ev.evaluate_volume(vol, seed=seed, return_views=False)
        probs = R.fused_probs(ref, vol, cfg, seed)
        assert float((out["fused"] - probs).abs().max()) < 1e-5
        assert R.label_gap(probs, out["argmax"]) < 1e-5


def test_label_gap_reads_the_served_label_against_the_best():
    probs = torch.tensor([[0.2, 0.5, 0.3], [0.6, 0.3, 0.1]]).view(2, 1, 1, 3)
    labels = torch.tensor([1.0, 2.0]).view(2, 1, 1).numpy()
    assert R.label_gap(probs, labels) == pytest.approx(0.5)
    assert R.label_gap(probs, labels * 0 + 7) == 1.0


def test_train_steps_agree_with_the_port():
    from pmpu_tpu_torch import make_task
    from pmpu_tpu_torch.data.sampler import sample_batch_vt
    from pmpu_tpu_torch.train.steps import create_train_state, make_train_step

    cfg = dict(CFG, views=3, num_filters=[4, 8])
    w = inputs.make_weights(cfg, 5, "cpu")
    imgs, lbls = inputs.make_scans(2, 5, (10, 16, 16), 16, "cpu")
    task = make_task("probunet", num_filters=cfg["num_filters"], device="cpu", seed=0,
                     train=True)
    task.net.load_state_dict(w)
    state = create_train_state(task)
    step = make_train_step(task, acc_steps=1, sampler=sample_batch_vt)
    g = torch.Generator().manual_seed(3)
    triples = torch.stack([torch.randint(0, 2, (3, 8), generator=g),
                           torch.randint(0, 3, (3, 8), generator=g),
                           torch.randint(2, 8, (3, 8), generator=g)], -1)
    eps = torch.randn((3, 8, 6), generator=g)
    stacks = RT.view_planes(imgs).contiguous(), RT.view_planes(lbls).contiguous()
    names = {id(p): k for k, p in task.net.named_parameters()}
    losses = []
    for k in range(3):
        state, m = step(state, *stacks, triples[k], 1e-3, eps=eps[k:k + 1])
        losses.append(float(m["loss"]))
        if k == 0:
            grads = {names[id(p)]: s["momentum_buffer"].clone()
                     for p, s in state.optimizer.state.items()}
    ref = RT.run_steps(_reference(cfg), imgs, lbls, triples, eps, 1e-3, 0.9, 0.1, 10.0)
    assert losses == pytest.approx(ref["loss"], rel=1e-6)
    for k, gk in grads.items():
        assert float((gk - ref["grad1"][k]).abs().max()) < 1e-4
    for k, p in task.net.named_parameters():
        assert float((p.detach() - ref["params"][k]).abs().max()) < 1e-5
