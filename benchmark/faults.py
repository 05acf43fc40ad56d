"""Faults planted in the program under test, to show that the comparison
with the reference catches them: the tests plant them on the CPU, and
``readings.py --fault NAME`` on the card at the cells' own sizes. Each takes
``patch(obj, attribute, value)`` (pytest's ``monkeypatch.setattr``, or a
plain ``setattr`` for a process that ends after)."""

from __future__ import annotations

import torch


def altered(patch):
    """The served labels altered where they are produced: half of each
    volume's voxels moved to the next class."""
    from pmpu_tpu_torch.inference.engine import VolumeEvaluator

    orig = VolumeEvaluator._fetch_seg

    def fetch(self, h):
        seg = orig(self, h)
        half = seg.shape[0] // 2
        seg[:half] = (seg[:half] + 1) % 3
        return seg

    patch(VolumeEvaluator, "_fetch_seg", fetch)


def half_batch(patch):
    """Half of every chunk left out of the model, the mean of the other
    half's logits in its place."""
    from pmpu_tpu_torch.inference.engine import VolumeEvaluator

    orig = VolumeEvaluator._model_logits

    def logits(self, x, generator=None, per_sample=False):
        out = orig(self, x, generator, per_sample)
        half = out.shape[0] // 2
        out[half:] = out[:half].mean(0)
        return out

    patch(VolumeEvaluator, "_model_logits", logits)


def stale(patch):
    """The state left unchanged: each fetch returns the labels of the
    volume served before it."""
    from pmpu_tpu_torch.inference.engine import VolumeEvaluator

    orig = VolumeEvaluator._fetch_seg

    def fetch(self, h):
        seg = orig(self, h)
        last = getattr(self, "_stale", None)
        self._stale = seg
        return seg if last is None else last

    patch(VolumeEvaluator, "_fetch_seg", fetch)


def unchanged(patch):
    """A train step that returns its state unchanged: the optimizer never
    steps."""
    from pmpu_tpu_torch.train import steps

    class Still(torch.optim.SGD):
        def step(self, closure=None):
            return None

    patch(steps, "make_optimizer", lambda params, momentum=0.9, lr=1e-3:
          Still(params, lr=lr, momentum=momentum))


def train_half_batch(patch):
    """Half of each train batch left out: its rows replaced by the other
    half's, so the loss is the mean over the rest, times the batch."""
    from pmpu_tpu_torch.data import sampler

    orig = sampler.sample_batch_vt

    def sample(vt_images, vt_labels, triples):
        img, lbl = orig(vt_images, vt_labels, triples)
        half = img.shape[0] // 2
        return torch.cat([img[:half], img[:half]]), torch.cat([lbl[:half], lbl[:half]])

    patch(sampler, "sample_batch_vt", sample)


SERVING = {"altered": altered, "half_batch": half_batch, "stale": stale}
TRAIN = {"unchanged": unchanged, "train_half_batch": train_half_batch}
ALL = {**SERVING, **TRAIN}
