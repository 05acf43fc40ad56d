"""Faults of the hpunet's sampling, planted in one evaluator of the program
under test, to show that the hpunet cell's comparison with the reference
catches them. The cell's traffic plants the one that the workload's
``fault`` key names (``readings.py --set fault=NAME`` on the card; the tests
on the CPU). Each wraps the evaluator's ``_model_logits``, so the fault runs
on the program's own path."""

from __future__ import annotations

import types


def mean_z(ev):
    """μ decoded at every latent level in place of the prior's draws."""
    from pmpu_tpu_torch.inference.engine import VolumeEvaluator

    def logits(self, x, generator=None, per_sample=False):
        self.mean_z = True
        try:
            return VolumeEvaluator._model_logits(self, x, None, per_sample)
        finally:
            self.mean_z = False

    ev._model_logits = types.MethodType(logits, ev)


def one_draw(ev):
    """The first draw's logits in place of the mean over the draws."""
    from pmpu_tpu_torch.inference.engine import VolumeEvaluator

    def logits(self, x, generator=None, per_sample=False):
        out = VolumeEvaluator._model_logits(self, x, generator, True)
        return out if per_sample else out[0]

    ev._model_logits = types.MethodType(logits, ev)


FAULTS = {"mean_z": mean_z, "one_draw": one_draw}
