"""pmpu_tpu_torch — the PyTorch/CUDA port of pmpu_tpu for one NVIDIA H100.

The JAX package ``pmpu_tpu`` stays beside this one as the reference the
port is held against. This package imports torch and numpy only: never
jax, flax, ml_dtypes or any ``pmpu_tpu`` module (it keeps its own copies
of what it needs).

Entry points take ``device=None``, which means ``"cuda"``; without a CUDA
device they raise unless the caller passes ``device="cpu"``, which runs
the plain PyTorch versions of the hand-written kernels
(``pmpu_tpu_torch.ops.cuda``).

What is ported so far: whole-volume inference of the U-Net and the
probabilistic U-Net on the 3 standard views or on k isotropic oblique
views, in float and in int8, and the generalized energy distance of one
volume (``inference.engine.VolumeEvaluator``).
"""

from pmpu_tpu_torch.inference.engine import VolumeEvaluator
from pmpu_tpu_torch.train.tasks import make_task

__all__ = ["VolumeEvaluator", "make_task"]
