"""Train and eval steps (counterpart of ``pmpu_tpu/train/steps.py``).

One optimizer step (``make_train_step``, the counterpart of
``build_step_fn`` :116 and ``make_train_step`` :206): ``acc_steps``
microbatches, each sampled on the device from the resident volume stacks,
run forward in BatchNorm train mode and backward; the summed gradients are
divided by ``acc_steps`` once, clipped elementwise at 0.1 and applied by
SGD with momentum (``make_optimizer`` :37: ``optax.clip(0.1)`` then
``optax.sgd(lr, momentum)``, which is ``clip_grad_value_`` on the averaged
gradient then ``torch.optim.SGD(momentum, dampening=0, nesterov=False)``).
The learning rate is set before each step from the host's plateau
scheduler (``set_lr`` :53). BatchNorm running statistics advance through
the microbatches in order, as the JAX step threads ``batch_stats``.

The backward pass runs with TF32 off (``backward``): cuDNN's backward
convolutions read the TF32 flag when they run, after the forward's own
per-conv guards have exited; the JAX gradients of f32 convs are exact f32.
A bf16 step has f32 convs too (the μ/log σ heads), and the flag does not
touch its bf16 convs, so every step enters the guard.

``augment`` (an ``AugmentConfig``, ``--augment``) augments each microbatch
after the sampler, in f32, before the loss (:175). ``remat`` (``--remat``,
the counterpart of ``jax.checkpoint(train_loss)`` :156) runs the loss under
``torch.utils.checkpoint``: the forward keeps only its inputs and the
backward recomputes it. The recompute must repeat the forward exactly and
change nothing, so the posterior eps are drawn before the checkpointed call
(``task.draw_eps``; ``preserve_rng_state`` saves the global generators, not
the step's) and the BatchNorm running statistics are updated by the first
forward only (``update_running`` off in the recompute).

``parallel`` (None: this process runs the whole batch) is how a step of
several ranks splits and reduces (``parallel/sharding.py``): an object with
``take(x)`` (this rank's rows of a microbatch-sized tensor: the rows, the
eps, the augmentation draws), ``share(micro)`` (the ``BatchShare`` the
losses take, or None), ``context(net, share)`` (entered around the
microbatches and their backward passes: the synchronized BatchNorm) and
``reduce(state, metrics, stop)`` (the all-reduce after the accumulation,
before the clip; returns the reduced metrics with ``"stop"``).

``mask_inert_bn_biases`` (:79, always on) turns off the gradient of
every conv bias whose output feeds a train-mode BatchNorm (found by
structure: a ``Conv2d`` followed by a ``BatchNorm2d`` in one
``nn.Sequential``); BatchNorm subtracts the batch mean, so that gradient is
zero analytically, and the biases keep their init values in both packages.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch
from torch import nn
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from pmpu_tpu_torch.data.augment import augment_batch, draw_augment
from pmpu_tpu_torch.data.sampler import sample_batch
from pmpu_tpu_torch.device import exact_f32
from pmpu_tpu_torch.models.unet import BatchNorm2d
from pmpu_tpu_torch.ops.metrics import per_class_dice

CLIP = 0.1


@dataclass
class TrainState:
    """What a step changes: the network (parameters and BatchNorm buffers),
    the optimizer (momentum buffers), the step count and the generator of
    the posterior draws (on the network's device)."""

    net: nn.Module
    optimizer: torch.optim.SGD
    generator: torch.Generator
    step: int = 0

    @property
    def params(self) -> list:
        return [p for g in self.optimizer.param_groups for p in g["params"]]


def make_optimizer(params, momentum: float = 0.9, lr: float = 1e-3) -> torch.optim.SGD:
    return torch.optim.SGD(params, lr=lr, momentum=momentum, dampening=0.0, nesterov=False)


def set_lr(optimizer: torch.optim.Optimizer, lr: float):
    for g in optimizer.param_groups:
        g["lr"] = float(lr)


def inert_bn_biases(net: nn.Module) -> list:
    """The biases of the convs whose output goes straight into a BatchNorm."""
    out = []
    for seq in net.modules():
        if isinstance(seq, nn.Sequential):
            layers = list(seq)
            out += [a.bias for a, b in zip(layers, layers[1:])
                    if isinstance(a, nn.Conv2d) and isinstance(b, BatchNorm2d)]
    return out


def mask_inert_bn_biases(net: nn.Module) -> int:
    """Turn off the gradients of :func:`inert_bn_biases`; returns how many."""
    biases = inert_bn_biases(net)
    for b in biases:
        b.requires_grad_(False)
    return len(biases)


def create_train_state(task, seed: int = 0, momentum: float = 0.9,
                       lr: float = 1e-3) -> TrainState:
    """The state of a task made with ``train=True``: the inert biases
    masked, SGD over the parameters that take gradients, a generator on the
    network's device seeded by ``seed``."""
    net = task.net
    if not net.training:
        raise ValueError("create_train_state: the task's network is in eval mode; "
                         "make the task with train=True")
    mask_inert_bn_biases(net)
    params = [p for p in net.parameters() if p.requires_grad]
    device = params[0].device
    return TrainState(net, make_optimizer(params, momentum, lr),
                      torch.Generator(device=device).manual_seed(seed))


def backward(loss: torch.Tensor):
    """``loss.backward()`` with TF32 off."""
    with exact_f32():
        loss.backward()


@contextlib.contextmanager
def running_stats_frozen(net: nn.Module):
    """The BatchNorm modules of ``net`` leave their running statistics as
    they are inside (the ``--remat`` recompute)."""
    bns = [m for m in net.modules() if isinstance(m, BatchNorm2d)]
    for m in bns:
        m.update_running = False
    try:
        yield
    finally:
        for m in bns:
            del m.update_running  # back to the class's True


def make_train_step(task, acc_steps: int = 1, sampler=sample_batch, augment=None,
                    remat: bool = False, parallel=None):
    """step(state, images, labels, triples, lr, eps=None, draws=None,
    stop=False) → (state, metrics).

    * images/labels: the device-resident (N,S,S,S) stacks for
      ``sample_batch`` (or ``make_oblique_sampler``), (V,N,S,S,S) view
      stacks for ``sample_batch_vt`` (the gather-normalize kernel, one
      launch a microbatch), or a host-gathered (B,S,S,1) batch for
      ``sample_rows`` (``--stream``)
    * triples: (acc_steps·micro, 3) int rows (scan, view, slice) on the device
    * eps: None (draws from ``state.generator``), or one posterior eps per
      microbatch, (acc_steps, micro, latent)
    * draws: None (``augment`` draws from ``state.generator``), or one
      ``draw_augment`` dict per microbatch
    * metrics: the microbatches' mean of each loss term, device scalars
    * stop: with ``parallel``, this rank's interrupt flag, carried in the
      step's all-reduce: ``metrics["stop"]`` is 1 on every rank when any
      rank was interrupted (ignored without ``parallel``)

    Each microbatch is scoped for the profiler as ``sample``, ``augment``,
    ``forward``, ``backward``; the update as ``optimizer``.
    """
    net = task.net

    def take(x):
        return x if parallel is None or x is None else parallel.take(x)

    def step(state: TrainState, images, labels, triples, lr, eps=None, draws=None,
             stop=False):
        params = state.params
        micro = triples.shape[0] // acc_steps
        share = None if parallel is None else parallel.share(micro)

        def loss_fn(img, msk, eps):
            return task.train_loss(img, msk, None, eps, share)

        state.optimizer.zero_grad(set_to_none=True)
        auxes = []
        ctx = contextlib.nullcontext() if parallel is None else parallel.context(net, share)
        with ctx:
            for i in range(acc_steps):
                with record_function("sample"):
                    img, msk = sampler(images, labels, take(triples[i * micro:(i + 1) * micro]))
                if augment is not None:
                    with record_function("augment"):
                        d = (draw_augment((micro, *img.shape[1:]), augment, state.generator)
                             if draws is None else draws[i])
                        img, msk = augment_batch(img, msk, state.generator, augment,
                                                 {k: take(v) for k, v in d.items()})
                e = take(task.draw_eps(state.generator, micro) if eps is None else eps[i])
                with record_function("forward"):
                    if remat:
                        loss, aux = checkpoint(
                            loss_fn, img, msk, e, use_reentrant=False, preserve_rng_state=False,
                            context_fn=lambda: (contextlib.nullcontext(),
                                                running_stats_frozen(net)))
                    else:
                        loss, aux = loss_fn(img, msk, e)
                with record_function("backward"):
                    backward(loss)
                auxes.append(aux)
        metrics = {k: torch.stack([a[k] for a in auxes]).mean() for k in auxes[0]}
        with record_function("optimizer"):
            if acc_steps > 1:
                with torch.no_grad():
                    for p in params:
                        if p.grad is not None:
                            p.grad.div_(acc_steps)
            if parallel is not None:
                with record_function("all_reduce"):
                    metrics = parallel.reduce(state, metrics, stop)
            torch.nn.utils.clip_grad_value_(params, CLIP)
            set_lr(state.optimizer, lr)
            state.optimizer.step()
        state.step += 1
        return state, metrics

    return step


def make_eval_step(task, sampler=sample_batch):
    """step(state, images, labels, triples, eps=None) → (val loss, per-class
    Dice, preds, img, msk): BatchNorm on running statistics, no gradients
    (``make_eval_step`` :221). ``eps``: for probunet None or the pair
    (posterior eps, prior eps)."""

    @torch.no_grad()
    def step(state: TrainState, images, labels, triples, eps=None):
        img, msk = sampler(images, labels, triples)
        loss, preds = task.val_loss(img, msk, state.generator, eps)
        return loss, per_class_dice(preds, msk, task.n_classes), preds, img, msk

    return step
