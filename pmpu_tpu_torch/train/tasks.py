"""Task adapters (counterpart of ``pmpu_tpu/train/tasks.py:30-219``): a task
owns the network, says how many classes it predicts and whether it is
probabilistic, and gives the training loss (``train_loss``), the
validation loss with its predictions (``val_loss``) and the prediction of
a batch (``predict``). The inference engine runs the network itself.

A task's network is made from a seed: initialized on the CPU with a
``torch.Generator`` (the reference's init families,
``models/initializers.py``), then moved to the device in
``torch.channels_last`` memory. A task for inference (the default) is in
eval mode with ``requires_grad_(False)``; one made with ``train=True`` is
in train mode (BatchNorm on batch statistics) with gradients on.

Randomness: a probabilistic loss draws its eps from ``generator`` unless an
explicit ``eps`` is given (the tests inject the JAX package's draws).
``val_loss`` and ``predict`` run the network in eval mode and restore the
mode it was in. The validation loss takes the posterior of the current
batch (the JAX package's fix of the reference's stale posterior) and its
Dice prediction a second, independent prior draw.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch

from pmpu_tpu_torch.device import resolve_device
from pmpu_tpu_torch.models import ProbabilisticUNet, UNet
from pmpu_tpu_torch.models.initializers import initialize
from pmpu_tpu_torch.ops import losses


def _place(net: torch.nn.Module, device, seed: int, train: bool) -> torch.nn.Module:
    dev = resolve_device(device)
    initialize(net, torch.Generator().manual_seed(seed))
    net = net.to(dev, memory_format=torch.channels_last)
    return net.train().requires_grad_(True) if train else net.eval().requires_grad_(False)


@contextlib.contextmanager
def _eval_mode(net: torch.nn.Module):
    """Eval mode and no autograd inside; the mode the net was in after."""
    was = net.training
    net.eval()
    try:
        with torch.no_grad():
            yield
    finally:
        net.train(was)


class UNetTask:
    name = "unet"
    is_probabilistic = False

    def __init__(
        self,
        n_channels: int = 1,
        n_classes: int = 1,
        num_filters: Sequence[int] = (64, 128, 256, 512, 1024),
        dtype: Optional[torch.dtype] = None,
        loss_type: str = "auto",
        class_weights=None,
        split_decoder: bool = False,
        device=None,
        seed: int = 0,
        train: bool = False,
    ):
        self.n_classes = n_classes
        self.loss_type = loss_type  # auto (reference CE/BCE) | dice | ce+dice
        self.class_weights = class_weights
        self.net = _place(
            UNet(n_channels, n_classes, tuple(num_filters), dtype=dtype,
                 split_decoder=split_decoder),
            device, seed, train,
        )

    def _loss(self, preds, msk, share=None):
        base = losses.unet_loss(preds, msk, self.n_classes, self.class_weights, share)
        if self.loss_type == "auto":
            return base
        m = msk[..., 0] if msk.dim() == 4 else msk
        if self.n_classes == 1:
            dice = losses.soft_dice_loss(preds[..., 0], m.to(preds.dtype), share=share)
        else:
            probs = torch.softmax(preds, dim=-1)
            per_class = [
                losses.soft_dice_loss(probs[..., c], (m == c).to(probs.dtype), share=share)
                for c in range(1, self.n_classes)
            ]
            dice = sum(per_class) / len(per_class)
        return dice if self.loss_type == "dice" else base + dice

    def draw_eps(self, generator, n):
        """None: the U-Net draws nothing."""
        return None

    def train_loss(self, img, msk, generator=None, eps=None, share=None):
        """(loss, aux) of one batch in the net's current mode; ``generator``
        and ``eps`` are unused (the U-Net draws nothing). ``share``: this
        rank's share of a batch split over the ranks (``ops/losses.py``)."""
        loss = self._loss(self.net(img), msk, share)
        return loss, {"loss": loss.detach()}

    def predict(self, img, msk=None, generator=None, eps=None):
        """Sigmoid probs (1 class) or logits, BatchNorm on running stats."""
        with _eval_mode(self.net):
            return self.net(img)

    def val_loss(self, img, msk, generator=None, eps=None):
        with _eval_mode(self.net):
            preds = self.net(img)
            return self._loss(preds, msk), preds


class ProbUNetTask:
    name = "probunet"
    is_probabilistic = True

    def __init__(
        self,
        n_channels: int = 1,
        n_classes: int = 3,
        num_filters: Sequence[int] = (64, 128, 256, 512, 1024),
        latent_dim: int = 6,
        no_convs_fcomb: int = 4,
        beta: float = 10.0,
        dtype: Optional[torch.dtype] = None,
        class_weights=None,
        split_decoder: bool = False,
        device=None,
        seed: int = 0,
        train: bool = False,
    ):
        self.n_classes = n_classes
        self.beta = beta
        self.class_weights = class_weights
        self.net = _place(
            ProbabilisticUNet(
                input_channels=n_channels, num_classes=n_classes,
                num_filters=tuple(num_filters), latent_dim=latent_dim,
                no_convs_fcomb=no_convs_fcomb, dtype=dtype, split_decoder=split_decoder,
            ),
            device, seed, train,
        )

    def draw_eps(self, generator, n):
        """The posterior eps of ``train_loss`` on n slices, drawn from
        ``generator`` before the forward pass, as ``train_loss`` would draw
        them after it (the same numbers)."""
        return torch.randn((n, self.net.prior.latent_dim), generator=generator,
                           device=generator.device)

    def train_loss(self, img, msk, generator=None, eps=None, share=None):
        """−ELBO with z_q = posterior.sample: one forward of the three towers
        in the net's current mode, the draw decoded through the fcomb →
        (loss, {"loss", "reconstruction_loss", "kl"}); with ``share`` this
        rank's share of each (``ops/losses.py``)."""
        out = self.net(img, msk.float())
        z_q = out.posterior.sample(generator, eps)
        logits = self.net.decode(out.unet_features, z_q)
        loss, aux = losses.elbo_loss(
            logits, msk, out.posterior, out.prior, self.beta, self.n_classes,
            self.class_weights, share,
        )
        aux = {k: v.detach() for k, v in aux.items()}
        aux["loss"] = loss.detach()
        return loss, aux

    def predict(self, img, msk=None, generator=None, eps=None, z=None):
        """A prior draw (or ``z``) decoded: sigmoid probs for 1 class,
        logits otherwise."""
        with _eval_mode(self.net):
            out = self.net(img)
            if z is None:
                z = out.prior.sample(generator, eps)
            logits = self.net.decode(out.unet_features, z)
        return torch.sigmoid(logits) if self.n_classes == 1 else logits

    def val_loss(self, img, msk, generator=None, eps=None):
        """(−ELBO from the current batch's posterior, the Dice prediction of
        an independent prior draw). ``eps``: None, or the pair (posterior
        eps, prior eps)."""
        eps_q, eps_p = (None, None) if eps is None else eps
        with _eval_mode(self.net):
            out = self.net(img, msk.float())
            z_q = out.posterior.sample(generator, eps_q)
            logits = self.net.decode(out.unet_features, z_q)
            loss, _ = losses.elbo_loss(
                logits, msk, out.posterior, out.prior, self.beta, self.n_classes
            )
            preds = self.net.decode(out.unet_features, out.prior.sample(generator, eps_p))
        if self.n_classes == 1:
            preds = torch.sigmoid(preds)
        return loss, preds


def make_task(name: str, **kw):
    """Factory keyed by the reference's ``-m unet|probunet`` flag; ``device``
    None means ``"cuda"``, ``seed`` makes the random weights and
    ``train=True`` gives the network in train mode with gradients on."""
    if name == "unet":
        kw.setdefault("n_classes", 1)
        return UNetTask(**kw)
    if name == "probunet":
        kw.setdefault("n_classes", 3)
        return ProbUNetTask(**kw)
    raise ValueError(f"unknown model {name!r} (expected unet|probunet)")
