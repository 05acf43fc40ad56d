"""Diagonal Gaussian latent distribution (counterpart of
``pmpu_tpu/models/distributions.py:18-39``). ``kl_divergence`` comes with
the training path."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class DiagGaussian(NamedTuple):
    """N(loc, diag(exp(log_scale)²)); shapes (..., latent_dim)."""

    loc: torch.Tensor
    log_scale: torch.Tensor

    @property
    def scale(self) -> torch.Tensor:
        return torch.exp(self.log_scale)

    def sample(self, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Reparameterized draw ``loc + scale·eps`` with eps from
        ``generator`` (it must live on ``loc``'s device)."""
        eps = torch.randn(
            self.loc.shape, generator=generator, device=self.loc.device,
            dtype=self.loc.dtype,
        )
        return self.loc + self.scale * eps
