"""Diagonal Gaussian latent distribution and its KL divergence (counterpart
of ``pmpu_tpu/models/distributions.py``)."""

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

    def sample(self, generator: Optional[torch.Generator] = None,
               eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Reparameterized draw ``loc + scale·eps``. An explicit ``eps`` (of
        ``loc``'s shape) wins; otherwise eps is drawn from ``generator``
        (it must live on ``loc``'s device)."""
        if eps is None:
            eps = torch.randn(
                self.loc.shape, generator=generator, device=self.loc.device,
                dtype=self.loc.dtype,
            )
        return self.loc + self.scale * eps.to(self.loc)


def kl_divergence(q: DiagGaussian, p: DiagGaussian) -> torch.Tensor:
    """Analytic KL(q‖p) of diagonal Gaussians, summed over the latent axis
    (the JAX package's operation order)."""
    var_q = torch.exp(2.0 * q.log_scale)
    var_p = torch.exp(2.0 * p.log_scale)
    kl = (p.log_scale - q.log_scale) + (var_q + (q.loc - p.loc) ** 2) / (2.0 * var_p) - 0.5
    return torch.sum(kl, dim=-1)
