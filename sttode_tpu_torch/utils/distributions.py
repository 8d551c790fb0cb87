"""Diagonal Gaussian for the CVAE prior and posterior (port of
``sttode_tpu/utils/distributions.py::DiagNormal``)."""

from __future__ import annotations

from typing import NamedTuple

import torch


class DiagNormal(NamedTuple):
    """Diagonal Gaussian parameterized by (mu, logvar)."""
    mu: torch.Tensor
    logvar: torch.Tensor

    @property
    def sigma(self) -> torch.Tensor:
        return torch.exp(0.5 * self.logvar)

    @staticmethod
    def from_params(params: torch.Tensor) -> "DiagNormal":
        """Split a [..., 2Z] parameter vector into mu / logvar halves."""
        mu, logvar = params.chunk(2, dim=-1)
        return DiagNormal(mu=mu, logvar=logvar)

    @staticmethod
    def standard(shape, dtype=torch.float32, device=None) -> "DiagNormal":
        z = torch.zeros(shape, dtype=dtype, device=device)
        return DiagNormal(mu=z, logvar=z)

    def rsample(self, generator: torch.Generator | None = None, *,
                noise: torch.Tensor | None = None) -> torch.Tensor:
        """mu + eps·sigma. ``noise`` injects eps (the tests hand both
        frameworks the same draw); otherwise eps comes from ``generator``,
        which must live on the distribution's device."""
        if noise is None:
            noise = torch.randn(self.mu.shape, generator=generator,
                                dtype=self.mu.dtype, device=self.mu.device)
        elif noise.shape != self.mu.shape:
            raise ValueError(f"noise shape {tuple(noise.shape)} != "
                             f"{tuple(self.mu.shape)}")
        return self.mu + noise * self.sigma

    def kl(self, p: "DiagNormal") -> torch.Tensor:
        """Elementwise KL(self ‖ p), the general branch of the JAX
        ``DiagNormal.kl`` with the reference's 1e-8 sigma guards; ``loss_kl``
        takes it against the standard prior."""
        t1 = (self.mu - p.mu) / (p.sigma + 1e-8)
        t2 = self.sigma / (p.sigma + 1e-8)
        return 0.5 * (t1 * t1 + t2 * t2) - 0.5 - torch.log(t2)
