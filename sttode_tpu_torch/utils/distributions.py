"""Diagonal Gaussian for the CVAE prior (port of
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
