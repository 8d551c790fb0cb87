"""Latent distributions (port of ``sttode_tpu/utils/distributions.py``): the
diagonal Gaussian of the CVAE prior and posterior, and the relaxed one-hot
categorical. Where JAX draws from a key, the port takes the draw itself
(the tests hand both frameworks the same one) or a ``torch.Generator`` on
the distribution's device."""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


def draw_gumbel(shape, *, generator: torch.Generator | None = None,
                dtype=torch.float32, device=None) -> torch.Tensor:
    """Standard Gumbel noise −log(−log U), U uniform on (0, 1)."""
    u = torch.rand(shape, generator=generator, dtype=dtype, device=device)
    tiny = torch.finfo(dtype).tiny
    return -torch.log(-torch.log(torch.clamp(u, min=tiny)))


def gumbel_noise(logits: torch.Tensor, generator=None,
                 gumbel: torch.Tensor | None = None) -> torch.Tensor:
    """The Gumbel noise for ``logits``: ``gumbel`` when injected (of the
    logits' shape), else a draw from ``generator`` on their device."""
    if gumbel is None:
        return draw_gumbel(logits.shape, generator=generator,
                           dtype=logits.dtype, device=logits.device)
    if gumbel.shape != logits.shape:
        raise ValueError(f"gumbel shape {tuple(gumbel.shape)} != "
                         f"{tuple(logits.shape)}")
    return gumbel


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


class RelaxedOneHot(NamedTuple):
    """Gumbel-softmax relaxed categorical over the last axis."""
    logits: torch.Tensor
    temperature: float = 0.1

    @property
    def probs(self) -> torch.Tensor:
        return torch.softmax(self.logits, dim=-1)

    def _one_hot(self, idx: torch.Tensor) -> torch.Tensor:
        return F.one_hot(idx, self.logits.shape[-1]).to(self.logits.dtype)

    def rsample(self, generator: torch.Generator | None = None, *,
                gumbel: torch.Tensor | None = None) -> torch.Tensor:
        """softmax((logits + g) / temperature), g standard Gumbel noise
        (``gumbel`` injects it)."""
        g = gumbel_noise(self.logits, generator, gumbel)
        return torch.softmax((self.logits + g) / self.temperature, dim=-1)

    def sample(self, generator: torch.Generator | None = None, *,
               gumbel: torch.Tensor | None = None) -> torch.Tensor:
        """A one-hot categorical draw: the Gumbel-max argmax(logits + g)."""
        g = gumbel_noise(self.logits, generator, gumbel)
        return self._one_hot(torch.argmax(self.logits + g, dim=-1))

    def kl(self, p: "RelaxedOneHot | None" = None) -> torch.Tensor:
        """KL(self ‖ p) of the categoricals over the last axis; p = None
        means the uniform one."""
        q = self.probs
        logq = torch.log_softmax(self.logits, dim=-1)
        if p is None:
            logp = -torch.log(torch.tensor(float(self.logits.shape[-1]),
                                           dtype=q.dtype, device=q.device))
        else:
            logp = torch.log_softmax(p.logits, dim=-1)
        return torch.sum(q * (logq - logp), dim=-1)

    def mode(self) -> torch.Tensor:
        return self._one_hot(torch.argmax(self.logits, dim=-1))
