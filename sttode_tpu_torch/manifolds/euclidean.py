"""Euclidean manifold, the trivial instance of the manifold interface (port
of ``sttode_tpu/manifolds/euclidean.py``): the degenerate baseline, on which
geodesic attention would be (negated) distance attention."""

from __future__ import annotations

import torch


def proj(x: torch.Tensor) -> torch.Tensor:
    return x


def proj_tan(u: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return u


def inner(u: torch.Tensor, v: torch.Tensor | None = None) -> torch.Tensor:
    """Pairwise Gram matrix u @ vᵀ; ``v`` defaults to ``u``. JAX's
    ``inner(x, u, v=None)`` takes a base point x that it does not use; the
    port drops it, as ``oblique.inner`` does."""
    if v is None:
        v = u
    return u @ v.transpose(-1, -2)


def dist(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Pairwise Euclidean distance matrix [..., L, S]."""
    diff = u[..., :, None, :] - v[..., None, :, :]
    return torch.linalg.vector_norm(diff, dim=-1)


def dist_point(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(u - v, dim=-1)


def expmap(u: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return x + u


def logmap(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return y - x


def retr(u: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return x + u


def ptransp(v: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return v


def egrad2rgrad(grad: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return grad


def mobius_add(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Degenerate Möbius addition: x + y."""
    return x + y


def mobius_matvec(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Degenerate Möbius matvec: x @ mᵀ."""
    return x @ m.T


class Euclidean:
    name = "Euclidean"

    proj = staticmethod(proj)
    proj_tan = staticmethod(proj_tan)
    inner = staticmethod(inner)
    dist = staticmethod(dist)
    expmap = staticmethod(expmap)
    logmap = staticmethod(logmap)
    retr = staticmethod(retr)
    ptransp = staticmethod(ptransp)
    egrad2rgrad = staticmethod(egrad2rgrad)
    mobius_add = staticmethod(mobius_add)
    mobius_matvec = staticmethod(mobius_matvec)
