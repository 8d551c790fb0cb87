"""Oblique manifold (rows on unit spheres): the metric of geodesic attention
and the Riemannian ops of ``train.riemannian``.

Port of ``sttode_tpu/manifolds/oblique.py``. Every function works on the
trailing dimension and broadcasts over the leading ones. The acos input is
clipped to ±(1 − EPS[dtype]) (1e-4 in fp32, reference quirk Q9), and the
Gram is a full-fp32 matmul: acos'(g) ~ 1/√(1−g²) amplifies Gram error near
±1, so the TF32 matmul path must stay off (the PyTorch default).
"""

from __future__ import annotations

import torch

EPS = {torch.float32: 1e-4, torch.float64: 1e-7, torch.bfloat16: 1e-2}
NORM_FLOOR = 1e-12   # guards 0/0 on exactly-zero rows


def proj(x: torch.Tensor) -> torch.Tensor:
    """Row-normalize onto the unit sphere over the trailing dimension."""
    norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.clamp(norm, min=NORM_FLOOR)


def _eps(dtype) -> float:
    return EPS.get(dtype, 1e-4)


def proj_tan(u: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Project u onto the tangent space at x: subtract the radial part."""
    return u - torch.sum(x * u, dim=-1, keepdim=True) * x


def inner(u: torch.Tensor, v: torch.Tensor | None = None) -> torch.Tensor:
    """Pairwise Gram matrix u @ vᵀ over the trailing two dims; ``v``
    defaults to ``u``. JAX's ``inner(x, u, v=None)`` takes a base point x
    that it does not use; the port drops it."""
    if v is None:
        v = u
    return u @ v.transpose(-1, -2)


def dist(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Pairwise geodesic distance acos(clip(u @ vᵀ)) for row-normalized
    inputs: u [..., L, D], v [..., S, D] → [..., L, S]."""
    eps = _eps(u.dtype)
    g = torch.clamp(inner(u, v), -1.0 + eps, 1.0 - eps)
    return torch.arccos(g)


def dist_point(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Geodesic distance between matching rows: acos(clip(⟨u, v⟩))."""
    eps = _eps(u.dtype)
    g = torch.clamp(torch.sum(u * v, dim=-1), -1.0 + eps, 1.0 - eps)
    return torch.arccos(g)


def expmap(u: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Great-circle exponential map of tangent u at x; where ‖u‖ ≤ EPS the
    retraction normalize(x + u) instead."""
    norm_u = torch.linalg.vector_norm(u, dim=-1, keepdim=True)
    safe = torch.clamp(norm_u, min=NORM_FLOOR)
    exp = x * torch.cos(norm_u) + (u / safe) * torch.sin(norm_u)
    return torch.where(norm_u > _eps(x.dtype), exp, retr(u, x))


def logmap(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Inverse of ``expmap``: the tangent vector at x that points to y, of
    length dist_point(x, y); where its projection is shorter than EPS the
    projection itself."""
    u = proj_tan(y - x, x)
    d = dist_point(x, y)[..., None]
    norm_u = torch.linalg.vector_norm(u, dim=-1, keepdim=True)
    scaled = u * d / torch.clamp(norm_u, min=NORM_FLOOR)
    return torch.where(norm_u > _eps(x.dtype), scaled, u)


def retr(u: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """First-order retraction: normalize(x + u)."""
    return proj(x + u)


def retr_transp(u: torch.Tensor, x: torch.Tensor,
                v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Retract u at x and transport v to the new point (projection)."""
    y = retr(u, x)
    return y, proj_tan(v, y)


def ptransp(v: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Parallel transport of tangent v from x to y, approximated by the
    projection onto y's tangent space."""
    return proj_tan(v, y)


def egrad2rgrad(grad: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Euclidean → Riemannian gradient: the tangent projection."""
    return proj_tan(grad, x)


class Oblique:
    """Namespace of the oblique ops, for call sites that want an object
    (the reference's ``Manifold`` interface)."""

    name = "Oblique"

    proj = staticmethod(proj)
    proj_tan = staticmethod(proj_tan)
    inner = staticmethod(inner)
    dist = staticmethod(dist)
    expmap = staticmethod(expmap)
    logmap = staticmethod(logmap)
    retr = staticmethod(retr)
    retr_transp = staticmethod(retr_transp)
    ptransp = staticmethod(ptransp)
    egrad2rgrad = staticmethod(egrad2rgrad)
