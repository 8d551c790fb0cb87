"""Oblique manifold (rows on unit spheres): the metric of geodesic attention.

Port of ``sttode_tpu/manifolds/oblique.py`` (``proj`` :35, ``dist`` :64).
The acos input is clipped to ±(1 − 1e-4) in fp32 (reference quirk Q9), and
the Gram is a full-fp32 matmul: acos'(g) ~ 1/√(1−g²) amplifies Gram error
near ±1, so the TF32 matmul path must stay off (the PyTorch default).
"""

from __future__ import annotations

import torch

EPS = {torch.float32: 1e-4, torch.float64: 1e-7, torch.bfloat16: 1e-2}
NORM_FLOOR = 1e-12   # guards 0/0 on exactly-zero rows


def proj(x: torch.Tensor) -> torch.Tensor:
    """Row-normalize onto the unit sphere over the trailing dimension."""
    norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.clamp(norm, min=NORM_FLOOR)


def inner(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Pairwise Gram matrix u @ vᵀ over the trailing two dims."""
    return u @ v.transpose(-1, -2)


def dist(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Pairwise geodesic distance acos(clip(u @ vᵀ)) for row-normalized
    inputs: u [..., L, D], v [..., S, D] → [..., L, S]."""
    eps = EPS.get(u.dtype, 1e-4)
    g = torch.clamp(inner(u, v), -1.0 + eps, 1.0 - eps)
    return torch.arccos(g)
