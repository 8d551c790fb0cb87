"""Hyperbolic (Poincaré-ball) layers (port of ``sttode_tpu/nn/hyperbolic.py``):
hyperbolic multinomial logistic regression, the Möbius linear layer, the
ball's "concatenation", the pointwise distance feature and the maps between
Euclidean space and the ball (feature clipping, a trainable base point and
the Riemannian gradient rescale). Each layer is an ``*_init(gen, ...)`` and
a function over its parameter dict, in the JAX package's layouts (a weight
is ``[in, out]``), so that ``bridge.params_from_jax`` carries JAX's
parameters across."""

from __future__ import annotations

import torch

from sttode_tpu_torch.manifolds import pmath
from sttode_tpu_torch.nn import core


def hyperbolic_mlr_init(gen, ball_dim: int, n_classes: int,
                        dtype=torch.float32) -> dict:
    """a_vals / p_vals [n_classes, ball_dim], nn.Linear's default
    distribution (kaiming-uniform a = √5 over fan-in ball_dim)."""
    return {
        "a_vals": core.torch_linear_weight(gen, ball_dim, n_classes,
                                           dtype).T,
        "p_vals": core.torch_linear_weight(gen, ball_dim, n_classes,
                                           dtype).T,
    }


def hyperbolic_mlr(params: dict, x: torch.Tensor, *,
                   c: float = 1.0) -> torch.Tensor:
    """Logits [B, n_classes] of ball points x [B, ball_dim]: p lifted with
    expmap0, a scaled by the conformal factor at p, then the hyperbolic
    softmax margins."""
    p_ball = pmath.expmap0(params["p_vals"], c=c)
    conformal = 1.0 - c * torch.sum(p_ball ** 2, dim=1, keepdim=True)
    a_ball = params["a_vals"] * conformal
    return pmath.hyperbolic_softmax(x, a_ball, p_ball, c=c)


def hyp_linear_init(gen, in_features: int, out_features: int, *,
                    bias: bool = True, dtype=torch.float32) -> dict:
    p = {"w": core.torch_linear_weight(gen, in_features, out_features,
                                       dtype)}
    if bias:
        p["b"] = core.torch_linear_bias(gen, in_features, out_features,
                                        dtype)
    return p


def hyp_linear(params: dict, x: torch.Tensor, *,
               c: float = 1.0) -> torch.Tensor:
    """Möbius matrix-vector product and Möbius bias (expmap0 of ``b``),
    projected back into the ball."""
    mv = pmath.mobius_matvec(params["w"].T, x, c=c)
    if "b" not in params:
        return pmath.project(mv, c=c)
    bias = pmath.expmap0(params["b"], c=c)
    return pmath.project(pmath.mobius_add(mv, bias, c=c), c=c)


def concat_poincare_init(gen, d1: int, d2: int, d_out: int,
                         dtype=torch.float32) -> dict:
    return {"l1": hyp_linear_init(gen, d1, d_out, bias=False, dtype=dtype),
            "l2": hyp_linear_init(gen, d2, d_out, bias=False, dtype=dtype)}


def concat_poincare(params: dict, x1: torch.Tensor, x2: torch.Tensor, *,
                    c: float = 1.0) -> torch.Tensor:
    """The ball's "concatenation": the Möbius sum of two Möbius-linear
    images."""
    return pmath.mobius_add(hyp_linear(params["l1"], x1, c=c),
                            hyp_linear(params["l2"], x2, c=c), c=c)


def hyperbolic_distance(x1: torch.Tensor, x2: torch.Tensor, *,
                        c: float = 1.0) -> torch.Tensor:
    """Pointwise geodesic distance feature [..., 1]."""
    return pmath.dist(x1, x2, c=c, keepdims=True)


def to_poincare(x: torch.Tensor, *, c: float = 1.0,
                clip_r: float | None = None, riemannian: bool = True,
                xp: torch.Tensor | None = None) -> torch.Tensor:
    """Euclidean features onto the ball: with ``clip_r`` the feature norm
    clipped to clip_r first (Guo et al. 2021), then expmap0 (or expmap at
    the base point project(expmap0(``xp``))) and the projection; with
    ``riemannian`` the backward pass rescales the gradient by
    (1 − c‖x‖²)²/4 (``pmath.riemannian_gradient``)."""
    if clip_r is not None:
        x_norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-5
        x = x * torch.clamp(clip_r / x_norm, max=1.0)
    if xp is not None:
        base = pmath.project(pmath.expmap0(xp, c=c), c=c)
        out = pmath.project(pmath.expmap(base, x, c=c), c=c)
    else:
        out = pmath.project(pmath.expmap0(x, c=c), c=c)
    if riemannian:
        out = pmath.riemannian_gradient(out, c=c)
    return out


def from_poincare(x: torch.Tensor, *, c: float = 1.0,
                  xp: torch.Tensor | None = None) -> torch.Tensor:
    """Ball points back to Euclidean space: logmap0, or logmap at the base
    point project(expmap0(``xp``))."""
    if xp is not None:
        base = pmath.project(pmath.expmap0(xp, c=c), c=c)
        return pmath.logmap(base, x, c=c)
    return pmath.logmap0(x, c=c)
