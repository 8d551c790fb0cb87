"""Poincaré-ball math (constant negative curvature c).

Port of ``sttode_tpu/manifolds/pmath.py``, function for function, with the
same stability constants (reference quirk Q9): the artanh clamp
±(1 − 1e-5), the Möbius denominator ``+1e-5``, norm floors 1e-5, the ball
projection radius (1 − 1e-3)/√c, the tanh input clamp ±15 and
``_safe_norm``'s ``+1e-15``.

``artanh``, ``arsinh`` and ``riemannian_gradient`` are
``torch.autograd.Function``s whose backward is the JAX ``custom_vjp``'s:
artanh divides the cotangent by 1 − xc² of the *clamped* input (so the
gradient passes through the clamp instead of vanishing), arsinh by
√(1 + x²), and riemannian_gradient is the identity forward whose backward
scales by (1 − c‖x‖²)²/4. Everything else is plain differentiable torch over
the trailing dim; ``c`` is a Python float.

The attention path (``nn.attention``) uses ``project``, ``expmap0``,
``tanh``, ``artanh``, ``_safe_norm`` and ``dist_matrix_gram``.
"""

from __future__ import annotations

import math

import torch

_BALL_EPS = 1e-3      # projection margin
_NORM_MIN = 1e-5      # norm floors
_DENOM_EPS = 1e-5     # Möbius denominator guard
_TANH_CLAMP = 15.0    # tanh input clamp


def tanh(x: torch.Tensor) -> torch.Tensor:
    """tanh with its input clamped to ±15."""
    return torch.tanh(torch.clamp(x, -_TANH_CLAMP, _TANH_CLAMP))


class _Artanh(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        xc = torch.clamp(x, -1 + _NORM_MIN, 1 - _NORM_MIN)
        ctx.save_for_backward(xc)
        return 0.5 * (torch.log1p(xc) - torch.log1p(-xc))

    @staticmethod
    def backward(ctx, g):
        (xc,) = ctx.saved_tensors
        return g / (1 - xc ** 2)


class _Arsinh(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.log(torch.clamp(x + torch.sqrt(1 + x ** 2),
                                     min=_NORM_MIN))

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g / torch.sqrt(1 + x ** 2)


class _RiemannianGradient(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, c):
        ctx.save_for_backward(x)
        ctx.c = c
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        scale = (1 - ctx.c * torch.sum(x ** 2, dim=-1, keepdim=True)) ** 2 / 4
        return g * scale, None


def artanh(x: torch.Tensor) -> torch.Tensor:
    """artanh of x clamped to ±(1 − 1e-5); the gradient g / (1 − xc²)."""
    return _Artanh.apply(x)


def arsinh(x: torch.Tensor) -> torch.Tensor:
    """log(max(x + √(1 + x²), 1e-5)); the gradient g / √(1 + x²)."""
    return _Arsinh.apply(x)


def arcosh(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """The reference's arcosh, with its clamp to ±(1 − eps) kept (the
    degenerate branch, for API parity)."""
    xc = torch.clamp(x, -1 + eps, 1 - eps)
    return torch.log(xc + torch.sqrt(torch.abs(1 + xc))
                     * torch.sqrt(torch.abs(xc - 1)))


def riemannian_gradient(x: torch.Tensor, c: float = 1.0) -> torch.Tensor:
    """Identity forward; the backward scales by the inverse squared
    conformal factor (1 − c‖x‖²)²/4."""
    return _RiemannianGradient.apply(x, c)


def _safe_norm(x: torch.Tensor, keepdims: bool = False) -> torch.Tensor:
    """‖x‖ with a finite gradient at x = 0."""
    return torch.sqrt(torch.sum(x * x, dim=-1, keepdim=keepdims) + 1e-15)


def project(x: torch.Tensor, *, c: float = 1.0) -> torch.Tensor:
    """Clip points back inside the ball of radius (1 − 1e-3)/√c."""
    norm = torch.clamp(_safe_norm(x, keepdims=True), min=_NORM_MIN)
    maxnorm = (1 - _BALL_EPS) / math.sqrt(c)
    return torch.where(norm > maxnorm, x / norm * maxnorm, x)


def lambda_x(x: torch.Tensor, *, c: float = 1.0,
             keepdims: bool = False) -> torch.Tensor:
    """Conformal factor λ_x = 2 / (1 − c‖x‖²)."""
    return 2 / (1 - c * torch.sum(x ** 2, dim=-1, keepdim=keepdims))


def mobius_add(x: torch.Tensor, y: torch.Tensor, *,
               c: float = 1.0) -> torch.Tensor:
    """Möbius addition x ⊕_c y."""
    x2 = torch.sum(x ** 2, dim=-1, keepdim=True)
    y2 = torch.sum(y ** 2, dim=-1, keepdim=True)
    xy = torch.sum(x * y, dim=-1, keepdim=True)
    num = (1 + 2 * c * xy + c * y2) * x + (1 - c * x2) * y
    denom = 1 + 2 * c * xy + c ** 2 * x2 * y2
    return num / (denom + _DENOM_EPS)


def dist(x: torch.Tensor, y: torch.Tensor, *, c: float = 1.0,
         keepdims: bool = False) -> torch.Tensor:
    """Geodesic distance 2/√c · artanh(√c ‖(−x) ⊕ y‖)."""
    sqrt_c = c ** 0.5
    n = _safe_norm(mobius_add(-x, y, c=c), keepdims=keepdims)
    return artanh(sqrt_c * n) * 2 / sqrt_c


def dist0(x: torch.Tensor, *, c: float = 1.0,
          keepdims: bool = False) -> torch.Tensor:
    """Distance to the origin."""
    sqrt_c = c ** 0.5
    return artanh(sqrt_c * _safe_norm(x, keepdims=keepdims)) * 2 / sqrt_c


def expmap(x: torch.Tensor, u: torch.Tensor, *,
           c: float = 1.0) -> torch.Tensor:
    """Exp_x(u) = x ⊕ tanh(√c λ_x ‖u‖ / 2) u / (√c ‖u‖)."""
    sqrt_c = c ** 0.5
    u_norm = torch.clamp(_safe_norm(u, keepdims=True), min=_NORM_MIN)
    second = tanh(sqrt_c / 2 * lambda_x(x, c=c, keepdims=True) * u_norm) \
        * u / (sqrt_c * u_norm)
    return mobius_add(x, second, c=c)


def expmap0(u: torch.Tensor, *, c: float = 1.0) -> torch.Tensor:
    """Exp_0(u) = tanh(√c ‖u‖) u / (√c ‖u‖)."""
    sqrt_c = c ** 0.5
    u_norm = torch.clamp(_safe_norm(u, keepdims=True), min=_NORM_MIN)
    return tanh(sqrt_c * u_norm) * u / (sqrt_c * u_norm)


def logmap(x: torch.Tensor, y: torch.Tensor, *,
           c: float = 1.0) -> torch.Tensor:
    """Log_x(y)."""
    sub = mobius_add(-x, y, c=c)
    sub_norm = torch.clamp(_safe_norm(sub, keepdims=True), min=_NORM_MIN)
    lam = lambda_x(x, c=c, keepdims=True)
    sqrt_c = c ** 0.5
    return 2 / sqrt_c / lam * artanh(sqrt_c * sub_norm) * sub / sub_norm


def logmap0(y: torch.Tensor, *, c: float = 1.0) -> torch.Tensor:
    """Log_0(y)."""
    sqrt_c = c ** 0.5
    y_norm = torch.clamp(_safe_norm(y, keepdims=True), min=_NORM_MIN)
    return y / y_norm / sqrt_c * artanh(sqrt_c * y_norm)


def mobius_matvec(m: torch.Tensor, x: torch.Tensor, *,
                  c: float = 1.0) -> torch.Tensor:
    """Möbius matrix-vector product M ⊗_c x, projected into the ball."""
    sqrt_c = c ** 0.5
    x_norm = torch.clamp(_safe_norm(x, keepdims=True), min=_NORM_MIN)
    mx = x @ m.T
    mx_norm = torch.clamp(_safe_norm(mx, keepdims=True), min=_NORM_MIN)
    res = tanh(mx_norm / x_norm * artanh(sqrt_c * x_norm)) * mx \
        / (mx_norm * sqrt_c)
    zero_mx = torch.all(mx == 0, dim=-1, keepdim=True)
    res = torch.where(zero_mx, torch.zeros_like(res), res)
    return project(res, c=c)


def mobius_addition_batch(x: torch.Tensor, y: torch.Tensor, *,
                          c: float = 1.0) -> torch.Tensor:
    """All-pairs Möbius addition: x [B, D], y [C, D] → [B, C, D]."""
    xy = x @ y.T
    x2 = torch.sum(x ** 2, dim=-1, keepdim=True)
    y2 = torch.sum(y ** 2, dim=-1, keepdim=True)
    num = 1 + 2 * c * xy + c * y2.T
    num = num[..., None] * x[:, None, :] + (1 - c * x2)[..., None] \
        * y[None, :, :]
    denom = 1 + 2 * c * xy + c ** 2 * x2 * y2.T
    return num / (denom[..., None] + _DENOM_EPS)


def hyperbolic_softmax(x: torch.Tensor, a: torch.Tensor, p: torch.Tensor,
                       c: float = 1.0) -> torch.Tensor:
    """Hyperbolic multinomial-logistic-regression logits: x [B, D] points,
    a [K, D] normals, p [K, D] offsets → [B, K]."""
    lambda_pkc = 2 / (1 - c * torch.sum(p ** 2, dim=1))
    k = lambda_pkc * torch.linalg.vector_norm(a, dim=1) / math.sqrt(c)
    mob = mobius_addition_batch(-p, x, c=c)                      # [K, B, D]
    num = 2 * math.sqrt(c) * torch.sum(mob * a[:, None, :], dim=-1)
    denom = torch.linalg.vector_norm(a, dim=1, keepdim=True) * (
        1 - c * torch.sum(mob ** 2, dim=2))
    return (k[:, None] * arsinh(num / denom)).T


def p2k(x: torch.Tensor, c: float = 1.0) -> torch.Tensor:
    """Poincaré → Klein coordinates."""
    return 2 * x / (1 + c * torch.sum(x ** 2, dim=-1, keepdim=True))


def k2p(x: torch.Tensor, c: float = 1.0) -> torch.Tensor:
    """Klein → Poincaré coordinates."""
    return x / (1 + torch.sqrt(1 - c * torch.sum(x ** 2, dim=-1,
                                                 keepdim=True)))


def lorenz_factor(x: torch.Tensor, *, c: float = 1.0, axis: int = -1,
                  keepdims: bool = False) -> torch.Tensor:
    """Lorentz factor on the Klein disk."""
    return 1 / torch.sqrt(1 - c * torch.sum(x ** 2, dim=axis,
                                            keepdim=keepdims))


def poincare_mean(x: torch.Tensor, axis: int = 0,
                  c: float = 1.0) -> torch.Tensor:
    """Einstein-midpoint mean through the Klein model."""
    xk = p2k(x, c)
    lamb = lorenz_factor(xk, c=c, keepdims=True)
    mean = torch.sum(lamb * xk, dim=axis, keepdim=True) / torch.sum(
        lamb, dim=axis, keepdim=True)
    return torch.squeeze(k2p(mean, c), dim=axis)


def dist_matrix(x: torch.Tensor, y: torch.Tensor,
                c: float = 1.0) -> torch.Tensor:
    """All-pairs geodesic distance matrix [B, C] from the Möbius sums."""
    sqrt_c = c ** 0.5
    n = torch.linalg.vector_norm(mobius_addition_batch(-x, y, c=c), dim=-1)
    return 2 / sqrt_c * artanh(sqrt_c * n)


def dist_matrix_gram(x: torch.Tensor, y: torch.Tensor, *,
                     c: float = 1.0) -> torch.Tensor:
    """All-pairs Poincaré geodesic distance over the trailing two dims from
    one Gram matrix, without the [L, S, D] Möbius sums: with g = <x, y>,
    x2 = ‖x‖², y2 = ‖y‖², ‖−x ⊕_c y‖² = (x2 − 2g + y2) / den with
    den = 1 − 2c·g + c²·x2·y2, and the reference's ``+1e-5`` denominator
    convention as den / (den + ε)². The Gram is a full-fp32 matmul: the
    x2 − 2g + y2 cancellation for close points and artanh's amplification
    near the ball's edge make TF32 unacceptable here.
    x [..., L, D], y [..., S, D] → [..., L, S]."""
    g = x @ y.transpose(-1, -2)
    x2 = torch.sum(x * x, dim=-1)[..., :, None]
    y2 = torch.sum(y * y, dim=-1)[..., None, :]
    den = 1 - 2 * c * g + c * c * x2 * y2
    n2 = torch.clamp(x2 - 2 * g + y2, min=0.0) * den / (den + _DENOM_EPS) ** 2
    n = torch.sqrt(n2 + 1e-15)
    sqrt_c = c ** 0.5
    return 2 / sqrt_c * artanh(sqrt_c * n)


def auto_select_c(d: int) -> float:
    """Curvature giving a d-ball of constant volume π."""
    dim2 = d / 2.0
    r = math.gamma(dim2 + 1) / (math.pi ** (dim2 - 1))
    r = r ** (1 / float(d))
    return 1 / (r ** 2)
