"""Riemannian SGD over manifold-constrained parameters (port of
``sttode_tpu/train/riemannian.py``).

The reference tags parameters with a manifold (``ManifoldParameter``); as in
the JAX package, a *mask* over the parameter tree marks the leaves that live
on a manifold instead: a tree of bools, a prefix of the parameter tree (a
mask leaf covers a whole subtree) or a callable on the parameters that
returns one. ``riemannian_sgd`` updates the marked leaves by the Riemannian
step

    p ← retr(−lr · egrad2rgrad(g, p), p)

and the others by SGD, p ← p − lr · g. It works with any manifold namespace
that has ``egrad2rgrad(grad, x)`` and ``retr(u, x)``, e.g.
``manifolds.oblique``. JAX's optax transform returns ``retr − p`` and lands
on ``p + (retr − p)``; the port writes the retracted point itself, which
differs from JAX's by the rounding of that sum (≤ 1 ulp of |p| a step).

``riemannian_sgd`` makes an optimizer factory for ``make_train_step(...,
optimizer=)``, the counterpart of passing the transform to JAX's
``make_train_step(cfg, opt)``. The step hands a factory only the flat
leaves, so the port's ``riemannian_sgd`` takes the mask flat, one bool a
leaf in ``bridge.tree_leaves`` order: ``flat_mask(mask, params)`` builds it
from the forms JAX's takes (a tree, a prefix or a callable). The update
reads no host value: with the learning rate a 0-dim device tensor
(``capturable``, as a captured step makes it) a step can be captured in a
CUDA graph (``scan_steps``).
"""

from __future__ import annotations

import functools
from typing import Callable, Sequence

import torch

from sttode_tpu_torch import bridge
from sttode_tpu_torch.manifolds import oblique


def _prefix_map(fn: Callable, mask, params):
    """``fn(mask_leaf, subtree)`` at each leaf of ``mask``, a prefix of
    ``params``' tree; the result has ``params``' structure above it."""
    if isinstance(mask, dict):
        if not isinstance(params, dict) or set(mask) != set(params):
            raise ValueError(f"mask keys {sorted(mask)} do not match the "
                             f"parameters' {_keys(params)}")
        return {k: _prefix_map(fn, mask[k], params[k]) for k in params}
    if isinstance(mask, (list, tuple)):
        if not isinstance(params, (list, tuple)) or len(mask) != len(params):
            raise ValueError(f"a mask sequence of {len(mask)} does not match "
                             f"the parameters' {type(params).__name__}")
        out = [_prefix_map(fn, m, p) for m, p in zip(mask, params)]
        return type(params)(*out) if hasattr(params, "_fields") \
            else type(params)(out)
    return fn(bool(mask), params)


def _keys(tree):
    return sorted(tree) if isinstance(tree, dict) else type(tree).__name__


def _resolve(mask, params):
    return mask(params) if callable(mask) else mask


def flat_mask(manifold_mask, params) -> list[bool]:
    """The mask (tree, prefix or callable) as one bool a leaf of
    ``params``, in ``bridge.tree_leaves`` order."""
    return bridge.tree_leaves(_prefix_map(
        lambda m, p: bridge.tree_map(lambda _: m, p),
        _resolve(manifold_mask, params), params))


def project_to_manifold(params, manifold_mask, manifold=oblique):
    """The parameter tree with its marked leaves projected onto the
    manifold (the init-time invariant that points start on it); the mask
    may be a prefix of the tree or a callable, as in ``flat_mask``."""
    return _prefix_map(
        lambda m, p: bridge.tree_map(manifold.proj, p) if m else p,
        _resolve(manifold_mask, params), params)


class RiemannianSGD(torch.optim.Optimizer):
    """SGD over ``params`` (a flat list) whose update on the leaves that
    ``manifold_mask`` (one bool a leaf) marks is the Riemannian step. The
    learning rate may be a float or, ``capturable``, a 0-dim device tensor;
    the step reads no host value either way. A leaf without a gradient
    keeps its value."""

    def __init__(self, params, lr: float, manifold_mask: list[bool],
                 manifold=oblique, capturable: bool = False):
        params = list(params)
        if not isinstance(manifold_mask, (list, tuple)) \
                or len(manifold_mask) != len(params):
            raise ValueError(f"{manifold_mask!r:.60} is not one mask flag for "
                             f"each of {len(params)} parameters (see "
                             f"flat_mask)")
        super().__init__(params, {"lr": lr, "capturable": capturable})
        self.manifold = manifold
        self.on_manifold = {id(p): bool(m)
                            for p, m in zip(params, manifold_mask)}

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            lr = group["lr"]
            flat, flat_grads = [], []
            for p in group["params"]:
                if p.grad is None:
                    continue
                if self.on_manifold[id(p)]:
                    rgrad = self.manifold.egrad2rgrad(p.grad, p)
                    p.copy_(self.manifold.retr(-lr * rgrad, p))
                else:
                    flat.append(p)
                    flat_grads.append(p.grad)
            if flat:
                torch._foreach_sub_(flat, torch._foreach_mul(flat_grads, lr))
        return loss


def riemannian_sgd(learning_rate: float, manifold_mask: Sequence[bool],
                   manifold=oblique) -> Callable[..., RiemannianSGD]:
    """An optimizer factory for ``make_train_step(..., optimizer=)``: SGD
    at ``learning_rate`` whose update on the leaves that ``manifold_mask``
    marks (one bool a leaf, as ``flat_mask`` builds it) is the Riemannian
    step on ``manifold`` (rows on the manifold, the trailing dimension the
    ambient coordinates)."""
    return functools.partial(RiemannianSGD, lr=learning_rate,
                             manifold_mask=manifold_mask,
                             manifold=manifold)
