"""Training guards (port of ``sttode_tpu/train/guards.py``).

The reference ships an unused ``detect_grad_nan`` that zeroes NaN gradients
in place; the JAX package makes it an optax transform chained before a
global-norm clip and Adam (``guarded_adam``). Here the same chain is an
Adam whose ``step`` first zeroes the non-finite gradient entries and clips
them by their global norm, as ``optax.clip_by_global_norm`` does, then
takes Adam's step. Every guard stays on the device (no host read), so a
guarded step can be captured in a CUDA graph (``scan_steps``).
"""

from __future__ import annotations

import functools

import torch

from sttode_tpu_torch import bridge


def _grads(opt: torch.optim.Optimizer) -> list:
    return [p.grad for g in opt.param_groups for p in g["params"]
            if p.grad is not None]


def zero_nan_grads(grads: list) -> list:
    """Replace the NaN and ±Inf entries of ``grads`` by 0, in place."""
    for g in grads:
        g.nan_to_num_(nan=0.0, posinf=0.0, neginf=0.0)
    return grads


def global_norm(tree) -> torch.Tensor:
    """The L2 norm of all the leaves of a tree together (0-dim, on the
    leaves' device)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(
        bridge.tree_leaves(tree))))


def clip_by_global_norm(grads: list, max_norm: float) -> list:
    """Scale ``grads`` in place by max_norm / their global norm where that
    norm is not below ``max_norm`` (``optax.clip_by_global_norm``)."""
    if grads:
        norm = global_norm(grads)
        torch._foreach_mul_(grads, torch.where(norm < max_norm,
                                               torch.ones_like(norm),
                                               max_norm / norm))
    return grads


def all_finite(tree) -> torch.Tensor:
    """0-dim bool on the leaves' device: every entry of every leaf is
    finite (a divergence check without a host read per leaf)."""
    return torch.stack([torch.isfinite(t).all()
                        for t in bridge.tree_leaves(tree)]).all()


class GuardedAdam(torch.optim.Adam):
    """``torch.optim.Adam`` whose ``step`` zeroes the non-finite gradient
    entries and, with ``max_grad_norm``, clips the gradients by their
    global norm first: optax's ``chain(zero_nan_grads(),
    clip_by_global_norm(max_grad_norm), adam(lr))``."""

    def __init__(self, params, lr: float = 1e-3, *,
                 max_grad_norm: float | None = None, **adam_kwargs):
        super().__init__(params, lr=lr, **adam_kwargs)
        self.max_grad_norm = max_grad_norm

    def step(self, closure=None):
        with torch.no_grad():
            grads = zero_nan_grads(_grads(self))
            if self.max_grad_norm is not None:
                clip_by_global_norm(grads, self.max_grad_norm)
        return super().step(closure)


def guarded_adam(lr: float, max_grad_norm: float | None = None,
                 **adam_kwargs):
    """An optimizer factory for ``make_train_step(..., optimizer=)``:
    ``factory(leaves, capturable=...)`` makes a ``GuardedAdam`` over the
    leaves at learning rate ``lr``."""
    return functools.partial(GuardedAdam, lr=lr, max_grad_norm=max_grad_norm,
                             **adam_kwargs)
