"""Flat parameter and gradient views (port of
``sttode_tpu/utils/flat_params.py``, the reference's
``get_flat_params_from`` / ``set_flat_params_to`` / ``get_flat_grad_from``).

The flat order is ``bridge.tree_leaves``': JAX's ``ravel_pytree`` order,
dict keys sorted."""

from __future__ import annotations

from typing import Any, Callable

import torch

from sttode_tpu_torch import bridge


def get_flat_params(params: Any) -> tuple[torch.Tensor, Callable]:
    """(flat [P] tensor, unravel): ``unravel(flat)`` rebuilds a tree of the
    same structure and shapes from a [P] tensor."""
    leaves = bridge.tree_leaves(params)
    shapes = [t.shape for t in leaves]
    sizes = [t.numel() for t in leaves]
    flat = torch.cat([t.reshape(-1) for t in leaves]) if leaves \
        else torch.zeros(0)

    def unravel(vec: torch.Tensor):
        parts = iter(p.reshape(s) for p, s in
                     zip(torch.split(vec, sizes), shapes))
        return bridge.tree_map(lambda _: next(parts), params)

    return flat, unravel


def set_flat_params(flat: torch.Tensor, unravel_fn: Callable) -> Any:
    return unravel_fn(flat)


def get_flat_grad(grad_tree: Any) -> torch.Tensor:
    return get_flat_params(grad_tree)[0]


def param_l2(params: Any) -> torch.Tensor:
    """Global L2 norm of a tree (a weight-decay / monitoring helper)."""
    return torch.sqrt(sum(t.square().sum() for t in bridge.tree_leaves(params)))
