"""JAX parameters → the port's parameters.

``params_from_jax`` takes the JAX package's parameter tree with numpy (or
array-like) leaves — get one with ``jax.tree_util.tree_map(np.asarray,
params)`` — nested in dicts, lists and NamedTuples, and returns the same
tree with float32 torch tensors on ``device``. Layouts are kept as they are
(dense ``[in, out]``, ``in_proj_w [E, 3E]``, GRU ``w_ih [D, 3H]``, conv WIO):
the port uses the JAX layouts. NamedTuples are matched by class name and
field names to the port's own classes; this module does not import JAX.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from sttode_tpu_torch.nn.attention import MHGSAParams
from sttode_tpu_torch.nn.recurrent import Conv1dParams, GRUParams
from sttode_tpu_torch.nn.transformer import (EncoderLayerParams, FFNParams,
                                             GatedAttentionParams)

_NAMEDTUPLES = {cls.__name__: cls for cls in (
    MHGSAParams, GatedAttentionParams, FFNParams, EncoderLayerParams,
    GRUParams, Conv1dParams)}


def tree_map(fn: Callable, tree):
    """Apply ``fn`` to every leaf of a tree of dicts, lists, tuples and
    parameter NamedTuples (rebuilt as the port's NamedTuple classes)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        cls = _NAMEDTUPLES.get(type(tree).__name__)
        if cls is None or cls._fields != tuple(tree._fields):
            raise TypeError(f"no port counterpart for parameter NamedTuple "
                            f"{type(tree).__name__}{tuple(tree._fields)}")
        return cls(*(tree_map(fn, getattr(tree, f)) for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def params_from_jax(tree, device: torch.device | str | None = None):
    """JAX parameter tree (numpy leaves) → port parameter tree (float32
    tensors on ``device``, default CPU)."""
    def leaf(x):
        a = np.array(x, dtype=np.float32, copy=True)
        return torch.from_numpy(a).to(device)
    return tree_map(leaf, tree)


def to_device(tree, device: torch.device | str):
    """Move every tensor of a port parameter tree to ``device``."""
    return tree_map(lambda t: t.to(device), tree)
