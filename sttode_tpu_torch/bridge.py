"""JAX parameters ↔ the port's parameters, and the port tree's leaves.

``params_from_jax`` takes the JAX package's parameter tree with numpy (or
array-like) leaves — get one with ``jax.tree_util.tree_map(np.asarray,
params)`` — nested in dicts, lists and NamedTuples, and returns the same
tree with float32 torch tensors on ``device``. Layouts are kept as they are
(dense ``[in, out]``, ``in_proj_w [E, 3E]``, GRU ``w_ih [D, 3H]``, conv WIO):
the port uses the JAX layouts. NamedTuples are matched by class name and
field names to the port's own classes; this module does not import JAX.
``params_to_numpy`` goes back (port tree → the same tree of numpy arrays),
and ``tree_leaves`` lists a tree's leaves in the JAX package's order
(dict keys sorted), for the optimizer and for leaf-by-leaf comparisons;
``tree_leaves_with_path`` names them as JAX's paths do (and
``tree_map_with_path`` maps over them).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from sttode_tpu_torch.nn.attention import MHGSAParams
from sttode_tpu_torch.nn.recurrent import Conv1dParams, GRUParams
from sttode_tpu_torch.nn.transformer import (DecoderLayerParams,
                                             EncoderLayerParams, FFNParams,
                                             GatedAttentionParams)

_NAMEDTUPLES = {cls.__name__: cls for cls in (
    MHGSAParams, GatedAttentionParams, FFNParams, EncoderLayerParams,
    DecoderLayerParams, GRUParams, Conv1dParams)}


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


def resolve_device(device: torch.device | str) -> torch.device:
    """The device an entry point runs on: the port runs on the card unless
    the caller asks for the CPU, so a CUDA device with none present
    raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is present: pass device='cpu' to "
                           "run the port's plain PyTorch paths on the CPU")
    return device


def to_device(tree, device: torch.device | str):
    """Move every tensor of a port parameter tree to ``device``."""
    return tree_map(lambda t: t.to(device), tree)


def tree_leaves(tree) -> list:
    """The leaves of a tree of dicts, lists, tuples and NamedTuples, in a
    fixed order: dict keys sorted, sequences and NamedTuple fields in order
    (``jax.tree_util.tree_leaves``'s order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_leaves_with_path(tree, path: tuple = ()) -> list:
    """(path, leaf) pairs in ``tree_leaves``' order; a path holds the dict
    keys, sequence indices and NamedTuple field names from the root, as
    ``jax.tree_util.tree_leaves_with_path`` names them."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in tree_leaves_with_path(tree[k], path + (k,))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for f in tree._fields
                for x in tree_leaves_with_path(getattr(tree, f), path + (f,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in tree_leaves_with_path(v, path + (i,))]
    return [(path, tree)]


def tree_map_with_path(fn: Callable, tree, path: tuple = ()):
    """``fn(path, leaf)`` at every leaf, paths as in
    ``tree_leaves_with_path`` (``jax.tree_util.tree_map_with_path``'s
    counterpart); the tree's structure is kept."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map_with_path(fn, getattr(tree, f),
                                               path + (f,))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def params_to_numpy(tree):
    """Port parameter tree → the same tree with float32 numpy leaves."""
    return tree_map(lambda t: t.detach().to("cpu", torch.float32).numpy(),
                    tree)
