"""Model introspection (port of ``sttode_tpu/utils/profiling.py::
param_count``; the JAX tracing and timing helpers are not ported)."""

from __future__ import annotations

from sttode_tpu_torch import bridge


def param_count(params) -> int:
    """Number of scalars in a parameter tree."""
    return sum(t.numel() for t in bridge.tree_leaves(params))
