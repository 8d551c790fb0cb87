"""Agent-count buckets (port of ``sttode_tpu/data/batching.py::bucket_for``).

Scenes are padded to a small ladder of agent counts so that requests of
similar size share one batched call."""

from __future__ import annotations

from typing import Sequence

DEFAULT_BUCKETS = (8, 16, 32, 64, 128)


def bucket_for(n: int, buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    """Smallest bucket ≥ n; beyond the ladder, the next multiple of the
    largest bucket."""
    for b in buckets:
        if n <= b:
            return b
    top = buckets[-1]
    return ((n + top - 1) // top) * top
