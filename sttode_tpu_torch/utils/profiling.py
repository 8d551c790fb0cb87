"""Tracing, timing and model introspection (port of
``sttode_tpu/utils/profiling.py``: ``trace``, ``time_fn``, ``param_count``
and ``param_table``).

- ``trace``       — a ``torch.profiler`` window (CPU activity, and CUDA
  activity where a card is present) written as a Chrome-trace JSON file
  into a directory, the role of JAX's ``jax.profiler`` trace.
- ``time_fn``     — steady-state seconds a call from the slope between two
  timing windows, each ending in a device barrier.
- ``param_table`` — one row per leaf (name, shape, params, bytes), the
  reference's parameter table, with JAX's names and printed layout.

JAX's ``cost_analysis`` and ``roofline`` use XLA's cost model and TPU
peaks; the port's bounds are ``chip_smoke.py``'s.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable

import torch

from sttode_tpu_torch import bridge


def _sync() -> None:
    """The device barrier: synchronize the card where there is one (a CPU
    call's work is done when it returns)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block and write its Chrome-trace JSON into ``log_dir``
    (``trace_<time>_<pid>.pt.trace.json``): ``with trace(d): step()``.
    Yields the ``torch.profiler.profile``; its ``trace_path`` attribute
    names the file once the block has ended."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        _sync()
        prof.stop()
        prof.trace_path = os.path.join(
            log_dir, f"trace_{time.strftime('%Y%m%d-%H%M%S')}_"
                     f"{os.getpid()}.pt.trace.json")
        prof.export_chrome_trace(prof.trace_path)


def time_fn(fn: Callable, *args, iters: int = 20, warmup: int = 2,
            **kwargs) -> dict:
    """Steady-state seconds a call of ``fn(*args, **kwargs)``, its first
    calls (the kernels' build, caches) excluded.

    Two timing windows of n and 2n calls, each ending in a device barrier;
    the slope ``(T(2n) - T(n)) / n`` cancels the barrier's constant latency
    and any constant dispatch tail. Where noise makes the slope ≤ 0: one
    retry, then the mean of a 2n window."""
    for _ in range(max(warmup, 1)):
        fn(*args, **kwargs)
    _sync()

    def window(n: int) -> float:
        t0 = time.perf_counter()
        for _ in range(n):
            fn(*args, **kwargs)
        _sync()
        return time.perf_counter() - t0

    t1 = window(iters)
    slope = (window(2 * iters) - t1) / iters
    if slope <= 0:
        t1 = window(iters)
        slope = (window(2 * iters) - t1) / iters
        if slope <= 0:
            slope = window(2 * iters) / (2 * iters)
    return {"seconds_per_call": slope, "calls_per_s": 1.0 / slope}


def param_count(params) -> int:
    """Number of scalars in a parameter tree."""
    return sum(t.numel() for t in bridge.tree_leaves(params))


def param_table(params: Any, *, print_fn=None) -> list[dict]:
    """Per-leaf rows {name, shape, params, bytes}, names the leaf's path
    joined by "/" as JAX's ``tree_leaves_with_path`` names it; with
    ``print_fn``, the table and its total printed in JAX's layout."""
    rows = []
    for path, leaf in bridge.tree_leaves_with_path(params):
        n = leaf.numel()
        rows.append({"name": "/".join(str(p) for p in path),
                     "shape": tuple(leaf.shape), "params": n,
                     "bytes": n * leaf.element_size()})
    total = sum(r["params"] for r in rows)
    if print_fn:
        width = max(len(r["name"]) for r in rows) if rows else 10
        print_fn(f"{'name':<{width}}  {'shape':>20}  {'params':>12}")
        for r in rows:
            print_fn(f"{r['name']:<{width}}  {str(r['shape']):>20}  "
                     f"{r['params']:>12,}")
        print_fn(f"{'TOTAL':<{width}}  {'':>20}  {total:>12,}")
    return rows
