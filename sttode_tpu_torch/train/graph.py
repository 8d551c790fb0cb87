"""S optimizer steps captured as one CUDA graph: the port's counterpart of
the JAX package's ``scan_steps`` (``lax.scan`` over stacked batches in one
device dispatch).

A ``StepGraph`` holds one capture of a step body run S times over static
[S, ...] batch and noise buffers: S forwards, autograd backwards and Adam
updates, replayed in one launch. It is bound to the parameters, the Adam
state and the learning-rate tensors it was captured over (their addresses
are in the graph) and to the generator it draws from. What the capture
needs of the step:

- no host synchronization: a device-to-host read or a pageable copy inside
  the body makes the capture raise, and the error propagates;
- ``torch.optim.Adam(capturable=True)`` with the learning rate a 0-dim
  device tensor that ``schedulers.set_lr`` fills in place, and its state
  made before the capture;
- the generator registered with the graph, so that each replay draws anew.

The first call of a signature runs its S steps eagerly on a side stream
(``warm_up``), as real steps: lazy initializations and Adam's state happen
there, not inside the capture. The capture that follows runs nothing, so
the next call's replay goes on from the parameters, the Adam state and the
generator that the warm-up left. Outputs of a replay live in the graph's
buffers: ``replay`` returns copies. A replay writes the parameters and the
Adam state without dispatching an operation, so their autograd version
counters would not move: ``replay`` increments them, so that a cache keyed
on versions (kernel B's packed weights) sees the update. dopri5's scan form
does not read its step counts inside a capture: whether its budget ran out
is ORed into the graph's ``exhausted`` flag on the device
(``ode.exhaustion_flag``), which the step reads at its log boundaries. The
kernel wrappers' launch counters count host calls, and a replay makes none:
the capture's launches are taken out of the counters and added back once a
replay (``kernels.counters``). A data-parallel step over NCCL is captured
with its collectives (the loss's sums, the K/V gathers, the gradient
all-reduce), which a replay runs on the device with the other ranks'. The
capture uses ``capture_error_mode="thread_local"``, so that the prefetch
thread's pinned-memory copies may go on while the training thread
captures.
"""

from __future__ import annotations

import time
from typing import Any, Callable

import torch
import torch.distributed as dist

from sttode_tpu_torch.data.prefetch import tree_to
from sttode_tpu_torch.kernels import counters
from sttode_tpu_torch.ode import exhaustion_flag


def capturable(cfg, mesh=None) -> bool:
    """Whether a step of ``cfg`` on ``mesh`` can be captured, decided when
    the step is built: dopri5's while form (``ode_scan_budget == 0``)
    reads the host once an attempt, and a mesh over gloo stages its
    collectives through host memory (``parallel.collectives``), so such
    steps run eagerly; every other step is captured, NCCL's collectives
    with it."""
    while_form = cfg.ode_method == "dopri5" and cfg.ode_scan_budget == 0
    return not while_form and (mesh is None or
                               dist.get_backend(mesh.get_group("data"))
                               == "nccl")


def tensors(tree) -> list:
    """The tensors of a batch or noise tree, in ``tree_to``'s order."""
    out = []
    tree_to(tree, out.append)
    return out


def signature(tree) -> tuple:
    """Shapes and dtypes of a tree's tensors, with its structure (a
    ``Batch``'s ints included): what a capture is specialized to."""
    shapes = []

    def leaf(t):
        shapes.append((tuple(t.shape), t.dtype))
        return None

    return repr(tree_to(tree, leaf)), tuple(shapes)


def _bound(opt: torch.optim.Optimizer) -> list:
    """The tensors a captured step reads and writes in place: the
    parameters, their Adam state and the learning-rate tensors."""
    out = []
    for group in opt.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            out.append(group["lr"])
        for p in group["params"]:
            out.append(p)
            out.extend(v for v in opt.state.get(p, {}).values()
                       if isinstance(v, torch.Tensor))
    return out


def pool_bytes(pool) -> int | None:
    """Bytes the caching allocator holds in a graph's private memory pool,
    from its memory snapshot (None when the snapshot does not name pools)."""
    total, named = 0, False
    for seg in torch.cuda.memory_snapshot():
        if "segment_pool_id" in seg:
            named = True
            if tuple(seg["segment_pool_id"]) == tuple(pool):
                total += seg["total_size"]
    return total if named else None


def warm_up(run: Callable[[], Any], device: torch.device):
    """``run()`` on a side stream, after the current stream's work and
    before its later work: a capture's warm-up. What ``run`` returns (a
    dict of tensors) is recorded as used by the current stream."""
    current = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        out = run()
    current.wait_stream(side)
    for v in out.values():
        v.record_stream(current)
    return out


def mark_changed(tensors: list) -> None:
    """Increment the autograd version counters of ``tensors``, written in
    place by a replay that dispatched no operation."""
    for t in tensors:
        torch.autograd.graph.increment_version(t)


class StepGraph:
    """One capture of ``body(params, opt, batch_i, generator, noise_i) →
    metrics`` for i in 0..S-1 over static copies of ``batch`` and ``noise``
    ([S, ...] trees), made after ``warm_up``; ``replay`` runs it on new
    inputs of the same signature and returns the metrics stacked [S]
    (copies)."""

    def __init__(self, body: Callable, params, opt: torch.optim.Optimizer,
                 batch, generator: torch.Generator | None, noise: Any):
        self.device = tensors(batch)[0].device
        self.steps = n = tensors(batch)[0].shape[0]
        self.generator = generator
        self.opt = opt
        self.static_batch = tree_to(batch, torch.clone)
        self.static_noise = tree_to(noise, torch.clone)
        self.bound = _bound(opt)
        self.bound_ptrs = [t.data_ptr() for t in self.bound]
        self.exhausted = torch.zeros((), dtype=torch.bool, device=self.device)

        opt.zero_grad(set_to_none=True)
        self.graph = torch.cuda.CUDAGraph()
        if generator is not None:
            self.graph.register_generator_state(generator)
        before = counters.snapshot()
        t0 = time.perf_counter()
        with exhaustion_flag(self.exhausted), torch.cuda.graph(
                self.graph, capture_error_mode="thread_local"):
            outs = [body(params, opt,
                         tree_to(self.static_batch, lambda t: t[i]),
                         generator,
                         tree_to(self.static_noise, lambda t: t[i]))
                    for i in range(n)]
            self.outputs = {k: torch.stack([o[k] for o in outs])
                            for k in outs[0]}
        self.capture_s = time.perf_counter() - t0
        self.launches = counters.delta(before, counters.snapshot())
        counters.restore(before)        # a capture launches nothing
        self.pool_bytes = pool_bytes(self.graph.pool())
        self.replays = 0

    def bound_to(self, opt: torch.optim.Optimizer,
                 generator: torch.Generator | None) -> bool:
        """Whether the capture still addresses ``opt``'s tensors and draws
        from ``generator``."""
        return (opt is self.opt and generator is self.generator
                and [t.data_ptr() for t in _bound(opt)] == self.bound_ptrs)

    def replay(self, batch, noise) -> dict:
        for dst, src in zip(tensors(self.static_batch), tensors(batch)):
            dst.copy_(src)
        for dst, src in zip(tensors(self.static_noise), tensors(noise)):
            dst.copy_(src)
        self.graph.replay()
        mark_changed(self.bound)
        self.replays += 1
        counters.add(self.launches)
        return {k: v.clone() for k, v in self.outputs.items()}
