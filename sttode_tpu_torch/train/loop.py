"""Training steps and the epoch loop (port of ``sttode_tpu/train/loop.py``:
``stack_batches``, ``make_train_step``, ``make_sampler_train_step``,
``train_epoch``).

A stage-1 step is ``sttode_forward``, a backward pass through PyTorch
autograd over every leaf of the parameter tree, and an Adam update. Every
leaf is trained, the two positional-encoding tables included: the JAX
package differentiates the whole tree and its optimizer updates them. A
stage-2 step is ``sampler_forward`` over the frozen net that the step holds,
``sampler_loss``, a backward pass and an Adam update of the sampler's leaves
only. ``torch.optim.Adam`` computes what ``optax.adam`` does,
lr · m̂ / (√v̂ + ε) with ε = 1e-8. A step that runs as a CUDA graph makes
it ``capturable``, with the learning rate a 0-dim device tensor (``set_lr``
fills it); an eager step keeps the plain form. A checkpoint stores it
device-free (``train.checkpoint``), so either resumes the other's.

Unlike the JAX step, the update is in place: the parameter tensors and the
optimizer state are updated where they are, and the step returns the same
objects. With ``scan_steps`` = S > 1 (JAX's several steps a dispatch) the
step takes a stacked batch (``stack_batches``: every tensor [S', ...], S'
read from the batch, so one step serves full chunks and an epoch's tail)
and runs S' optimizer steps; its metrics are stacked [S']. On the card one
CUDA graph of the S' steps is captured for each batch signature and S'
(``train.graph``) and replayed a call, ``step.mode == "graph"``; a config
that reads the host inside a step (dopri5's while form) runs its S' steps
one after another, ``"eager"``, as the CPU does. ``train_epoch`` takes its
batches through a background prefetch thread (``data.prefetch``: pinned
host memory and non-blocking copies on a side CUDA stream), so host
preparation and the copy overlap the previous step, and with S > 1 stacks
them per bucket signature into chunks, in JAX's order.

With a ``mesh`` (``parallel.make_mesh``, data parallelism) every rank
calls the step with its block of whole scenes (``parallel.shard_batch``)
and the global noise: the forward computes the single process's model
and losses (``models.sttode``: the gathered scene axis, the global
normalizers and noise), each rank's backward gives its share of every
gradient leaf, one all-reduce over "data" sums the shares (on a data ×
sequence mesh the "seq" ranks of a data group each hold their rows' whole
gradient, alike), and every rank runs the same update from rank 0's
initial values, so the parameters stay equal bit for bit across the
ranks. The metrics are the global losses, alike on
every rank. The stage-2 step does the same over the sampler's leaves. With
``scan_steps`` > 1 each rank passes its block of a stacked batch
(``shard_batch(..., stacked=True)``) and the global stacked noise; over
NCCL the S steps are captured with their collectives, over gloo (host
staged) they run eagerly (``train.graph.capturable``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Iterable

import torch

from sttode_tpu_torch import bridge
from sttode_tpu_torch.data.prefetch import prefetch, tree_to
from sttode_tpu_torch.models.sampler import (SamplerConfig, sampler_forward,
                                             sampler_loss)
from sttode_tpu_torch.models.sttode import (Batch, STTODEConfig, check_mesh,
                                            sttode_forward)
from sttode_tpu_torch.ode import warn_exhausted
from sttode_tpu_torch.parallel import collectives
from sttode_tpu_torch.parallel.mesh import TP_NOT_PORTED, replicate
from sttode_tpu_torch.train import graph as tgraph
from sttode_tpu_torch.train.schedulers import set_lr

METRICS = ("total", "pred", "recover", "kl", "diverse")


def stack_batches(batches: list[Batch]) -> Batch:
    """Stack same-shape batches along a new leading step axis for a step
    built with ``scan_steps`` > 1: every tensor field becomes [S, ...]; the
    static shape (``batch_size``, ``agent_num``) must agree across steps."""
    assert batches, "stack_batches needs at least one batch"
    b0 = batches[0]
    assert all(b.batch_size == b0.batch_size and b.agent_num == b0.agent_num
               for b in batches), "stacked batches must share static shape"
    return dataclasses.replace(b0, **{
        f.name: torch.stack([getattr(b, f.name) for b in batches])
        for f in dataclasses.fields(b0)
        if isinstance(getattr(b0, f.name), torch.Tensor)})


def stack_noise(noises: list):
    """Stack per-step injected draws along a new leading step axis, for a
    step built with ``scan_steps`` > 1: a list of ``TrainNoise`` (stage 1;
    the encoder layers' keep-mask lists included) or of stage 2's ε
    tensors. None fields stay None."""
    n0 = noises[0]
    if n0 is None:
        return None
    if isinstance(n0, torch.Tensor):
        return torch.stack(noises)
    if isinstance(n0, tuple) and hasattr(n0, "_fields"):
        return type(n0)(*(stack_noise(list(f)) for f in zip(*noises)))
    if isinstance(n0, list):
        return [stack_noise(list(f)) for f in zip(*noises)]
    raise TypeError(f"cannot stack {type(n0).__name__}")


class TrainStep:
    """The stage-1 step for one config, learning rate, device and
    ``scan_steps``.

    >>> step = make_train_step(cfg, 1e-4)            # on the card
    >>> params, opt_state = step.init(sttode_init(0, cfg))
    >>> params, opt_state, metrics = step(params, opt_state, batch, gen)

    ``step.mode`` is "graph" when the step runs S > 1 steps as one CUDA
    graph replay, else "eager". ``step.mesh`` is the data-parallel mesh or
    None."""

    def __init__(self, cfg: STTODEConfig, lr: float,
                 device: torch.device | str = "cuda", scan_steps: int = 1,
                 optimizer: Callable | None = None, mesh=None,
                 tp: bool = False):
        if scan_steps < 1:
            raise ValueError(f"scan_steps must be >= 1, got {scan_steps}")
        if tp:
            raise NotImplementedError(TP_NOT_PORTED)
        check_mesh(mesh)
        self.mesh = mesh
        self.cfg = cfg.validate()
        self.optimizer = optimizer or functools.partial(torch.optim.Adam,
                                                        lr=lr)
        self.device = bridge.resolve_device(device)
        self.scan_steps = scan_steps
        self.mode = "graph" if (scan_steps > 1 and self.device.type == "cuda"
                                and tgraph.capturable(self.cfg, mesh)) \
            else "eager"
        self.graphs: dict = {}

    def init(self, params, opt_state: dict | None = None
             ) -> tuple[Any, torch.optim.Adam]:
        """(params as trainable leaf tensors on the step's device, the
        optimizer over them), the state loaded from ``opt_state`` (a
        checkpoint's ``state_dict``) when given. A graph step's Adam is
        capturable, the learning rate a device tensor. Under a mesh every
        rank starts from rank 0's parameters (``param_sharding``'s
        replicated placement)."""
        params = bridge.tree_map(
            lambda t: t.detach().to(self.device, torch.float32)
            .clone().requires_grad_(), params)
        if self.mesh is not None:
            replicate(params, self.mesh)
        graph = self.mode == "graph"
        opt = self.optimizer(bridge.tree_leaves(params), capturable=graph)
        if opt_state is not None:
            opt.load_state_dict(opt_state)
        if graph:
            _make_capturable(opt, self.device)
        return params, opt

    def _loss(self, params, batch: Batch, generator, noise):
        """(total loss, metrics) of one step's forward."""
        out = sttode_forward(params, self.cfg, batch, generator=generator,
                             noise=noise, mesh=self.mesh)
        return out.total_loss, dict(zip(METRICS, (
            out.total_loss, out.loss_pred, out.loss_recover, out.loss_kl,
            out.loss_diverse)))

    def _one(self, params, opt_state, batch: Batch, generator, noise) -> dict:
        opt_state.zero_grad(set_to_none=True)
        total, metrics = self._loss(params, batch, generator, noise)
        total.backward()
        if self.mesh is not None:
            _sum_grads(params, self.mesh.get_group("data"))
        opt_state.step()
        return {k: v.detach() for k, v in metrics.items()}

    def _steps(self, params, opt_state, batch: Batch, generator,
               noise) -> dict:
        """A stacked batch's steps one after another, metrics stacked."""
        outs = [self._one(params, opt_state, tree_to(batch, lambda t: t[i]),
                          generator, tree_to(noise, lambda t: t[i]))
                for i in range(batch.past.shape[0])]
        return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}

    def __call__(self, params, opt_state: torch.optim.Adam, batch: Batch,
                 generator: torch.Generator | None = None, *,
                 noise: Any = None):
        """One call → (params, opt_state, metrics): one step, metrics the
        loss terms as 0-dim tensors on the device; with ``scan_steps`` > 1
        a stacked batch's S steps, metrics stacked [S]. The random draws
        come from ``generator`` (on the step's device) unless injected with
        ``noise`` (stage 1: a ``TrainNoise``; stacked with ``stack_noise``
        when the batch is)."""
        batch = batch.to(self.device)
        if self.scan_steps == 1:
            return params, opt_state, self._one(params, opt_state, batch,
                                                generator, noise)
        if batch.past.dim() != 4:
            raise ValueError("a step built with scan_steps > 1 takes a "
                             "stacked batch (stack_batches)")
        if self.mode == "eager":
            return params, opt_state, self._steps(params, opt_state, batch,
                                                  generator, noise)
        key = (tgraph.signature(batch), tgraph.signature(noise))
        g = self.graphs.get(key)
        if g is not None and g.bound_to(opt_state, generator):
            return params, opt_state, g.replay(batch, noise)
        # a new signature (or optimizer): its first chunk runs eagerly as
        # the capture's warm-up, then the capture; replays from the next
        metrics = tgraph.warm_up(lambda: self._steps(
            params, opt_state, batch, generator, noise), self.device)
        self.graphs[key] = tgraph.StepGraph(self._one, params, opt_state,
                                            batch, generator, noise)
        return params, opt_state, metrics

    def check_budget(self) -> None:
        """Warn if dopri5's scan budget ran out in a replay since the last
        check, then clear the graphs' flags (one host read, where the config
        integrates with dopri5; an eager step warns from the solver)."""
        flags = [g.exhausted for g in self.graphs.values()]
        if self.cfg.ode_method != "dopri5" or not flags:
            return
        if bool(torch.stack(flags).any()):
            warn_exhausted("scan_budget", self.cfg.ode_scan_budget)
        for f in flags:
            f.zero_()

    def graph_stats(self) -> dict:
        """Captures, replays, capture seconds and pool bytes of the step's
        graphs."""
        gs = list(self.graphs.values())
        return {"graphs": len(gs), "replays": sum(g.replays for g in gs),
                "capture_s": sum(g.capture_s for g in gs),
                "pool_bytes": sum(g.pool_bytes or 0 for g in gs)}


def _sum_grads(params, group) -> None:
    """Sum every gradient leaf over ``group``: one all-reduce of the leaves
    laid end to end."""
    grads = [p.grad for p in bridge.tree_leaves(params) if p.grad is not None]
    flat = collectives.all_reduce(torch.cat([g.reshape(-1) for g in grads]),
                                  group)
    at = 0
    for g in grads:
        g.copy_(flat[at:at + g.numel()].view_as(g))
        at += g.numel()


def _make_capturable(opt: torch.optim.Adam, device: torch.device) -> None:
    """Put an Adam on the card in its capturable form: the learning rate a
    0-dim device tensor, ``capturable`` set, and a loaded state's step
    counts moved to the device (a new state is made by Adam's first step,
    which a captured step's warm-up runs)."""
    for group in opt.param_groups:
        group["lr"] = torch.tensor(float(group["lr"]), device=device)
        group["capturable"] = True
        for p in group["params"]:
            st = opt.state.get(p)       # no entry made for a stateless leaf
            if st:
                st["step"] = st["step"].to(device, torch.float32)
    # a graph step's warm-up runs it uncaptured, on purpose
    opt._warned_capturable_if_run_uncaptured = True


def make_train_step(cfg: STTODEConfig, lr: float, *, scan_steps: int = 1,
                    device: torch.device | str = "cuda",
                    optimizer: Callable | None = None, mesh=None,
                    tp: bool = False) -> TrainStep:
    """Stage-1 step ``(params, opt_state, batch, generator) → (params,
    opt_state, metrics)`` with ``torch.optim.Adam(lr)``, or the optimizer
    that ``optimizer(leaves, capturable=...)`` makes (a factory that
    carries its own learning rate, e.g. ``train.guards.guarded_adam`` or
    ``train.riemannian.riemannian_sgd``: the counterpart of JAX's
    ``make_train_step(cfg, opt)``); ``step.init(params)`` makes its params
    and optimizer state. ``scan_steps`` > 1 takes a stacked batch and runs
    its steps in one call (one CUDA graph replay on the card). Runs on the
    card unless ``device="cpu"``; raises when CUDA is asked for and
    absent. ``mesh``: data parallelism over its "data" axis (see the
    module's docstring); ``tp=True`` and the meshes
    ``models.sttode.check_mesh`` refuses raise NotImplementedError."""
    return TrainStep(cfg, lr, device, scan_steps, optimizer, mesh, tp)


class SamplerTrainStep(TrainStep):
    """The stage-2 step for one net, sampler config, learning rate, device
    and ``scan_steps``: the stage-1 net is frozen and held by the step (its
    leaves on the step's device, without gradients); ``init`` and the call
    take the sampler's parameters, in the call shape of ``TrainStep``, so
    that ``train_epoch`` drives either.

    >>> step = make_sampler_train_step(cfg, scfg, 1e-4, net_params)
    >>> sp, opt_state = step.init(sampler_init(0, scfg))
    >>> sp, opt_state, metrics = step(sp, opt_state, batch, gen)

    Metrics are {"total", "kld", "diverse"} (the KL and diversity
    unweighted). ε is drawn from the generator when the config samples
    (``train_w_mean=False``) unless injected with ``noise`` (ε's draw, see
    ``sampler_forward``; stacked with ``stack_noise``)."""

    def __init__(self, cfg: STTODEConfig, scfg: SamplerConfig, lr: float,
                 net_params, device: torch.device | str = "cuda",
                 scan_steps: int = 1, mesh=None):
        super().__init__(cfg, lr, device, scan_steps, mesh=mesh)
        self.scfg = scfg
        self.net_params = bridge.tree_map(
            lambda t: t.detach().to(self.device, torch.float32), net_params)
        if mesh is not None:
            # the frozen net too is rank 0's on every rank
            replicate(self.net_params, mesh)

    def _loss(self, params, batch: Batch, generator, noise):
        out = sampler_forward(params, self.net_params, self.scfg, self.cfg,
                              batch, generator=generator, eps=noise,
                              mesh=self.mesh)
        total, parts = sampler_loss(out, self.scfg, batch, self.mesh)
        return total, {"total": total, **parts}


def make_sampler_train_step(cfg: STTODEConfig, scfg: SamplerConfig,
                            lr: float, net_params, *, scan_steps: int = 1,
                            device: torch.device | str = "cuda", mesh=None
                            ) -> SamplerTrainStep:
    """Stage-2 step ``(sampler_params, opt_state, batch, generator) →
    (sampler_params, opt_state, metrics)`` over the frozen ``net_params``,
    with ``torch.optim.Adam(lr)`` over the sampler's leaves;
    ``step.init(sampler_params)`` makes its params and optimizer state.
    ``scan_steps`` and ``mesh`` as in ``make_train_step`` (under a mesh ε,
    injected or drawn, is the whole batch's draw). Runs on the card unless
    ``device="cpu"``; raises when CUDA is asked for and absent."""
    return SamplerTrainStep(cfg, scfg, lr, net_params, device, scan_steps,
                            mesh)


def train_epoch(step: TrainStep, params, opt_state,
                batches: Iterable[tuple[Batch, Any]],
                generator: torch.Generator | None = None, *,
                lr: float | None = None, log_every: int = 0,
                log_fn: Callable = print, prefetch_depth: int = 2) -> tuple:
    """Drive one epoch over host-prepared (batch, aux) pairs, at learning
    rate ``lr`` when given (the epoch's value of a schedule). Returns
    (params, opt_state, mean metrics). Metrics accumulate on the device and
    are fetched only at log boundaries and at the end. With
    ``prefetch_depth`` > 0 the batches are prepared and copied to the
    step's device by a background thread, that many ahead; 0 prepares each
    in the loop.

    A step built with ``scan_steps`` > 1 gets the batches grouped into
    stacked chunks per bucket signature (batch size, agents, past and
    future shapes): each full chunk runs as one call, and the tails are
    flushed at the end of the epoch, in JAX's order. A log line is written
    once ``log_every`` steps have run since the last; the means are the
    sums of the stacked metrics over the step count, as in JAX. At each log
    line and at the end the step checks its captured solves' budget
    (``check_budget``)."""
    scan_steps = step.scan_steps
    if lr is not None:
        set_lr(opt_state, lr)
    sums: dict = {}
    count = 0
    if prefetch_depth:
        batches = prefetch(batches, size=prefetch_depth, device=step.device)

    def accumulate(metrics, n, stacked):
        nonlocal count
        count += n
        for k, v in metrics.items():
            sums[k] = sums.get(k, 0.0) + (v.sum() if stacked else v)

    def log(at):
        step.check_budget()
        log_fn(f"iter {at}: " + " ".join(
            f"{k}: {float(sums[k]) / count:.4f}" for k in sorted(sums)))

    if scan_steps <= 1:
        for i, (batch, _aux) in enumerate(batches):
            params, opt_state, metrics = step(params, opt_state, batch,
                                              generator)
            accumulate(metrics, 1, stacked=False)
            if log_every and (i + 1) % log_every == 0:
                log(i + 1)
    else:
        chunks: dict = {}     # bucket signature → pending same-shape batches
        logged_at = 0

        def flush(sig):
            nonlocal params, opt_state, logged_at
            chunk = chunks.pop(sig, [])
            if not chunk:
                return
            params, opt_state, metrics = step(
                params, opt_state, stack_batches(chunk), generator)
            accumulate(metrics, len(chunk), stacked=True)
            if log_every and count - logged_at >= log_every:
                logged_at = count
                log(count)

        for batch, _aux in batches:
            sig = (batch.batch_size, batch.agent_num,
                   tuple(batch.past.shape), tuple(batch.future.shape))
            chunks.setdefault(sig, []).append(batch)
            if len(chunks[sig]) == scan_steps:
                flush(sig)
        for sig in list(chunks):
            flush(sig)
    step.check_budget()
    return params, opt_state, {k: float(v) / max(count, 1)
                               for k, v in sums.items()}
