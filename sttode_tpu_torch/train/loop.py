"""Training steps and the epoch loop (port of ``sttode_tpu/train/loop.py``:
``make_train_step``, ``make_sampler_train_step``, ``train_epoch``).

A stage-1 step is ``sttode_forward``, a backward pass through PyTorch
autograd over every leaf of the parameter tree, and an Adam update. Every
leaf is trained, the two positional-encoding tables included: the JAX
package differentiates the whole tree and its optimizer updates them. A
stage-2 step is ``sampler_forward`` over the frozen net that the step holds,
``sampler_loss``, a backward pass and an Adam update of the sampler's leaves
only. ``torch.optim.Adam`` computes what ``optax.adam`` does,
lr · m̂ / (√v̂ + ε) with ε = 1e-8.

Unlike the JAX step, the update is in place: the parameter tensors and the
optimizer state are updated where they are, and the step returns the same
objects. ``train_epoch`` takes its batches through a background prefetch
thread (``data.prefetch``: pinned host memory and non-blocking copies on a
side CUDA stream), so host preparation and the copy overlap the previous
step. The JAX package's ``scan_steps`` (several steps per dispatch, a
workaround for its TPU's dispatch latency) is not ported.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable

import torch

from sttode_tpu_torch import bridge
from sttode_tpu_torch.data.prefetch import prefetch
from sttode_tpu_torch.models.sampler import (SamplerConfig, sampler_forward,
                                             sampler_loss)
from sttode_tpu_torch.models.sttode import Batch, STTODEConfig, sttode_forward
from sttode_tpu_torch.train.schedulers import set_lr

METRICS = ("total", "pred", "recover", "kl", "diverse")


class TrainStep:
    """The stage-1 step for one config, learning rate and device.

    >>> step = make_train_step(cfg, 1e-4)            # on the card
    >>> params, opt_state = step.init(sttode_init(0, cfg))
    >>> params, opt_state, metrics = step(params, opt_state, batch, gen)
    """

    def __init__(self, cfg: STTODEConfig, lr: float,
                 device: torch.device | str = "cuda"):
        self.cfg = cfg.validate()
        self.lr = lr
        self.device = bridge.resolve_device(device)

    def init(self, params) -> tuple[Any, torch.optim.Adam]:
        """(params as trainable leaf tensors on the step's device, the Adam
        state over them)."""
        params = bridge.tree_map(
            lambda t: t.detach().to(self.device, torch.float32)
            .clone().requires_grad_(), params)
        return params, torch.optim.Adam(bridge.tree_leaves(params),
                                        lr=self.lr)

    def __call__(self, params, opt_state: torch.optim.Adam, batch: Batch,
                 generator: torch.Generator | None = None):
        """One step → (params, opt_state, metrics), metrics the five loss
        terms as 0-dim tensors on the device. The random draws come from
        ``generator`` (on the step's device)."""
        batch = batch.to(self.device)
        opt_state.zero_grad(set_to_none=True)
        out = sttode_forward(params, self.cfg, batch, generator=generator)
        out.total_loss.backward()
        opt_state.step()
        metrics = dict(zip(METRICS, (
            out.total_loss, out.loss_pred, out.loss_recover, out.loss_kl,
            out.loss_diverse)))
        return params, opt_state, {k: v.detach() for k, v in metrics.items()}


def make_train_step(cfg: STTODEConfig, lr: float, *,
                    device: torch.device | str = "cuda") -> TrainStep:
    """Stage-1 step ``(params, opt_state, batch, generator) → (params,
    opt_state, metrics)`` with ``torch.optim.Adam(lr)``; ``step.init(params)``
    makes its params and optimizer state. Runs on the card unless
    ``device="cpu"``; raises when CUDA is asked for and absent."""
    return TrainStep(cfg, lr, device)


class SamplerTrainStep(TrainStep):
    """The stage-2 step for one net, sampler config, learning rate and
    device: the stage-1 net is frozen and held by the step (its leaves on
    the step's device, without gradients); ``init`` and the call take the
    sampler's parameters, in the call shape of ``TrainStep``, so that
    ``train_epoch`` drives either.

    >>> step = make_sampler_train_step(cfg, scfg, 1e-4, net_params)
    >>> sp, opt_state = step.init(sampler_init(0, scfg))
    >>> sp, opt_state, metrics = step(sp, opt_state, batch, gen)
    """

    def __init__(self, cfg: STTODEConfig, scfg: SamplerConfig, lr: float,
                 net_params, device: torch.device | str = "cuda"):
        super().__init__(cfg, lr, device)
        self.scfg = scfg
        self.net_params = bridge.tree_map(
            lambda t: t.detach().to(self.device, torch.float32), net_params)

    def __call__(self, params, opt_state: torch.optim.Adam, batch: Batch,
                 generator: torch.Generator | None = None):
        """One step → (params, opt_state, metrics), metrics {"total", "kld",
        "diverse"} (the KL and diversity unweighted) as 0-dim tensors on the
        device. ε is drawn from ``generator`` when the config samples
        (``train_w_mean=False``)."""
        batch = batch.to(self.device)
        opt_state.zero_grad(set_to_none=True)
        out = sampler_forward(params, self.net_params, self.scfg, self.cfg,
                              batch, generator=generator)
        total, parts = sampler_loss(out, self.scfg, batch)
        total.backward()
        opt_state.step()
        metrics = {"total": total, **parts}
        return params, opt_state, {k: v.detach() for k, v in metrics.items()}


def make_sampler_train_step(cfg: STTODEConfig, scfg: SamplerConfig,
                            lr: float, net_params, *,
                            device: torch.device | str = "cuda"
                            ) -> SamplerTrainStep:
    """Stage-2 step ``(sampler_params, opt_state, batch, generator) →
    (sampler_params, opt_state, metrics)`` over the frozen ``net_params``,
    with ``torch.optim.Adam(lr)`` over the sampler's leaves;
    ``step.init(sampler_params)`` makes its params and optimizer state.
    Runs on the card unless ``device="cpu"``; raises when CUDA is asked for
    and absent."""
    return SamplerTrainStep(cfg, scfg, lr, net_params, device)


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
    in the loop."""
    if lr is not None:
        set_lr(opt_state, lr)
    sums: dict = {}
    count = 0
    if prefetch_depth:
        batches = prefetch(batches, size=prefetch_depth, device=step.device)
    for i, (batch, _aux) in enumerate(batches):
        params, opt_state, metrics = step(params, opt_state, batch, generator)
        count += 1
        for k, v in metrics.items():
            sums[k] = sums.get(k, 0.0) + v
        if log_every and (i + 1) % log_every == 0:
            log_fn(f"iter {i + 1}: " + " ".join(
                f"{k}: {float(sums[k]) / count:.4f}" for k in sorted(sums)))
    return params, opt_state, {k: float(v) / max(count, 1)
                               for k, v in sums.items()}
