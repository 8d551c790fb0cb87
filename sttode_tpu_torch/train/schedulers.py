"""Learning-rate schedules (port of ``sttode_tpu/train/schedulers.py``:
``step_lr``, ``lambda_lr``, ``adam_with_schedule``, ``set_lr``,
``ReduceOnPlateau`` and ``ExpParamAnnealer``).

The reference steps its scheduler once per epoch, so a schedule is a function
of the epoch that the trainer evaluates before each epoch and writes into the
optimizer with ``set_lr``.
"""

from __future__ import annotations

import functools

import torch


def step_lr(base_lr: float, decay_step: int, gamma: float = 0.5):
    """torch StepLR as a function of the epoch: lr·γ^⌊epoch/decay_step⌋ (the
    reference trains with StepLR(10, 0.5))."""
    def schedule(epoch: int) -> float:
        return base_lr * (gamma ** (epoch // decay_step))
    return schedule


def lambda_lr(base_lr: float, fix_epochs: int, total_epochs: int):
    """The reference sampler trainer's lambda decay as a function of the
    epoch: ``base_lr`` for ``fix_epochs`` epochs, then linear towards 0."""
    def schedule(epoch: int) -> float:
        if epoch < fix_epochs:
            return base_lr
        frac = 1.0 - (epoch - fix_epochs) / max(
            total_epochs - fix_epochs + 1, 1)
        return base_lr * max(frac, 0.0)
    return schedule


class ReduceOnPlateau:
    """Metric-driven decay (torch's ReduceLROnPlateau, the reference's
    plateau scheduler). Host-side state: call ``step(metric)`` once an epoch
    and read ``.lr``."""

    def __init__(self, base_lr: float, factor: float = 0.5, patience: int = 10,
                 threshold: float = 1e-4, min_lr: float = 0.0):
        self.lr = base_lr
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.best = float("inf")
        self.bad_epochs = 0

    def step(self, metric: float) -> float:
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.bad_epochs = 0
        return self.lr


class ExpParamAnnealer:
    """Exponential parameter annealer (the reference's machinery, whose
    registered list stays empty there): ``val`` goes from ``start`` towards
    ``finish`` by ``rate`` per ``step``."""

    def __init__(self, start: float, finish: float, rate: float):
        self.start = start
        self.finish = finish
        self.rate = rate
        self.t = 0

    def step(self):
        self.t += 1

    @property
    def val(self) -> float:
        return self.finish - (self.finish - self.start) * (self.rate ** self.t)


def adam_with_schedule(schedule_fn, epoch: int = 0, **adam_kwargs):
    """An optimizer factory for ``make_train_step(..., optimizer=)``: Adam
    at ``schedule_fn(epoch)``; the trainer moves it between epochs with
    ``set_lr``, its moments kept (JAX's ``inject_hyperparams`` Adam)."""
    return functools.partial(torch.optim.Adam, lr=schedule_fn(epoch),
                             **adam_kwargs)


def set_lr(opt: torch.optim.Optimizer, lr: float) -> torch.optim.Optimizer:
    """Set the learning rate of every parameter group of ``opt``; its
    moments are kept. A learning rate held as a tensor (a capturable Adam
    on the card) is filled in place, so that a captured step's replays
    read the new value."""
    for group in opt.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr
    return opt
