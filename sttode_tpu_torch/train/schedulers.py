"""Learning-rate schedules (port of ``sttode_tpu/train/schedulers.py``:
``step_lr``, ``lambda_lr``, ``set_lr``).

The reference steps its scheduler once per epoch, so a schedule is a function
of the epoch that the trainer evaluates before each epoch and writes into the
optimizer with ``set_lr``.
"""

from __future__ import annotations

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
