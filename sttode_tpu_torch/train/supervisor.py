"""Fault-tolerant training supervisor (port of
``sttode_tpu/train/supervisor.py``).

After each epoch ``after_epoch`` judges the epoch's mean loss: a
non-finite loss, or one above ``explosion_factor`` of the running median's
scale, is a divergence. A healthy epoch joins the history window and, on
the ``save_every`` cadence, writes the last-good checkpoint
(``train.checkpoint``). A divergence restores the last-good checkpoint,
halves ``lr_scale`` (``lr_decay_on_rollback``) and continues from its
epoch, at most ``max_rollbacks`` times; with no checkpoint or no budget
left it aborts.

The restore writes the checkpoint's values into the parameter tensors and
the optimizer's state tensors in place: a training step captured as a CUDA
graph (``scan_steps``) is bound to those tensors' addresses, so its next
replay goes on from the restored state, not from the diverged one.
"""

from __future__ import annotations

import collections
import math

import numpy as np
import torch

from sttode_tpu_torch import bridge
from sttode_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint


def restore_in_place(params, opt: torch.optim.Optimizer, saved_params,
                     saved_opt_state: dict) -> None:
    """Copy a checkpoint's parameters and optimizer state (its
    ``state_dict``) into ``params`` and ``opt``'s state tensors, keeping
    every tensor's address; raises ValueError where the checkpoint's state
    does not hold the same entries."""
    dst, src = bridge.tree_leaves(params), bridge.tree_leaves(saved_params)
    if len(dst) != len(src) or any(a.shape != b.shape
                                   for a, b in zip(dst, src)):
        raise ValueError("the checkpoint's parameters do not match the "
                         "run's")
    saved = saved_opt_state["state"]
    leaves = [p for g in opt.param_groups for p in g["params"]]
    for i, p in enumerate(leaves):
        cur, old = opt.state.get(p, {}), saved.get(i, {})
        if set(cur) != set(old):
            raise ValueError(f"the checkpoint's optimizer state of leaf {i} "
                             f"holds {sorted(old)}, the run's {sorted(cur)}")
    with torch.no_grad():
        for a, b in zip(dst, src):
            a.copy_(b)
        for i, p in enumerate(leaves):
            st = opt.state.get(p, {})
            for k, v in saved.get(i, {}).items():
                if isinstance(st[k], torch.Tensor):
                    st[k].copy_(v)
                else:
                    st[k] = v


class Supervisor:
    def __init__(self, ckpt_dir: str, cfg, *, explosion_factor: float = 50.0,
                 window: int = 20, max_rollbacks: int = 5,
                 lr_decay_on_rollback: float = 0.5,
                 save_every: int = 5):
        self.ckpt_dir = ckpt_dir
        self.cfg = cfg
        self.explosion_factor = explosion_factor
        self.history: collections.deque = collections.deque(maxlen=window)
        self.max_rollbacks = max_rollbacks
        self.lr_decay_on_rollback = lr_decay_on_rollback
        self.save_every = save_every
        self.rollbacks = 0
        self.lr_scale = 1.0
        self._last_good: str | None = None

    def healthy(self, loss: float) -> bool:
        """Is this epoch-mean loss sane given recent history?"""
        if not math.isfinite(loss):
            return False
        if self.history:
            baseline = float(np.median(self.history))
            # threshold = baseline + (f-1)·max(|baseline|, 1): the plain
            # f·baseline ratio for baselines ≥ 1, and still armed for losses
            # near zero or negative, where a ratio test disables itself
            scale = max(abs(baseline), 1.0)
            if loss > baseline + (self.explosion_factor - 1.0) * scale:
                return False
        return True

    def after_epoch(self, epoch: int, loss: float, params,
                    opt: torch.optim.Optimizer, *, log=print):
        """Record health; checkpoint on cadence. Returns (params, opt,
        epoch, action), action one of 'ok', 'rollback', 'abort': on
        'rollback' ``params`` and ``opt`` hold the last-good checkpoint's
        values (the same objects, restored in place), ``epoch`` is its
        epoch and ``lr_scale`` has been decayed."""
        if self.healthy(loss):
            self.history.append(loss)
            if (epoch + 1) % self.save_every == 0:
                self._last_good = save_checkpoint(
                    self.ckpt_dir, epoch + 1, params, opt, self.cfg)
            return params, opt, epoch, "ok"

        if self._last_good is None or self.rollbacks >= self.max_rollbacks:
            log(f"supervisor: divergence at epoch {epoch} "
                f"(loss={loss}); no recovery possible — aborting")
            return params, opt, epoch, "abort"

        self.rollbacks += 1
        self.lr_scale *= self.lr_decay_on_rollback
        saved_params, saved_opt, good_epoch, _ = load_checkpoint(
            self._last_good)
        restore_in_place(params, opt, saved_params, saved_opt)
        log(f"supervisor: divergence at epoch {epoch} (loss={loss}); "
            f"rolled back to epoch {good_epoch}, lr×{self.lr_scale}")
        return params, opt, good_epoch, "rollback"
