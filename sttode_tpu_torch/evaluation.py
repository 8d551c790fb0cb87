"""NBA evaluation of the port (port of ``sttode_tpu/evaluation.py::
evaluate_nba``; ``evaluate_scenes`` for ETH-UCY and SDD is not ported yet).

The horizon table of the reference's ``test_model_all``: per agent the
best-of-K prefix ADE and step FDE at each 0.4 s step, 1.0 s and 3.0 s as the
mean of the two adjacent steps. ``device_reduce=True`` decodes each batch and
reduces it on the device, and fetches the sums once after the loop;
``device_reduce=False`` keeps the host-numpy loop, the oracle the device
path is tested against.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

from sttode_tpu_torch import bridge
from sttode_tpu_torch.data.preprocess import prepare_nba_batch
from sttode_tpu_torch.models.sttode import STTODEConfig, sttode_inference
from sttode_tpu_torch.utils.metrics import (NBA_FUTURE_LENGTH,
                                            nba_horizon_table)


def _horizon_means(preds: torch.Tensor, future: torch.Tensor,
                   traj_scale: float):
    """(prefix ADE [T], step FDE [T]) of one batch, means over agents, on
    the device: preds [K, M, T, 2], future [M, T, 2]."""
    T = preds.shape[2]
    d = torch.linalg.vector_norm(preds - future[None], dim=-1) * traj_scale
    d = d.transpose(0, 1)                                        # [M, K, T]
    steps = torch.arange(1, T + 1, device=d.device, dtype=d.dtype)
    prefix = torch.cumsum(d, dim=-1) / steps                     # [M, K, T]
    return prefix.min(dim=1).values.mean(dim=0), d.min(dim=1).values.mean(0)


def evaluate_nba(params, cfg: STTODEConfig, batches: Iterable[dict],
                 generator: torch.Generator | None = None, *,
                 sample_k: int = 20, traj_scale: float = 1.0,
                 device_reduce: bool = True) -> dict:
    """NBA horizon table {'ade': {...}, 'fde': {...}, 'scenes'} over the
    collated dict batches of ``data.nba.nba_batches``. Runs on the device of
    ``params``; the K latents of every batch come from ``generator`` (on
    that device)."""
    T = cfg.future_length
    if T != NBA_FUTURE_LENGTH:
        raise ValueError(
            f"evaluate_nba assumes the NBA protocol: 10 prediction steps at "
            f"0.4 s (horizon rows 1.0s-4.0s index that grid); got "
            f"future_length={T}")
    device = bridge.tree_leaves(params)[0].device
    avg_acc, dest_acc = np.zeros(T), np.zeros(T)
    sums = []
    n_scenes = 0
    with torch.inference_mode():
        for data in batches:
            batch = prepare_nba_batch(data).to(device)
            B = batch.batch_size
            n_scenes += B
            preds = sttode_inference(params, cfg, batch, generator=generator,
                                     sample_k=sample_k)
            if device_reduce:
                avg, dest = _horizon_means(preds, batch.future, traj_scale)
                sums.append(torch.stack([avg, dest]) * B)
                continue
            preds = np.transpose(preds.cpu().numpy(), (1, 0, 2, 3)) \
                * traj_scale
            gt = batch.future.cpu().numpy() * traj_scale        # [M, T, 2]
            d = np.linalg.norm(preds - gt[:, None], axis=-1)    # [M, K, T]
            for t in range(T):
                avg_acc[t] += d[:, :, :t + 1].mean(-1).min(-1).mean() * B
                dest_acc[t] += d[:, :, t].min(-1).mean() * B
        if sums:
            avg_acc, dest_acc = torch.stack(sums).sum(0).double().cpu() \
                .numpy()
    n = max(n_scenes, 1)
    return nba_horizon_table(avg_acc / n, dest_acc / n, n_scenes)
