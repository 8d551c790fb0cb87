"""Evaluation of the port (port of ``sttode_tpu/evaluation.py``).

``evaluate_scenes`` (ETH-UCY, SDD): per agent the best-of-K ADE and FDE
and the miss rate, averaged over the real agents of every scene (the
reference's ``test.py`` protocol). ``evaluate_nba``: the horizon table of
the reference's ``test_model_all``, per agent the best-of-K prefix ADE and
step FDE at each 0.4 s step, 1.0 s and 3.0 s as the mean of the two
adjacent steps. With ``device_reduce=True`` each batch is decoded and
reduced on the device and the sums are fetched once after the loop;
``device_reduce=False`` keeps the host-numpy loop, the oracle the device
path is tested against.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

from sttode_tpu_torch import bridge
from sttode_tpu_torch.data.batching import scene_batches
from sttode_tpu_torch.data.preprocess import prepare_nba_batch
from sttode_tpu_torch.models.sttode import STTODEConfig, sttode_inference
from sttode_tpu_torch.utils.metrics import (NBA_FUTURE_LENGTH, AverageMeter,
                                            compute_ade, compute_fde,
                                            count_miss_samples,
                                            nba_horizon_table)


def _best_of_k_sums(preds: torch.Tensor, future: torch.Tensor,
                    valid: torch.Tensor, miss_threshold: float):
    """[Σ ADE, Σ FDE, Σ missed, Σ valid] of one batch on the device, masked
    by ``valid``: preds [K, M, T, 2], future [M, T, 2]. The scene origins
    cancel in pred − gt, so the sums are origin-free."""
    err = torch.linalg.vector_norm(preds - future[None], dim=-1)  # [K, M, T]
    ade = err.mean(dim=-1).min(dim=0).values                     # [M]
    fde = err[..., -1].min(dim=0).values                         # [M]
    return torch.stack([(ade * valid).sum(), (fde * valid).sum(),
                        ((fde > miss_threshold) * valid).sum(), valid.sum()])


def evaluate_scenes(params, cfg: STTODEConfig, scenes: list[dict],
                    generator: torch.Generator | None = None, *,
                    sample_k: int = 20, scenes_per_batch: int = 1,
                    miss_threshold: float = 1.0,
                    device_reduce: bool = True) -> dict:
    """ETH/SDD protocol over scene dicts (``data.scene_batches``, no
    shuffle or augmentation): {'ade', 'fde', 'miss_rate', 'agents'}. Runs
    on the device of ``params``; the K latents of every batch come from
    ``generator`` (on that device)."""
    device = bridge.tree_leaves(params)[0].device
    batches = scene_batches(scenes, training=False,
                            scenes_per_batch=scenes_per_batch,
                            compat=cfg.compat)
    with torch.inference_mode():
        if device_reduce:
            sums = None
            for batch, _origs in batches:
                batch = batch.to(device)
                preds = sttode_inference(params, cfg, batch,
                                         generator=generator,
                                         sample_k=sample_k)
                s = _best_of_k_sums(preds, batch.future, batch.valid,
                                    miss_threshold)
                sums = s if sums is None else sums + s
            if sums is None:
                return {"ade": 0.0, "fde": 0.0, "miss_rate": 0.0,
                        "agents": 0}
            ade_s, fde_s, miss_s, n_s = sums.double().cpu().tolist()
            n = max(n_s, 1.0)
            return {"ade": ade_s / n, "fde": fde_s / n,
                    "miss_rate": miss_s / n, "agents": int(n)}

        ade_m, fde_m = AverageMeter(), AverageMeter()
        missed, total = 0, 0
        for batch, origs in batches:
            preds = sttode_inference(params, cfg, batch.to(device),
                                     generator=generator,
                                     sample_k=sample_k).cpu().numpy()
            K, M, T, _ = preds.shape
            B, N = batch.batch_size, batch.agent_num
            # each scene's origin re-added (the reference's inference tail)
            preds = preds.reshape(K, B, N, T, 2) + \
                origs[None, :, None, None, :]
            gt = batch.future.numpy().reshape(B, N, T, 2) + \
                origs[:, None, None, :]
            valid = batch.valid.numpy().reshape(B, N)
            pred_nk = np.transpose(preds, (1, 2, 0, 3, 4))  # [B, N, K, T, 2]
            for b in range(B):
                v = valid[b]
                n_real = int(v.sum())
                if n_real == 0:
                    continue
                ade_m.update(compute_ade(pred_nk[b], gt[b], v), n=n_real)
                fde_m.update(compute_fde(pred_nk[b], gt[b], v), n=n_real)
                real = v > 0
                missed += count_miss_samples(pred_nk[b][real], gt[b][real],
                                             miss_threshold)
                total += n_real
    return {"ade": ade_m.avg, "fde": fde_m.avg,
            "miss_rate": missed / max(total, 1), "agents": total}


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
