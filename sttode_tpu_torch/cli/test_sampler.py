"""Stage-2 evaluation CLI of the port (port of
``sttode_tpu/cli/test_sampler.py``).

    python -m sttode_tpu_torch.cli.test_sampler --dataset eth --data_root D --ckpt_dir C

A nested sweep over the newest ``--sweep`` stage-1 checkpoints × the newest
``--sweep`` sampler checkpoints (each with the config stored in it): the
best-of-nk min ADE and FDE of the sampler's deterministic decode
(mean=True) over the real agents of the test split, and the best pair by
ADE. ETH-UCY and SDD: one scene a batch, padded to its agent bucket; NBA
(which the JAX CLI's scene batching does not take): batches of 128 scenes
unless ``--batch_size``. Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import math
import os
from typing import Iterator

import numpy as np
import torch

from sttode_tpu_torch import bridge
from sttode_tpu_torch.cli import common
from sttode_tpu_torch.cli.trainsampler import add_sampler_args
from sttode_tpu_torch.data import (nba_batches, prepare_nba_batch,
                                   scene_batches)
from sttode_tpu_torch.models.sampler import SamplerConfig, sampler_forward
from sttode_tpu_torch.models.sttode import STTODEConfig
from sttode_tpu_torch.train import (checkpoint_epochs, checkpoint_path,
                                    load_checkpoint)
from sttode_tpu_torch.utils.metrics import (AverageMeter, compute_ade,
                                            compute_fde)


def _batches(scenes, cfg: STTODEConfig, nba_batch_size: int) -> Iterator:
    """(Batch, scene origins [B, 2]) of the evaluation: scene dicts through
    ``scene_batches``, NBA's (past, future) arrays through ``nba_batches``
    (its coordinates carry no origin: zeros)."""
    if isinstance(scenes, tuple):
        past, fut = scenes
        for d in nba_batches(past, fut, nba_batch_size):
            batch = prepare_nba_batch(d)
            yield batch, np.zeros((batch.batch_size, 2), np.float32)
    else:
        yield from scene_batches(scenes, training=False, compat=cfg.compat)


def eval_sampler(sampler_params, net_params, scfg: SamplerConfig,
                 cfg: STTODEConfig, scenes, *, device_reduce: bool = True,
                 nba_batch_size: int = 128) -> tuple[float, float]:
    """(ADE, FDE): per agent the best of the sampler's nk decodes, averaged
    over the real agents. ``scenes``: ETH/SDD scene dicts or NBA's (past,
    future) arrays. Runs on the device of ``net_params``. With
    ``device_reduce=True`` each batch is decoded and reduced on the device
    and the sums are fetched once after the loop; ``device_reduce=False``
    keeps the host-numpy loop, the oracle the device path is tested
    against. The decode is deterministic (mean=True): no random draw."""
    device = bridge.tree_leaves(net_params)[0].device
    with torch.inference_mode():
        if device_reduce:
            sums = None
            for batch, _origs in _batches(scenes, cfg, nba_batch_size):
                batch = batch.to(device)
                dec = sampler_forward(sampler_params, net_params, scfg, cfg,
                                      batch, mean=True).dec_motion
                # the scene origins cancel in pred − gt
                err = torch.linalg.vector_norm(
                    dec - batch.future[:, None], dim=-1)         # [M, K, T]
                ade = err.mean(dim=-1).min(dim=1).values         # [M]
                fde = err[..., -1].min(dim=1).values             # [M]
                v = batch.valid
                s = torch.stack([(ade * v).sum(), (fde * v).sum(), v.sum()])
                sums = s if sums is None else sums + s
            if sums is None:
                return 0.0, 0.0
            ade_s, fde_s, n_s = sums.double().cpu().tolist()
            n = max(n_s, 1.0)
            return ade_s / n, fde_s / n

        ade_m, fde_m = AverageMeter(), AverageMeter()
        for batch, origs in _batches(scenes, cfg, nba_batch_size):
            dec = sampler_forward(sampler_params, net_params, scfg, cfg,
                                  batch.to(device), mean=True) \
                .dec_motion.cpu().numpy()
            B, N = batch.batch_size, batch.agent_num
            K, T = dec.shape[1], dec.shape[2]
            dec = dec.reshape(B, N, K, T, 2) + origs[:, None, None, None, :]
            gt = batch.future.numpy().reshape(B, N, T, 2) + \
                origs[:, None, None, :]
            valid = batch.valid.numpy().reshape(B, N)
            for b in range(B):
                n_real = int(valid[b].sum())
                if n_real == 0:
                    continue
                ade_m.update(compute_ade(dec[b], gt[b], valid[b]), n=n_real)
                fde_m.update(compute_fde(dec[b], gt[b], valid[b]), n=n_real)
    return ade_m.avg, fde_m.avg


def main(argv=None) -> dict:
    parser = add_sampler_args(
        common.base_parser("STTODE stage-2 sampler evaluation (PyTorch)"))
    parser.add_argument("--sweep", type=int, default=2,
                        help="evaluate the last N stage-1 × the last N "
                             "sampler checkpoints")
    args = parser.parse_args(argv)
    device = bridge.resolve_device(args.device)
    common.model_config(args)              # refuses unported flag values
    cdir = common.ckpt_dir(args)
    sdir = os.path.join(cdir, "sampler")
    vae_epochs = checkpoint_epochs(cdir)[-args.sweep:]
    sampler_epochs = checkpoint_epochs(sdir)[-args.sweep:]
    if not vae_epochs or not sampler_epochs:
        raise SystemExit(f"need checkpoints under {cdir} and {sdir}")

    scenes = common.load_scenes(args, "test")
    best = {"ade": math.inf, "fde": math.inf}
    for ve in vae_epochs:
        net_params, _, _, cfg = load_checkpoint(checkpoint_path(cdir, ve),
                                                device=device)
        for se in sampler_epochs:
            sp, _, _, scfg = load_checkpoint(checkpoint_path(sdir, se),
                                             device=device)
            ade, fde = eval_sampler(sp, net_params, scfg, cfg, scenes,
                                    nba_batch_size=args.batch_size or 128)
            print(f"vae {ve} × sampler {se}: ADE {ade:.4f} FDE {fde:.4f}")
            if ade < best["ade"]:
                best = {"ade": ade, "fde": fde, "vae": ve, "sampler": se}
    print(f"best: ADE: {best['ade']:.4f} FDE: {best['fde']:.4f}")
    return best


if __name__ == "__main__":
    main()
