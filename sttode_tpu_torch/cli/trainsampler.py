"""Stage-2 sampler training CLI of the port (port of
``sttode_tpu/cli/trainsampler.py``).

    python -m sttode_tpu_torch.cli.trainsampler --dataset eth --data_root D --ckpt_dir C

Loads the frozen stage-1 net from ``<ckpt_dir>/<dataset>/model_%04d.pt``
(``--vae_epoch``, or the newest), trains only the sampler's parameters with
Adam under the reference's lambda decay (``--lr`` for ``--fix_epochs``
epochs, then linear towards 0; set before each epoch), resumes from the
newest checkpoint under ``<ckpt_dir>/<dataset>/sampler/`` and writes one
there every ``--model_save_epoch`` epochs (from a background thread with
``--async_ckpt``). Batches as in ``cli.train`` (``batch_stream``, seeded
by ``--seed``; the prefetch thread), ``--scan_steps`` steps a call (one
CUDA graph replay on the card). Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import os
import time
from typing import NamedTuple

import torch

from sttode_tpu_torch import bridge
from sttode_tpu_torch.cli import common
from sttode_tpu_torch.cli.train import batch_stream
from sttode_tpu_torch.models.sampler import SamplerConfig, sampler_init
from sttode_tpu_torch.models.sttode import STTODEConfig
from sttode_tpu_torch.train import (checkpoint_path, flush_saves,
                                    lambda_lr, latest_checkpoint,
                                    load_checkpoint, make_sampler_train_step,
                                    save_checkpoint, train_epoch)


class SamplerRun(NamedTuple):
    """What ``main`` returns: the trained sampler parameters and optimizer,
    the sampler's and the frozen net's configs, the epoch the run started
    from, per epoch run, (epoch, learning rate, mean metrics), and the
    training step."""
    params: object
    opt: torch.optim.Optimizer
    scfg: SamplerConfig
    cfg: STTODEConfig
    start_epoch: int
    history: list
    step: object = None


def add_sampler_args(parser):
    parser.add_argument("--nz", type=int, default=32)
    parser.add_argument("--qnet_mlp", type=int, nargs="+", default=[512, 256])
    parser.add_argument("--no_share_eps", action="store_true")
    parser.add_argument("--no_train_w_mean", action="store_true")
    parser.add_argument("--kld_weight", type=float, default=0.1)
    parser.add_argument("--kld_min_clamp", type=float, default=10.0)
    parser.add_argument("--vae_epoch", type=int, default=0,
                        help="stage-1 checkpoint epoch (0 = latest)")
    parser.add_argument("--fix_epochs", type=int, default=5)
    return parser


def main(argv=None) -> SamplerRun:
    parser = add_sampler_args(
        common.base_parser("STTODE stage-2 sampler training (PyTorch)"))
    args = parser.parse_args(argv)
    device = bridge.resolve_device(args.device)
    nprng = common.seed_everything(args.seed)
    common.model_config(args)              # refuses unported flag values
    scfg = common.sampler_config(args)

    # the frozen stage-1 net, with the config stored in its checkpoint
    cdir = common.ckpt_dir(args)
    vae_path = checkpoint_path(cdir, args.vae_epoch) if args.vae_epoch > 0 \
        else latest_checkpoint(cdir)
    if vae_path is None:
        raise SystemExit(f"no stage-1 checkpoint under {cdir}")
    net_params, _, _, cfg = load_checkpoint(vae_path, device=device)
    print(f"frozen net from {vae_path}")
    if scfg.nz != cfg.zdim:
        # the sampler's A·ε+b latents drive the net's decoder: fail here
        # with the fix named, not with a shape error inside the decoder
        raise SystemExit(
            f"--nz {scfg.nz} must equal the frozen net's zdim {cfg.zdim} "
            f"(the sampler's A·ε+b latents feed the net's decoder); "
            f"pass --nz {cfg.zdim}")

    sampler_params = sampler_init(args.seed, scfg,
                                  pred_model_dim=cfg.hidden_dim,
                                  past_feature_dim=2 * cfg.hidden_dim)
    schedule = lambda_lr(args.lr, args.fix_epochs, args.num_epochs)
    sdir = os.path.join(cdir, "sampler")
    start_epoch, opt_state = 0, None
    resume = latest_checkpoint(sdir)
    if resume is not None:
        sampler_params, opt_state, start_epoch, scfg = load_checkpoint(resume)
        print(f"resumed sampler epoch {start_epoch}")

    step = make_sampler_train_step(cfg, scfg, args.lr, net_params,
                                   device=device, scan_steps=args.scan_steps)
    params, opt = step.init(sampler_params, opt_state)
    print(f"sampler step: {step.mode}, {args.scan_steps} step(s) a call")
    gen = torch.Generator(device=device).manual_seed(args.seed)
    data = common.load_scenes(args, "train")
    history = []
    for epoch in range(start_epoch, args.num_epochs):
        lr = schedule(epoch)
        t0 = time.time()
        params, opt, means = train_epoch(
            step, params, opt, batch_stream(args, data, nprng, cfg), gen,
            lr=lr, log_every=args.log_every)
        history.append((epoch, lr, means))
        msg = " ".join(f"{k}: {v:.4f}" for k, v in sorted(means.items()))
        print(f"sampler epoch {epoch:03d} [{time.time() - t0:.1f}s] "
              f"lr {lr:.3e} {msg}")
        if (epoch + 1) % args.model_save_epoch == 0:
            path = save_checkpoint(sdir, epoch + 1, params, opt, scfg,
                                   keep_last=args.keep_last_ckpts or None,
                                   background=args.async_ckpt)
            print(f"saved {path}")
    flush_saves()
    return SamplerRun(params, opt, scfg, cfg, start_epoch, history, step)


if __name__ == "__main__":
    main()
