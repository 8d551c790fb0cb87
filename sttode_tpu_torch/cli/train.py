"""Stage-1 CVAE training CLI of the port (port of ``sttode_tpu/cli/train.py``).

    python -m sttode_tpu_torch.cli.train --dataset eth --data_root D --ckpt_dir C

The epoch loop: shuffled batches (numpy, seeded by ``--seed``; NBA: 32
scenes; ETH-UCY and SDD: one scene padded to its agent bucket, or
``--scenes_per_batch`` scenes of one bucket, rotated at random unless
``--no_rand_rot``) → a prefetch thread → the training step on the card
(``--device cpu`` for the plain paths) → StepLR(``--decay_step``,
``--decay_gamma``) set before each epoch →
a checkpoint every ``--model_save_epoch`` epochs (from a background
thread with ``--async_ckpt``); ``--epoch_continue N`` resumes from
checkpoint N (parameters, Adam state, epoch, config), whatever
``--scan_steps`` wrote it. ``--scan_steps S`` runs S same-bucket steps a
call, on the card as one CUDA graph replay; the run prints the step's mode
("graph" or "eager"). The model's random draws come from a
``torch.Generator`` seeded by ``--seed`` on the device. On SIGTERM the run
finishes the epoch, writes a checkpoint and returns, so that
``--epoch_continue`` resumes it. ``--supervise`` hands the checkpoints to
a ``train.supervisor.Supervisor``: a healthy epoch is checkpointed every
``--model_save_epoch`` epochs, a diverged one (a non-finite or exploding
mean loss) is rolled back in place to the last-good checkpoint and run
again at half the learning rate, and the run aborts when it cannot roll
back. ``--profile_dir D`` traces the first epoch with ``torch.profiler``
into a Chrome-trace JSON file in D (``utils.profiling.trace``).
``--distributed`` joins the processes that a launcher started (torchrun's
environment: ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``) over ``--dist_backend`` (nccl on the card, gloo on the CPU
or for several processes on one card), or exits when that environment is
missing; as in the JAX package's CLI, the step then has no mesh, so each
process trains the whole run.
"""

from __future__ import annotations

import contextlib
import signal
import time
from typing import NamedTuple

import torch
import torch.distributed as dist

from sttode_tpu_torch import bridge
from sttode_tpu_torch.cli import common
from sttode_tpu_torch.data import nba_batches, prepare_nba_batch, scene_batches
from sttode_tpu_torch.models.sttode import STTODEConfig, sttode_init
from sttode_tpu_torch.parallel.mesh import init_distributed
from sttode_tpu_torch.train import (checkpoint_path, flush_saves,
                                    load_checkpoint, make_train_step,
                                    save_checkpoint, step_lr, train_epoch)
from sttode_tpu_torch.train.supervisor import Supervisor
from sttode_tpu_torch.utils.profiling import param_count, trace


class TrainRun(NamedTuple):
    """What ``main`` returns: the trained parameters and optimizer, the
    config, the epoch the run started from and, per epoch run, (epoch,
    learning rate, mean metrics), and the training step (its ``mode`` and
    captured graphs, ``step.graph_stats()``)."""
    params: object
    opt: torch.optim.Optimizer
    cfg: STTODEConfig
    start_epoch: int
    history: list
    step: object = None


def batch_stream(args, data, nprng, cfg: STTODEConfig):
    """One epoch's (Batch, aux) pairs, drawn from ``nprng``."""
    if args.dataset == "nba":
        past, fut = data
        for d in nba_batches(past, fut, args.batch_size or 32, rng=nprng):
            yield prepare_nba_batch(d), None
    else:
        yield from scene_batches(
            data, training=True, rng=nprng,
            scenes_per_batch=args.scenes_per_batch,
            max_train_agent=common.effective_max_train_agent(args),
            rand_rot=not args.no_rand_rot, compat=cfg.compat)


def main(argv=None) -> TrainRun:
    parser = common.base_parser("STTODE stage-1 CVAE training (PyTorch)")
    parser.add_argument("--supervise", action="store_true",
                        help="enable divergence detection + rollback "
                             "(train.supervisor)")
    parser.add_argument("--profile_dir", default="",
                        help="write a torch.profiler trace of the first "
                             "epoch here")
    parser.add_argument("--distributed", action="store_true",
                        help="join the processes of a launcher (torchrun's "
                             "MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE, "
                             "LOCAL_RANK; parallel.init_distributed)")
    parser.add_argument("--dist_backend", choices=("nccl", "gloo"),
                        default=None,
                        help="--distributed's backend: nccl (the default "
                             "on cuda) or gloo (the default on cpu; also "
                             "several processes on one card)")
    args = parser.parse_args(argv)
    if args.distributed:
        backend = args.dist_backend or (
            "gloo" if torch.device(args.device).type == "cpu" else "nccl")
        if not init_distributed(backend):
            # an explicit request: a process without its launcher's
            # environment must not quietly train alone
            raise SystemExit(
                "--distributed was passed but no launcher environment is "
                "set: run under torchrun (MASTER_ADDR, MASTER_PORT, RANK, "
                "WORLD_SIZE, LOCAL_RANK); drop the flag for single-process "
                "training")
        print(f"distributed: process {dist.get_rank()} of "
              f"{dist.get_world_size()} over {backend}", flush=True)
    try:
        return _train(args)
    finally:
        if args.distributed:
            dist.destroy_process_group()


def _train(args) -> TrainRun:
    device = bridge.resolve_device(args.device)
    nprng = common.seed_everything(args.seed)
    cfg = common.model_config(args)
    data = common.load_scenes(args, "train")
    schedule = step_lr(args.lr, args.decay_step, args.decay_gamma)

    params, opt_state, start_epoch = sttode_init(args.seed, cfg), None, 0
    cdir = common.ckpt_dir(args)
    if args.epoch_continue > 0:
        path = checkpoint_path(cdir, args.epoch_continue)
        params, opt_state, start_epoch, cfg = load_checkpoint(path)
        print(f"resumed epoch {start_epoch} from {path}")
    print(f"model parameters: {param_count(params):,}")

    step = make_train_step(cfg, args.lr, device=device,
                           scan_steps=args.scan_steps)
    params, opt = step.init(params, opt_state)
    print(f"train step: {step.mode}, {args.scan_steps} step(s) a call")
    gen = torch.Generator(device=device).manual_seed(args.seed)
    supervisor = (Supervisor(cdir, cfg, save_every=args.model_save_epoch)
                  if args.supervise else None)

    # Preemption: finish the current epoch, checkpoint, and return, so that
    # --epoch_continue resumes exactly where the run stopped.
    preempted = {"flag": False}

    def _on_term(signum, frame):
        preempted["flag"] = True
        print(f"signal {signum}: checkpointing after this epoch", flush=True)

    prev_handler = signal.signal(signal.SIGTERM, _on_term)
    history = []
    try:
        epoch, saved_epoch = start_epoch, -1
        while epoch < args.num_epochs:
            lr = schedule(epoch) * (supervisor.lr_scale if supervisor
                                    else 1.0)
            t0 = time.time()
            profiling = bool(args.profile_dir) and epoch == start_epoch
            with (trace(args.profile_dir) if profiling
                  else contextlib.nullcontext()):
                params, opt, means = train_epoch(
                    step, params, opt, batch_stream(args, data, nprng, cfg),
                    gen, lr=lr, log_every=args.log_every)
            if profiling:
                print(f"profiler trace written to {args.profile_dir}")
            history.append((epoch, lr, means))
            msg = " ".join(f"{k}: {v:.4f}" for k, v in sorted(means.items()))
            print(f"epoch {epoch:03d} [{time.time() - t0:.1f}s] lr {lr:.3e} "
                  f"{msg}")
            if supervisor is not None:
                # the supervisor owns the checkpoint cadence
                params, opt, epoch, action = supervisor.after_epoch(
                    epoch, means["total"], params, opt)
                if action == "abort":
                    break
                if action == "rollback":
                    continue
            elif (epoch + 1) % args.model_save_epoch == 0:
                path = save_checkpoint(cdir, epoch + 1, params, opt, cfg,
                                       keep_last=args.keep_last_ckpts or None,
                                       background=args.async_ckpt)
                saved_epoch = epoch + 1
                print(f"saved {path}")
            epoch += 1
            if preempted["flag"]:
                if saved_epoch != epoch:
                    path = save_checkpoint(cdir, epoch, params, opt, cfg)
                print(f"preempted: saved {checkpoint_path(cdir, epoch)}; "
                      f"resume with --epoch_continue {epoch}", flush=True)
                break
    finally:
        signal.signal(signal.SIGTERM, prev_handler)
        flush_saves()
    return TrainRun(params, opt, cfg, start_epoch, history, step)


if __name__ == "__main__":
    main()
