"""Shared CLI plumbing of the port (port of ``sttode_tpu/cli/common.py``).

The JAX package's flag surface, with the same names and defaults, so that a
command line carries over (the stage-2 flags are ``cli.trainsampler``'s
``add_sampler_args``); plus ``--device`` (default ``cuda``: the port runs
on the card unless the caller asks for the CPU). The reference's
dataset-conditional defaults: NBA 5/10 steps and batches of 32 scenes,
ETH-UCY and SDD 8/12 steps and one scene a step (``--scenes_per_batch``
stacks more), ETH's ``--max_train_agent`` 32, SDD's pixels ÷ 50. What is
not ported yet raises ``NotImplementedError`` naming it: the config values
``STTODEConfig.validate`` refuses.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from sttode_tpu_torch.models.sampler import DIVERSITY_CONFIG, SamplerConfig
from sttode_tpu_torch.models.sttode import STTODEConfig

ETH_UCY = ("eth", "hotel", "univ", "zara1", "zara2")


def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--dataset", default="eth",
                   choices=ETH_UCY + ("sdd", "nba"))
    p.add_argument("--data_root", default="./datasets")
    p.add_argument("--ckpt_dir", default="./saved_models")
    p.add_argument("--device", default="cuda",
                   help="torch device the model runs on; 'cpu' runs the "
                        "plain PyTorch paths (no card needed)")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--hidden_dim", type=int, default=64)
    p.add_argument("--zdim", type=int, default=32)
    p.add_argument("--num_decompose", type=int, default=2)
    p.add_argument("--min_clip", type=float, default=2.0)
    p.add_argument("--sample_k", type=int, default=20)
    p.add_argument("--learn_prior", action="store_true")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--decay_step", type=int, default=10)
    p.add_argument("--decay_gamma", type=float, default=0.5)
    p.add_argument("--num_epochs", type=int, default=100)
    p.add_argument("--model_save_epoch", type=int, default=5)
    p.add_argument("--keep_last_ckpts", type=int, default=0,
                   help="retain only the newest N checkpoints (0 = keep all)")
    p.add_argument("--async_ckpt", action="store_true",
                   help="write checkpoints from a background thread, so "
                        "that training steps overlap the write")
    p.add_argument("--epoch_continue", type=int, default=0)
    p.add_argument("--max_train_agent", type=int, default=100)
    p.add_argument("--no_rand_rot", action="store_true")
    p.add_argument("--batch_size", type=int, default=0,
                   help="0 = dataset default (NBA: 32 training, 128 "
                        "evaluation; per-scene otherwise)")
    p.add_argument("--scenes_per_batch", type=int, default=1,
                   help=">1 stacks same-bucket ETH/SDD scenes (needs "
                        "--compat tpu --attn_axis agent)")
    p.add_argument("--attn_axis", default="scene", choices=("scene", "agent"))
    p.add_argument("--compat", default="reference",
                   choices=("reference", "tpu"))
    p.add_argument("--ode_method", default="euler",
                   choices=("euler", "midpoint", "rk4", "dopri5"))
    p.add_argument("--ode_steps", type=int, default=1)
    p.add_argument("--ode_adjoint", action="store_true",
                   help="O(1)-memory continuous-adjoint gradients through "
                        "the ODE encoder")
    p.add_argument("--ode_rtol", type=float, default=1e-7,
                   help="dopri5 relative tolerance (looser = fewer steps)")
    p.add_argument("--ode_atol", type=float, default=1e-9)
    p.add_argument("--ode_scan_budget", type=int, default=0,
                   help="dopri5 only: >0 runs exactly this many RK45 "
                        "attempts per interval (no host synchronization, "
                        "directly differentiable; the encoder field needs "
                        "71 at the default tolerances, 16 at 1e-5/1e-7, 7 "
                        "at 1e-3/1e-6); 0 = the while form, which trains "
                        "only with --ode_adjoint")
    p.add_argument("--compute_dtype", default="float32",
                   choices=("float32", "bfloat16"))
    p.add_argument("--select_dtype", default="float32",
                   choices=("float32", "bfloat16"),
                   help="bfloat16 runs the gradient-free best-of-K selection "
                        "decode in bf16 storage")
    p.add_argument("--select_impl", default="xla",
                   choices=("xla", "fused", "auto"),
                   help="best-of-K selection decode route: 'xla' = the plain "
                        "PyTorch decode, 'fused' = the selection kernel, "
                        "'auto' = the kernel on the card")
    p.add_argument("--decode_dtype", default="float32",
                   choices=("float32", "bfloat16"),
                   help="bfloat16 gives the differentiable decode bf16 "
                        "storage (fp32 master weights)")
    p.add_argument("--attn_impl", default="auto",
                   choices=("auto", "dense", "fused", "flash", "packed",
                            "ring", "ulysses"),
                   help="attention route: 'auto' = the kernels on the card "
                        "(packed for small problems, S-tiled flash beyond "
                        "the whole-S kernels' shared memory or S > 2048 — "
                        "on the scene axis, --batch_size above 1036 — "
                        "whole-S otherwise); 'fused', 'packed', 'flash' "
                        "force one kernel; 'dense' = the plain path")
    p.add_argument("--attn_metric", default="oblique",
                   choices=("oblique", "poincare"),
                   help="attention distance: 'oblique' (the reference's "
                        "-acos) or 'poincare' (the Möbius distance on the "
                        "ball of --curvature; the whole-S and flash kernels "
                        "serve it on the card, never the packed one)")
    p.add_argument("--curvature", type=float, default=1.0,
                   help="Poincaré ball curvature c > 0; the kernels need "
                        "c >= 0.032, below it 'auto' takes the plain path")
    p.add_argument("--loss_terms", default="pred,recover,kl,diverse",
                   help="comma-separated subset of pred,recover,kl,diverse")
    p.add_argument("--log_every", type=int, default=100)
    p.add_argument("--scan_steps", type=int, default=1,
                   help="optimizer steps run in one call over stacked "
                        "same-bucket batches: on the card one CUDA graph "
                        "replay (dopri5's while form runs them eagerly); "
                        "1 = one step a call")
    return p


def horizons_for(dataset: str) -> tuple[int, int]:
    return (5, 10) if dataset == "nba" else (8, 12)


def model_config(args) -> STTODEConfig:
    past_len, future_len = horizons_for(args.dataset)
    return STTODEConfig(
        hidden_dim=args.hidden_dim, zdim=args.zdim,
        past_length=past_len, future_length=future_len,
        num_decompose=args.num_decompose, min_clip=args.min_clip,
        sample_k=args.sample_k, learn_prior=args.learn_prior,
        compat=args.compat, attn_axis=args.attn_axis,
        ode_method=args.ode_method, ode_steps=args.ode_steps,
        ode_adjoint=args.ode_adjoint, ode_rtol=args.ode_rtol,
        ode_atol=args.ode_atol, ode_scan_budget=args.ode_scan_budget,
        compute_dtype=args.compute_dtype, select_dtype=args.select_dtype,
        select_impl=args.select_impl, decode_dtype=args.decode_dtype,
        attn_impl=args.attn_impl, attn_metric=args.attn_metric,
        curvature=args.curvature,
        loss_terms=tuple(t for t in args.loss_terms.split(",") if t),
    ).validate()


def sampler_config(args) -> SamplerConfig:
    """The stage-2 config of a command line with the sampler's flags
    (``cli.trainsampler.add_sampler_args``): K = ``--sample_k`` and the
    dataset's (diversity weight, scale) from the reference's table (3.0,
    2.0 for a dataset it does not list)."""
    w, s = DIVERSITY_CONFIG.get(args.dataset, (3.0, 2.0))
    return SamplerConfig(
        nk=args.sample_k, nz=args.nz, qnet_mlp=tuple(args.qnet_mlp),
        share_eps=not args.no_share_eps,
        train_w_mean=not args.no_train_w_mean, kld_weight=args.kld_weight,
        kld_min_clamp=args.kld_min_clamp, div_weight=w, div_scale=s)


def effective_max_train_agent(args) -> int:
    """The reference caps ETH's training scenes at 32 agents unless the
    flag is set."""
    if args.dataset == "eth" and args.max_train_agent == 100:
        return 32
    return args.max_train_agent


def load_scenes(args, split: str):
    """split 'train' | 'test' → scene dicts (ETH-UCY from
    ``data_root/<dataset>/<split>``, SDD from ``data_root/sdd/<split>``) or
    (past, future) arrays (NBA from ``data_root/nba``)."""
    from sttode_tpu_torch.data import load_eth_ucy, load_nba, load_sdd
    ds = args.dataset
    if ds in ETH_UCY:
        return load_eth_ucy(os.path.join(args.data_root, ds, split),
                            obs_len=8, pred_len=12)
    if ds == "sdd":
        return load_sdd(os.path.join(args.data_root, "sdd", split))
    return load_nba(os.path.join(args.data_root, "nba"),
                    training=(split == "train"))


def ckpt_dir(args) -> str:
    return os.path.join(args.ckpt_dir, args.dataset)


def seed_everything(seed: int) -> np.random.Generator:
    np.random.seed(seed)
    return np.random.default_rng(seed)
