"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``sttode_tpu_torch/csrc`` (nvcc,
sm_90a, one compiler process per source, started together; prints the
registers and spills of kernel B and of the flash backward sweeps, and the
HMMA instructions of kernel B's SASS), holds each
against its plain PyTorch version at the shapes of the serving and training
paths, then drives both paths at the full width of the repo's model
(hidden 64, 8 heads, ff 1024, zdim 32, K = 20, random weights from a seed):

  phase 2  geodesic attention forward kernel (serving and training shapes);
  phase 3  fp32 selection decode kernel (serving and training shapes, and
           the B = 2304 scene batch's M = 25,344), with its achieved
           TFLOP/s and share of its tensor-core bound;
  phase 4  agent-axis server: ``Predictor(max_group=64)`` answering 64
           synthetic scenes of 8 agents per call;
  phase 5  reference compat: ``sttode_inference`` on 32 scenes × 11 agents
           (5 past / 10 future steps), and a default-config ``Predictor``
           answering single-scene requests (both on the packed kernel);
  phase 6  geodesic attention backward kernel: the training shape
           (88 × 128 × 8, q/k swapped, no mask), the agent-axis shape with a
           key mask that takes a gradient, and an all-excluded row; then at
           the training shape its mode (the small-S mode), wrapper ms, host
           µs per call and device µs, and its launch-path floor;
  phase 7  bf16 selection decode kernel at the training step's M = 1408
           and at M = 25,344, K = 20, mode "dist", likewise;
  phase 8  the stage-1 training step at B = 128 scenes × 11 agents: the fp32
           variant once on the kernel route against the plain route (same
           parameters, batch and noise; every loss term and every parameter
           gradient), then ≥ 20 Adam steps of the bf16 recipe on the kernel
           route, then step time, train scenes/s and the device's idle share
           of both routes;
  phase 9  packed attention forward and backward kernels against their
           plain versions: the NBA recipe's 11 × 8 × 32 × 8 (q/k swapped),
           a key validity with an all-invalid problem (exact zeros),
           L = S = 1, a rectangular case and H·Dh = 128 (each kernel's
           host µs per call beside its wrapper ms), both kernels'
           launch-path floors (one 1 × 1 × 8 problem); then both kernels
           against kernels A and C at the recipe's shape and at L = S = 1;
  phase 10 the NBA reference recipe through the port's CLIs on synthetic
           NBA files: ``cli.train`` for 2 epochs (a checkpoint each), a
           resume from epoch 1 for one more, ``cli.test`` on the checkpoints
           (horizon table, B = 128); then the fp32 step at B = 32 on the
           kernel route against the plain route, and step time (beside the
           step at commit 8079157), train scenes/s and idle share of both
           routes;
  phase 11 the S-tiled (flash) attention kernels — forward, the dq sweep and
           the dk/dv sweep — against their plain versions: the NBA recipe at
           B = 2304 (11 × 8 × 2304 × 8, q/k swapped), the long-context
           8 × 4096² × 64 (forward, and forward + backward), a ragged
           L = 300, S = 1100, Dh = 5, a key validity with an all-invalid
           problem (exact zeros) and L = S = 1152; then against kernels A
           and C at L = S = 1024 and 2048 (wrapper ms and device µs); then
           the masked whole-S forward beyond shared memory (its
           key-streaming mode) at 8 × 1569² × 16, 8 × 2048² × 64 and
           8 × 512² × 256, and the flash kernels at Dh = 256
           (4 × 1024 × 1100, ragged validity);
  phase 12 the large-batch path: ``cli.train --batch_size 2304`` (1 epoch of
           2 steps on synthetic NBA files; the flash kernels, not A or C)
           and ``cli.test`` on its checkpoint; the fp32 step at B = 2304 on
           the kernel route against the dense route; one step at B = 1152,
           beyond the whole-S backward kernel's shared memory; step time,
           train scenes/s and idle share of both routes at B = 2304; the
           fp32 step with kernel B (select_impl "auto") against the plain
           decode, and the step's time, idle share and kernel B's share
           under select_impl "xla", "auto" fp32 and "auto" bf16;
  phase 13 the poincaré branches of the geodesic-attention kernels against
           their plain versions, on ball points: the whole-S forward and
           backward at the NBA recipe's 88 × 32² × 8 (q/k swapped; c = 1
           and 0.7) and 88 × 128² × 8, both with the agent-axis server's
           key mask (host µs per call of the forward and the backward,
           which body the backward, 2p, runs and its registers, the
           kernel the trace names at 88 × 32² × 8; their launch-path
           floors);
           the flash forward, dq and dk/dv sweeps at 88 × 2304² × 8 (q/k
           swapped) and 8 × 4096² × 64; the forward and the sweeps'
           general form at c = 0.7 and 0.05 (88 × 2304² × 8, timed), rows
           at the ball's edge and close pairs; then the masked whole-S backward at
           8 × 1500² × 8, beyond shared memory (its device-workspace mode),
           in both metrics; then phase 11's two repairs in the poincaré
           metric;
  phase 14 the poincaré path end to end: ``cli.train --attn_metric
           poincare`` for 2 epochs at B = 32, a resume from epoch 1, and
           ``cli.test`` on its checkpoint (the poincaré whole-S kernels); the fp32 step at B = 32
           on the kernel route against the dense route (and both against the
           dense route in float64); ``--batch_size 2304`` for 1 epoch of 2
           steps (the poincaré flash kernels only); the flash-route step
           against the dense route at the largest of B = 2304 and 1152 that
           the dense route's memory allows; the agent-axis ``Predictor`` with
           the poincaré metric against the dense route; step time, train
           scenes/s and idle share of both routes at B = 32 (the step
           beside the one at commit 8079157) and B = 2304,
           and of the oblique flash route beside them at B = 2304.
  phase 15 the ETH-UCY and SDD path: synthetic ETH-style CSVs (2 files x
           200 frames x 12 agents a split, in a git-ignored ``.smoke_eth_*``
           directory of the checkout, removed after) windowed by the native
           engine (equal to the numpy loop); the reference recipe
           ``cli.train --dataset eth --select_impl auto`` for 1 epoch (one
           scene a step, bucket 16: P, Q and kernel B fp32 "dist", seen by
           the profiler over 3 of the CLI's steps) and 1 resumed epoch, then
           ``cli.test`` (P, kernel B "traj"; ADE/FDE); the agent-axis recipe
           (``--compat tpu --attn_axis agent --scenes_per_batch 32``: A and C
           with key masks); ``cli.test --dataset sdd`` on a pixel pickle in
           the reference's [N, 2, T] layout; both recipes' padded batches on
           the kernel route against the plain route; kernel B at M = 16 and
           512 (8 / 12 steps, "dist", winner check; "traj" at 16); both
           recipes' step time, train scenes/s, kernels a step and idle
           share; one epoch with the prefetch thread (depth 2) and one
           without (0) from the same seeds, with equal mean losses.
  phase 16 stage 2, the DLow sampler (qnet_mlp (512, 256), nk 20, nz 32)
           over the frozen net: in phase 15's directory, on its CSVs and
           the reference recipe's stage-1 checkpoints,
           ``cli.trainsampler --dataset eth`` for 1 epoch and 1 resumed
           epoch (``--fix_epochs 0``: the lambda decay) and
           ``cli.test_sampler --sweep 2`` (P only); the stage-2 step on
           the kernel route against the plain route at the NBA recipe's
           32 x 11 (P), the ETH agent-axis recipe's 32 x 16 (A, key
           masks) and with the poincaré metric (1p): losses, dec_motion
           and every sampler gradient leaf, no net leaf with a gradient;
           20 profiled steps of each recipe in one trace (its forward
           kernel, none of C, 2p, Q, Fdq, Fdkv, 4p or kernel B); both routes' step time,
           train scenes/s, idle share and kernels a step at the ETH
           reference shape 1 x 16 and at NBA 32 x 11; the sampler's
           ``Predictor`` on the agent axis, the isolated scene axis (64
           scenes x 8 agents a call, p50 beside the stage-1 server's) and
           with the poincaré metric, equal to the plain route's and
           independent of the seed.
  phase 17 the adaptive and adjoint ODE encoder (``ode_phase``): dopri5 on
           the NBA trunk field (one layer at full width, the port's seeded
           init, [32, 11, 1, 64], ts = [0, 12]) at rtol / atol 1e-7 /
           1e-9, 1e-5 / 1e-7 and 1e-3 / 1e-6 on the kernel route (P), the
           plain route and the CPU: attempted and accepted steps and RHS
           evaluations (the plain route's equal to the CPU's), the
           solutions (kernel within 1e-4 of the solution's largest
           magnitude), ms a solve, µs and P launches an evaluation, idle
           share; one training step at B = 32 x 11 on both routes with the
           same noise for dopri5 + adjoint at 1e-5 / 1e-7 (the trunk
           solve's 92 RHS evaluations, not the default tolerances' 416),
           dopri5 + scan budget 24 at 1e-5 / 1e-7 (P, Q and kernel B
           "dist"; losses within TRAIN_TOL, the gradients held to the
           float64 plain route as phase 16 holds q_A; each dopri5 step's
           time is its forward + backward) and learn_prior on euler
           (TRAIN_TOL; its step timed); cut for the time limit: the
           solve under TF32 and the scan-budget step's timed rounds;
           dropout 0.1
           (no attention kernel; a forced packed route refused); the CLIs
           (``cli.train --ode_method dopri5 --ode_adjoint`` 1 + 1 resumed
           epoch of 2 steps, ``cli.test``, ``cli.trainvae``); the dopri5
           agent-axis server at 64 scenes x 8 agents beside the euler one.
  phase 18 ``scan_steps``, S optimizer steps captured as one CUDA graph
           (``scan_phase``): (a) the bench recipe (B = 128 × 11, bf16,
           kernel B): 48 eager steps against the S = 16 step's warm-up
           chunk and 2 replays from the same parameters, injected noise
           and Adam form (every loss term, parameter leaf and Adam
           moment), ``set_lr`` between replays (0: the parameters stay;
           3e-4: both move alike), kernel B's winners at the first and
           last weights and an eager kernel-B call after the replays
           against a fresh packing; (b) the eager step (plain Adam, and
           the capturable one) against the captured one, alternating:
           ms/step, train scenes/s, idle share, capture s and pool bytes,
           and two profiled replays' A, C and B kernels against the launch
           counters; (c) the stage-2 step at 1 × 16 (S = 16) and the
           scan-budget dopri5 step (budget 24, NBA 32 × 11, S = 2), a
           warm-up chunk and a replay each against eager steps, the while
           form's step eager; in phase 15's
           directory ``cli.train --dataset eth --scan_steps 16
           --async_ckpt`` for 1 + 1 resumed epoch (the resume reads the
           background-saved file) and ``cli.trainsampler --scan_steps
           16`` for 1 epoch.
  phase 19 the decoder side and the last training options
           (``decoder_phase``; d_model 64, 8 heads, ff 1024, one layer,
           time 12): (a) ``decoder_stack`` forced onto packed (tgt 32,
           memory 24: P, Q), fused (128 / 96 and the square 128 / 128, Q3
           swapped: A, C) and flash (256 / 2304: F, Fdq, Fdkv), and
           ``ode_decoder`` on fused, each against the plain route forward
           and backward (outputs within MODEL_TOL, every decoder leaf's,
           tgt's and memory's gradient within TRAIN_TOL × its largest
           magnitude, the kinks rule at 256 / 2304; None weights), with
           ms beside the plain route's; (b) ``mhgsa`` with ``bias_kv``,
           ``add_zero_attn`` and both at [11, 16, 64] (packed, S = 17, 18)
           and [11, 128, 64] (fused, S = 129, 130), against the plain
           route, the square call swapped and the appended one unswapped
           (by result); (c) ``cli.train --supervise --profile_dir
           --select_impl auto`` 2 NBA epochs (the supervisor's checkpoints;
           P, Q and kernel B fp32 by name in the trace of epoch 0) and
           ``cli.trainvae --supervise``; (d) a rollback under
           ``scan_steps`` 4: a NaN parameter, ``after_epoch`` →
           rollback, parameters and Adam moments equal to the last-good
           checkpoint and the next replay equal to an eager chunk from it,
           bit for bit; (e) ``time_fn`` beside CUDA events.
  phase 20 the last single-process modules (``riemannian_phase``): (a) the
           NBA reference recipe's step (B = 32 × 11, ``select_impl
           "auto"``) under ``train.riemannian.riemannian_sgd`` over the
           encoder layers' ``in_proj_w`` (projected with
           ``project_to_manifold`` first): 4 eager steps of the capturable
           form against one ``scan_steps`` 4 replay, bit for bit, the
           marked rows unit-norm within 1e-5, P, Q and kernel B fp32 in the
           counters and in a trace of 20 replays, ms a step eager and
           captured; (b) every public function of ``manifolds.oblique``'s
           Riemannian ops, ``manifolds.euclidean``, ``train.riemannian``,
           ``nn.hyperbolic``, ``nn.dot_attention``, ``nn.gumbel``,
           ``RelaxedOneHot``, ``utils.delta``, ``utils.analysis`` and
           ``gru_cell`` on the card against the CPU on the same inputs
           (``card_vs_cpu``: 1e-5 in fp32; float64 near antipodes and at the
           ball's edge), gradients included; (c) ``batched_delta_hyp`` at
           batch_size 1500 (2 tries) and ``features_delta`` (sample 1500)
           over the past encoder's features of 8 NBA batches on P, against
           float64 on the card and 400 points against the CPU: seconds and
           peak memory.
  phase 21 data parallelism, the ring and Ulysses over torch.distributed
           (``parallel_phase``): (a) world 1 over NCCL in this process,
           ``make_train_step(mesh=)`` on the bench recipe (B = 128 x 11,
           bf16 selection, a generator of one seed) for 2 steps against
           the single-process step bit for bit (each loss term, gradient
           leaf and parameter; the first that differs is named), A, C and
           B bf16 in the counters, ms a step of both; (b) world 2 on the
           one card over gloo (two processes, ``parallel_rank``; the
           ring's sends staged through host memory): the NBA reference
           recipe (32 x 11: P, Q, B fp32) and the bench recipe (A and C
           at L 64 x S 128; B bf16, and B fp32 in its fp32 twin) on the
           routes "auto" and "ring", each of 2 steps against the
           single-process step from the same state (losses; fp32
           gradients and parameters, ``DP_KINK_*`` and
           ``compare_adam_params``), the parameters equal on both ranks
           bit for bit, each rank's launches and ms a step; (c)
           ``cli.train --distributed --dist_backend gloo`` at world 2, one
           epoch of 2 NBA steps: both ranks join; (d) the stage-2 step
           (``make_sampler_train_step(mesh=)``, NBA 32 x 11, ε drawn and
           not shared) at world 1 over NCCL bit for bit against the
           single-process step (P in the counters) and at world 2 over
           gloo within TRAIN_TOL of it; (e) the captured mesh step at
           world 1 over NCCL (bench recipe, ``scan_steps`` 16: the
           collectives inside the graph): its warm-up chunk and 2 replays
           against 32 eager mesh steps bit for bit, A, C and B bf16 in
           the counters, ms a step captured beside eager, and at world 2
           over gloo the same step's mode, "eager"; (f) dopri5 at
           world 2 over gloo (NBA 32 x 11, 1e-3 / 1e-6): the while form
           (the stage-2 step's frozen encoder, P), the scan budget 16 and
           the adjoint (stage-1 steps: P, Q, B fp32), each solve's
           attempted and accepted steps and RHS evaluations equal on both
           ranks and the forward solves' to the single process's, losses
           within TRAIN_TOL, gradients as (b) holds them but the
           adjoint's, within 10 x rtol of each leaf's largest
           (``ADJOINT_GRAD_TOL``); (g) the NBA
           recipe's state after (b)'s 2 steps, saved at world 2 and
           restored at world 1 over NCCL through ``restore_shardings``:
           parameters and Adam moments bit for bit; (h) Ulysses at
           world 1 over NCCL (``ulysses_world1``): the stage-1 step with
           ``attn_impl="ulysses"`` (the all-to-all over a one-rank NCCL
           group, the local core on the kernels) at NBA 32 x 11 (P, Q, B
           fp32) and the bench recipe (A, C, B bf16) against the
           single-process "auto" step, 2 steps within TRAIN_TOL (bit for
           bit or not, said), ms a step of both; the captured Ulysses
           mesh step (``scan_steps`` 16, the all-to-all inside the graph)
           against its eager steps bit for bit; (i) at world 2 over gloo
           (the all-to-all staged through host memory): Ulysses at both
           recipes as (b) holds "auto" and "ring"; a [1, 2, 1] data x seq
           mesh with "ring" and "ulysses" on the agent axis (32 scenes x 16
           agents, compat "tpu", padded agents: P and Q under ulysses) and
           the stage-2 step on it (``stage2_seq_world2``), against the
           single-process "auto" step within TRAIN_TOL and ``DP_KINK_*``,
           ms a step of each.

Each serving or training phase is compared with the same computation on the
plain routes (``attn_impl="dense"``, ``select_impl="xla"``) with the same
latents, and checks that every kernel of the path was launched by it (the
launch counts are set to 0 just before a path runs and read just after).
Every failure raises; nothing is caught. The second-to-last line of the
output is a JSON object with each kernel's measurements and its bound, the
last line the device summary. Exits non-zero without a result when no CUDA
device is present. Times are medians taken with CUDA events (kernels) or the
host clock around synchronized calls (serving, training steps), the kernel
and plain routes timed in alternating rounds within the same run.
"""

from __future__ import annotations

import json
import math
import os
import pickle
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ATTN_TOL = 1e-5
LSE_REL_TOL = 1e-6        # the flash forward's lse, × max(1, |lse|) a row
ATTN_GRAD_TOL = 5e-5      # × max(1, max |gradient|): acos' amplifies the Gram
SELECT_TOL = 1e-4
SELECT_BF16_TOL = 1e-3    # × the distance scale: bf16 rounding boundaries
MODEL_TOL = 1e-4
TRAIN_TOL = 1e-4          # × max(1, |loss|), and × max |gradient| per leaf
TRAIN_STEPS = 20

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): the bounds below
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
BF16_FLOP_PER_S = 989e12


def bound(nbytes: float, ops: float, peak: float) -> tuple[float, str]:
    """The least time the card could take for the work, in ms: the larger
    of the bytes over the memory rate and the operations over the peak
    rate of their type; and which of the two it is."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# Elementwise operations per (i, j) pair beyond the FMAs, by metric. The
# poincaré score (poincare.cuh) is 19: x2 − 2g + y2 (2), max, den
# (x2·y2 and two FMAs, 3), + ε, m·den, (den + ε)², ÷, + 1e-15, √, × √c,
# min, 1 ± zc (2), ÷, log, × −1/√c; its VJP another 22: 1 − zc² (2), max,
# ÷, × ds, dn·½/n (2), + ε, A (2), Bd (4), a (2), b (2), dg (4).
SCORE_OPS = {"oblique": 3, "poincare": 19}       # oblique: clip ×2, acos
SCORE_VJP_OPS = {"oblique": 4, "poincare": 22}   # |g| test, 1 − gc², rsqrt, × gate


def attn_fwd_work(B, L, S, Dh, masked, metric="oblique"):
    """Bytes (q, k, v and the mask read once, out written once) and
    operations: per (i, j) pair the Gram and p·V FMAs (4·Dh), the score
    (``SCORE_OPS``) and three elementwise ones (add, exp, sum); fp32."""
    nbytes = 4 * (2 * B * L * Dh + 2 * B * S * Dh + (B * L * S if masked
                                                     else 0))
    return nbytes, B * L * S * (4 * Dh + SCORE_OPS[metric] + 3)


def attn_bwd_work(B, L, S, Dh, masked, metric="oblique"):
    """Bytes: q, k, v, do (and the mask) read once; dq, dk, dv (and dmask)
    written once. Operations per (i, j): the recomputed Gram, dp, dq̂, dk̂
    and dv FMAs (10·Dh), the score and its VJP (``SCORE_OPS``,
    ``SCORE_VJP_OPS``) and four elementwise ones (add, exp, p, ds); the
    poincaré dx2 and dy2 sums add four more."""
    nbytes = 4 * (3 * B * L * Dh + 4 * B * S * Dh + (2 * B * L * S if masked
                                                     else 0))
    return nbytes, B * L * S * (10 * Dh + SCORE_OPS[metric] + 4
                                + SCORE_VJP_OPS[metric]
                                + (4 if metric == "poincare" else 0))


def flash_fwd_work(B, L, S, Dh, has_val, metric="oblique"):
    """Bytes: q, k, v (and the validity) read once, out and the per-row lse
    written once. Operations per (i, j): as ``attn_fwd_work``."""
    nbytes = 4 * (2 * B * L * Dh + 2 * B * S * Dh + B * L
                  + (B * S if has_val else 0))
    return nbytes, B * L * S * (4 * Dh + SCORE_OPS[metric] + 3)


def _sweep_ops(metric):
    """Elementwise operations per (i, j) of one backward sweep: the replayed
    score, − lse, exp, − δ, × p, the score's VJP, and the poincaré dx2 (or
    dy2) sum (2)."""
    return SCORE_OPS[metric] + 4 + SCORE_VJP_OPS[metric] + (
        2 if metric == "poincare" else 0)


def flash_dq_work(B, L, S, Dh, has_val, metric="oblique"):
    """The dq sweep replays the scores. Bytes: q, k, v, do, lse, δ (and the
    validity) read once, dq written once. Operations per (i, j): the Gram,
    do·v and dq̂ FMAs (6·Dh) and ``_sweep_ops`` (eleven oblique)."""
    nbytes = 4 * (3 * B * L * Dh + 2 * B * S * Dh + 2 * B * L
                  + (B * S if has_val else 0))
    return nbytes, B * L * S * (6 * Dh + _sweep_ops(metric))


def flash_dkv_work(B, L, S, Dh, has_val, metric="oblique"):
    """The dk/dv sweep replays the scores again. Bytes: q, k, v, do, lse, δ
    (and the validity) read once, dk and dv written once. Operations per
    (i, j): the Gram, do·v, dv and dk̂ FMAs (8·Dh) and ``_sweep_ops``."""
    nbytes = 4 * (2 * B * L * Dh + 4 * B * S * Dh + 2 * B * L
                  + (B * S if has_val else 0))
    return nbytes, B * L * S * (8 * Dh + _sweep_ops(metric))


def flash_bwd_work(B, L, S, Dh, has_val, metric="oblique"):
    """Both sweeps of the flash backward: each replays the scores, so the
    Gram, score and exp of every pair are counted twice."""
    (b1, o1), (b2, o2) = (flash_dq_work(B, L, S, Dh, has_val, metric),
                          flash_dkv_work(B, L, S, Dh, has_val, metric))
    return b1 + b2, o1 + o2


def select_work(weights, M, K, D2, Z, Tp, Tf, mode):
    """Bytes: the per-agent operands, z, the weights (in their storage type)
    read once and the output written once. Operations, as (matrix, other):
    the matrix products, which the kernel runs on the tensor cores — the
    prologue's z-independent first-layer partials per agent, then per (m, k)
    row the z part of both block-0 first layers, both block-0 tails, the
    T_p GRU products, block 1's first layer (z and state rows) and tail —
    and the rest, on the fp32 cores: the conv and the distance."""
    w_bytes = sum(w.numel() * w.element_size() for w in weights)
    out = M * K if mode == "dist" else K * M * 2 * Tf
    nbytes = w_bytes + 4 * (M * (D2 + 96 + 2 * Tp + 2 * Tf) + K * M * Z
                            + out)
    pro = 2 * M * (3 * D2 * 512 + 2 * 96 * 512)
    row = 2 * (2 * Z * 512 + 2 * 512 * 256 + 256 * 2 * Tf + 256 * 2 * Tp
               + Tp * (32 + 96) * 288 + (Z + 96) * 512 + 512 * 256
               + 256 * 2 * Tf)
    other = M * K * (2 * Tp * 6 * 32 + 3 * 2 * Tf)
    return nbytes, pro + M * K * row, other


def select_bound(work, dtype, simt=False):
    """Kernel B's bound in ms and what sets it. Its design runs the matrix
    products on the tensor cores: bf16 operands at the bf16 peak, fp32 as
    3xTF32 (three TF32 products per product, at a third of the TF32 peak);
    the rest at the fp32 peak. ``simt`` gives the bound of a design that
    runs everything on the fp32 cores (kernel B's earlier, SIMT design)."""
    nbytes, matrix, other = work
    if simt:
        return bound(nbytes, matrix + other, FP32_FLOP_PER_S)
    peak = BF16_FLOP_PER_S if dtype == torch.bfloat16 else \
        TF32_FLOP_PER_S / 3
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = matrix / peak + other / FP32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def kernel_b_name(mangled: str) -> str:
    """select_{main,base}_kernel<float|bf16, BM> from a mangled name."""
    import re
    m = re.search(r"(select_[a-z]+_kernel)I(f|13__nv_bfloat16)Li(\d+)E",
                  mangled)
    if m is None:
        return mangled[:60]
    return (f"{m.group(1)}<{'float' if m.group(2) == 'f' else 'bf16'}, "
            f"{m.group(3)}>")


# the templated attention kernels whose registers the build report prints:
# the flash backward sweeps, the flash forward of both metrics (F and 3p:
# one kernel, a metric policy), the whole-S backward's small-S mode (C and
# 2p: <DH, poincaré, c = 1>) and its kernel of before, and the packed
# backward (Q: the small body, and the warp kernel beyond it)
ATTN_KERNELS = (r"flash_(?:mhgsa|poincare)_d(?:q|kv)_kernel|flash_fwd_kernel|"
                r"mhgsa_(?:small_)?bwd_kernel|"
                r"packed_(?:small|warp)_bwd_kernel")


def sweep_name(mangled: str, kernels: str = ATTN_KERNELS) -> str:
    """kernel<template arguments> of a ``kernels`` kernel (a regex) from a
    mangled name: its integer and bool arguments, then the forward's metric
    policy (``ObliqueFwd`` or ``PoincareFwd<C1>``)."""
    import re
    m = re.search(rf"({kernels})I((?:L[ib]\d+E)+)", mangled)
    if m is None:
        return mangled[:60]
    args = [v if t == "i" else ("true" if v == "1" else "false")
            for t, v in re.findall(r"L([ib])(\d+)E", m.group(2))]
    pol = re.match(r"NS_\d+(ObliqueFwd|PoincareFwd)(?:ILb([01])E)?",
                   mangled[m.end():])
    if pol:
        args.append(pol.group(1) + ("" if pol.group(2) is None else
                                    "<true>" if pol.group(2) == "1"
                                    else "<false>"))
    return f"{m.group(1)}<" + ", ".join(args) + ">"


def build_report(lib) -> dict:
    """Print the registers and spills of kernel B, the flash register
    kernels (F, 3p and the sweeps), the whole-S backward (C, 2p) and Q from
    the build log (``-Xptxas -v``) and the tensor-core MMA instructions
    (HMMA) in kernel B's SASS, from ``cuobjdump`` where the toolkit has it;
    return each attention kernel's "Used ..." line by kernel<template
    arguments>."""
    log = lib.with_name(lib.name + ".log").read_text().splitlines()
    entry, used = None, {}
    for line in log:
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            entry = (kernel_b_name(name) if "select_" in name else
                     sweep_name(name) if re.search(ATTN_KERNELS, name)
                     else None)
        elif entry and ("spill" in line or "Used" in line):
            print(f"ptxas {entry}: {line.split(':', 1)[-1].strip()}")
            if "Used" in line:
                used[entry] = line.split(":", 1)[-1].strip()
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                             "bin", "cuobjdump")
    if not os.path.exists(cuobjdump):
        print("cuobjdump: not in the toolkit; SASS not shown")
        return used
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
        elif fn and "select_" in fn and "HMMA" in line:
            op = line.split("HMMA")[1].split()[0]
            counts.setdefault(fn, {}).setdefault("HMMA" + op, 0)
            counts[fn]["HMMA" + op] += 1
    for fn, ops in sorted(counts.items()):
        print(f"sass {kernel_b_name(fn)}: {ops}")
    require(counts, "kernel B's SASS holds no HMMA instruction")
    return used


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def paired_ms(kernel_fn, plain_fn, *, calls: int = 20,
              rounds: int = 8) -> tuple[float, float]:
    """Per-call ms of two routes, timed in alternating order (kernel, plain,
    plain, kernel, ...) so that drift on the shared host hits both alike:
    each sample is the mean of ``calls`` back-to-back calls between two CUDA
    events (it includes the host work of each call when the host is the
    slower side); returns the median sample of each route."""
    fns = (kernel_fn, plain_fn)
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    times: tuple[list, list] = ([], [])
    for r in range(rounds):
        for i in ((0, 1) if r % 2 == 0 else (1, 0)):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(calls):
                fns[i]()
            end.record()
            torch.cuda.synchronize()
            times[i].append(start.elapsed_time(end) / calls)
    return statistics.median(times[0]), statistics.median(times[1])


def device_us(fn, calls: int = 20):
    """Device µs per call of this repo's attention kernels launched by
    ``fn`` (the profiler's kernel time, other kernels excluded), or None when
    the trace has no device time."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and "_kernel" in e.key
             and any(n in e.key for n in ("packed_", "mhgsa_", "poincare_")))
    return us / calls if us > 0 else None


def kernel_names(fn, pattern: str = r"(mhgsa_\w*bwd_kernel)",
                 calls: int = 20) -> set:
    """The names (``pattern``'s group) of the kernels that calls of ``fn``
    launch, from one profiler trace of ``calls`` calls after an untraced
    warm-up call, as ``device_us`` traces: a trace can miss launches (one
    call traced after a warm-up call under a profiler schedule came back
    empty in phase 13 on an H100, where ``device_us``' 20-call windows of
    the same kernel held it), so the names are those of any call in the
    window."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {m.group(1) for m in (re.search(pattern, e.key)
                                 for e in prof.key_averages()) if m}


def host_us(fn, calls: int = 20) -> float:
    """Host µs per call of ``fn``: the host clock around ``calls``
    back-to-back calls, read before synchronizing (the wrapper's own work:
    checks, allocation, the launch)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t) / calls * 1e6
    torch.cuda.synchronize()
    return us


def launch_floor(fn, one, full, card, label) -> None:
    """Print the launch-path floor of a wrapper: ``fn`` on ``one`` (one
    problem of 1 × 1 × 8) in wrapper ms, host µs and device µs, timed in
    alternating rounds with ``fn`` on ``full`` (the path's shape)."""
    with torch.inference_mode():
        ms = paired_ms(lambda: fn(*one), lambda: fn(*full))
        h, d = host_us(lambda: fn(*one)), device_us(lambda: fn(*one))
    print(f"{label} launch-path floor, one 1 x 1 x 8 problem: wrapper "
          f"{ms[0]:.4f} ms (the path's shape {ms[1]:.4f} ms in the same "
          f"rounds), host {h:.1f} µs/call, device "
          + ("not measured" if d is None else f"{d:.2f} µs") + f"  [{card}]")


# the B = 32 kernel-route step times of this script's run at commit 8079157
# (NVIDIA H100 80GB HBM3, 700.00 W), printed beside this run's
BASELINE_STEP_MS = {"phase 10": 32.155, "phase 14": 37.416}
BASELINE = "at commit 8079157"


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max())


def forward_backward(params, cfg, batch, noise, dev):
    """The training forward and backward at ``cfg`` on fresh trainable
    copies of ``params`` with injected ``noise``: (params, output, the
    gradient of every leaf)."""
    from sttode_tpu_torch import bridge
    from sttode_tpu_torch.models import sttode as tm
    p = bridge.tree_map(lambda t: t.detach().to(dev, copy=True), params)
    leaves = [t.requires_grad_() for t in bridge.tree_leaves(p)]
    out = tm.sttode_forward(p, cfg, batch, noise=noise)
    out.total_loss.backward()
    return p, out, [t.grad for t in leaves]


def compare_routes(out_k, g_k, out_p, g_p, what, kinks=False):
    """Hold the kernel route's loss terms and gradients to the plain
    route's: each loss within TRAIN_TOL × max(1, |loss|), each leaf within
    TRAIN_TOL × its largest magnitude. With ``kinks`` (the large batches,
    where a ReLU whose input lies within rounding of 0 can switch between
    the routes and move a few elements of a leaf discretely) each leaf is
    held within TRAIN_TOL in relative L2 and each element within
    10 × TRAIN_TOL of the leaf's largest magnitude. Returns (worst relative
    loss error, worst gradient ratio, its leaf, worst relative L2)."""
    loss_err = 0.0
    for name in ("total_loss", "loss_pred", "loss_recover", "loss_kl",
                 "loss_diverse"):
        a = float(getattr(out_k, name).detach())
        b = float(getattr(out_p, name).detach())
        tol = TRAIN_TOL * max(1.0, abs(b))
        require(abs(a - b) <= tol, f"{what} {name}: {a} vs plain {b}")
        loss_err = max(loss_err, abs(a - b) / max(1.0, abs(b)))
    return (loss_err, *compare_grads(g_k, g_p, what, kinks))


def compare_grads(g_k, g_p, what, kinks=False):
    """``compare_routes``' rule for the gradient leaves alone: returns
    (worst gradient ratio, its leaf, worst relative L2)."""
    grad_ratio, worst, l2 = 0.0, None, 0.0
    for i, (a, b) in enumerate(zip(g_k, g_p)):
        require(bool(torch.isfinite(a).all()), f"{what}: leaf {i} NaN")
        ratio = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        l2 = max(l2, float(torch.linalg.vector_norm(a - b)) / max(
            float(torch.linalg.vector_norm(b)), 1e-30))
        if ratio > grad_ratio:
            grad_ratio, worst = ratio, i
    require(grad_ratio <= (10 * TRAIN_TOL if kinks else TRAIN_TOL)
            and (not kinks or l2 <= TRAIN_TOL),
            f"{what}: gradient leaf {worst} differs by {grad_ratio:.3e} of "
            f"its largest magnitude (worst relative L2 {l2:.3e})")
    return grad_ratio, worst, l2


def serve_rounds(preds, scenes, rounds, single=False):
    """Serve ``rounds`` rounds of requests from each Predictor of
    ``preds``, in alternating order (0, 1, ..., then reversed, ...): a
    round is one ``predict_many`` of all ``scenes``, or with ``single`` one
    ``predict`` per scene. Returns, per Predictor, (outputs of its last
    round, p50 ms per request, scenes/s over the time spent in it)."""
    n = len(preds)
    lat, busy, out = [[] for _ in preds], [0.0] * n, [None] * n
    for r in range(rounds):
        for i in (range(n) if r % 2 == 0 else reversed(range(n))):
            res = []
            for batch in ([[s] for s in scenes] if single else [scenes]):
                t = time.perf_counter()
                res += preds[i].predict_many(batch, seed=11)
                dt = time.perf_counter() - t
                lat[i].append(dt * 1e3)
                busy[i] += dt
            out[i] = res
    return [(out[i], statistics.median(lat[i]),
             len(scenes) * rounds / busy[i]) for i in range(n)]


def compare(out, ref, shape_of, what):
    err = 0.0
    for o, r, s in zip(out, ref, shape_of):
        require(o.shape == s, f"{what}: shape {o.shape} != {s}")
        require(bool(np.isfinite(o).all()), f"{what}: non-finite")
        err = max(err, float(np.abs(o - r).max()))
    require(err <= MODEL_TOL, f"{what}: max abs err {err} > {MODEL_TOL}")
    return err


def step_times(routes, batch, gen, B, label, card, rounds=6,
               names=("kernel route", "plain route"), steps=5):
    """Train step ms, train scenes/s and the device's idle share of the
    routes ``[[step, params, opt], ...]`` (named by ``names``), timed in
    alternating rounds of ``steps`` synchronized steps on ``batch`` (the
    order reversed every other round); then ``steps`` steps of each under
    the profiler for the device busy time and kernel B's share of it.
    Prints one line per route and returns the median step ms of each."""
    n = len(routes)

    def run_steps(i, count):
        st, p, o = routes[i]
        for _ in range(count):
            p, o, _ = st(p, o, batch, gen)
        routes[i][1:] = [p, o]

    for i in range(n):
        run_steps(i, min(2, steps))
    torch.cuda.synchronize()
    step_ms: list[list] = [[] for _ in range(n)]
    for r in range(rounds):
        for i in (range(n) if r % 2 == 0 else reversed(range(n))):
            t = time.perf_counter()
            run_steps(i, steps)
            torch.cuda.synchronize()
            step_ms[i].append((time.perf_counter() - t) / steps * 1e3)
    busy = []
    for i in range(n):
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            run_steps(i, steps)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) / steps * 1e3
        # device kernels only: a user annotation (Optimizer.step#Adam.step)
        # spans the kernels inside it and would count them twice
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)]
        dev_us = sum(e.self_device_time_total for e in kernels)
        sel_us = sum(e.self_device_time_total for e in kernels
                     if "select_" in e.key and "_kernel" in e.key)
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
        busy.append(None if dev_us <= 0 else (
            dev_us / steps / 1e3, wall, sum(e.count for e in kernels) / steps,
            sel_us / dev_us,
            "; ".join(f"{e.self_device_time_total / steps / 1e3:.3f} ms "
                      f"x{e.count // steps} {e.key[:60]}" for e in top)))
    medians = []
    for i, route in enumerate(names):
        ms = statistics.median(step_ms[i])
        medians.append(ms)
        if busy[i] is None:
            idle = "device busy not measured (no device time in the trace)"
        else:
            dev_ms, t_ms, n_k, sel, top = busy[i]
            idle = (f"device busy {dev_ms:.3f} ms/step, idle share "
                    f"{1 - dev_ms / ms:.3f} of the untraced step "
                    f"({1 - dev_ms / t_ms:.3f} of the traced {t_ms:.3f} ms); "
                    f"{n_k:.0f} kernels/step; kernel B {sel:.3f} of the "
                    f"device time; top: {top}")
        print(f"{label}, {route}: {ms:.3f} ms/step, "
              f"{B * 1e3 / ms:.1f} train scenes/s; {idle}  [{card}]")
    return medians


TRACE_KERNELS = (
    ("P", r"packed_fwd_kernel"),
    ("Q", r"packed_(?:small|warp)_bwd_kernel"),
    ("A", r"mhgsa_(?:small_)?fwd_kernel"),
    # C and 2p: the whole-S backward kernels of both metrics
    ("C", r"mhgsa_(?:small_)?bwd_kernel"),
    ("B_fp32", r"select_main_kernel(?:<float|If)"),
    ("B", r"select_(?:main|base)_kernel"),
    ("F", r"flash_fwd_kernel"),
    # Fdq, Fdkv, 4p dq and dk/dv, and their wide-head modes
    ("F_bwd", r"flash_\w*d(?:q|kv)_kernel|wide_d(?:q|kv)_kernel"))


def trace_names(events) -> dict:
    """Launches by kernel of this repo's kernels in a trace (labels of
    ``TRACE_KERNELS``)."""
    found: dict = {}
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for label, pattern in TRACE_KERNELS:
            if re.search(pattern, e.key):
                found[label] = found.get(label, 0) + e.count
    return found


def step_clock(hook_fn=None):
    """Host clock at every optimizer step (a global post-step hook), calling
    ``hook_fn`` after each."""
    stamps: list = []

    def hook(opt, args, kwargs):
        stamps.append(time.perf_counter())
        if hook_fn is not None:
            hook_fn()

    from torch.optim.optimizer import register_optimizer_step_post_hook
    handle = register_optimizer_step_post_hook(hook)
    return stamps, handle


def eth_phase(dev, card, counts, reset, inside=None) -> dict:
    """Phase 15: the ETH-UCY and SDD path. Returns the launches of its main
    paths (the reference recipe's CLIs, the agent-axis CLI) and kernel B's
    times at the ETH shapes, and under "inside" what ``inside(tmp, flags,
    n_train)`` returns: called in the phase's directory after its CLIs
    (the ETH CSVs under ``tmp/data``, the reference recipe's stage-1
    checkpoints of epochs 1 and 2 under ``tmp/ck/eth``, ``n_train`` scenes
    in the train split), its time not counted in the phase's."""
    from sttode_tpu_torch.cli import test as cli_test
    from sttode_tpu_torch.cli import train as cli_train
    from sttode_tpu_torch.data import load_eth_ucy, scene_batches
    from sttode_tpu_torch.data.synthetic import (make_social_scenes,
                                                 write_eth_style_csvs)
    from sttode_tpu_torch.kernels import select_decode as ks
    from sttode_tpu_torch.models import sttode as tm
    from sttode_tpu_torch.native import binding
    from sttode_tpu_torch.train import make_train_step, train_epoch

    t_phase = time.perf_counter()
    cuda = torch.profiler.ProfilerActivity.CUDA
    cpu = torch.profiler.ProfilerActivity.CPU

    with tempfile.TemporaryDirectory(dir=HERE, prefix=".smoke_eth_") as tmp:
        root = os.path.join(tmp, "data")
        for split, seed in (("train", 15), ("test", 16)):
            write_eth_style_csvs(os.path.join(root, "eth", split), n_files=2,
                                 frames_per_file=200, agents=12, seed=seed)
        flags = ["--dataset", "eth", "--data_root", root, "--ckpt_dir",
                 os.path.join(tmp, "ck"), "--log_every", "0",
                 "--model_save_epoch", "1", "--select_impl", "auto"]

        # the reference recipe (the JAX CLI's default run): one epoch, the
        # profiler over 3 of its steps; a resumed epoch; cli.test
        traces: list = []
        prof = torch.profiler.profile(
            activities=[cpu, cuda],
            schedule=torch.profiler.schedule(wait=60, warmup=2, active=3,
                                             repeat=1),
            on_trace_ready=lambda p: traces.append(p.key_averages()))
        binding.window_file.calls = 0
        ks.select_decode.launches_by_mode.update(dist=0, traj=0)
        reset()   # the main path: train, resume, evaluate
        _, handle = step_clock(prof.step)
        with prof:
            run = cli_train.main(flags + ["--num_epochs", "1"])
            torch.cuda.synchronize()
        handle.remove()
        stamps, handle = step_clock()
        t = time.perf_counter()
        resumed = cli_train.main(flags + ["--num_epochs", "2",
                                          "--epoch_continue", "1"])
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t
        handle.remove()
        launches_train = counts()
        modes_train = dict(ks.select_decode.launches_by_mode)
        native_files = binding.window_file.calls
        with open("/proc/self/maps") as f:
            native_mapped = str(binding.library_path()) in f.read()
        t = time.perf_counter()
        with torch.profiler.profile(activities=[cuda]) as prof_e:
            best = cli_test.main(flags + ["--sweep", "1"])
            torch.cuda.synchronize()
        test_s = time.perf_counter() - t
        launches_ref = counts()
        modes_ref = dict(ks.select_decode.launches_by_mode)
        eval_names = trace_names(prof_e.key_averages())
        train_names = trace_names(traces[0]) if traces else {}
        n_train = len(stamps)
        scenes = load_eth_ucy(os.path.join(root, "eth", "train"))
        numpy_scenes = load_eth_ucy(os.path.join(root, "eth", "train"),
                                    backend="python")

        # the agent-axis recipe on the same files
        reset()   # the main path: train
        run_a = cli_train.main(flags + [
            "--ckpt_dir", os.path.join(tmp, "ck_agent"), "--num_epochs", "1",
            "--compat", "tpu", "--attn_axis", "agent",
            "--scenes_per_batch", "32"])
        torch.cuda.synchronize()
        launches_agent = counts()

        # SDD: a pickle of scene groups in pixels, the reference's
        # [N, 2, T] layout, evaluated with the reference recipe's checkpoint
        sdd_dir = os.path.join(root, "sdd", "test")
        os.makedirs(sdd_dir)
        groups = [np.transpose(np.concatenate([s["obs"], s["pred"]], 1)
                               * 50.0, (0, 2, 1))
                  for s in make_social_scenes(64, agents_range=(2, 20),
                                              seed=17)]
        with open(os.path.join(sdd_dir, "sdd_test.pkl"), "wb") as f:
            pickle.dump(groups, f)
        os.makedirs(os.path.join(tmp, "ck", "sdd"))
        shutil.copy(os.path.join(tmp, "ck", "eth", "model_0002.pt"),
                    os.path.join(tmp, "ck", "sdd"))
        flags_sdd = [("sdd" if a == "eth" else a) for a in flags]
        best_sdd = cli_test.main(flags_sdd + ["--sweep", "1"])
        t_inside = time.perf_counter()
        inside_result = None if inside is None else inside(tmp, flags,
                                                           len(scenes))
        t_inside = time.perf_counter() - t_inside

    require(native_files == 4 and native_mapped,
            f"phase 15: the native windowing engine did not load the data "
            f"({native_files} files windowed, library mapped: "
            f"{native_mapped})")
    require(len(scenes) == len(numpy_scenes) and all(
        all(np.array_equal(a[k], b[k]) if isinstance(a[k], np.ndarray)
            else a[k] == b[k] for k in a)
        for a, b in zip(scenes, numpy_scenes)),
        "phase 15: the native engine's scenes differ from the numpy loop's")
    steps = len(scenes)                          # one scene a step
    require(launches_train["packed"] > 0 and launches_train["packed_bwd"] > 0
            and launches_train["select_fp32"] > 0 and modes_train["dist"] > 0
            and modes_train["traj"] == 0,
            f"phase 15: the reference recipe's training did not launch P, Q "
            f"and kernel B fp32 in mode dist {launches_train} {modes_train}")
    require(all(train_names.get(n, 0) > 0 for n in ("P", "Q", "B_fp32")),
            f"phase 15: the profiler did not see P, Q and kernel B fp32 in "
            f"the CLI's training steps: {train_names}")
    require(modes_ref["traj"] > 0 and modes_ref["dist"] == modes_train["dist"]
            and launches_ref["packed"] > launches_train["packed"],
            f"phase 15: evaluation did not launch P and kernel B in mode "
            f"traj {launches_ref} {modes_ref}")
    require(all(eval_names.get(n, 0) > 0 for n in ("P", "B_fp32")),
            f"phase 15: the profiler did not see P and kernel B fp32 in the "
            f"CLI's evaluation: {eval_names}")
    require(launches_agent["attn_masked"] > 0
            and launches_agent["attn_bwd_masked"] > 0
            and launches_agent["select_fp32"] > 0,
            f"phase 15: the agent-axis recipe did not launch A and C with "
            f"a key mask {launches_agent}")
    for r in (run, resumed, run_a):
        for epoch, lr, means in r.history:
            require(all(np.isfinite(list(means.values()))),
                    f"phase 15: non-finite loss at epoch {epoch}: {means}")
    require(resumed.start_epoch == 1 and all(
        int(st["step"]) == 2 * steps
        for st in resumed.opt.state_dict()["state"].values()),
        "phase 15: the resumed run did not continue from the saved epoch")
    n_sdd = sum(len(g) for g in groups)
    for b, what in ((best, "ETH"), (best_sdd, "SDD")):
        require(np.isfinite([b["ade"], b["fde"]]).all() and b["epoch"] == 2,
                f"phase 15: {what} evaluation {b}")
    span = stamps[-1] - stamps[0]
    rate = (n_train - 1) / span
    print(f"phase 15 ETH reference recipe through the CLIs ({len(scenes)} "
          f"train scenes of 12 agents, bucket 16; native windowing engine, "
          f"{native_files} files, equal to the numpy loop): epochs "
          + "; ".join(f"{e} total {m['total']:.4f}"
                      for e, _, m in run.history + resumed.history)
          + f"; the resumed epoch: {n_train} steps in "
          f"{span * n_train / (n_train - 1):.2f} s, {rate:.2f} train steps/s "
          f"= scenes/s (host clock between optimizer steps), the resumed CLI "
          f"run {resume_s:.2f} s end to end; profiled training steps: "
          f"{train_names} over 3 steps; evaluation ({test_s:.2f} s, "
          f"profiled): {eval_names}; ADE "
          f"{best['ade']:.4f} FDE {best['fde']:.4f} (epoch {best['epoch']}); "
          f"launches {launches_ref}, kernel B by mode {modes_ref}  [{card}]")
    print(f"phase 15 agent-axis ETH recipe (--compat tpu --attn_axis agent "
          f"--scenes_per_batch 32): total "
          f"{run_a.history[0][2]['total']:.4f}; launches {launches_agent}")
    print(f"phase 15 SDD through cli.test ({len(groups)} pixel groups, "
          f"[N, 2, T], {n_sdd} agents, the ETH checkpoint of epoch 2): ADE "
          f"{best_sdd['ade']:.4f} FDE {best_sdd['fde']:.4f}")

    # both recipes' batches: the kernel route against the plain route
    # (same parameters, batch and noise), kernel B at their shapes, steps
    cfg_ref = run.cfg
    cfg_agent = run_a.cfg
    D, Z, K = cfg_ref.hidden_dim, cfg_ref.zdim, cfg_ref.sample_k
    result = {"launches": {k: launches_ref[k] + launches_agent[k]
                           for k in launches_ref}}
    sel_times = {}
    for label, cfg, spb in (("reference recipe", cfg_ref, 1),
                            ("agent-axis recipe", cfg_agent, 32)):
        (batch, _), *_ = scene_batches(scenes, training=True,
                                       rng=np.random.default_rng(15),
                                       scenes_per_batch=spb,
                                       compat=cfg.compat)
        batch = batch.to(dev)
        B, M = batch.batch_size, batch.batch_size * batch.agent_num
        require(batch.agent_num == 16 and float(batch.valid.min()) == 0.0,
                f"phase 15: {label} batch has no padded agent")
        params = tm.sttode_init(15, cfg)
        gen = torch.Generator(device=dev).manual_seed(15)
        noise = tm.TrainNoise(
            torch.rand(M, 8, D, device=dev, generator=gen) >= 0.1,
            torch.rand(M, 12, D, device=dev, generator=gen) >= 0.1,
            torch.randn(M, Z, device=dev, generator=gen),
            torch.randn(M * K, Z, device=dev, generator=gen))
        plain = cfg._replace(attn_impl="dense", select_impl="xla")
        p_k, out_k, g_k = forward_backward(params, cfg, batch, noise, dev)
        _, out_p, g_p = forward_backward(params, plain, batch, noise, dev)
        loss_err, grad_ratio, worst, _ = compare_routes(
            out_k, g_k, out_p, g_p, f"phase 15 {label}")
        print(f"phase 15 fp32 {label} forward+backward at B = {B} x 16 "
              f"(padded), kernel vs plain route: loss terms within "
              f"{loss_err:.3e} (relative), gradients within "
              f"{grad_ratio:.3e} of each leaf's largest magnitude (worst "
              f"leaf {worst})")

        # kernel B, mode "dist" (and "traj" at the evaluation's M = 16),
        # on the batch's operands: the trained recipe's decode at 8 / 12
        with torch.inference_mode():
            pf = tm.encode_past(p_k, cfg, batch)
            z_km = noise.eps_p.reshape(M, K, -1).transpose(0, 1)
            ops = [pf, z_km, tm.decode_block0_state(p_k, batch.past),
                   batch.past.reshape(M, -1),
                   (batch.future - batch.cur_location).reshape(M, -1)]
            weights = ks.prep_select_weights(p_k, 2 * D, Z, 8, 12)
            for mode in (("dist", "traj") if spb == 1 else ("dist",)):
                got = ks.select_decode(p_k, *ops, mode=mode)
                want = ks.select_decode_reference(weights, *ops, mode=mode)
                torch.cuda.synchronize()
                err = max_err(got, want)
                # a distance sums 24 squares of metres: its fp32 rounding
                # scales with it, so "dist" is held relative to its scale
                scale = float(want.abs().max()) if mode == "dist" else 1.0
                tol = SELECT_TOL * max(1.0, scale)
                require(bool(torch.isfinite(got).all()) and err <= tol,
                        f"phase 15 kernel B {mode} M = {M}: max abs err {err} "
                        f"> {tol}")
                extra = ""
                if mode == "dist":
                    g_win, w_win = got.argmin(1), want.argmin(1)
                    gap = (want.gather(1, g_win[:, None])
                           - want.gather(1, w_win[:, None])).abs()
                    require(bool((gap <= 2 * tol).all()),
                            f"phase 15 kernel B M = {M}: argmin winners "
                            f"differ beyond near-ties")
                    extra = (f" (distance scale {scale:.1f}), winners differ "
                             f"at {int((g_win != w_win).sum())} near-ties")
                ms = paired_ms(lambda: ks.select_decode(p_k, *ops, mode=mode),
                               lambda: ks.select_decode_reference(
                                   weights, *ops, mode=mode))
                sel_times[f"{mode}_M{M}"] = ms
                print(f"phase 15 kernel B fp32 {mode} at M = {M}, K = 20, "
                      f"8 / 12 steps: max_abs_err {err:.3e}{extra}; kernel "
                      f"{ms[0]:.4f} ms plain {ms[1]:.4f} ms  [{card}]")

        step_k = make_train_step(cfg, 1e-4, device=dev)
        step_p = make_train_step(plain, 1e-4, device=dev)
        step_times([[step_k, *step_k.init(params)],
                    [step_p, *step_p.init(params)]], batch, gen, B,
                   f"phase 15 ETH {label} step at B = {B} x 16", card)
        del batch, noise, out_k, out_p, g_k, g_p

    # prefetch: the same epochs with the background thread (depth 2) and
    # without it (0), from the same seeds, give the same mean losses
    for label, cfg, spb, subset in (("reference recipe", cfg_ref, 1, 64),
                                    ("agent-axis recipe", cfg_agent, 32,
                                     len(scenes))):
        means = []
        for depth in (2, 0):
            step = make_train_step(cfg, 1e-4, device=dev)
            params, opt = step.init(tm.sttode_init(16, cfg))
            _, _, m = train_epoch(
                step, params, opt, scene_batches(
                    scenes[:subset], training=True,
                    rng=np.random.default_rng(16), scenes_per_batch=spb,
                    compat=cfg.compat),
                torch.Generator(device=dev).manual_seed(16),
                prefetch_depth=depth)
            means.append(m)
        require(means[0] == means[1],
                f"phase 15 prefetch, {label}: depth 2 {means[0]} vs depth 0 "
                f"{means[1]}")
        print(f"phase 15 prefetch, {label} ({subset} scenes): the epoch's "
              f"mean losses with depth 2 equal depth 0's: {means[0]}")
    result["select_times"] = sel_times
    result["resume_s"] = resume_s
    result["inside"] = inside_result
    print(f"phase 15 took {time.perf_counter() - t_phase - t_inside:.1f} s  "
          f"[{card}]")
    return result


# the counters of the kernels a stage-2 path must not launch: the attention
# backward of every route and metric (C, 2p; Q; Fdq, Fdkv, 4p) and kernel B
STAGE2_NOT_LAUNCHED = ("attn_bwd", "packed_bwd", "flash_dq", "flash_dkv",
                       "select_fp32", "select_bf16")


def leaf_names(tree, prefix="") -> list:
    """Paths of a parameter tree's leaves ("q_mlp/layers/0/w"), in
    ``bridge.tree_leaves`` order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in leaf_names(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in leaf_names(v, f"{prefix}{i}/")]
    return [prefix.rstrip("/")]


def nonzero(launches: dict) -> dict:
    return {k: v for k, v in launches.items() if v}


def stage2_forward_only(launches: dict, what: str) -> None:
    """Stage 2 runs the frozen encoder's attention forward only and decodes
    in plain PyTorch: hold a stage-2 path's launches to that."""
    bad = {k: launches[k] for k in STAGE2_NOT_LAUNCHED if launches[k]}
    require(not bad, f"{what}: launched {bad}")


def stage2_cli(tmp, flags, n_train, counts, reset) -> dict:
    """Phase 16, its CLIs: the reference's default stage-2 run in phase
    15's directory, on its ETH CSVs and the reference recipe's stage-1
    checkpoints: ``cli.trainsampler --dataset eth`` for 1 epoch and 1
    resumed epoch (``--fix_epochs 0``: the resumed epoch at 2/3 of the
    rate), then ``cli.test_sampler --sweep 2`` (2 nets × 2 samplers).
    Checks them and returns their launches and the line to print."""
    from sttode_tpu_torch.cli import test_sampler as cli_test_sampler
    from sttode_tpu_torch.cli import trainsampler as cli_trainsampler

    t_cli = time.perf_counter()
    sflags = flags + ["--fix_epochs", "0"]
    reset()   # the main path: train, resume, evaluate
    run = cli_trainsampler.main(sflags + ["--num_epochs", "1"])
    stamps, handle = step_clock()
    t = time.perf_counter()
    resumed = cli_trainsampler.main(sflags + ["--num_epochs", "2"])
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t
    handle.remove()
    launches_train = counts()
    t = time.perf_counter()
    best = cli_test_sampler.main(sflags + ["--sweep", "2"])
    torch.cuda.synchronize()
    test_s = time.perf_counter() - t
    launches = counts()
    require(launches_train["packed"] > 0
            and launches["packed"] > launches_train["packed"]
            and launches["attn"] == 0,
            f"phase 16: the stage-2 CLIs did not run on P alone: training "
            f"{launches_train}, with evaluation {launches}")
    stage2_forward_only(launches, "phase 16 stage-2 CLIs")
    for r in (run, resumed):
        for epoch, lr, means in r.history:
            require(all(np.isfinite(list(means.values()))),
                    f"phase 16: non-finite loss at epoch {epoch}: {means}")
    lrs = [lr for _, lr, _ in run.history + resumed.history]
    require(resumed.start_epoch == 1 and abs(lrs[0] - 1e-4) < 1e-15
            and abs(lrs[1] - 1e-4 * 2 / 3) < 1e-15,
            f"phase 16: the resumed run or the lambda decay: start epoch "
            f"{resumed.start_epoch}, learning rates {lrs}")
    require(all(int(st["step"]) == 2 * n_train
                for st in resumed.opt.state_dict()["state"].values()),
            "phase 16: the resumed run did not continue from the saved epoch")
    require(np.isfinite([best["ade"], best["fde"]]).all()
            and best["vae"] in (1, 2) and best["sampler"] in (1, 2),
            f"phase 16: stage-2 evaluation {best}")
    rate = (len(stamps) - 1) / (stamps[-1] - stamps[0])
    line = (
        f"phase 16 ETH stage 2 through the CLIs ({n_train} train scenes, one "
        f"a step, on phase 15's stage-1 checkpoints): epochs "
        + "; ".join(f"{e} lr {lr:.3e} total {m['total']:.4f} kld "
                    f"{m['kld']:.4f} diverse {m['diverse']:.4f}"
                    for e, lr, m in run.history + resumed.history)
        + f"; the resumed epoch: {len(stamps)} steps, {rate:.2f} train "
        f"steps/s = scenes/s (host clock between optimizer steps), the "
        f"resumed CLI run {resume_s:.2f} s end to end; cli.test_sampler "
        f"--sweep 2 (4 evaluations) {test_s:.2f} s: best ADE "
        f"{best['ade']:.4f} FDE {best['fde']:.4f} (vae {best['vae']}, "
        f"sampler {best['sampler']}); launches {nonzero(launches)}")
    return {"launches": launches, "line": line,
            "seconds": time.perf_counter() - t_cli}


def sampler_phase(dev, card, counts, reset, cli: dict) -> dict:
    """Phase 16: stage 2, the DLow sampler, at full width (the sampler:
    qnet_mlp (512, 256), nk 20, nz 32). Prints ``cli`` (``stage2_cli``'s
    result); holds the stage-2 step on the kernel route against the plain
    route; profiles one step of each recipe; times the step; serves with
    the sampler. Returns the launches of its main paths (the servers)."""
    from sttode_tpu_torch import bridge
    from sttode_tpu_torch.data import scene_batches
    from sttode_tpu_torch.data.preprocess import prepare_scene_group
    from sttode_tpu_torch.data.synthetic import make_social_scenes
    from sttode_tpu_torch.models import sampler as ts
    from sttode_tpu_torch.models import sttode as tm
    from sttode_tpu_torch.serving import Predictor
    from sttode_tpu_torch.train import make_sampler_train_step

    t_phase = time.perf_counter()
    print(cli["line"] + f"  [{card}]")
    scfg = ts.SamplerConfig()
    sp0 = ts.sampler_init(16, scfg)

    def nba_batch(B, seed):
        sc = make_social_scenes(B, agents_range=(11, 11), obs_len=5,
                                pred_len=10, seed=seed)
        batch, _ = prepare_scene_group(
            np.stack([s["obs"] for s in sc]),
            np.stack([s["pred"] for s in sc]),
            np.ones((B, 11), np.float32), training=True,
            rng=np.random.default_rng(seed))
        return batch.to(dev)

    def eth_batch(B, compat, seed):
        """B scenes of 9-16 agents, padded to bucket 16."""
        sc = make_social_scenes(B, agents_range=(9, 16), seed=seed)
        (batch, _), = scene_batches(sc, training=True,
                                    rng=np.random.default_rng(seed),
                                    scenes_per_batch=B, compat=compat)
        require(batch.batch_size == B and batch.agent_num == 16,
                f"phase 16: ETH batch {batch.batch_size} x "
                f"{batch.agent_num}")
        return batch.to(dev)

    cfg_nba = tm.STTODEConfig(past_length=5, future_length=10).validate()
    cfg_agent = tm.STTODEConfig(compat="tpu", attn_axis="agent").validate()
    cfg_pagent = cfg_agent._replace(attn_metric="poincare").validate()
    cfg_ref = tm.STTODEConfig().validate()

    def plain(cfg):
        return cfg._replace(attn_impl="dense", select_impl="xla")

    def trainable_net(cfg, seed):
        # trainable leaves, as a caller's stage-1 params may be: the sampler
        # must leave them without a gradient
        return bridge.tree_map(lambda t: t.to(dev).requires_grad_(),
                               tm.sttode_init(seed, cfg))

    def stage2_fb(net, cfg, batch, dtype=torch.float32):
        sp = bridge.tree_map(lambda t: t.to(dev, dtype, copy=True), sp0)
        leaves = [t.requires_grad_() for t in bridge.tree_leaves(sp)]
        out = ts.sampler_forward(sp, net, scfg, cfg, batch)
        total, parts = ts.sampler_loss(out, scfg, batch)
        total.backward()
        return ([float(total.detach())]
                + [float(v.detach()) for v in parts.values()],
                out.dec_motion.detach(), [t.grad for t in leaves])

    f64 = torch.float64
    names = leaf_names(sp0)

    # the stage-2 step on the kernel route against the plain route (same
    # weights and batch): the losses, dec_motion, every sampler leaf
    batch_nba = nba_batch(32, 16)
    batch_agent = eth_batch(32, "tpu", 16)
    for label, cfg, batch, key in (
            ("NBA recipe at B = 32 x 11 (P)", cfg_nba, batch_nba, "packed"),
            ("ETH agent-axis recipe at 32 x 16 (A, key masks)", cfg_agent,
             batch_agent, "attn_masked"),
            ("poincaré agent axis at 32 x 16 (1p)", cfg_pagent, batch_agent,
             "attn_p")):
        net = trainable_net(cfg, 16)
        reset()
        losses_k, dec_k, g_k = stage2_fb(net, cfg, batch)
        torch.cuda.synchronize()
        moved = counts()
        losses_p, dec_p, g_p = stage2_fb(net, plain(cfg), batch)
        require(moved[key] > 0, f"phase 16 {label}: {key} not launched "
                                f"{moved}")
        stage2_forward_only(moved, f"phase 16 {label}")
        require(all(t.grad is None for t in bridge.tree_leaves(net)),
                f"phase 16 {label}: a net leaf received a gradient")
        loss_err = 0.0
        for name, a, b in zip(("total", "kld", "diverse"), losses_k,
                              losses_p):
            require(abs(a - b) <= TRAIN_TOL * max(1.0, abs(b)),
                    f"phase 16 {label} {name}: {a} vs plain {b}")
            loss_err = max(loss_err, abs(a - b) / max(1.0, abs(b)))
        dec_scale = max(1.0, float(dec_p.abs().max()))
        dec_err = max_err(dec_k, dec_p)
        require(bool(torch.isfinite(dec_k).all())
                and dec_err <= TRAIN_TOL * dec_scale,
                f"phase 16 {label}: dec_motion max abs err {dec_err}")
        # the sampler's gradient is ill-conditioned in fp32 on either route
        # (the KL's −log(A² + 1e-8) gives q_A a 1/A gradient where A is a
        # cancelling sum near 0): each leaf is held within 1e-3 of its
        # largest magnitude between the routes (PERF.md §2's large-batch
        # limit), and against the plain route in float64 the kernel route
        # at most 3× as far off as the fp32 plain route
        net64 = bridge.tree_map(lambda t: t.detach().to(f64), net)
        _, _, g_64 = stage2_fb(net64, plain(cfg), batch.to(f64), f64)
        ratio = {"routes": [], "kernel_f64": [], "plain_f64": []}
        for name, a, b, o in zip(names, g_k, g_p, g_64):
            require((a is None) == (b is None) == (o is None),
                    f"phase 16 {label}: leaf {name} has a gradient on one "
                    f"route only")
            if b is None:        # q_c: only the reconstruction decode
                continue
            require(bool(torch.isfinite(a).all()),
                    f"phase 16 {label}: leaf {name} not finite")
            for key, x, y in (("routes", a, b), ("kernel_f64", a, o),
                              ("plain_f64", b, o)):
                ratio[key].append((float((x.to(f64) - y).abs().max())
                                   / max(float(y.abs().max()), 1e-30),
                                   name))
        worst = {k: max(v) for k, v in ratio.items()}
        require(worst["routes"][0] <= 10 * TRAIN_TOL
                and worst["kernel_f64"][0] <= 10 * TRAIN_TOL
                and worst["kernel_f64"][0] <= 3 * worst["plain_f64"][0],
                f"phase 16 {label}: sampler gradients, worst leaf (share of "
                f"its largest magnitude) between the routes, kernel route "
                f"vs float64, plain route vs float64: {worst}")
        grad_ratio = worst["routes"][0]
        print(f"phase 16 fp32 stage-2 forward+backward, {label}, kernel vs "
              f"plain route: losses (total {losses_k[0]:.4f}, kld "
              f"{losses_k[1]:.4f}, diverse {losses_k[2]:.4f}) within "
              f"{loss_err:.3e} (relative), dec_motion within {dec_err:.3e} "
              f"(scale {dec_scale:.1f}), sampler gradients within "
              f"{grad_ratio:.3e} of each leaf's largest magnitude (worst "
              f"leaf {worst['routes'][1]}); against the float64 plain "
              f"route the kernel route's worst leaf "
              f"{worst['kernel_f64'][0]:.3e} ({worst['kernel_f64'][1]}), the "
              f"fp32 plain route's "
              f"{worst['plain_f64'][0]:.3e} ({worst['plain_f64'][1]}); no "
              f"net leaf has a gradient; launches {nonzero(moved)}")
        del net64, g_64
        del net, g_k, g_p

    # profiled stage-2 training steps of each recipe: its forward kernel,
    # and no backward attention kernel and no kernel B
    cpu = torch.profiler.ProfilerActivity.CPU
    cuda = torch.profiler.ProfilerActivity.CUDA
    for label, cfg, batch, fwd in (
            ("NBA recipe 32 x 11", cfg_nba, batch_nba, "P"),
            ("ETH agent-axis recipe 32 x 16", cfg_agent, batch_agent, "A")):
        net = trainable_net(cfg, 17)
        step = make_sampler_train_step(cfg, scfg, 1e-4, net, device=dev)
        params, opt = step.init(sp0)
        for _ in range(2):
            params, opt, _ = step(params, opt, batch)
        torch.cuda.synchronize()
        # 20 steps in one trace after the warm-up steps: traces of one step
        # each (three in a row) came back empty on the card, as traces of a
        # few calls did in phase 13 (kernel_names)
        reset()
        with torch.profiler.profile(activities=[cpu, cuda]) as prof:
            for _ in range(20):
                params, opt, metrics = step(params, opt, batch)
            torch.cuda.synchronize()
        moved = counts()
        seen = trace_names(prof.key_averages())
        stage2_forward_only(moved, f"phase 16 profiled {label} steps")
        require(seen.get(fwd, 0) > 0,
                f"phase 16: the profiler did not see {fwd} in a {label} "
                f"stage-2 step: {seen}")
        forbidden = {k: seen[k] for k in ("C", "Q", "F_bwd", "B")
                     if seen.get(k)}
        require(not forbidden, f"phase 16: a {label} stage-2 step launched "
                               f"{forbidden}")
        require(all(t.grad is None for t in bridge.tree_leaves(net))
                and all(t.grad is None
                        for t in bridge.tree_leaves(step.net_params)),
                f"phase 16 {label}: a net leaf received a gradient")
        require(all(bool(torch.isfinite(v)) for v in metrics.values()),
                f"phase 16 {label}: non-finite metrics {metrics}")
        print(f"phase 16 20 profiled stage-2 steps, {label}: the trace saw "
              f"{seen}; the counters {nonzero(moved)}; no net leaf has a "
              f"gradient")
        del net, step, params, opt

    # step time, train scenes/s, idle share and kernels a step, both routes
    batch_ref = eth_batch(1, "reference", 18)
    gen = torch.Generator(device=dev).manual_seed(16)
    for label, cfg, batch in (("ETH reference shape 1 x 16", cfg_ref,
                               batch_ref),
                              ("NBA recipe B = 32 x 11", cfg_nba, batch_nba)):
        net = bridge.to_device(tm.sttode_init(18, cfg), dev)
        steps = [make_sampler_train_step(c, scfg, 1e-4, net, device=dev)
                 for c in (cfg, plain(cfg))]
        step_times([[st, *st.init(sp0)] for st in steps], batch, gen,
                   batch.batch_size, f"phase 16 stage-2 step, {label}", card)

    # the sampler's server: kernel route against the plain route (equal, and
    # independent of the seed), and its p50 beside the stage-1 server's
    scenes = [s["obs"] for s in make_social_scenes(64, agents_range=(8, 8),
                                                   seed=0)]
    shapes = [(20, 8, 12, 2)] * 64
    launches: dict = {}
    for label, cfg, key in (
            ("agent axis (compat tpu)", cfg_agent, "attn_masked"),
            ("scene axis (reference compat, isolated)", cfg_ref, "packed"),
            ("poincaré agent axis", cfg_pagent, "attn_p")):
        net = tm.sttode_init(0, cfg)
        kw = dict(device=dev, max_group=64, sampler_params=sp0,
                  sampler_cfg=scfg)
        preds = [Predictor(net, cfg, **kw), Predictor(net, plain(cfg), **kw)]
        if key != "attn_p":
            preds.append(Predictor(net, cfg, device=dev, max_group=64))
        for pr in preds:
            pr.warmup([8], scenes_per=64)
        torch.cuda.synchronize()
        reset()   # the main path: the sampler's server
        out = preds[0].predict_many(scenes, seed=11)
        torch.cuda.synchronize()
        moved = counts()
        require(moved[key] > 0, f"phase 16 server, {label}: {key} not "
                                f"launched {moved}")
        stage2_forward_only(moved, f"phase 16 server, {label}")
        for k, v in moved.items():
            launches[k] = launches.get(k, 0) + v
        other = preds[0].predict_many(scenes, seed=12)
        require(all(np.array_equal(a, b) for a, b in zip(out, other)),
                f"phase 16 server, {label}: the forecasts depend on the seed")
        if key == "attn_p":
            err = compare(out, preds[1].predict_many(scenes, seed=11),
                          shapes, f"phase 16 server, {label}")
            print(f"phase 16 sampler server, {label}, 64 scenes x 8 agents "
                  f"a call: max_abs_err vs plain {err:.3e}, independent of "
                  f"the seed; launches {nonzero(moved)}")
            continue
        timed = serve_rounds(preds, scenes, 10)
        err = compare(timed[0][0], timed[1][0], shapes,
                      f"phase 16 server, {label}")
        (_, p50, rate), (_, p50_p, rate_p), (_, p50_1, rate_1) = timed
        print(f"phase 16 sampler server, {label}, 64 scenes x 8 agents a "
              f"call: max_abs_err vs plain {err:.3e}, independent of the "
              f"seed; p50 per predict_many {p50:.3f} ms ({rate:.1f} "
              f"scenes/s), plain {p50_p:.3f} ms ({rate_p:.1f}), the "
              f"stage-1 server at the same shape {p50_1:.3f} ms "
              f"({rate_1:.1f}); launches {nonzero(moved)}  [{card}]")
    seconds = time.perf_counter() - t_phase + cli["seconds"]
    print(f"phase 16 took {seconds:.1f} s ({cli['seconds']:.1f} s of CLIs "
          f"inside phase 15's directory)  [{card}]")
    return {"launches": {k: launches[k] + cli["launches"][k]
                         for k in launches}}


ODE_TOLS = ((1e-7, 1e-9), (1e-5, 1e-7), (1e-3, 1e-6))


def busy_ms(fn) -> tuple:
    """(device busy ms, kernel launches) of one call of ``fn`` from the
    profiler; busy None when the trace holds no device time."""
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    us = sum(e.self_device_time_total for e in kernels)
    return (us / 1e3 if us > 0 else None), sum(e.count for e in kernels)


def idle_text(busy, ms) -> str:
    return ("idle share not measured (no device time in the trace)"
            if busy is None else f"idle share {1 - busy / ms:.3f}")


def ode_phase(dev, card, counts, reset, nba_files) -> dict:
    """Phase 17: the adaptive and adjoint ODE encoder, learn_prior and
    encoder-layer dropout at full width. (a) dopri5's accounting on the
    NBA trunk field (one layer at d 64, 8 heads, ff 1024, the port's seeded
    init, input [32, 11, 1, 64]) at three tolerance pairs on the kernel
    route (P), the plain route and the CPU; (b) one training step at
    B = 32 x 11 on both routes with the same noise: dopri5 + adjoint and
    dopri5 + scan budget 24, both at 1e-5 / 1e-7 (a dopri5 step's time is
    its forward + backward: the scan budget's timed rounds and the solve
    under TF32 were cut for the smoke's time limit), learn_prior on euler
    (timed); (c) dropout 0.1; (d) the CLIs
    (``cli.train --ode_method dopri5 --ode_adjoint``, a resume,
    ``cli.test``, ``cli.trainvae``); (e) a dopri5 server. Returns the
    launches of its main paths."""
    import warnings
    from sttode_tpu_torch import bridge
    from sttode_tpu_torch.cli import test as cli_test
    from sttode_tpu_torch.cli import train as cli_train
    from sttode_tpu_torch.cli import trainvae as cli_trainvae
    from sttode_tpu_torch.data.preprocess import prepare_scene_group
    from sttode_tpu_torch.data.synthetic import make_social_scenes
    from sttode_tpu_torch.kernels import select_decode as ks
    from sttode_tpu_torch.models import sttode as tm
    from sttode_tpu_torch.nn import transformer as ttr
    from sttode_tpu_torch.ode import odeint
    from sttode_tpu_torch.serving import Predictor
    from sttode_tpu_torch.train import make_train_step

    t_phase = time.perf_counter()
    total: dict = {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    # (a) the solver's own accounting on the trunk field
    cfg_nba = tm.STTODEConfig(past_length=5, future_length=10).validate()
    D, Z, K, M = cfg_nba.hidden_dim, cfg_nba.zdim, cfg_nba.sample_k, 32 * 11
    lcfg = cfg_nba.layer_cfg
    layers = ttr.encoder_stack_init(torch.Generator().manual_seed(17), lcfg,
                                    1)
    x = np.random.default_rng(17).standard_normal((32, 11, 1, D)) \
        .astype(np.float32)
    routes = {"kernel route": (lcfg, bridge.to_device(layers, dev),
                               torch.from_numpy(x).to(dev)),
              "plain route": (lcfg._replace(attn_impl="dense"),
                              bridge.to_device(layers, dev),
                              torch.from_numpy(x).to(dev)),
              "CPU": (lcfg._replace(attn_impl="dense"), layers,
                      torch.from_numpy(x))}

    def solve(route, rtol, atol, **kw):
        cfg, p, y = routes[route]
        return odeint(lambda t, y_, p_: ttr.encoder_stack(p_, y_, cfg), y,
                      torch.tensor([0.0, 12.0]), p, method="dopri5",
                      rtol=rtol, atol=atol, return_stats=True, **kw)

    def timed(route, rtol, atol):
        t = time.perf_counter()
        solve(route, rtol, atol)
        if route != "CPU":
            torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    findings = []
    with torch.no_grad(), warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*exhausted")
        for rtol, atol in ODE_TOLS:
            res = {}
            for route in routes:
                reset()
                ys, st = solve(route, rtol, atol)
                if route != "CPU":
                    torch.cuda.synchronize()
                res[route] = [ys[-1].cpu(), st, counts()["packed"]]
            ms = {r: [] for r in routes}
            for r in range(3):   # kernel, plain alternating
                for route in (("kernel route", "plain route") if r % 2 == 0
                              else ("plain route", "kernel route")):
                    ms[route].append(timed(route, rtol, atol))
            ms = {r: statistics.median(v) for r, v in ms.items() if v}
            ms["CPU"] = timed("CPU", rtol, atol)
            busy = {r: busy_ms(lambda r=r: solve(r, rtol, atol))[0]
                    for r in ("kernel route", "plain route")}
            st_k, st_p, st_c = (res[r][1] for r in routes)
            key = ("attempted_steps", "accepted_steps", "rhs_evals")
            require(all(st_p[k] == st_c[k] for k in key),
                    f"phase 17 at {rtol:g} / {atol:g}: the plain route's "
                    f"counts {st_p} differ from the CPU's {st_c}")
            y_p = res["plain route"][0]
            err = max_err(res["kernel route"][0], y_p)
            scale = max(1.0, float(y_p.abs().max()))
            if st_k["attempted_steps"] > st_p["attempted_steps"]:
                findings.append((rtol, atol, st_k, st_p))
            print(f"phase 17 dopri5 on the trunk field at rtol {rtol:g} / "
                  f"atol {atol:g}: " + "; ".join(
                      f"{r} {res[r][1]['attempted_steps']} attempted / "
                      f"{res[r][1]['accepted_steps']} accepted / "
                      f"{res[r][1]['rhs_evals']} RHS evaluations, "
                      f"{ms[r]:.3f} ms a solve, "
                      f"{ms[r] * 1e3 / res[r][1]['rhs_evals']:.1f} µs an "
                      f"evaluation, {res[r][2] / res[r][1]['rhs_evals']:.3f}"
                      f" P launches an evaluation"
                      + ("" if r == "CPU" else ", " + idle_text(busy[r],
                                                                ms[r]))
                      for r in routes)
                  + f"; kernel vs plain route max abs err {err:.3e} (max "
                  f"|y| {scale:.3f})  [{card}]")
            require(err <= 1e-4 * scale,
                    f"phase 17 at {rtol:g} / {atol:g}: the kernel route's "
                    f"solution differs by {err} > 1e-4 x {scale}")
        for rtol, atol, st_k, st_p in findings:
            print(f"phase 17 FINDING: at {rtol:g} / {atol:g} the kernel "
                  f"route took {st_k['attempted_steps']} attempts, the plain "
                  f"route {st_p['attempted_steps']}")

    # (b) one training step at the NBA recipe's B = 32 x 11 on both routes
    sc = make_social_scenes(32, agents_range=(11, 11), obs_len=5,
                            pred_len=10, seed=17)
    batch, _ = prepare_scene_group(
        np.stack([s_["obs"] for s_ in sc]),
        np.stack([s_["pred"] for s_ in sc]),
        np.ones((32, 11), np.float32), training=True,
        rng=np.random.default_rng(17))
    batch = batch.to(dev)
    gen = torch.Generator(device=dev).manual_seed(17)
    noise = tm.TrainNoise(
        torch.rand(M, 5, D, device=dev, generator=gen) >= 0.1,
        torch.rand(M, 10, D, device=dev, generator=gen) >= 0.1,
        torch.randn(M, Z, device=dev, generator=gen),
        torch.randn(M * K, Z, device=dev, generator=gen))
    f64 = torch.float64
    noise64 = noise._replace(eps_q=noise.eps_q.to(f64),
                             eps_p=noise.eps_p.to(f64))

    def plain(cfg):
        return cfg._replace(attn_impl="dense", select_impl="xla")

    def timed_fb(params, cfg, b, nz):
        t = time.perf_counter()
        _, out, g = forward_backward(params, cfg, b, nz, dev)
        torch.cuda.synchronize()
        return out, g, (time.perf_counter() - t) * 1e3

    steps_b = {}
    for label, cfg in (
            ("dopri5 + adjoint at 1e-5 / 1e-7", cfg_nba._replace(
                ode_method="dopri5", ode_adjoint=True, ode_rtol=1e-5,
                ode_atol=1e-7)),
            ("dopri5 + scan budget 24 at 1e-5 / 1e-7", cfg_nba._replace(
                ode_method="dopri5", ode_rtol=1e-5, ode_atol=1e-7,
                ode_scan_budget=24)),
            ("learn_prior on euler", cfg_nba._replace(learn_prior=True))):
        cfg = cfg.validate()
        params = tm.sttode_init(17, cfg)
        with warnings.catch_warnings():
            warnings.filterwarnings("error", message=".*exhausted")
            reset()   # the main path: one training step, kernel route
            dist0 = ks.select_decode.launches_by_mode["dist"]
            out_k, g_k, ms_k = timed_fb(params, cfg, batch, noise)
            launches = counts()
            dist = ks.select_decode.launches_by_mode["dist"] - dist0
            add(launches)
            out_p, g_p, ms_p = timed_fb(params, plain(cfg), batch, noise)
            if cfg.ode_method == "dopri5":
                # the float64 plain route, the reference for the gradients
                _, g_o, ms_o = timed_fb(
                    bridge.tree_map(lambda t: t.to(f64), params),
                    plain(cfg), batch.to(f64), noise64)
        require(launches["packed"] > 0 and launches["packed_bwd"] > 0
                and launches["select_fp32"] > 0 and dist > 0,
                f"phase 17 {label}: the step did not launch P, Q and kernel "
                f"B 'dist' {nonzero(launches)}")
        if cfg.ode_method == "euler":
            loss_err, grad_ratio, worst, _ = compare_routes(
                out_k, g_k, out_p, g_p, f"phase 17 {label}")
            detail = (f"gradients within {grad_ratio:.3e} of each leaf's "
                      f"largest magnitude (worst leaf {worst})")
        else:
            # dopri5's gradients pass through a step-size controller whose
            # error ratio fp32 rounding sets (the embedded pair cancels), so
            # no fp32 route is within TRAIN_TOL of the exact gradient: the
            # kernel route is held, as phase 16 holds q_A, within 3x the
            # fp32 plain route's distance to the float64 plain route
            loss_err = 0.0
            for name in ("total_loss", "loss_pred", "loss_recover",
                         "loss_kl", "loss_diverse"):
                a = float(getattr(out_k, name).detach())
                b = float(getattr(out_p, name).detach())
                require(abs(a - b) <= TRAIN_TOL * max(1.0, abs(b)),
                        f"phase 17 {label} {name}: {a} vs plain {b}")
                loss_err = max(loss_err, abs(a - b) / max(1.0, abs(b)))
            worst = {}
            for key, gs, ref in (("routes", g_k, g_p), ("kernel", g_k, g_o),
                                 ("plain", g_p, g_o)):
                require(all(bool(torch.isfinite(a).all()) for a in gs),
                        f"phase 17 {label}: a non-finite gradient")
                worst[key] = max(float((a.to(r.dtype) - r).abs().max())
                                 / max(float(r.abs().max()), 1e-30)
                                 for a, r in zip(gs, ref))
            require(worst["kernel"] <= 3 * worst["plain"],
                    f"phase 17 {label}: against the float64 plain route the "
                    f"kernel route's worst leaf differs by "
                    f"{worst['kernel']:.3e}, the fp32 plain route's by "
                    f"{worst['plain']:.3e}")
            detail = (f"gradients between the routes within "
                      f"{worst['routes']:.3e} of a leaf's largest magnitude; "
                      f"against the float64 plain route ({ms_o:.1f} ms) the "
                      f"kernel route's worst leaf {worst['kernel']:.3e}, the "
                      f"fp32 plain route's {worst['plain']:.3e}")
        steps_b[label] = (cfg, params, ms_k, ms_p)
        print(f"phase 17 {label}, forward + backward at B = 32 x 11: loss "
              f"terms within {loss_err:.3e} (relative); {detail}; kernel "
              f"route {ms_k:.1f} ms, plain {ms_p:.1f} ms; the kernel route's "
              f"launches {nonzero(launches)}  [{card}]")
    for label, (cfg, params, ms_k, ms_p) in steps_b.items():
        if cfg.ode_method == "dopri5":
            # the forward + backward above is a dopri5 step's time: the
            # adjoint's launches some 10^6 kernels, beyond what one profiler
            # trace holds, and the scan budget's timed rounds were cut for
            # the smoke's time limit
            print(f"phase 17 {label} step, kernel route: {ms_k:.1f} "
                  f"ms/step, {32e3 / ms_k:.2f} train scenes/s; plain route "
                  f"{ms_p:.1f} ms/step, {32e3 / ms_p:.2f} train scenes/s "
                  f"(one forward + backward each; kernels a step and idle "
                  f"share not measured)  [{card}]")
            continue
        step_k = make_train_step(cfg, 1e-4, device=dev)
        step_p = make_train_step(plain(cfg), 1e-4, device=dev)
        step_times([[step_k, *step_k.init(params)],
                    [step_p, *step_p.init(params)]], batch, gen, 32,
                   f"phase 17 {label} step at B = 32", card, rounds=2,
                   steps=5)

    # (c) dropout 0.1 on the euler recipe: no attention kernel, the plain
    #     path's weight dropout; a forced kernel refuses
    cfg_d = cfg_nba._replace(dropout=0.1).validate()
    step_d = make_train_step(cfg_d, 1e-4, device=dev)
    pd_, od_ = step_d.init(tm.sttode_init(17, cfg_d))
    reset()   # the main path: one training step with dropout
    _, _, metrics_d = step_d(pd_, od_, batch, gen)
    torch.cuda.synchronize()
    launches_d = counts()
    add(launches_d)
    attn_kernels = {k: launches_d[k] for k in (
        "attn", "attn_bwd", "packed", "packed_bwd", "flash", "flash_dq",
        "flash_dkv")}
    require(not any(attn_kernels.values())
            and launches_d["select_fp32"] > 0,
            f"phase 17 dropout: the step launched an attention kernel or no "
            f"kernel B {nonzero(launches_d)}")
    require(all(bool(torch.isfinite(v)) for v in metrics_d.values()),
            f"phase 17 dropout: non-finite losses {metrics_d}")
    try:
        tm.sttode_forward(bridge.to_device(tm.sttode_init(17, cfg_d), dev),
                          cfg_d._replace(attn_impl="packed"), batch,
                          generator=gen)
        refused = ""
    except ValueError as e:
        refused = str(e)
    require("does not implement attention dropout" in refused,
            f"phase 17 dropout: attn_impl='packed' was not refused "
            f"({refused!r})")
    print(f"phase 17 dropout 0.1, euler NBA step at B = 32: no attention "
          f"kernel launched, kernel B {launches_d['select_fp32']}; losses "
          + " ".join(f"{k} {float(v):.4f}" for k, v in metrics_d.items())
          + f"; attn_impl='packed' refused: {refused!r}")

    # (d) the CLIs on synthetic NBA files: dopri5 + adjoint (train, resume,
    #     evaluate) and the VAE-only trainer
    ode_flags = ["--ode_method", "dopri5", "--ode_adjoint", "--ode_rtol",
                 "1e-3", "--ode_atol", "1e-6", "--select_impl", "auto"]
    with tempfile.TemporaryDirectory(dir=HERE, prefix=".smoke_nba_") as tmp:
        _, flags = nba_files(tmp, 64, 17)
        t = time.perf_counter()
        reset()   # the main path: train, resume, evaluate
        run = cli_train.main(flags + ode_flags + ["--num_epochs", "1"])
        resumed = cli_train.main(flags + ode_flags + [
            "--num_epochs", "2", "--epoch_continue", "1"])
        torch.cuda.synchronize()
        launches_train = counts()
        best = cli_test.main(flags)
        torch.cuda.synchronize()
        launches_cli = counts()
        cli_s = time.perf_counter() - t
        add(launches_cli)
        reset()   # the main path: the VAE-only trainer
        vae = cli_trainvae.main(flags + ["--ckpt_dir",
                                         os.path.join(tmp, "vae"),
                                         "--num_epochs", "1"])
        torch.cuda.synchronize()
        launches_vae = counts()
        add(launches_vae)
    require(launches_train["packed"] > 0 and launches_train["packed_bwd"] > 0
            and launches_train["select_fp32"] > 0,
            f"phase 17: the dopri5 adjoint CLI training did not launch P, Q "
            f"and kernel B {nonzero(launches_train)}")
    require(launches_cli["attn"] > launches_train["attn"],
            f"phase 17: evaluation at B = 128 did not launch kernel A "
            f"{nonzero(launches_cli)}")
    require(run.cfg.ode_method == "dopri5" and run.cfg.ode_adjoint
            and resumed.start_epoch == 1
            and all(int(st_["step"]) == 4 for st_ in
                    resumed.opt.state_dict()["state"].values()),
            "phase 17: the dopri5 CLI run did not resume its epoch and Adam "
            "state")
    for r in (run, resumed, vae):
        for epoch, lr, means in r.history:
            require(all(np.isfinite(list(means.values()))),
                    f"phase 17: non-finite loss at epoch {epoch}: {means}")
    require(vae.cfg.loss_terms == ("pred", "recover", "kl")
            and launches_vae["packed"] > 0
            and launches_vae["select_fp32"] == 0,
            f"phase 17: cli.trainvae {vae.cfg.loss_terms} "
            f"{nonzero(launches_vae)}")
    table = best["table"]
    require(table is not None and all(np.isfinite(list(table[k].values()))
                                      .all() for k in ("ade", "fde")),
            f"phase 17: the dopri5 horizon table is not finite: {best}")
    print(f"phase 17 dopri5 + adjoint NBA recipe through the CLIs "
          f"(--ode_rtol 1e-3 --ode_atol 1e-6, 2 steps an epoch): epochs "
          + "; ".join(f"{e} total {m['total']:.4f}"
                      for e, _, m in run.history + resumed.history)
          + f"; resumed from epoch {resumed.start_epoch}; cli.test best "
          f"epoch {best['epoch']}: "
          + " ".join(f"ADE@{h} {v:.4f}" for h, v in table["ade"].items())
          + f"; {cli_s:.1f} s; launches {nonzero(launches_cli)}; "
          f"cli.trainvae: total {vae.history[0][2]['total']:.4f}, launches "
          f"{nonzero(launches_vae)}")

    # (e) the dopri5 server, agent axis, 64 scenes x 8 agents a call, beside
    #     the euler server in the same rounds
    cfg_e = tm.STTODEConfig(compat="tpu", attn_axis="agent",
                            ode_method="dopri5").validate()
    params_e = tm.sttode_init(17, cfg_e)
    scenes = [s_["obs"] for s_ in make_social_scenes(
        64, agents_range=(8, 8), seed=17)]
    servers = (Predictor(params_e, cfg_e, device=dev, max_group=64),
               Predictor(params_e, plain(cfg_e), device=dev, max_group=64),
               Predictor(params_e, cfg_e._replace(ode_method="euler"),
                         device=dev, max_group=64))
    for srv in servers:
        srv.warmup([8], scenes_per=64)
    reset()   # the main path: serving
    (out_e, p50_e, rate_e), (ref_e, p50_ep, rate_ep), (_, p50_eu, rate_eu) \
        = serve_rounds(servers, scenes, 6)
    torch.cuda.synchronize()
    launches_e = counts()
    add(launches_e)
    require(launches_e["attn_masked"] > 0
            and launches_e["select_fp32"] > 0,
            f"phase 17: the dopri5 server did not launch A and kernel B "
            f"{nonzero(launches_e)}")
    err_e = compare(out_e, ref_e, [(cfg_e.sample_k, 8, 12, 2)] * 64,
                    "phase 17 server")
    print(f"phase 17 dopri5 agent-axis server (1e-7 / 1e-9), 64 scenes x 8 "
          f"agents/call: max_abs_err vs plain {err_e:.3e}; kernels p50 "
          f"{p50_e:.3f} ms, {rate_e:.1f} scenes/s; plain p50 {p50_ep:.3f} "
          f"ms, {rate_ep:.1f} scenes/s; the euler server in the same rounds "
          f"p50 {p50_eu:.3f} ms, {rate_eu:.1f} scenes/s; launches "
          f"{nonzero(launches_e)}  [{card}]")
    print(f"phase 17 took {time.perf_counter() - t_phase:.1f} s; its main "
          f"paths launched {nonzero(total)}")
    return {"launches": total}


def scan_cli(tmp, flags, n_train, counts, reset) -> dict:
    """Phase 18 (c), its CLIs in phase 15's directory, on its ETH CSVs:
    ``cli.train --dataset eth --scan_steps 16 --async_ckpt`` for 1 epoch
    and 1 resumed epoch (into their own checkpoint directory), then
    ``cli.trainsampler --scan_steps 16`` for 1 epoch on those checkpoints.
    Checks that the resumed run read the file the background save wrote
    and returns the launches, the resumed run's seconds and the line to
    print."""
    from sttode_tpu_torch.cli import train as cli_train
    from sttode_tpu_torch.cli import trainsampler as cli_trainsampler
    from sttode_tpu_torch.train import checkpoint_path, load_checkpoint

    t_cli = time.perf_counter()
    ck = os.path.join(tmp, "ck_scan")
    sflags = flags + ["--ckpt_dir", ck, "--scan_steps", "16", "--async_ckpt"]
    reset()   # the main path: train, resume, stage 2
    t = time.perf_counter()
    run = cli_train.main(sflags + ["--num_epochs", "1"])
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t
    path = checkpoint_path(os.path.join(ck, "eth"), 1)
    saved, _, epoch, _ = load_checkpoint(path)
    require(epoch == 1 and all(
        torch.equal(a.cpu(), b.detach().cpu()) for a, b in zip(
            _leaves(saved), _leaves(run.params))),
        "phase 18: the background-saved checkpoint is not the trained state")
    t = time.perf_counter()
    resumed = cli_train.main(sflags + ["--num_epochs", "2",
                                       "--epoch_continue", "1"])
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t
    require(resumed.start_epoch == 1 and all(
        int(st["step"]) == 2 * n_train
        for st in resumed.opt.state_dict()["state"].values()),
        "phase 18: the resumed run did not continue from the background-"
        "saved epoch")
    launches_train = counts()
    t = time.perf_counter()
    stage2 = cli_trainsampler.main(sflags + ["--num_epochs", "1",
                                             "--fix_epochs", "0"])
    torch.cuda.synchronize()
    stage2_s = time.perf_counter() - t
    launches = counts()
    require(launches_train["packed"] > 0 and launches_train["packed_bwd"] > 0
            and launches_train["select_fp32"] > 0
            and launches["packed"] > launches_train["packed"]
            and launches["packed_bwd"] == launches_train["packed_bwd"],
            f"phase 18: the scan_steps CLIs did not launch P, Q and kernel B "
            f"(stage 2: P alone): training {launches_train}, with stage 2 "
            f"{launches}")
    for r in (run, resumed, stage2):
        for e, _, means in r.history:
            require(all(np.isfinite(list(means.values()))),
                    f"phase 18: non-finite loss at epoch {e}: {means}")
    line = (
        f"phase 18 (c) cli.train --dataset eth --scan_steps 16 --async_ckpt "
        f"({n_train} train scenes, one a step; 16 a CUDA graph replay): "
        f"epochs " + "; ".join(f"{e} total {m['total']:.4f}"
                               for e, _, m in run.history + resumed.history)
        + f"; the first CLI run {first_s:.2f} s, the resumed one (read the "
        f"background-saved epoch 1) {resume_s:.2f} s end to end, "
        f"{n_train / resume_s:.2f} train steps/s; its graphs "
        f"{graphs(resumed.step)}; cli.trainsampler --scan_steps 16, 1 "
        f"epoch: {stage2_s:.2f} s, total "
        f"{stage2.history[0][2]['total']:.4f}, graphs "
        f"{graphs(stage2.step)}; launches {nonzero(launches)}")
    return {"launches": launches, "line": line, "resume_s": resume_s,
            "seconds": time.perf_counter() - t_cli}


def graphs(step) -> str:
    """A step's captures: S and pool MiB of each, capture seconds."""
    gs = list(step.graphs.values())
    return (f"{len(gs)} (S = "
            + ", ".join(f"{g.steps}: {g.pool_bytes / 2 ** 20:.1f} MiB"
                        for g in gs)
            + f"; captures {sum(g.capture_s for g in gs):.2f} s)")


def _leaves(tree):
    from sttode_tpu_torch import bridge
    return bridge.tree_leaves(tree)


def scan_phase(dev, card, counts, reset, cli: dict, eager_resume_s) -> dict:
    """Phase 18: ``scan_steps``, S optimizer steps as one CUDA graph replay.
    (a) the bench recipe (B = 128 × 11, bf16, kernel B): 48 eager steps
    against 3 calls of the S = 16 step (the first runs its chunk eagerly
    as the capture's warm-up, then 2 replays) from the same parameters
    with the same injected noise, then ``set_lr`` between replays (0, then
    3e-4) and kernel B's winners after the replays against a fresh
    packing; (b) the eager step (the plain Adam of a step built with
    scan_steps 1, and the graph's capturable Adam) against the graph's,
    alternating (ms/step, train scenes/s, idle share, capture s, pool
    bytes) and two profiled replays' kernels against the counters; (c)
    the stage-2 step at 1 × 16 (S = 16) and the scan-budget dopri5 step
    (budget 24, NBA 32 × 11, S = 2), each a warm-up chunk and one replay
    against eager steps, and ``cli`` (``scan_cli``'s result). Returns the
    launches of its main paths."""
    from sttode_tpu_torch import bridge
    from sttode_tpu_torch.data import scene_batches
    from sttode_tpu_torch.data.preprocess import prepare_scene_group
    from sttode_tpu_torch.data.synthetic import make_social_scenes
    from sttode_tpu_torch.kernels import select_decode as ks
    from sttode_tpu_torch.models import sampler as ts
    from sttode_tpu_torch.models import sttode as tm
    from sttode_tpu_torch.train import (make_sampler_train_step,
                                        make_train_step, set_lr,
                                        stack_batches, stack_noise)

    t_phase = time.perf_counter()
    S = 16
    total: dict = {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    def scene_group(B, N, T, seed):
        sc = make_social_scenes(B, agents_range=(N, N), obs_len=T[0],
                                pred_len=T[1], seed=seed)
        batch, _ = prepare_scene_group(
            np.stack([s["obs"] for s in sc]),
            np.stack([s["pred"] for s in sc]), np.ones((B, N), np.float32),
            training=True, rng=np.random.default_rng(seed))
        return batch.to(dev)

    def draws(cfg, M, gen):
        D, Z, K = cfg.hidden_dim, cfg.zdim, cfg.sample_k
        return tm.TrainNoise(
            torch.rand(M, cfg.past_length, D, device=dev, generator=gen)
            >= cfg.pe_dropout,
            torch.rand(M, cfg.future_length, D, device=dev, generator=gen)
            >= cfg.pe_dropout,
            torch.randn(M, Z, device=dev, generator=gen),
            torch.randn(M * K, Z, device=dev, generator=gen))

    def moments(opt):
        return [v for p in opt.param_groups[0]["params"]
                for k, v in opt.state.get(p, {}).items() if k != "step"]

    def pair(make, params, batches, noises, steps, what, lr=1e-4):
        """Eager single steps against ``len(batches) / steps`` calls of the
        step built with ``steps`` (the first its warm-up chunk, the others
        replays) from the same parameters and noise: each loss term within
        TRAIN_TOL × max(1, |loss|), each parameter leaf and Adam moment
        within TRAIN_TOL × its largest magnitude. The eager steps run on
        the graph's Adam form (capturable), so that both sides compute the
        same updates. The graph step is the main path: the counts are set
        to 0 just before it. Returns (the worst differences (losses,
        parameters, moments), its launches, the two routes)."""
        eager, graph = make(lr, 1), make(lr, steps)
        require(graph.mode == "graph", f"{what}: mode {graph.mode}")
        pe, oe = graph.init(params)
        pg, og = graph.init(params)
        gen = torch.Generator(device=dev).manual_seed(18)
        me = [eager(pe, oe, b, gen, noise=n)[2]
              for b, n in zip(batches, noises)]
        torch.cuda.synchronize()
        reset()   # the main path: the captured step
        mg = [graph(pg, og, stack_batches(batches[i:i + steps]), gen,
                    noise=stack_noise(noises[i:i + steps]))[2]
              for i in range(0, len(batches), steps)]
        torch.cuda.synchronize()
        launches = counts()
        add(launches)
        worst = compare_runs(me, mg, (pe, oe), (pg, og), what)
        return worst, launches, (eager, pe, oe), (graph, pg, og)

    def compare_runs(me, mg, run_e, run_g, what):
        loss = max(
            float((torch.stack([m[k] for m in me])
                   - torch.cat([m[k] for m in mg])).abs().max()
                  / max(1.0, float(torch.stack([m[k] for m in me])
                                   .abs().max())))
            for k in me[0])
        leaves = []
        for get in (lambda r: _leaves(r[0]), lambda r: moments(r[1])):
            worst = 0.0
            for a, b in zip(get(run_g), get(run_e)):
                worst = max(worst, float((a - b).abs().max()) / max(
                    float(b.abs().max()), 1e-30))
            leaves.append(worst)
        require(loss <= TRAIN_TOL and max(leaves) <= TRAIN_TOL,
                f"{what}: graph vs eager losses {loss:.3e}, parameters "
                f"{leaves[0]:.3e}, Adam moments {leaves[1]:.3e}")
        return loss, *leaves

    # (a) the bench recipe: 48 eager steps against the warm-up chunk and 2
    #     replays of S = 16
    cfg = tm.STTODEConfig(past_length=5, future_length=10,
                          select_dtype="bfloat16",
                          decode_dtype="bfloat16").validate()
    B, N = 128, 11
    M = B * N
    bs = [scene_group(B, N, (5, 10), 1800 + i) for i in range(3 * S)]
    gen = torch.Generator(device=dev).manual_seed(18)
    noises = [draws(cfg, M, gen) for _ in bs]
    p0 = tm.sttode_init(18, cfg)

    def make(lr, steps):
        return make_train_step(cfg, lr, device=dev, scan_steps=steps)

    worst_a, launches_a, (eager, pe, oe), (graph, pg, og) = pair(
        make, p0, bs, noises, S, "phase 18 (a) bench recipe")
    require(launches_a["attn"] > 0 and launches_a["attn_bwd"] > 0
            and launches_a["select_bf16"] > 0,
            f"phase 18 (a): the captured step launched no A, C or kernel B "
            f"bf16 {launches_a}")
    # set_lr between replays: at 0 the parameters stay, at 3e-4 both
    # routes move alike
    lr_worst = []
    for lr in (0.0, 3e-4):
        before = [t.detach().clone() for t in _leaves(pg)]
        set_lr(oe, lr)
        set_lr(og, lr)
        me = [eager(pe, oe, b, gen, noise=n)[2]
              for b, n in zip(bs[:S], noises[:S])]
        reset()   # the main path: a replay at the new rate
        mg = [graph(pg, og, stack_batches(bs[:S]), gen,
                    noise=stack_noise(noises[:S]))[2]]
        torch.cuda.synchronize()
        add(counts())
        lr_worst.append(compare_runs(me, mg, (pe, oe), (pg, og),
                                     f"phase 18 (a) after set_lr({lr})"))
        still = all(torch.equal(a, b) for a, b in zip(_leaves(pg), before))
        require(still == (lr == 0.0),
                f"phase 18 (a): after set_lr({lr}) a replay "
                f"{'moved' if still is False else 'kept'} the parameters")
    # kernel B inside the replays packed the weights of each step: the
    # winners at the first and the last weights differ, and every replayed
    # loss equals the eager step's; an eager call after the replays packs
    # the weights they wrote (its cache is keyed on versions, which each
    # replay moves): its distances equal a fresh packing's
    with torch.inference_mode():
        def decode(p):
            pf = tm.encode_past(p, cfg, bs[0])
            z_km = noises[0].eps_p.reshape(M, 20, -1).transpose(0, 1)
            return ks.select_decode(
                p, pf, z_km, tm.decode_block0_state(p, bs[0].past),
                bs[0].past.reshape(M, -1),
                (bs[0].future - bs[0].cur_location).reshape(M, -1),
                dtype=torch.bfloat16)

        dists = [decode(bridge.to_device(p0, dev)), decode(pg)]
        ks._PACKED.clear()
        fresh = decode(pg)
        moved = int((dists[0].argmin(1) != dists[1].argmin(1)).sum())
    require(moved > 0, "phase 18 (a): kernel B's winners did not move with "
                       "the weights, so the replays do not test its packing")
    require(torch.equal(dists[1], fresh),
            "phase 18 (a): an eager kernel-B call after the replays used "
            "stale packed weights")
    print(f"phase 18 (a) bench recipe (B = 128 x 11, bf16, kernel B), 48 "
          f"eager steps vs the S = 16 step's warm-up chunk and 2 replays, "
          f"same noise and Adam form: loss terms within {worst_a[0]:.3e} "
          f"(relative), "
          f"parameters {worst_a[1]:.3e}, Adam moments {worst_a[2]:.3e} (of "
          f"each leaf's largest magnitude); set_lr(0) kept every parameter "
          f"through a replay, set_lr(3e-4) moved both alike (worst "
          f"{max(max(w) for w in lr_worst):.3e}); kernel B's winners at "
          f"the first and the last weights differ at {moved} of {M} rows, "
          f"and an eager call after the replays equals a fresh packing; "
          f"launches {nonzero(launches_a)}")

    # (b) times: eager S = 1 (a step built with scan_steps 1: the plain
    #     Adam; and on the graph's capturable Adam) against the graph at
    #     S = 16, alternating; two profiled replays' kernels against the
    #     counters
    stacked = stack_batches(bs[:S])
    graph(pg, og, stacked, gen)          # its warm-up chunk and capture
    torch.cuda.synchronize()
    timed = graph.graphs[list(graph.graphs)[-1]]
    pp, op = eager.init(pg)              # the plain Adam: S = 1's own
    eager(pp, op, bs[0], gen)
    order = ("eager", "capturable", "graph")
    step_ms: dict = {name: [] for name in order}
    for r in range(6):
        for name in (order if r % 2 == 0 else order[::-1]):
            torch.cuda.synchronize()
            t = time.perf_counter()
            if name == "eager":
                for b in bs[:S]:
                    eager(pp, op, b, gen)
            elif name == "capturable":
                for b in bs[:S]:
                    eager(pe, oe, b, gen)
            else:
                graph(pg, og, stacked, gen)
            torch.cuda.synchronize()
            step_ms[name].append((time.perf_counter() - t) / S * 1e3)
    eager_ms = statistics.median(step_ms["eager"])
    cap_ms = statistics.median(step_ms["capturable"])
    graph_ms = statistics.median(step_ms["graph"])
    busy_e, n_e = busy_ms(lambda: [eager(pp, op, b, gen) for b in bs[:S]])
    # three replays under the profiler, the first its warm-up (a trace
    # that starts with the replay can miss its first kernels), the other
    # two traced: their kernels against the counters
    traces: list = []
    reset()   # the main path: the profiled replays
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA],
            schedule=torch.profiler.schedule(wait=0, warmup=1, active=2,
                                             repeat=1),
            on_trace_ready=lambda p: traces.append(p.key_averages())) as prof:
        for _ in range(3):
            graph(pg, og, stacked, gen)
            torch.cuda.synchronize()
            prof.step()
    three = counts()
    add(three)
    one = {k: v // 3 for k, v in three.items()}
    kernels = [e for e in (traces[0] if traces else [])
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy_g = sum(e.self_device_time_total for e in kernels) / 2e3
    seen = {label: sum(e.count for e in kernels if re.search(pat, e.key))
            for label, pat in (("attn", r"mhgsa_(?:small_)?fwd_kernel"),
                               ("attn_bwd", r"mhgsa_(?:small_)?bwd_kernel"),
                               ("select_bf16", r"select_main_kernel"))}
    traced = sum(seen.values()) > 0
    require(not traced or all(seen[k] == 2 * one[k] for k in seen),
            f"phase 18 (b): the two traced replays' kernels {seen} differ "
            f"from twice the counters' {nonzero(one)} a replay")
    idle_e = "not measured" if busy_e is None else \
        f"{1 - busy_e / S / eager_ms:.3f}"
    idle_g = "not measured" if busy_g <= 0 else \
        f"{1 - busy_g / S / graph_ms:.3f}"
    print(f"phase 18 (b) bench recipe step, eager (1 step a call, plain "
          f"Adam): {eager_ms:.3f} ms/step, {B * 1e3 / eager_ms:.1f} train "
          f"scenes/s, idle share {idle_e} ({n_e / S:.0f} kernels/step); "
          f"eager on the capturable Adam: {cap_ms:.3f} ms/step; "
          f"captured (S = 16, one replay a call): {graph_ms:.3f} ms/step, "
          f"{B * 1e3 / graph_ms:.1f} train scenes/s, idle share {idle_g} "
          f"({sum(e.count for e in kernels) / 2 / S:.0f} kernels/step); "
          f"its capture {timed.capture_s:.3f} s (after its warm-up chunk, "
          f"16 eager steps), graph pool {timed.pool_bytes / 2 ** 20:.1f} "
          f"MiB ({timed.pool_bytes} bytes); two traced replays: "
          + (f"A, C, B launches {seen}, twice the counters' a replay"
             if traced else "the trace holds no kernel names (counters "
             f"{nonzero(one)})") + f"  [{card}]")
    del bs, noises, stacked, pp, op

    # (c) the stage-2 step at 1 x 16 and the scan-budget dopri5 step
    scfg = ts.SamplerConfig()
    cfg2 = tm.STTODEConfig().validate()
    net = tm.sttode_init(19, cfg2)
    eth = [b.to(dev) for b, _ in scene_batches(
        make_social_scenes(2 * S, agents_range=(12, 12), seed=19),
        training=True, rng=np.random.default_rng(19))]
    require({(b.batch_size, b.agent_num) for b in eth} == {(1, 16)},
            "phase 18 (c): the ETH batches are not 1 x 16")
    t = time.perf_counter()
    worst_2, launches_2, _, (g2, _, _) = pair(
        lambda lr, steps: make_sampler_train_step(
            cfg2, scfg, lr, net, device=dev, scan_steps=steps),
        ts.sampler_init(19, scfg, pred_model_dim=cfg2.hidden_dim,
                        past_feature_dim=2 * cfg2.hidden_dim),
        eth, [None] * len(eth), S,
        "phase 18 (c) stage 2")
    s2_s = time.perf_counter() - t
    require(launches_2["packed"] > 0 and launches_2["packed_bwd"] == 0,
            f"phase 18 (c): the stage-2 step did not run on P alone "
            f"{launches_2}")
    cfg_d = tm.STTODEConfig(past_length=5, future_length=10,
                            ode_method="dopri5", ode_scan_budget=24,
                            ode_rtol=1e-5, ode_atol=1e-7,
                            select_impl="auto").validate()
    nba = [scene_group(32, 11, (5, 10), 1900 + i) for i in range(4)]
    gen = torch.Generator(device=dev).manual_seed(19)
    t = time.perf_counter()
    worst_d, launches_d, _, (gd, _, _) = pair(
        lambda lr, steps: make_train_step(cfg_d, lr, device=dev,
                                          scan_steps=steps),
        tm.sttode_init(19, cfg_d), nba, [draws(cfg_d, 352, gen)
                                         for _ in nba], 2,
        "phase 18 (c) dopri5 scan budget 24")
    d_s = time.perf_counter() - t
    require(launches_d["packed"] > 0 and launches_d["packed_bwd"] > 0
            and launches_d["select_fp32"] > 0,
            f"phase 18 (c): the dopri5 step did not launch P, Q and kernel B "
            f"{launches_d}")
    while_mode = make_train_step(cfg_d._replace(ode_scan_budget=0,
                                                ode_adjoint=True), 1e-4,
                                 device=dev, scan_steps=S).mode
    require(while_mode == "eager",
            f"phase 18 (c): the while form's step mode is {while_mode}")
    s2, sd = g2.graph_stats(), gd.graph_stats()
    print(f"phase 18 (c) stage-2 step at 1 x 16 (S = 16): graph vs eager "
          f"losses {worst_2[0]:.3e}, sampler parameters {worst_2[1]:.3e}, "
          f"moments {worst_2[2]:.3e}; capture {s2['capture_s']:.3f} s, pool "
          f"{s2['pool_bytes'] / 2 ** 20:.1f} MiB ({s2_s:.1f} s with the "
          f"eager steps); dopri5 scan budget 24 (1e-5 / 1e-7) at 32 x 11, "
          f"S = 2: losses {worst_d[0]:.3e}, parameters {worst_d[1]:.3e}, "
          f"moments {worst_d[2]:.3e}; capture {sd['capture_s']:.3f} s, pool "
          f"{sd['pool_bytes'] / 2 ** 20:.1f} MiB ({d_s:.1f} s); the while "
          f"form's step: mode {while_mode}")
    print(cli["line"] + f"; phase 15's eager resumed run {eager_resume_s:.2f}"
          f" s  [{card}]")
    add(cli["launches"])
    print(f"phase 18 took {time.perf_counter() - t_phase + cli['seconds']:.1f}"
          f" s ({cli['seconds']:.1f} s of CLIs inside phase 15's directory)"
          f"  [{card}]")
    return {"launches": total}


# (route, tgt L, memory L_mem, kinks): phase 19 (a)'s decoder cases. The
# square cross (128 / 128) runs in quirk Q3's swapped orientation; at
# 256 x 2304 (2,816 rows into the FFN's 1,024 ReLUs) a ReLU whose input
# lies within rounding of 0 can switch between the routes
DECODER_CASES = (("packed", 32, 24, False), ("fused", 128, 96, False),
                 ("fused", 128, 128, False), ("flash", 256, 2304, True))
ROUTE_KERNELS = {"packed": ("packed", "packed_bwd"),
                 "fused": ("attn", "attn_bwd"),
                 "flash": ("flash", "flash_dq", "flash_dkv")}


def decoder_phase(dev, card, counts, reset, nba_files) -> dict:
    """Phase 19: the decoder side and the last training options at full
    width (d_model 64, 8 heads, ff 1024, one layer, reference compat,
    time 12, the port's seeded init, numpy-seeded tokens [L, 11, 1, 64]).
    (a) ``decoder_stack`` on each forced kernel route against the plain
    route, forward and backward (outputs, every decoder leaf's gradient,
    tgt's and memory's; None weights; the launch counters), and
    ``ode_decoder`` on fused; (b) ``mhgsa`` with ``bias_kv``,
    ``add_zero_attn`` and both on packed and fused; (c) ``cli.train
    --supervise --profile_dir`` and ``cli.trainvae --supervise`` on NBA
    files; (d) a rollback under a captured step; (e) ``time_fn``. Returns
    the launches of its main paths."""
    from sttode_tpu_torch import bridge
    from sttode_tpu_torch.cli import train as cli_train
    from sttode_tpu_torch.cli import trainvae as cli_trainvae
    from sttode_tpu_torch.data.preprocess import prepare_scene_group
    from sttode_tpu_torch.data.synthetic import make_social_scenes
    from sttode_tpu_torch.models import sttode as tm
    from sttode_tpu_torch.nn import attention as tattn
    from sttode_tpu_torch.nn import ode_block as tode
    from sttode_tpu_torch.nn import transformer as ttr
    from sttode_tpu_torch.train import (checkpoint_epochs, checkpoint_path,
                                        load_checkpoint, make_train_step,
                                        set_lr, stack_batches, stack_noise)
    from sttode_tpu_torch.train.supervisor import Supervisor
    from sttode_tpu_torch.utils.profiling import time_fn

    t_phase = time.perf_counter()
    total: dict = {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    # (a) the decoder stack (and ode_decoder) on each forced route
    lcfg = ttr.LayerConfig(d_model=64, num_heads=8, ff_dim=1024)
    layers = bridge.to_device(ttr.decoder_stack_init(
        torch.Generator().manual_seed(19), lcfg, 1), dev)
    rng = np.random.default_rng(19)

    def tokens(L):
        return torch.from_numpy(rng.standard_normal((L, 11, 1, 64))
                                .astype(np.float32)).to(dev)

    def stack(p, x, m, cfg):
        out, sw, cw = ttr.decoder_stack(p, x, m, cfg)
        return out, (sw, cw)

    def ode(p, x, m, cfg):
        out, w = tode.ode_decoder(p, x, m, cfg, time=12.0)
        return out, (w["self"], w["cross"])

    def forward_backward(fn, cfg, x, m, cot):
        """(out, weights, gradients of every decoder leaf, tgt and memory)
        on fresh trainable copies."""
        p = bridge.tree_map(lambda t: t.detach().clone().requires_grad_(),
                            layers)
        x, m = x.clone().requires_grad_(), m.clone().requires_grad_()
        out, w = fn(p, x, m, cfg)
        (out * cot).sum().backward()
        return out.detach(), w, [t.grad for t in bridge.tree_leaves(p)] + [
            x.grad, m.grad]

    cases = [(f"decoder_stack {r} tgt {L} memory {Lm}", stack, r, L, Lm, kk)
             for r, L, Lm, kk in DECODER_CASES] + [
        ("ode_decoder fused tgt 128 memory 96", ode, "fused", 128, 96, False)]
    for label, fn, route, L, Lm, kinks in cases:
        cfg_k, cfg_p = lcfg._replace(attn_impl=route), lcfg._replace(
            attn_impl="dense")
        x, m, cot = tokens(L), tokens(Lm), tokens(L)
        reset()   # the main path: the decoder's forward and backward
        out_k, w_k, g_k = forward_backward(fn, cfg_k, x, m, cot)
        torch.cuda.synchronize()
        launches = counts()
        add(launches)
        out_p, w_p, g_p = forward_backward(fn, cfg_p, x, m, cot)
        require(all(launches[k] > 0 for k in ROUTE_KERNELS[route]),
                f"phase 19 (a) {label}: the route did not launch its "
                f"kernels {nonzero(launches)}")
        require(w_k == (None, None) and w_p[0].shape == (11, L, L)
                and w_p[1].shape == (11, L, Lm),
                f"phase 19 (a) {label}: weights on the kernel route or "
                f"missing on the plain one")
        err = max_err(out_k, out_p)
        require(bool(torch.isfinite(out_k).all()) and err <= MODEL_TOL,
                f"phase 19 (a) {label}: max abs err {err} > {MODEL_TOL}")
        ratio, worst, l2 = compare_grads(g_k, g_p, f"phase 19 (a) {label}",
                                         kinks=kinks)
        ms_k, ms_p = paired_ms(
            lambda: forward_backward(fn, cfg_k, x, m, cot),
            lambda: forward_backward(fn, cfg_p, x, m, cot),
            calls=3, rounds=4)
        print(f"phase 19 (a) {label}, {route} against the plain route, "
              f"forward + backward: out max abs err {err:.3e}; gradients "
              f"(every decoder leaf, tgt, memory) within {ratio:.3e} of a "
              f"leaf's largest magnitude (worst leaf {worst}, relative L2 "
              f"{l2:.3e}{', kinks rule' if kinks else ''}); weights None; "
              f"{ms_k:.3f} ms, plain {ms_p:.3f} ms; launches "
              f"{nonzero(launches)}  [{card}]")

    # (b) mhgsa with bias_kv / add_zero_attn: an appended key makes a square
    #     reference-compat self-attention S = L + 1 (or + 2), unswapped
    gen = torch.Generator().manual_seed(19)
    mp = tattn.mhgsa_init(gen, 64)
    mp = bridge.to_device(mp._replace(
        in_proj_b=0.1 * torch.randn(192, generator=gen),
        out_proj_b=0.1 * torch.randn(64, generator=gen)), dev)
    bias = tuple(torch.randn(64, generator=gen).to(dev) for _ in range(2))
    for route, L in (("packed", 16), ("fused", 128)):
        x0 = torch.from_numpy(rng.standard_normal((11, L, 64)).astype(
            np.float32)).to(dev)
        cot = torch.from_numpy(rng.standard_normal((11, L, 64)).astype(
            np.float32)).to(dev)
        results = []
        for use_bias, zero in ((False, False), (True, False), (False, True),
                               (True, True)):
            def attend(fused, compat="reference"):
                p = bridge.tree_map(
                    lambda t: t.detach().clone().requires_grad_(), mp)
                b = tuple(t.detach().clone().requires_grad_() for t in bias)
                x = x0.clone().requires_grad_()
                out, _ = tattn.mhgsa(p, x, x, x, 8, compat=compat,
                                     fused=fused,
                                     bias_kv=b if use_bias else None,
                                     add_zero_attn=zero)
                (out * cot).sum().backward()
                return out.detach(), [t.grad for t in bridge.tree_leaves(
                    p)] + ([t.grad for t in b] if use_bias else []) + [x.grad]

            S = L + int(use_bias) + int(zero)
            reset()   # the main path: the attention's forward and backward
            out_k, g_k = attend(True if route == "fused" else "packed")
            torch.cuda.synchronize()
            launches = counts()
            add(launches)
            out_p, g_p = attend(False)
            out_t, _ = attend(False, compat="tpu")
            kern = ROUTE_KERNELS[route]
            require(all(launches[k] > 0 for k in kern),
                    f"phase 19 (b) {route} S = {S}: {nonzero(launches)}")
            err = max_err(out_k, out_p)
            require(err <= MODEL_TOL, f"phase 19 (b) {route} L = {L}, "
                    f"S = {S}: max abs err {err}")
            ratio, _, _ = compare_grads(g_k, g_p,
                                        f"phase 19 (b) {route} S = {S}")
            # the orientation, by result: square runs swapped (≠ compat
            # "tpu"), an appended key unswapped (= compat "tpu")
            swap_gap = max_err(out_p, out_t)
            require((swap_gap > 1e-3) == (S == L),
                    f"phase 19 (b) {route} L = {L}, S = {S}: the plain "
                    f"route's reference and tpu orientations differ by "
                    f"{swap_gap}")
            results.append(f"S = {S} ({'swapped' if S == L else 'unswapped'}"
                           f"; reference vs tpu orientation {swap_gap:.2e})"
                           f" out {err:.2e}, gradients {ratio:.2e}")
        print(f"phase 19 (b) mhgsa on {route}, query [11, {L}, 64], without "
              f"the options, bias_kv, add_zero_attn, both, against the "
              f"plain route: " + "; ".join(results) + f"  [{card}]")

    # (c) the CLIs with --supervise and --profile_dir on NBA files
    with tempfile.TemporaryDirectory(dir=HERE, prefix=".smoke_nba_") as tmp:
        _, flags = nba_files(tmp, 20 * 32, 19)
        prof_dir = os.path.join(tmp, "prof")
        epoch0: dict = {}
        real_epoch = cli_train.train_epoch

        def first_epoch_counted(*a, **kw):
            out = real_epoch(*a, **kw)
            if not epoch0:
                torch.cuda.synchronize()
                epoch0.update(counts())
            return out

        cli_train.train_epoch = first_epoch_counted
        t = time.perf_counter()
        try:
            reset()   # the main path: the supervised, profiled run
            run = cli_train.main(flags + [
                "--supervise", "--profile_dir", prof_dir, "--select_impl",
                "auto", "--num_epochs", "2"])
            torch.cuda.synchronize()
            launches_cli = counts()
            add(launches_cli)
            reset()   # the main path: the supervised VAE-only run
            vae = cli_trainvae.main(flags + [
                "--supervise", "--ckpt_dir", os.path.join(tmp, "vae"),
                "--num_epochs", "1"])
            torch.cuda.synchronize()
            launches_vae = counts()
            add(launches_vae)
        finally:
            cli_train.train_epoch = real_epoch
        cli_s = time.perf_counter() - t
        ck = checkpoint_epochs(os.path.join(tmp, "ck", "nba"))
        ck_vae = checkpoint_epochs(os.path.join(tmp, "vae", "nba"))
        files = os.listdir(prof_dir)
        require(len(files) == 1 and files[0].endswith(".pt.trace.json"),
                f"phase 19 (c): the trace directory holds {files}")
        trace_mb = os.path.getsize(os.path.join(prof_dir, files[0])) / 2**20
        with open(os.path.join(prof_dir, files[0])) as f:
            names = {e.get("name", "") for e in json.load(f)["traceEvents"]
                     if e.get("cat") == "kernel"}
    in_trace = {label for label, pat in TRACE_KERNELS
                if any(re.search(pat, n) for n in names)}
    want = {"packed": "P", "packed_bwd": "Q", "select_fp32": "B_fp32"}
    require(all(epoch0.get(k, 0) > 0 for k in want),
            f"phase 19 (c): epoch 0 did not launch P, Q and kernel B fp32 "
            f"{nonzero(epoch0)}")
    missing = {want.get(k, k) for k, v in epoch0.items()
               if v > 0 and k in want and want[k] not in in_trace}
    require(not missing and all(epoch0.get(k, 0) == 0 for k in (
        "attn", "attn_bwd", "flash", "flash_dq", "flash_dkv", "select_bf16")),
            f"phase 19 (c): the trace of epoch 0 lacks {missing} (launch "
            f"counters {nonzero(epoch0)}, trace {sorted(in_trace)})")
    require(ck == [1, 2] and ck_vae == [1] and [h[0] for h in run.history]
            == [0, 1] and vae.cfg.loss_terms == ("pred", "recover", "kl"),
            f"phase 19 (c): supervisor checkpoints {ck} / {ck_vae}, epochs "
            f"{[h[0] for h in run.history]}")
    for r in (run, vae):
        for epoch, _, means in r.history:
            require(all(np.isfinite(list(means.values()))),
                    f"phase 19 (c): non-finite loss at epoch {epoch}")
    print(f"phase 19 (c) cli.train --supervise --profile_dir --select_impl "
          f"auto (NBA, 20 steps an epoch, 2 epochs) and cli.trainvae "
          f"--supervise (1 epoch): supervisor checkpoints {ck} and {ck_vae}; "
          f"the trace of epoch 0 ({trace_mb:.1f} MiB) names "
          f"{sorted(in_trace)}, the counters saw {nonzero(epoch0)} in epoch "
          f"0; {cli_s:.1f} s; launches {nonzero(launches_cli)}, trainvae "
          f"{nonzero(launches_vae)}  [{card}]")

    # (d) a rollback under a captured step (scan_steps 4, NBA recipe at
    #     B = 32 x 11, kernel B fp32): the replay after the rollback goes on
    #     from the last-good checkpoint, equal bit for bit to an eager chunk
    #     from it with the same noise and Adam form
    cfg_r = tm.STTODEConfig(past_length=5, future_length=10,
                            select_impl="auto").validate()
    S_ = 4
    gen_r = torch.Generator(device=dev).manual_seed(19)
    batches, noises = [], []
    for i in range(4 * S_):
        sc = make_social_scenes(32, agents_range=(11, 11), obs_len=5,
                                pred_len=10, seed=190 + i)
        b, _ = prepare_scene_group(
            np.stack([s_["obs"] for s_ in sc]),
            np.stack([s_["pred"] for s_ in sc]), np.ones((32, 11),
                                                         np.float32),
            training=True, rng=np.random.default_rng(190 + i))
        batches.append(b.to(dev))
        M = 32 * 11
        noises.append(tm.TrainNoise(
            torch.rand(M, 5, 64, device=dev, generator=gen_r) >= 0.1,
            torch.rand(M, 10, 64, device=dev, generator=gen_r) >= 0.1,
            torch.randn(M, 32, device=dev, generator=gen_r),
            torch.randn(M * 20, 32, device=dev, generator=gen_r)))
    step = make_train_step(cfg_r, 1e-4, device=dev, scan_steps=S_)
    require(step.mode == "graph", "phase 19 (d): the step is not captured")
    params, opt = step.init(tm.sttode_init(19, cfg_r))

    def chunk(i, p, o):
        sl = slice(i * S_, (i + 1) * S_)
        return step(p, o, stack_batches(batches[sl]), gen_r,
                    noise=stack_noise(noises[sl]))[2]

    with tempfile.TemporaryDirectory(dir=HERE, prefix=".smoke_sup_") as tmp:
        sup = Supervisor(tmp, cfg_r, save_every=1)
        reset()   # the main path: two epochs and a replay after a rollback
        m0, m1 = chunk(0, params, opt), chunk(1, params, opt)
        loss0 = float(torch.cat([m0["total"], m1["total"]]).mean())
        _, _, e0, a0 = sup.after_epoch(0, loss0, params, opt)
        with torch.no_grad():
            bridge.tree_leaves(params)[0].view(-1)[0] = float("nan")
        m2 = chunk(2, params, opt)
        loss1 = float(m2["total"].mean())
        _, _, e1, a1 = sup.after_epoch(1, loss1, params, opt)
        saved_p, saved_o, _, _ = load_checkpoint(checkpoint_path(tmp, 1))
        restored = all(torch.equal(a.detach().cpu(), b) for a, b in zip(
            bridge.tree_leaves(params), bridge.tree_leaves(saved_p)))
        moments = all(
            torch.equal(opt.state[p][k].cpu(), saved_o["state"][i][k])
            for i, p in enumerate(opt.param_groups[0]["params"])
            for k in ("exp_avg", "exp_avg_sq", "step") if p in opt.state)
        set_lr(opt, 1e-4 * sup.lr_scale)
        m3 = chunk(3, params, opt)
        torch.cuda.synchronize()
        launches_r = counts()
        add(launches_r)
        stats = step.graph_stats()
        # the eager chunk from the checkpoint, on the graph's Adam form
        eager = make_train_step(cfg_r, 1e-4, device=dev)
        pe, oe = step.init(saved_p, saved_o)
        set_lr(oe, 1e-4 * 0.5)
        me = [eager(pe, oe, b, gen_r, noise=n)[2] for b, n in
              zip(batches[3 * S_:], noises[3 * S_:])]
        torch.cuda.synchronize()
    same_losses = all(torch.equal(m3[k], torch.stack([m[k] for m in me]))
                      for k in m3)
    same_params = all(torch.equal(a, b) for a, b in zip(
        bridge.tree_leaves(params), bridge.tree_leaves(pe)))
    require((a0, e0, a1, e1) == ("ok", 0, "rollback", 1)
            and math.isnan(loss1) and sup.lr_scale == 0.5,
            f"phase 19 (d): actions {(a0, e0, a1, e1)}, losses {loss0}, "
            f"{loss1}, lr_scale {sup.lr_scale}")
    require(restored and moments, "phase 19 (d): the parameters or Adam "
            "moments after the rollback differ from the checkpoint")
    require(same_losses and same_params and stats["graphs"] == 1
            and stats["replays"] == 3,
            f"phase 19 (d): the replay after the rollback differs from the "
            f"eager chunk from the checkpoint (losses equal {same_losses}, "
            f"parameters equal {same_params}; graphs {stats})")
    require(launches_r["packed"] > 0 and launches_r["packed_bwd"] > 0
            and launches_r["select_fp32"] > 0,
            f"phase 19 (d): {nonzero(launches_r)}")
    print(f"phase 19 (d) rollback under scan_steps {S_} (NBA recipe, B = 32 "
          f"x 11): epoch 0 ok (loss {loss0:.4f}), a NaN parameter → epoch 1 "
          f"loss {loss1} → rollback to epoch {e1}, lr_scale "
          f"{sup.lr_scale}; parameters and Adam moments equal the "
          f"checkpoint bit for bit; the next replay's losses "
          + " ".join(f"{float(v):.6f}" for v in m3["total"])
          + f" equal an eager chunk's from the checkpoint bit for bit, as do "
          f"the parameters after it; {stats['graphs']} graph, "
          f"{stats['replays']} replays (no recapture); launches "
          f"{nonzero(launches_r)}  [{card}]")

    # (e) time_fn on the fused decoder's forward, beside CUDA events
    x, m = tokens(128), tokens(96)
    cfg_f = lcfg._replace(attn_impl="fused")
    with torch.no_grad():
        fwd = lambda: ttr.decoder_stack(layers, x, m, cfg_f)[0]  # noqa: E731
        tf = time_fn(fwd, iters=20)
        ev_ms, _ = paired_ms(fwd, fwd, calls=20, rounds=4)
    print(f"phase 19 (e) time_fn on the fused decoder's forward (tgt 128, "
          f"memory 96): {tf['seconds_per_call'] * 1e3:.4f} ms a call; CUDA "
          f"events {ev_ms:.4f} ms  [{card}]")
    print(f"phase 19 took {time.perf_counter() - t_phase:.1f} s; its main "
          f"paths launched {nonzero(total)}")
    return {"launches": total}


def riemannian_phase(dev, card, counts, reset) -> dict:
    """Phase 20: the last single-process modules. (a) the NBA reference
    recipe's step (B = 32 × 11, scene axis, ``select_impl="auto"``, full
    width) with ``riemannian_sgd`` over the encoder layers' ``in_proj_w``,
    projected onto the oblique manifold first: 4 eager steps of the
    capturable form against one replay of the ``scan_steps=4`` step from
    the same parameters and noise, bit for bit; the marked rows unit-norm
    within 1e-5; P, Q and kernel B fp32 in the counters and in a trace
    of 20 replays; ms a step eager and captured. (b) every new module's
    public function on the card against the same function on the CPU on
    the same inputs (``card_vs_cpu``), gradients through
    ``to_poincare(riemannian=True)`` and ``hyp_linear`` among them. (c)
    δ-hyperbolicity at full size: ``batched_delta_hyp`` at the default
    batch_size 1500 (2 tries) and ``features_delta`` over the past
    encoder's features of NBA batches on the kernel route (sample 1500),
    each against float64 on the card and 400 of the points against the
    CPU; seconds and peak memory. Returns the launches of its main
    paths."""
    from sttode_tpu_torch import bridge
    from sttode_tpu_torch.data.preprocess import prepare_scene_group
    from sttode_tpu_torch.data.synthetic import make_social_scenes
    from sttode_tpu_torch.models import sttode as tm
    from sttode_tpu_torch.train import (make_train_step, stack_batches,
                                        stack_noise)
    from sttode_tpu_torch.train.riemannian import (RiemannianSGD,
                                                   flat_mask,
                                                   project_to_manifold,
                                                   riemannian_sgd)
    from sttode_tpu_torch.utils import delta as tdelta

    t_phase = time.perf_counter()
    total: dict = {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    # (a) the NBA recipe's step under riemannian_sgd, eager against captured
    cfg = tm.STTODEConfig(past_length=5, future_length=10,
                          select_impl="auto").validate()
    S_, lr, M = 4, 1e-5, 32 * 11
    gen = torch.Generator(device=dev).manual_seed(20)
    batches, noises = [], []
    for i in range(2 * S_):
        sc = make_social_scenes(32, agents_range=(11, 11), obs_len=5,
                                pred_len=10, seed=200 + i)
        b, _ = prepare_scene_group(
            np.stack([s_["obs"] for s_ in sc]),
            np.stack([s_["pred"] for s_ in sc]), np.ones((32, 11),
                                                         np.float32),
            training=True, rng=np.random.default_rng(200 + i))
        batches.append(b.to(dev))
        D, Z = cfg.hidden_dim, cfg.zdim
        noises.append(tm.TrainNoise(
            torch.rand(M, 5, D, device=dev, generator=gen) >= cfg.pe_dropout,
            torch.rand(M, 10, D, device=dev, generator=gen) >= cfg.pe_dropout,
            torch.randn(M, Z, device=dev, generator=gen),
            torch.randn(M * cfg.sample_k, Z, device=dev, generator=gen)))

    def in_proj(path) -> bool:
        return path[-1] == "in_proj_w"

    def mask(p):
        return bridge.tree_map_with_path(lambda path, _: in_proj(path), p)

    p0 = project_to_manifold(tm.sttode_init(20, cfg), mask)
    sgd = riemannian_sgd(lr, flat_mask(mask, p0))
    graph = make_train_step(cfg, lr, device=dev, scan_steps=S_,
                            optimizer=sgd)
    eager = make_train_step(cfg, lr, device=dev, optimizer=sgd)
    require(graph.mode == "graph", "phase 20 (a): the step is not captured")
    pg, og = graph.init(p0)
    marked = sum(og.on_manifold.values())
    require(isinstance(og, RiemannianSGD) and marked == 2 * cfg.nlayer
            and isinstance(og.param_groups[0]["lr"], torch.Tensor),
            f"phase 20 (a): the optimizer {type(og).__name__}, {marked} "
            f"marked leaves, lr {og.param_groups[0]['lr']!r}")
    first, second = slice(0, S_), slice(S_, 2 * S_)

    def chunk(sl):
        return stack_batches(batches[sl]), stack_noise(noises[sl])

    # the first call runs its chunk eagerly as the capture's warm-up
    b0, n0 = chunk(first)
    graph(pg, og, b0, gen, noise=n0)
    # the eager side from the same parameters, on the graph's optimizer form
    pe, oe = graph.init(pg)
    me = [eager(pe, oe, b, gen, noise=n)[2]
          for b, n in zip(batches[second], noises[second])]
    torch.cuda.synchronize()
    stacked, noise = chunk(second)
    reset()   # the main path: a replay of the captured Riemannian step
    mg = graph(pg, og, stacked, gen, noise=noise)[2]
    torch.cuda.synchronize()
    launches = counts()
    add(launches)
    same_losses = all(torch.equal(mg[k], torch.stack([m[k] for m in me]))
                      for k in mg)
    same_params = all(torch.equal(a, b) for a, b in zip(
        bridge.tree_leaves(pg), bridge.tree_leaves(pe)))
    stats = graph.graph_stats()
    norm_err, moved = 0.0, 0
    for (path, a), b in zip(bridge.tree_leaves_with_path(pg),
                            bridge.tree_leaves(p0)):
        if in_proj(path):
            norm_err = max(norm_err, float(
                (torch.linalg.vector_norm(a.detach(), dim=-1) - 1).abs()
                .max()))
            moved += not torch.equal(a.detach().cpu(), b)
    require(all(bool(torch.isfinite(v).all()) for v in mg.values()),
            f"phase 20 (a): non-finite losses {mg}")
    require(same_losses and same_params and stats["graphs"] == 1
            and stats["replays"] == 1,
            f"phase 20 (a): the replay differs from 4 eager steps (losses "
            f"equal {same_losses}, parameters equal {same_params}; graphs "
            f"{stats})")
    require(norm_err <= 1e-5 and moved == marked,
            f"phase 20 (a): marked rows off the sphere by {norm_err:.3e}, "
            f"{moved} of {marked} marked leaves moved")
    require(launches["packed"] > 0 and launches["packed_bwd"] > 0
            and launches["select_fp32"] > 0,
            f"phase 20 (a): the replay did not launch P, Q and kernel B fp32 "
            f"{nonzero(launches)}")
    # 20 warm replays in one trace (traces of a few calls can come back
    # empty: phase 16, kernel_names): the kernels by name
    reset()   # the main path: the profiled replays
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            graph(pg, og, stacked, gen, noise=noise)
        torch.cuda.synchronize()
    traced = counts()
    add(traced)
    in_trace = trace_names(prof.key_averages())
    require(all(in_trace.get(k, 0) > 0 for k in ("P", "Q", "B_fp32")),
            f"phase 20 (a): the trace of 20 replays names {in_trace} "
            f"(counters {nonzero(traced)})")
    step_ms: dict = {"eager": [], "captured": []}
    for r in range(5):
        for name in (("eager", "captured") if r % 2 == 0
                     else ("captured", "eager")):
            t = time.perf_counter()
            if name == "eager":
                for b, n in zip(batches[second], noises[second]):
                    eager(pe, oe, b, gen, noise=n)
            else:
                graph(pg, og, stacked, gen, noise=noise)
            torch.cuda.synchronize()
            step_ms[name].append((time.perf_counter() - t) / S_ * 1e3)
    ms_e = statistics.median(step_ms["eager"])
    ms_g = statistics.median(step_ms["captured"])
    print(f"phase 20 (a) NBA recipe step (B = 32 x 11, select_impl auto) "
          f"with riemannian_sgd(lr {lr:g}) on the {marked} encoder in_proj_w "
          f"leaves: one scan_steps {S_} replay equals {S_} eager steps of "
          f"the capturable form bit for bit (losses "
          + " ".join(f"{float(v):.6f}" for v in mg["total"])
          + f"; every parameter), the marked rows unit-norm within "
          f"{norm_err:.3e}; replay launches {nonzero(launches)}; the trace "
          f"of 20 replays names {in_trace}; eager {ms_e:.3f} ms a step, "
          f"captured {ms_g:.3f} ms a step ({32e3 / ms_g:.1f} train "
          f"scenes/s)  [{card}]")

    # (b) every new module's public function, the card against the CPU
    worst_b, checked = card_vs_cpu(dev)
    print(f"phase 20 (b) {checked} calls of the new modules' functions "
          f"(oblique, euclidean, riemannian_sgd, hyperbolic, dot attention, "
          f"gumbel, RelaxedOneHot, delta, analysis, gru_cell), outputs and "
          f"gradients, the card against the CPU: the worst difference is "
          f"{worst_b[1]:.3f} of its tolerance {worst_b[2]:g} ({worst_b[0]})"
          f"  [{card}]")

    # (c) δ-hyperbolicity at full size on the card
    params = bridge.to_device(p0, dev)
    reset()   # the main path: the past encoder's features on P
    with torch.no_grad():
        t = time.perf_counter()
        feats = torch.cat([tm.encode_past(params, cfg, b) for b in batches])
        torch.cuda.synchronize()
    t_feat = time.perf_counter() - t
    launches_f = counts()
    add(launches_f)
    require(launches_f["packed"] > 0, f"phase 20 (c): the past encoder did "
            f"not launch P {nonzero(launches_f)}")
    results = {}
    for name, call in (
            ("batched_delta_hyp", lambda x, r: tdelta.batched_delta_hyp(
                x, n_tries=2, batch_size=1500, rng=r)),
            ("features_delta", lambda x, r: tdelta.features_delta(
                [x[i:i + M] for i in range(0, len(x), M)], lambda f: f,
                sample=1500, rng=r))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        t = time.perf_counter()
        got = call(feats, np.random.default_rng(20))
        torch.cuda.synchronize()
        sec = time.perf_counter() - t
        peak = (torch.cuda.max_memory_allocated(dev) - base) / 2 ** 30
        want = call(feats.double(), np.random.default_rng(20))
        small = call(feats[:400].double().cpu(), np.random.default_rng(21))
        small_card = call(feats[:400].double(), np.random.default_rng(21))
        err = max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(got, want))
        err_small = max(abs(a - b) / max(abs(b), 1e-12)
                        for a, b in zip(small_card, small))
        require(all(math.isfinite(v) and v >= 0 for v in got)
                and err <= 1e-4 and err_small <= 1e-12,
                f"phase 20 (c) {name}: {got} against float64 {want} "
                f"(relative {err:.3e}); 400 points card {small_card} vs CPU "
                f"{small}")
        results[name] = (got, sec, peak, err, err_small)
    (dm, ds), sec_b, peak_b, err_b, small_b = results["batched_delta_hyp"]
    (fd, fdiam), sec_f, peak_f, err_f, small_f = results["features_delta"]
    print(f"phase 20 (c) δ-hyperbolicity on the card over the past encoder's "
          f"features of {len(batches)} NBA batches ({feats.shape[0]} x "
          f"{feats.shape[1]} fp32, {t_feat * 1e3:.1f} ms on P): "
          f"batched_delta_hyp(batch_size 1500, 2 tries) = {dm:.6f} ± "
          f"{ds:.6f} in {sec_b:.3f} s, peak {peak_b:.3f} GiB allocated "
          f"beyond the resident; features_delta(sample 1500) = δ {fd:.6f}, "
          f"diameter {fdiam:.6f} in {sec_f:.3f} s, peak {peak_f:.3f} GiB; "
          f"against float64 on the card within {max(err_b, err_f):.3e} "
          f"(relative), 400 points against the CPU within "
          f"{max(small_b, small_f):.3e}  [{card}]")
    print(f"phase 20 took {time.perf_counter() - t_phase:.1f} s; its main "
          f"paths launched {nonzero(total)}")
    return {"launches": total}


def card_vs_cpu(dev) -> tuple[tuple, int]:
    """Phase 20 (b): each public function of the modules ported last
    (``manifolds.oblique``'s Riemannian ops, ``manifolds.euclidean``,
    ``train.riemannian``, ``nn.hyperbolic``, ``nn.dot_attention``,
    ``nn.gumbel``, ``RelaxedOneHot``, ``utils.delta``, ``utils.analysis``,
    ``nn.recurrent.gru_cell``) on the card and on the CPU on the same
    numpy-seeded inputs, with the random draws injected: every output and,
    where marked, the gradient of Σ w·out with respect to every float input
    within ``tol`` × max(1, |CPU|) (1e-5 in fp32; float64 near the
    sphere's antipodes and at the ball's edge, 1e-9). Raises at the first
    that disagrees; returns (the worst (label, share of its tolerance,
    tolerance)) and the count of calls checked."""
    from sttode_tpu_torch import bridge
    from sttode_tpu_torch.manifolds import euclidean as teuc
    from sttode_tpu_torch.manifolds import oblique as tobl
    from sttode_tpu_torch.nn import dot_attention as tdot
    from sttode_tpu_torch.nn import gumbel as tgum
    from sttode_tpu_torch.nn import hyperbolic as th
    from sttode_tpu_torch.nn import recurrent as trec
    from sttode_tpu_torch.train import riemannian as triem
    from sttode_tpu_torch.utils import analysis as tan
    from sttode_tpu_torch.utils import delta as tdelta
    from sttode_tpu_torch.utils.distributions import (RelaxedOneHot,
                                                      draw_gumbel)

    rng = np.random.default_rng(20)
    gen = torch.Generator().manual_seed(20)
    cpu = torch.device("cpu")
    worst = ("", 0.0, 0.0)
    checked = 0

    def normal(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    def sphere(*shape, dtype=np.float32):
        x = rng.standard_normal(shape)
        return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(dtype)

    def ball(*shape, radius=0.9, dtype=np.float32):
        return (sphere(*shape, dtype=np.float64) * rng.uniform(
            0.05, radius, (*shape[:-1], 1))).astype(dtype)

    def check(label, fn, args, *, grad=False, tol=1e-5):
        """fn(*args) on both devices; args a list of numpy trees (integer
        and bool leaves are not differentiated)."""
        nonlocal worst, checked
        results = []
        for d in (dev, cpu):
            targs = bridge.tree_map(lambda a: torch.tensor(
                a, device=d, requires_grad=grad and a.dtype.kind == "f"),
                args)
            outs = fn(*targs)
            outs = list(outs) if isinstance(outs, tuple) else [outs]
            grads = []
            if grad:
                w = np.random.default_rng(2).standard_normal
                sum((o * torch.tensor(w(tuple(o.shape)), dtype=o.dtype,
                                      device=d)).sum()
                    for o in outs if o.is_floating_point()).backward()
                grads = [torch.zeros_like(t) if t.grad is None else t.grad
                         for t in bridge.tree_leaves(targs)
                         if t.requires_grad]
            results.append([t.detach().cpu() for t in outs + grads])
        for i, (a, b) in enumerate(zip(*results)):
            a, b = a.double(), b.double()
            err = float((a - b).abs().max()) / max(1.0, float(
                b.abs().max())) if b.numel() else 0.0
            require(err <= tol, f"phase 20 (b) {label}: output / gradient "
                    f"{i} differs on the card from the CPU by {err:.3e} > "
                    f"{tol:g}")
            if err / tol > worst[1]:
                worst = (label, err / tol, tol)
        checked += 1

    # the oblique manifold (fp32; float64 near the antipodes) and the
    # Euclidean one
    x, u, y = sphere(6, 4, 8), normal(6, 4, 8, scale=0.7), sphere(6, 4, 8)
    u[0] *= 1e-6      # expmap's retraction branch
    y[1] = x[1] + 1e-6 * rng.standard_normal((4, 8))  # logmap's small branch
    for name, fn in (
            ("proj_tan", lambda m, x, u, y: m.proj_tan(u, x)),
            ("inner", lambda m, x, u, y: (m.inner(u), m.inner(u, y))),
            ("dist_point", lambda m, x, u, y: m.dist_point(x, y)),
            ("expmap", lambda m, x, u, y: m.expmap(u, x)),
            ("logmap", lambda m, x, u, y: m.logmap(y, x)),
            ("retr", lambda m, x, u, y: m.retr(u, x)),
            ("ptransp", lambda m, x, u, y: m.ptransp(u, x, y)),
            ("egrad2rgrad", lambda m, x, u, y: m.egrad2rgrad(u, x))):
        for m in (tobl, teuc):
            check(f"{m.__name__.rsplit('.', 1)[1]}.{name}",
                  lambda *a, m=m, fn=fn: fn(m, *a), [x, u, y], grad=True)
    check("oblique.retr_transp", lambda x, u, y: tobl.retr_transp(u, x, y),
          [x, u, y], grad=True)
    check("euclidean.dist, mobius_add, mobius_matvec",
          lambda x, u, y: (teuc.dist(x, y), teuc.mobius_add(x, y),
                           teuc.mobius_matvec(u[0, :3], x)), [x, u, y],
          grad=True)
    xa = sphere(6, 4, 8, dtype=np.float64)
    ya = -xa + 1e-3 * rng.standard_normal(xa.shape)
    ya /= np.linalg.norm(ya, axis=-1, keepdims=True)
    ua = 3.0 * np.asarray(tobl.proj_tan(torch.from_numpy(
        rng.standard_normal(xa.shape)), torch.from_numpy(xa)))
    for name, fn in (("logmap", lambda x, u, y: tobl.logmap(y, x)),
                     ("expmap", lambda x, u, y: tobl.expmap(u, x)),
                     ("dist_point", lambda x, u, y: tobl.dist_point(x, y))):
        check(f"oblique.{name} near antipodes (float64)", fn, [xa, ua, ya],
              grad=True, tol=1e-9)
    # Riemannian SGD: the projection, then a step on a prefix mask
    tree = {"enc": {"w": normal(4, 6), "b": normal(4, 6)},
            "head": {"w": normal(3, 6)}}

    def riemannian_step(tree):
        p = triem.project_to_manifold(tree, {"enc": True, "head": False})
        leaves = [t.detach().clone().requires_grad_()
                  for t in bridge.tree_leaves(p)]
        opt = triem.riemannian_sgd(0.05, triem.flat_mask(
            {"enc": True, "head": False}, p))(leaves)
        for t in leaves:
            t.grad = torch.cos(3 * t.detach())
        opt.step()
        return tuple(t.detach() for t in leaves)

    check("riemannian project_to_manifold + riemannian_sgd step",
          riemannian_step, [tree])
    # the hyperbolic layers, on JAX's layouts; fp32 inside the ball, float64
    # at its edge
    mlr = {"a_vals": normal(5, 8, scale=0.3), "p_vals": normal(5, 8,
                                                             scale=0.3)}
    lin = {"w": normal(8, 6, scale=0.3), "b": normal(6, scale=0.3)}
    cat = {"l1": {"w": normal(8, 5, scale=0.3)},
           "l2": {"w": normal(6, 5, scale=0.3)}}
    xb, x6 = ball(12, 8), ball(12, 6)
    for c in (1.0, 0.7):
        check(f"hyperbolic_mlr c = {c}", lambda p, x, c=c: th.hyperbolic_mlr(
            p, x, c=c), [mlr, xb], grad=True)
        check(f"hyp_linear c = {c}", lambda p, x, c=c: th.hyp_linear(
            p, x, c=c), [lin, xb], grad=True)
    check("hyp_linear without bias", th.hyp_linear, [{"w": lin["w"]}, xb],
          grad=True)
    check("concat_poincare", th.concat_poincare, [cat, xb, x6], grad=True)
    check("hyperbolic_distance", th.hyperbolic_distance, [xb, ball(12, 8)],
          grad=True)
    feats, base = normal(12, 8, scale=0.8), normal(8, scale=0.3)
    for clip in (None, 1.0):
        check(f"to_poincare riemannian clip_r {clip}",
              lambda x, b, clip=clip: (
                  th.to_poincare(x, c=0.7, clip_r=clip),
                  th.to_poincare(x, c=0.7, clip_r=clip, xp=b)),
              [feats, base], grad=True)
    check("to_poincare riemannian=False", lambda x: th.to_poincare(
        x, riemannian=False), [feats], grad=True)
    check("from_poincare", lambda y, b: (th.from_poincare(y),
                                         th.from_poincare(y, xp=b)),
          [xb, base], grad=True)
    edge = sphere(12, 8, dtype=np.float64) * (1 - 1e-3)
    check("from_poincare, hyperbolic_distance at the ball's edge (float64)",
          lambda y, z: (th.from_poincare(y), th.hyperbolic_distance(y, z)),
          [edge, ball(12, 8, dtype=np.float64)], grad=True, tol=1e-9)
    check("to_poincare beyond the ball's edge (float64)",
          lambda x: th.to_poincare(x, clip_r=3.0),
          [4.0 * rng.standard_normal((12, 8))], grad=True, tol=1e-9)
    # dot-product attention: packed self-attention and cross-attention,
    # additive masks, the heads' mean weights, dropout with its keep-mask
    E, H = 64, 8
    attn = (normal(E, 3 * E, scale=0.15), normal(3 * E, scale=0.1),
            normal(E, E, scale=0.12), normal(E, scale=0.1))
    q, kv = normal(11, 32, E), normal(11, 20, E)
    mask = np.where(rng.uniform(size=(11, 32, 20)) < 0.3, -1e9, 0.0).astype(
        np.float32)
    keep = rng.uniform(size=(11, H, 32, 32)) >= 0.1
    from sttode_tpu_torch.nn.attention import MHGSAParams
    check("dot_mhsa self-attention (packed projection), weights",
          lambda p, q: tdot.dot_mhsa(MHGSAParams(*p), q, q, q, H,
                                     need_weights=True), [attn, q],
          grad=True)
    check("dot_mhsa cross-attention, masked, weights",
          lambda p, q, kv, m: tdot.dot_mhsa(MHGSAParams(*p), q, kv, kv, H,
                                            mask=m, need_weights=True),
          [attn, q, kv, mask], grad=True)
    check("dot_mhsa dropout 0.1 with its keep-mask",
          lambda p, q, k: tdot.dot_mhsa(MHGSAParams(*p), q, q, q, H,
                                        dropout_rate=0.1, dropout_mask=k)[0],
          [attn, q, keep], grad=True)
    # the Gumbel dictionaries and RelaxedOneHot, the Gumbel noise injected
    logits = normal(64, 10)
    g = draw_gumbel((64, 10), generator=gen).numpy()
    for hard in (False, True):
        check(f"gumbel_softmax hard={hard}", lambda lg, g, hard=hard:
              tgum.gumbel_softmax(lg, gumbel=g, temperature=0.5, hard=hard),
              [logits, g], grad=True)
    dp = {"mlp": {"layers": [{"w": normal(32, 64, scale=0.2),
                              "b": normal(64, scale=0.1)},
                             {"w": normal(64, 10, scale=0.2),
                              "b": normal(10, scale=0.1)}]},
          "dictionary": normal(10, 16, scale=0.1),
          "factor": {"w": normal(32, 1, scale=0.2), "b": normal(1)}}
    xd = normal(64, 32)
    check("mlp_dict, mlp_dict_softmax", lambda p, x, g: (
        *tgum.mlp_dict(p, x, gumbel=g), *tgum.mlp_dict_softmax(p, x)),
        [dp, xd, g], grad=True)
    other = normal(64, 10)
    check("RelaxedOneHot probs, rsample, sample, kl, kl(p), mode",
          lambda lg, o, g: (
              RelaxedOneHot(lg, 0.3).probs,
              RelaxedOneHot(lg, 0.3).rsample(gumbel=g),
              RelaxedOneHot(lg, 0.3).sample(gumbel=g),
              RelaxedOneHot(lg).kl(), RelaxedOneHot(lg).kl(
                  RelaxedOneHot(o)), RelaxedOneHot(lg).mode()),
          [logits, other, g], grad=True)
    # δ-hyperbolicity (float64, several row blocks) and the analysis toolbox
    pts = rng.standard_normal((300, 16))
    check("features_delta, batched_delta_hyp (float64)",
          lambda x: torch.tensor([
              *tdelta.features_delta([x[:100], x[100:]], lambda f: f,
                                     rng=np.random.default_rng(0)),
              *tdelta.batched_delta_hyp(x, n_tries=2, batch_size=200,
                                        rng=np.random.default_rng(0))]),
          [pts], tol=1e-12)
    a1, a2 = normal(4, 24, 32), normal(4, 40, 32)
    for metric in ("euclidean", "cosine", "cosine_v2"):
        check(f"compute_similarity {metric}",
              lambda a, b, metric=metric: tan.compute_similarity(
                  a, b, metric=metric), [a1, a2], grad=True)
    lg, labels = normal(64, 10), rng.integers(0, 10, 64)
    onehot = np.eye(10, dtype=np.float32)[labels]
    check("smooth_one_hot, cross_entropy, compute_acc, "
          "label_smoothing_loss_acc", lambda lg, lb, oh: (
              tan.smooth_one_hot(lb, 10), tan.cross_entropy(lg, oh),
              tan.compute_acc(lg, oh),
              *tan.label_smoothing_loss_acc(lg, lb, 10),
              tan.label_smoothing_loss_acc(torch.softmax(lg, -1), lb, 10,
                                           softmaxed=True)[0]),
          [lg, labels, onehot], grad=True)
    f1 = normal(256, 32)
    f2 = f1 + normal(256, 32, scale=0.3)
    check("grassmann_distance", tan.grassmann_distance, [f1, f2], tol=1e-4)
    # the GRU cell
    gp = (normal(32, 288, scale=0.2), normal(96, 288, scale=0.1),
          normal(288, scale=0.1), normal(288, scale=0.1))
    check("gru_cell", lambda p, h, x: trec.gru_cell(trec.GRUParams(*p), h, x),
          [gp, normal(352, 96), normal(352, 32)], grad=True)
    return worst, checked


# (recipe, scenes, selection and decode storage, route); the bench recipe
# also in fp32, whose winners do not flip at bf16's near-ties, so that its
# gradients and parameters compare
PARALLEL_CASES = tuple(
    (name, B, dtype, route) for name, B, dtype in (
        ("NBA reference recipe", 32, "float32"),
        ("bench recipe", 128, "float32"), ("bench recipe", 128, "bfloat16"))
    for route in ("auto", "ring", "ulysses"))
BENCH_BF16 = ("bench recipe", 128, "bfloat16", "auto")
PARALLEL_LR = 1e-4
# world 2 against the single process: each rank's dense layers run on half
# the rows, so the GEMMs round some rows otherwise; a decoder ReLU whose
# input lies at rounding then switches and moves one row's share of a
# gradient leaf (1 / M = 7.1e-4 at M = 1408): each leaf within this
# relative L2 and each element within DP_KINK_ELEM of its largest magnitude
DP_KINK_L2 = 1e-3
DP_KINK_ELEM = 1e-2


# phase 21 (i): the agent axis on a [1, 2, 1] data x seq mesh, ETH's
# agent-axis recipe's batch (32 scenes x 16 agents, compat "tpu"), the
# last 4 agents of every other scene padded
AGENT_RECIPE = "agent-axis recipe"
AGENT_CASES = tuple((AGENT_RECIPE, 32, "float32", route)
                    for route in ("ring", "ulysses"))


def parallel_recipe(name, B, dtype, route):
    """A phase-21 case on the CPU, from seeds: (config, parameters, 2
    global batches of B scenes × 11 agents, or × 16 on the agent axis for
    ``AGENT_RECIPE``, their global noise)."""
    from sttode_tpu_torch.data.preprocess import prepare_scene_group
    from sttode_tpu_torch.data.synthetic import make_social_scenes
    from sttode_tpu_torch.models import sttode as tm
    agent = name == AGENT_RECIPE
    N = 16 if agent else 11
    cfg = tm.STTODEConfig(past_length=5, future_length=10,
                          select_impl="auto", select_dtype=dtype,
                          decode_dtype=dtype, attn_impl=route,
                          **(dict(compat="tpu", attn_axis="agent")
                             if agent else {})).validate()
    valid = np.ones((B, N), np.float32)
    if agent:
        valid[::2, 12:] = 0.0
    batches, noises = [], []
    for i in range(2):
        sc = make_social_scenes(B, agents_range=(N, N), obs_len=5,
                                pred_len=10, seed=210 + i)
        b, _ = prepare_scene_group(
            np.stack([s_["obs"] for s_ in sc]),
            np.stack([s_["pred"] for s_ in sc]), valid, training=True,
            rng=np.random.default_rng(210 + i))
        batches.append(b)
        noises.append(tm.draw_train_noise(
            cfg, B, N, torch.Generator().manual_seed(21 + i), "cpu"))
    return cfg, tm.sttode_init(21, cfg), batches, noises


def _noise_to(noise, dev):
    return type(noise)(*(None if t is None else t.to(dev) for t in noise))


# phase 21 (d): stage 2 with ε drawn, [M, nz] and not shared, so that each
# rank keeps its rows of the global draw
PARALLEL_SCFG = dict(train_w_mean=False, share_eps=False)
# phase 21 (f): the continuous adjoint's gradient is exact only to its
# backward solves' tolerance (rtol 1e-3), and in fp32 their error ratios
# sit on the rounding floor, where the mesh's summation order takes other
# steps than the single process's (the CPU test's float32 case: 28 against
# 30 attempts; in float64 the two agree to 1.2e-8): the two adjoint
# gradients are held to each other within 10 x rtol of each leaf's largest
ADJOINT_GRAD_TOL = 1e-2
# phase 21 (f): dopri5 at phase 17's loosest tolerance in its three forms;
# the while form cannot be differentiated through: the stage-2 step runs
# it in its frozen encoder
PARALLEL_ODE = {
    "while form": dict(ode_method="dopri5", ode_rtol=1e-3, ode_atol=1e-6),
    "scan budget 16": dict(ode_method="dopri5", ode_rtol=1e-3,
                           ode_atol=1e-6, ode_scan_budget=16),
    "adjoint": dict(ode_method="dopri5", ode_rtol=1e-3, ode_atol=1e-6,
                    ode_adjoint=True)}


def sampler_recipe(ode: dict | None = None, case=PARALLEL_CASES[0]):
    """Phase 21's stage-2 case on the NBA reference recipe (32 x 11), or
    the recipe of ``case``, from seeds: (net config, under ``ode``'s
    settings when given, sampler config, net parameters, sampler
    parameters, 2 global batches)."""
    from sttode_tpu_torch.models import sampler as ts
    cfg, net, batches, _ = parallel_recipe(*case)
    cfg = cfg._replace(**(ode or {})).validate()
    scfg = ts.SamplerConfig(**PARALLEL_SCFG)
    return cfg, scfg, net, ts.sampler_init(21, scfg, cfg.hidden_dim,
                                           2 * cfg.hidden_dim), batches


class SolveLog:
    """Inside, every dopri5 solve's (attempted steps, accepted steps, RHS
    evaluations) in order, the adjoint's backward solves included (the
    solver's own counts, read where it returns them)."""

    def __enter__(self):
        from sttode_tpu_torch.ode import solvers
        self.solves, self._solvers = [], solvers
        self._real = real = solvers._dopri5_odeint

        def record(*args, **kw):
            ys, st = real(*args, **kw)
            self.solves.append((st["attempted_steps"], st["accepted_steps"],
                                st["rhs_evals"]))
            return ys, st

        solvers._dopri5_odeint = record
        return self

    def __exit__(self, *exc):
        self._solvers._dopri5_odeint = self._real


def ode_case_step(form, mesh, dev, batches, noises):
    """Phase 21 (f)'s one step of the dopri5 ``form`` (``PARALLEL_ODE``)
    on ``mesh`` (None: the single process on the whole batch): the stage-2
    step with a generator of one seed for the while form, else the stage-1
    step with the injected global noise. → (metrics, gradient leaves,
    solves)."""
    import warnings
    from sttode_tpu_torch import bridge
    from sttode_tpu_torch.parallel import shard_batch
    from sttode_tpu_torch.train import make_sampler_train_step, make_train_step
    cfg, scfg, net, sp0, _ = sampler_recipe(PARALLEL_ODE[form])
    if form == "while form":
        step = make_sampler_train_step(cfg, scfg, PARALLEL_LR, net,
                                       device=dev, mesh=mesh)
        params, kw = sp0, {}
    else:
        step = make_train_step(cfg, PARALLEL_LR, device=dev, mesh=mesh)
        params, kw = net, {"noise": _noise_to(noises[0], dev)}
    p, opt = step.init(params)
    b = batches[0] if mesh is None else shard_batch(batches[0], mesh)
    gen = torch.Generator(device=dev).manual_seed(213)
    with SolveLog() as log, warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*exhausted")
        p, opt, m = step(p, opt, b.to(dev), gen, **kw)
    return ({k: float(v) for k, v in m.items()},
            [torch.zeros_like(t) if t.grad is None else t.grad.detach().cpu()
             for t in bridge.tree_leaves(p)], log.solves)


def clone_state(opt) -> dict:
    """A copy of an optimizer's state_dict that shares no tensor with it."""
    sd = opt.state_dict()
    return {"state": {i: {k: v.clone() if isinstance(v, torch.Tensor) else v
                          for k, v in st.items()}
                      for i, st in sd["state"].items()},
            "param_groups": [dict(g) for g in sd["param_groups"]]}


def rank_steps(case, mesh, dev, counts, reset, save: str | None = None):
    """One rank's ``make_train_step(mesh=)`` for 2 steps of ``case``
    (``parallel_recipe``) on its part of each batch with the global
    noise: metrics, every gradient leaf and the state after each step,
    whether the parameters are equal on every rank, this rank's launch
    counts, then ms a step over 5 more steps. With ``save`` the state
    after the 2 steps is saved there first (epoch 2)."""
    from sttode_tpu_torch import bridge
    from sttode_tpu_torch.parallel import collectives, shard_batch
    from sttode_tpu_torch.train import make_train_step, save_checkpoint
    cfg, params, batches, noises = parallel_recipe(*case)
    step = make_train_step(cfg, PARALLEL_LR, device=dev, mesh=mesh)
    p, opt = step.init(params)
    leaves = bridge.tree_leaves(p)
    local = [shard_batch(b, mesh).to(dev) for b in batches]
    noises = [_noise_to(n, dev) for n in noises]
    reset()   # the main path: the mesh step on this rank
    metrics, grads, states = [], [], []
    for b, n in zip(local, noises):
        p, opt, m = step(p, opt, b, noise=n)
        metrics.append({k: float(v) for k, v in m.items()})
        grads.append([t.grad.detach().cpu() for t in leaves])
        # the state after the step: the parameters and Adam's
        states.append((bridge.tree_map(
            lambda t: t.detach().to("cpu", copy=True), p),
            bridge.tree_map(lambda t: t.to("cpu", copy=True)
                            if isinstance(t, torch.Tensor) else t,
                            opt.state_dict())))
    torch.cuda.synchronize()
    launches = counts()
    if save is not None:
        save_checkpoint(save, 2, p, opt, cfg)
    flat = torch.cat([t.detach().reshape(-1) for t in leaves])
    equal = bool(torch.equal(collectives.broadcast(flat.clone(), 0, None),
                             flat))
    ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        step(p, opt, local[0], noise=noises[0])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
    return {"metrics": metrics, "grads": grads, "states": states,
            "equal": equal, "launches": launches,
            "ms": statistics.median(ms)}


def parallel_rank(spec_path: str, rank: int) -> int:
    """One of phase 21's two ranks on the one card, over gloo: (b) each
    case's ``make_train_step(mesh=)`` for 2 steps on this rank's scenes
    with the global noise (metrics, every gradient leaf after each step,
    the parameters after both, whether they are equal on both ranks, this
    rank's launch counts), then ms a step over 5 more steps
    (``rank_steps``), rank 0 saving the NBA recipe's state after its 2
    steps for (g); (i) the agent-axis cases and the stage-2 step on a [1,
    2, 1] data x seq mesh; (d) the stage-2 mesh step; (e) the scanned
    mesh step's mode; (f) one step of each dopri5 form
    (``ode_case_step``) with its solves' counts. Writes its results under
    the spec's directory."""
    import datetime
    import torch.distributed as dist
    sys.path.insert(0, HERE)
    from sttode_tpu_torch import bridge
    from sttode_tpu_torch.parallel import collectives, make_mesh, shard_batch
    from sttode_tpu_torch.train import (make_sampler_train_step,
                                        make_train_step)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = torch.load(spec_path, weights_only=False)
    dev = torch.device(spec["device"])
    counts, reset = launch_counters()
    dist.init_process_group(
        "gloo", init_method=f"file://{spec['rendezvous']}", rank=rank,
        world_size=2, timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_mesh(dp=2)
        out = {"staging": collectives.staging(mesh.get_group("data"), dev)}
        for case in spec["cases"]:
            # (g): rank 0 saves the NBA recipe's state after 2 steps at
            # world 2, for phase 21 to restore at world 1
            out[case] = rank_steps(
                case, mesh, dev, counts, reset,
                os.path.join(spec["dir"], "ck")
                if case == PARALLEL_CASES[0] and rank == 0 else None)
        # (i) the agent axis on a [1, 2, 1] data x seq mesh: each rank holds
        #     every scene, the routes split the agents over "seq"
        seq = make_mesh(dp=1, sp=2)
        for case in AGENT_CASES:
            out[case] = rank_steps(case, seq, dev, counts, reset)
        cfg, scfg, net, sp0, batches = sampler_recipe(case=AGENT_CASES[1])
        step = make_sampler_train_step(cfg, scfg, PARALLEL_LR, net,
                                       device=dev, mesh=seq)
        p, opt = step.init(sp0)
        gen = torch.Generator(device=dev).manual_seed(211)
        reset()   # the main path: the stage-2 step on the seq mesh
        metrics = []
        for b in batches:
            p, opt, m = step(p, opt, shard_batch(b, seq).to(dev), gen)
            metrics.append({k: float(v) for k, v in m.items()})
        torch.cuda.synchronize()
        launches = counts()
        flat = torch.cat([t.detach().reshape(-1)
                          for t in bridge.tree_leaves(p)])
        ms = []
        for _ in range(5):
            torch.cuda.synchronize()
            t = time.perf_counter()
            step(p, opt, shard_batch(batches[0], seq).to(dev), gen)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        out["stage2_seq"] = {"metrics": metrics, "launches": launches,
                             "ms": statistics.median(ms),
                             "equal": bool(torch.equal(collectives.broadcast(
                                 flat.clone(), 0, None), flat))}
        # (d) the stage-2 step, 2 steps with a generator of one seed
        cfg, scfg, net, sp0, batches = sampler_recipe()
        step = make_sampler_train_step(cfg, scfg, PARALLEL_LR, net,
                                       device=dev, mesh=mesh)
        p, opt = step.init(sp0)
        gen = torch.Generator(device=dev).manual_seed(211)
        reset()   # the main path: the stage-2 mesh step on this rank
        metrics = []
        for b in batches:
            p, opt, m = step(p, opt, shard_batch(b, mesh).to(dev), gen)
            metrics.append({k: float(v) for k, v in m.items()})
        torch.cuda.synchronize()
        flat = torch.cat([t.detach().reshape(-1)
                          for t in bridge.tree_leaves(p)])
        out["stage2"] = {"metrics": metrics, "launches": counts(),
                         "params": flat.cpu(), "equal": bool(torch.equal(
                             collectives.broadcast(flat.clone(), 0, None),
                             flat))}
        # (e) over gloo the scanned mesh step is eager, decided when it is
        # built: gloo stages its collectives on CUDA tensors through host
        # memory, which a capture cannot hold
        cfg, _, batches, noises = parallel_recipe(*PARALLEL_CASES[0])
        out["scan_mode"] = make_train_step(cfg, PARALLEL_LR, device=dev,
                                           mesh=mesh, scan_steps=16).mode
        # (f) dopri5's three forms, one step each
        for form in PARALLEL_ODE:
            reset()   # the main path: the dopri5 mesh step on this rank
            t = time.perf_counter()
            metrics, grads, solves = ode_case_step(form, mesh, dev, batches,
                                                   noises)
            torch.cuda.synchronize()
            out[form] = {"metrics": metrics, "grads": grads,
                         "solves": solves, "launches": counts(),
                         "s": time.perf_counter() - t}
        torch.save(out, os.path.join(spec["dir"], f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


def free_port() -> int:
    """A free TCP port on this host's loopback (for a rendezvous)."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def wait_all(procs, limit_s: float, what: str) -> None:
    """Wait for every process within ``limit_s`` seconds; kill those left."""
    deadline = time.monotonic() + limit_s
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        require(False, f"{what}: not done within {limit_s:.0f} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def compare_adam_params(got, want, g_got, g_ref, what) -> tuple[float, int]:
    """Hold the parameters after an Adam step from the same state to a
    reference's: an entry more than PARALLEL_LR / 10 apart must have had a
    reference gradient within TRAIN_TOL of its leaf's largest magnitude
    (Adam moves an entry by ~lr whatever its gradient's size, so a
    gradient at rounding can take either sign) or a gradient that a ReLU
    at rounding moved (the two gradients more than TRAIN_TOL of that
    magnitude apart). Returns (the largest difference, the entries so
    excused)."""
    worst, excused = 0.0, 0
    for i, (a, b, ga, gb) in enumerate(zip(got, want, g_got, g_ref)):
        d = (a - b).abs()
        worst = max(worst, float(d.max()))
        far = d > PARALLEL_LR / 10
        if bool(far.any()):
            tol = TRAIN_TOL * gb.abs().max()
            ok = (gb.abs() <= tol) | ((ga - gb).abs() > tol)
            require(bool((ok | ~far).all()),
                    f"{what}: parameter leaf {i} differs by {float(d.max())} "
                    f"where its gradient is neither at rounding nor moved")
            excused += int(far.sum())
    return worst, excused


def parallel_phase(dev, card, counts, reset, nba_files) -> dict:
    """Phase 21: data parallelism and the ring over torch.distributed.
    (a) world 1 over NCCL in this process: ``make_train_step(mesh=)`` on
    the bench recipe (B = 128 × 11, bf16 selection, a generator of one
    seed) for 2 steps against the single-process step, bit for bit (each
    loss term, every gradient leaf, every parameter; the first that
    differs is named), A, C and B bf16 in the counters, ms a step of both.
    (b) world 2 on the one card over gloo (two processes,
    ``parallel_rank``; NCCL takes one rank a device): the NBA reference
    recipe (32 × 11: P, Q, B fp32) and the bench recipe (A, C at L 64 × S
    128; B bf16, and B fp32 in its fp32 twin) on the routes "auto" and
    "ring", scene axis, 2 steps, each against the single-process step on
    the card from the same state: losses within TRAIN_TOL; in fp32 every
    gradient leaf by
    ``DP_KINK_L2`` / ``DP_KINK_ELEM`` and the parameters by
    ``compare_adam_params`` (bf16 selection's winners may differ at
    near-ties, §2 of PERF.md); equal on both ranks bit for bit, each
    rank's launches, ms a step (host-bound).
    (c) ``cli.train --distributed --dist_backend gloo`` at world 2 on the
    card, one epoch of 2 NBA steps: both ranks join. (d) the stage-2 step
    at world 1 (``stage2_world1``) and 2 (``stage2_world2``); (e) the
    captured mesh step at world 1 (``captured_world1``); (f) dopri5's three
    forms at world 2 (``dopri5_world2``); (g) a checkpoint saved at world 2,
    restored at world 1 (``restore_world1``). Returns the launches of (a),
    (d), (e) and (h) at world 1. (h) and (i): ``ulysses_world1``,
    ``hold_world2``, ``stage2_seq_world2``."""
    import torch.distributed as dist
    from sttode_tpu_torch import bridge
    from sttode_tpu_torch.parallel import collectives, make_mesh, shard_batch
    from sttode_tpu_torch.train import make_train_step

    t_phase = time.perf_counter()
    # (a) world 1 over NCCL: the mesh step against the single-process step
    cfg, params, batches, _ = parallel_recipe(*BENCH_BF16)
    batches = [b.to(dev) for b in batches]
    names = leaf_names(params)
    torch.cuda.set_device(0)
    runs: dict = {}
    with tempfile.TemporaryDirectory(dir=HERE, prefix=".smoke_dist_") as tmp:
        dist.init_process_group(
            "nccl", init_method=f"file://{tmp}/rendezvous", rank=0,
            world_size=1)
        try:
            mesh = make_mesh(dp=1)
            steps = {name: make_train_step(cfg, PARALLEL_LR, device=dev,
                                           mesh=m)
                     for name, m in (("single", None), ("mesh", mesh))}
            for name, step in steps.items():
                p, opt = step.init(params)
                leaves = bridge.tree_leaves(p)
                gen = torch.Generator(device=dev).manual_seed(21)
                reset()   # the main path (the mesh step's run is kept)
                record = []
                for b in batches:
                    b = b if step.mesh is None else shard_batch(b, mesh)
                    p, opt, m = step(p, opt, b, gen)
                    record.append(({k: v.clone() for k, v in m.items()},
                                   [t.grad.clone() for t in leaves]))
                torch.cuda.synchronize()
                runs[name] = (record, [t.detach().clone() for t in leaves],
                              counts(), p, opt)
            launches = runs["mesh"][2]
            (rec_s, par_s, _, p_s, o_s), (rec_m, par_m, _, p_m, o_m) = \
                runs["single"], runs["mesh"]
            for i, ((m_s, g_s), (m_m, g_m)) in enumerate(zip(rec_s, rec_m)):
                for k in m_s:
                    require(torch.equal(m_s[k], m_m[k]),
                            f"phase 21 (a) step {i + 1}: loss term {k} "
                            f"{float(m_m[k])!r} on the mesh, "
                            f"{float(m_s[k])!r} single")
                for n_, a, b in zip(names, g_m, g_s):
                    require(torch.equal(a, b),
                            f"phase 21 (a) step {i + 1}: the gradient of "
                            f"{n_} differs by {max_err(a, b):.3e}")
            for n_, a, b in zip(names, par_m, par_s):
                require(torch.equal(a, b), f"phase 21 (a): parameter {n_} "
                        f"differs by {max_err(a, b):.3e}")
            require(launches["attn"] > 0 and launches["attn_bwd"] > 0
                    and launches["select_bf16"] > 0,
                    f"phase 21 (a): the mesh step did not launch A, C and "
                    f"B bf16 {nonzero(launches)}")
            ms: dict = {"single": [], "mesh": []}
            local = shard_batch(batches[0], mesh)
            gen = torch.Generator(device=dev).manual_seed(22)
            for r in range(6):
                for name in (("single", "mesh") if r % 2 == 0
                             else ("mesh", "single")):
                    _, _, _, p_, o_ = runs[name]
                    b = batches[0] if name == "single" else local
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    steps[name](p_, o_, b, gen)
                    torch.cuda.synchronize()
                    ms[name].append((time.perf_counter() - t) * 1e3)
            launches_d, text_d = stage2_world1(dev, mesh, counts, reset)
            launches_e, text_e = captured_world1(dev, mesh, counts, reset)
            # (h) ulysses: the all-to-all over a one-rank NCCL group
            launches_h, texts_h = ulysses_world1(dev, mesh, counts, reset)
            launches_hc, text_hc = captured_world1(dev, mesh, counts, reset,
                                                   route="ulysses")
        finally:
            dist.destroy_process_group()
    print(f"phase 21 (a) bench recipe (B = 128 x 11, bf16 selection) "
          f"make_train_step(mesh=) at world 1 over NCCL: 2 steps equal the "
          f"single-process step bit for bit (losses "
          + " ".join(f"{float(m['total']):.6f}" for m, _ in rec_m)
          + f"; every gradient leaf and parameter); launches "
          f"{nonzero(launches)}; ms a step single "
          f"{statistics.median(ms['single']):.3f}, mesh "
          f"{statistics.median(ms['mesh']):.3f}  [{card}]")
    print(f"{text_d}  [{card}]")
    print(f"{text_e}  [{card}]")
    for text in texts_h + [text_hc]:
        print(f"{text}  [{card}]")

    # (b) world 2 on the one card over gloo
    with tempfile.TemporaryDirectory(dir=HERE, prefix=".smoke_dist_") as tmp:
        spec = os.path.join(tmp, "spec.pt")
        torch.save({"cases": PARALLEL_CASES, "dir": tmp, "device": str(dev),
                    "rendezvous": os.path.join(tmp, "rendezvous")}, spec)
        t = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-c", "import sys, chip_smoke; sys.exit("
             "chip_smoke.parallel_rank(sys.argv[1], int(sys.argv[2])))",
             spec, str(r)], cwd=HERE,
            env=dict(os.environ, PYTHONPATH=HERE)) for r in range(2)]
        wait_all(procs, 480, "phase 21 (b), (d), (f)")
        wall_b = time.perf_counter() - t
        require(all(p.returncode == 0 for p in procs),
                f"phase 21 (b): ranks exited {[p.returncode for p in procs]}")
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                            weights_only=False) for r in range(2)]
        # (g) the checkpoint that rank 0 saved at world 2, restored at
        #     world 1 over NCCL in this process
        text_g = restore_world1(dev, os.path.join(tmp, "ck"),
                                ranks[0][PARALLEL_CASES[0]]["states"][1])
    print(f"{text_g}  [{card}]")
    # (c) the CLI with --distributed at world 2, started now: it runs while
    #     (b)'s single-process references are computed
    tmp_c = tempfile.mkdtemp(dir=HERE, prefix=".smoke_nba_")
    procs = []
    try:
        _, flags = nba_files(tmp_c, 64, 21)
        port = str(free_port())
        logs = [os.path.join(tmp_c, f"rank{r}.log") for r in range(2)]
        t_c = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "sttode_tpu_torch.cli.train",
             "--distributed", "--dist_backend", "gloo", *flags,
             "--ckpt_dir", os.path.join(tmp_c, f"ck{r}"), "--num_epochs",
             "1"],
            cwd=HERE, stdout=open(log, "w"), stderr=subprocess.STDOUT,
            env=dict(os.environ, PYTHONPATH=HERE, MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=port, RANK=str(r), LOCAL_RANK=str(r),
                     WORLD_SIZE="2"))
            for r, log in enumerate(logs)]
        for case in PARALLEL_CASES:
            print(f"{hold_world2(case, ranks, dev)}  [{card}]")
        for case in AGENT_CASES:
            print(f"{hold_world2(case, ranks, dev)}  [{card}]")
        print(f"{stage2_seq_world2(dev, ranks)}  [{card}]")
        print(f"phase 21 (b) two ranks: {wall_b:.1f} s from start to exit  "
              f"[{card}]")
        print(f"{stage2_world2(dev, ranks)}  [{card}]")
        modes = [r["scan_mode"] for r in ranks]
        require(modes == ["eager", "eager"], f"phase 21 (e) world 2: the "
                f"scanned mesh step over gloo runs as {modes}")
        print(f"phase 21 (e) at world 2 over gloo on the card: "
              f"make_train_step(mesh=, scan_steps=16).mode {modes[0]!r} on "
              f"both ranks, decided when the step is built  [{card}]")
        for form in PARALLEL_ODE:
            print(f"{dopri5_world2(dev, ranks, form)}  [{card}]")
        wait_all(procs, 180, "phase 21 (c)")
        wall_c = time.perf_counter() - t_c
        text = [open(log).read() for log in logs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp_c, ignore_errors=True)
    for r, (p, out) in enumerate(zip(procs, text)):
        require(p.returncode == 0 and
                f"distributed: process {r} of 2 over gloo" in out
                and "epoch 000" in out,
                f"phase 21 (c) rank {r} exited {p.returncode}: {out[-2000:]}")
    print(f"phase 21 (c) cli.train --distributed --dist_backend gloo at "
          f"world 2 on the card: both ranks joined ("
          + "; ".join(line for out in text for line in out.splitlines()
                      if line.startswith("distributed:"))
          + f") and trained one epoch of 2 NBA steps in {wall_c:.1f} s  "
          f"[{card}]")
    launches = {k: launches[k] + launches_d[k] + launches_e[k]
                + launches_h[k] + launches_hc[k] for k in launches}
    print(f"phase 21 took {time.perf_counter() - t_phase:.1f} s; its main "
          f"paths (a), (d), (e) and (h) at world 1 launched "
          f"{nonzero(launches)}  [{card}]")
    return {"launches": launches}


def hold_world2(case, ranks, dev) -> str:
    """Phase 21 (b) / (i): one case's 2 steps on the two ranks against the
    single-process "auto" step on the card from the same state (the
    initial one, then the mesh's after step 1, so that a ReLU switched at
    rounding in one step does not carry over): losses within TRAIN_TOL;
    in fp32 every gradient leaf by ``DP_KINK_*`` and the parameters by
    ``compare_adam_params``; the ranks' metrics and parameters equal; the
    route's kernels on both ranks. → its line."""
    from sttode_tpu_torch import bridge
    from sttode_tpu_torch.train import make_train_step
    name, B, dtype, route = case
    agent = name == AGENT_RECIPE
    what = f"phase 21 ({'i' if agent or route == 'ulysses' else 'b'}) " \
        f"{name} {dtype} {route}"
    fp32 = dtype == "float32"
    # the local attention: none in the ring; packed at NBA 32 x 11 and
    # under ulysses on the agent axis, whole-S at the bench recipe
    kernels = ("select_fp32" if fp32 else "select_bf16",) + (
        () if route == "ring" else ("packed", "packed_bwd")
        if B == 32 else ("attn", "attn_bwd"))
    got = [r_[case] for r_ in ranks]
    require(got[0]["metrics"] == got[1]["metrics"] and
            all(g["equal"] for g in got),
            f"{what}: the ranks' metrics or parameters differ")
    cfg, params, batches, noises = parallel_recipe(*case)
    step = make_train_step(cfg._replace(attn_impl="auto"), PARALLEL_LR,
                           device=dev)
    rec = []
    for i, (b, n) in enumerate(zip(batches, noises)):
        p, opt = step.init(*((params,) if i == 0
                             else got[0]["states"][i - 1]))
        p, opt, m = step(p, opt, b.to(dev), noise=_noise_to(n, dev))
        rec.append(({k: float(v) for k, v in m.items()},
                    [t.grad.detach().cpu() for t in bridge.tree_leaves(p)],
                    [t.detach().cpu() for t in bridge.tree_leaves(p)]))
    loss_err, grad_ratio, grad_l2 = 0.0, 0.0, 0.0
    p_err, excused = 0.0, 0
    for i, ((m_ref, g_ref, par), m_got, g_got, st) in enumerate(zip(
            rec, got[0]["metrics"], got[0]["grads"], got[0]["states"])):
        for k, want in m_ref.items():
            tol = TRAIN_TOL * max(1.0, abs(want))
            require(abs(m_got[k] - want) <= tol,
                    f"{what} step {i + 1}: {k} {m_got[k]} vs "
                    f"single-process {want}")
            loss_err = max(loss_err, abs(m_got[k] - want) /
                           max(1.0, abs(want)))
        if fp32:
            for j, (a, b) in enumerate(zip(g_got, g_ref)):
                big = max(float(b.abs().max()), 1e-30)
                ratio = float((a - b).abs().max()) / big
                l2 = float(torch.linalg.vector_norm(a - b)) / max(
                    float(torch.linalg.vector_norm(b)), 1e-30)
                require(ratio <= DP_KINK_ELEM and l2 <= DP_KINK_L2,
                        f"{what} step {i + 1}: gradient leaf {j} differs "
                        f"by {ratio:.3e} of its largest magnitude, "
                        f"{l2:.3e} in relative L2")
                grad_ratio = max(grad_ratio, ratio)
                grad_l2 = max(grad_l2, l2)
            e, x = compare_adam_params(bridge.tree_leaves(st[0]), par,
                                       g_got, g_ref, f"{what} step {i + 1}")
            p_err, excused = max(p_err, e), excused + x
    held = "(gradients and parameters not held: bf16 winners)"
    if fp32:
        held = (f"gradient leaves within {grad_ratio:.3e} of their largest "
                f"and {grad_l2:.3e} in relative L2, parameters within "
                f"{p_err:.3e} ({excused} entries at a gradient at rounding "
                f"or moved)")
    for r_, g in enumerate(got):
        require(all(g["launches"][k] > 0 for k in kernels),
                f"{what}: rank {r_} did not launch {kernels} "
                f"{nonzero(g['launches'])}")
    where = ("a [1, 2, 1] data x seq mesh, 16 agents a scene split over "
             "seq" if agent else "world 2")
    return (f"{what} ({B} x {16 if agent else 11}; {where} on one card over "
            f"gloo, staged through host memory: {ranks[0]['staging']}): 2 "
            f"steps against the single-process step, losses within "
            f"{loss_err:.3e} (relative), {held}, equal on both ranks; "
            f"launches rank 0 {nonzero(got[0]['launches'])}, rank 1 "
            f"{nonzero(got[1]['launches'])}; ms a step rank 0 "
            f"{got[0]['ms']:.3f}, rank 1 {got[1]['ms']:.3f} (host-bound)")


def stage2_seq_world2(dev, ranks) -> str:
    """Phase 21 (i): the ranks' stage-2 steps on the [1, 2, 1] data x seq
    mesh (the frozen net on the agent axis under ulysses) against the
    single-process step (the net on "auto") on the card with the same
    generator seed: losses within TRAIN_TOL, the ranks' metrics and
    sampler parameters equal, P on both ranks, forward only."""
    from sttode_tpu_torch.train import make_sampler_train_step
    cfg, scfg, net, sp0, batches = sampler_recipe(case=AGENT_CASES[1])
    step = make_sampler_train_step(cfg._replace(attn_impl="auto"), scfg,
                                   PARALLEL_LR, net, device=dev)
    p, opt = step.init(sp0)
    gen = torch.Generator(device=dev).manual_seed(211)
    ref = [{k: float(v) for k, v in step(p, opt, b.to(dev), gen)[2].items()}
           for b in batches]
    got = [r["stage2_seq"] for r in ranks]
    what = "phase 21 (i) stage 2 on the [1, 2, 1] data x seq mesh"
    require(got[0]["metrics"] == got[1]["metrics"]
            and all(g["equal"] for g in got),
            f"{what}: the ranks' metrics or parameters differ")
    err = 0.0
    for i, (m, w) in enumerate(zip(got[0]["metrics"], ref)):
        for k in w:
            require(abs(m[k] - w[k]) <= TRAIN_TOL * max(1.0, abs(w[k])),
                    f"{what} step {i + 1}: {k} {m[k]} vs single-process "
                    f"{w[k]}")
            err = max(err, abs(m[k] - w[k]) / max(1.0, abs(w[k])))
    for r, g in enumerate(got):
        require(g["launches"]["packed"] > 0, f"{what}: rank {r} did not "
                f"launch P {nonzero(g['launches'])}")
        stage2_forward_only(g["launches"], f"{what} rank {r}")
    return (f"{what} (the net on the agent axis under ulysses, 32 x 16, ε "
            f"drawn): 2 steps against the single-process step on the card, "
            f"losses within {err:.3e} (relative), the ranks' sampler "
            f"parameters equal bit for bit; launches rank 0 "
            f"{nonzero(got[0]['launches'])}, rank 1 "
            f"{nonzero(got[1]['launches'])}; ms a step rank 0 "
            f"{got[0]['ms']:.3f}, rank 1 {got[1]['ms']:.3f} (host-bound)")


def stage2_world1(dev, mesh, counts, reset) -> tuple[dict, str]:
    """Phase 21 (d) at world 1 over NCCL: the stage-2 step on the NBA
    recipe (32 x 11; ε drawn from a generator of one seed, not shared) on
    the mesh against the single-process step, 2 steps, bit for bit (each
    loss term, gradient leaf and parameter); P in the counters. → (the
    mesh step's launches, its line)."""
    from sttode_tpu_torch import bridge
    from sttode_tpu_torch.parallel import shard_batch
    from sttode_tpu_torch.train import make_sampler_train_step
    cfg, scfg, net, sp0, batches = sampler_recipe()
    names = leaf_names(sp0)
    runs = {}
    for name, m in (("single", None), ("mesh", mesh)):
        step = make_sampler_train_step(cfg, scfg, PARALLEL_LR, net,
                                       device=dev, mesh=m)
        p, opt = step.init(sp0)
        gen = torch.Generator(device=dev).manual_seed(211)
        reset()   # the main path (the mesh step's run is kept)
        record = []
        for b in batches:
            b = b.to(dev) if m is None else shard_batch(b, m).to(dev)
            p, opt, mt = step(p, opt, b, gen)
            record.append((mt, [None if t.grad is None else t.grad.clone()
                                for t in bridge.tree_leaves(p)]))
        torch.cuda.synchronize()
        runs[name] = (record, [t.detach().clone()
                               for t in bridge.tree_leaves(p)], counts())
    (rec_s, par_s, _), (rec_m, par_m, launches) = runs["single"], \
        runs["mesh"]
    for i, ((m_s, g_s), (m_m, g_m)) in enumerate(zip(rec_s, rec_m)):
        for k in m_s:
            require(torch.equal(m_s[k], m_m[k]),
                    f"phase 21 (d) step {i + 1}: {k} {float(m_m[k])!r} on "
                    f"the mesh, {float(m_s[k])!r} single")
        for n_, a, b in zip(names, g_m, g_s):
            require((a is None and b is None) or torch.equal(a, b),
                    f"phase 21 (d) step {i + 1}: the gradient of {n_} "
                    f"differs")
    for n_, a, b in zip(names, par_m, par_s):
        require(torch.equal(a, b), f"phase 21 (d): sampler parameter {n_} "
                f"differs by {max_err(a, b):.3e}")
    require(launches["packed"] > 0, f"phase 21 (d): the stage-2 mesh step "
            f"did not launch P {nonzero(launches)}")
    stage2_forward_only(launches, "phase 21 (d)")
    return launches, (
        f"phase 21 (d) stage 2 (NBA 32 x 11, nk {scfg.nk}, nz {scfg.nz}, "
        f"qnet {scfg.qnet_mlp}, ε drawn, not shared) "
        f"make_sampler_train_step(mesh=) at "
        f"world 1 over NCCL: 2 steps equal the single-process step bit for "
        f"bit (totals " + " ".join(f"{float(m['total']):.6f}"
                                   for m, _ in rec_m)
        + f"; every gradient leaf and sampler parameter); launches "
        f"{nonzero(launches)}")


def ulysses_world1(dev, mesh, counts, reset) -> tuple[dict, list]:
    """Phase 21 (h) at world 1 over NCCL: the stage-1 step with
    ``attn_impl="ulysses"`` on ``mesh`` (the head <-> token all-to-all
    over a one-rank group, the local core on the kernels) at NBA 32 x 11
    (fp32 selection: P, Q, B fp32) and the bench recipe (bf16: A, C, B
    bf16), 2 steps with the global noise, against the single-process
    "auto" step from the same parameters: the losses within TRAIN_TOL,
    in fp32 every gradient leaf within TRAIN_TOL of its largest; whether
    all of it is bit for bit; ms a step of both, alternating. → (the
    Ulysses steps' launches, a line a recipe)."""
    from sttode_tpu_torch import bridge
    from sttode_tpu_torch.parallel import shard_batch
    from sttode_tpu_torch.train import make_train_step
    total, lines = None, []
    for case, kernels in (
            (("NBA reference recipe", 32, "float32", "ulysses"),
             ("packed", "packed_bwd", "select_fp32")),
            (("bench recipe", 128, "bfloat16", "ulysses"),
             ("attn", "attn_bwd", "select_bf16"))):
        what = f"phase 21 (h) {case[0]} {case[2]}"
        cfg, params, batches, noises = parallel_recipe(*case)
        steps = {"single": make_train_step(cfg._replace(attn_impl="auto"),
                                           PARALLEL_LR, device=dev),
                 "ulysses": make_train_step(cfg, PARALLEL_LR, device=dev,
                                            mesh=mesh)}
        local = {"single": [b.to(dev) for b in batches],
                 "ulysses": [shard_batch(b, mesh).to(dev) for b in batches]}
        noises = [_noise_to(n, dev) for n in noises]
        runs = {}
        for name, step in steps.items():
            p, opt = step.init(params)
            leaves = bridge.tree_leaves(p)
            reset()   # the main path (the Ulysses step's run is kept)
            rec = []
            for b, n in zip(local[name], noises):
                p, opt, m = step(p, opt, b, noise=n)
                rec.append(({k: v.clone() for k, v in m.items()},
                            [t.grad.clone() for t in leaves]))
            torch.cuda.synchronize()
            runs[name] = (rec, counts(), p, opt)
        (rec_s, _, _, _), (rec_u, launches, _, _) = runs["single"], \
            runs["ulysses"]
        same, loss_err, grad_err = True, 0.0, 0.0
        for i, ((m_s, g_s), (m_u, g_u)) in enumerate(zip(rec_s, rec_u)):
            for k in m_s:
                want, got = float(m_s[k]), float(m_u[k])
                require(abs(got - want) <= TRAIN_TOL * max(1.0, abs(want)),
                        f"{what} step {i + 1}: {k} {got!r} under ulysses, "
                        f"{want!r} single")
                loss_err = max(loss_err, abs(got - want) / max(1.0,
                                                               abs(want)))
                same = same and torch.equal(m_s[k], m_u[k])
            for j, (a, b) in enumerate(zip(g_u, g_s)):
                same = same and torch.equal(a, b)
                ratio = max_err(a, b) / max(float(b.abs().max()), 1e-30)
                grad_err = max(grad_err, ratio)
                require(case[2] != "float32" or ratio <= TRAIN_TOL,
                        f"{what} step {i + 1}: gradient leaf {j} differs by "
                        f"{ratio:.3e} of its largest magnitude")
        require(all(launches[k] > 0 for k in kernels),
                f"{what}: the Ulysses step did not launch {kernels} "
                f"{nonzero(launches)}")
        ms: dict = {"single": [], "ulysses": []}
        for r in range(6):
            for name in (("single", "ulysses") if r % 2 == 0
                         else ("ulysses", "single")):
                _, _, p_, o_ = runs[name]
                torch.cuda.synchronize()
                t = time.perf_counter()
                steps[name](p_, o_, local[name][0], noise=noises[0])
                torch.cuda.synchronize()
                ms[name].append((time.perf_counter() - t) * 1e3)
        total = launches if total is None else {
            k: total[k] + launches[k] for k in total}
        lines.append(
            f"{what} ({case[1]} x 11) make_train_step(mesh=, "
            f"attn_impl='ulysses') at world 1 over NCCL: 2 steps against "
            f"the single-process 'auto' step, "
            + ("bit for bit (every loss term and gradient leaf)" if same
               else f"losses within {loss_err:.3e} (relative), gradient "
               f"leaves within {grad_err:.3e} of their largest, not bit "
               f"for bit") + f"; launches {nonzero(launches)}; ms a step "
            f"single {statistics.median(ms['single']):.3f}, ulysses "
            f"{statistics.median(ms['ulysses']):.3f}")
    return total, lines


def captured_world1(dev, mesh, counts, reset,
                    route: str = "auto") -> tuple[dict, str]:
    """Phase 21 (e) at world 1 over NCCL: the bench recipe's mesh step at
    ``scan_steps`` 16 (one CUDA graph with its collectives; under
    ``route="ulysses"``, (h), the all-to-alls too): its warm-up chunk,
    then 2 replays against 32 eager mesh steps from the state the warm-up
    left, on the graph's Adam form, bit for bit (each loss term, parameter
    and Adam moment); A, C and B bf16 in the replays' counters; ms a step
    captured against eager. → (the replays' launches, its line)."""
    from sttode_tpu_torch import bridge
    from sttode_tpu_torch.data.preprocess import prepare_scene_group
    from sttode_tpu_torch.data.synthetic import make_social_scenes
    from sttode_tpu_torch.models import sttode as tm
    from sttode_tpu_torch.parallel import shard_batch
    from sttode_tpu_torch.train import (make_train_step, stack_batches,
                                        stack_noise)
    S, B, N = 16, 128, 11
    cfg, params, _, _ = parallel_recipe(*BENCH_BF16)
    cfg = cfg._replace(attn_impl=route).validate()
    what = f"phase 21 ({'h' if route == 'ulysses' else 'e'})"
    gen = torch.Generator(device=dev).manual_seed(212)
    local, noises = [], []
    for i in range(3 * S):
        sc = make_social_scenes(B, agents_range=(N, N), obs_len=5,
                                pred_len=10, seed=2120 + i)
        b, _ = prepare_scene_group(
            np.stack([s_["obs"] for s_ in sc]),
            np.stack([s_["pred"] for s_ in sc]),
            np.ones((B, N), np.float32), training=True,
            rng=np.random.default_rng(2120 + i))
        local.append(shard_batch(b, mesh).to(dev))
        noises.append(tm.draw_train_noise(cfg, B, N, gen, dev))
    graph = make_train_step(cfg, PARALLEL_LR, device=dev, mesh=mesh,
                            scan_steps=S)
    eager = make_train_step(cfg, PARALLEL_LR, device=dev, mesh=mesh)
    require(graph.mode == "graph", f"{what}: the mesh step over NCCL "
            f"runs as {graph.mode!r}")
    pg, og = graph.init(params)
    chunks = [(stack_batches(local[i:i + S]), stack_noise(noises[i:i + S]))
              for i in range(0, 3 * S, S)]
    graph(pg, og, chunks[0][0], noise=chunks[0][1])   # the warm-up chunk
    # the eager side from the same state, on the graph's Adam form
    pe, oe = graph.init(pg, clone_state(og))
    torch.cuda.synchronize()
    t = time.perf_counter()
    me = [eager(pe, oe, b, noise=n)[2]
          for b, n in zip(local[S:], noises[S:])]
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t) * 1e3 / (2 * S)
    reset()   # the main path: two replays of the captured mesh step
    t = time.perf_counter()
    mg = [graph(pg, og, b, noise=n)[2] for b, n in chunks[1:]]
    torch.cuda.synchronize()
    graph_ms = (time.perf_counter() - t) * 1e3 / (2 * S)
    launches = counts()
    for k in mg[0]:
        require(torch.equal(torch.cat([m[k] for m in mg]),
                            torch.stack([m[k] for m in me])),
                f"{what}: the replays' {k} differ from the eager "
                f"mesh steps'")
    for n_, a, b in zip(leaf_names(params), bridge.tree_leaves(pg),
                        bridge.tree_leaves(pe)):
        require(torch.equal(a, b), f"{what}: parameter {n_} differs "
                f"by {max_err(a.detach(), b.detach()):.3e}")
    for a, b in zip(clone_state(og)["state"].values(),
                    clone_state(oe)["state"].values()):
        require(all(torch.equal(a[k], b[k]) for k in a),
                f"{what}: an Adam moment differs")
    require(launches["attn"] > 0 and launches["attn_bwd"] > 0
            and launches["select_bf16"] > 0,
            f"{what}: the replays did not launch A, C and B bf16 "
            f"{nonzero(launches)}")
    stats = graph.graph_stats()
    return launches, (
        f"{what} bench recipe (B = 128 x 11, bf16) attn_impl {route!r} "
        f"make_train_step(mesh=, scan_steps=16) at world 1 over NCCL, mode "
        f"{graph.mode!r}: the warm-up chunk and 2 replays (the gradient "
        f"all-reduce and the loss sums captured"
        + (", the all-to-alls too" if route == "ulysses" else "")
        + f") equal 32 eager mesh steps "
        f"bit for bit (every loss term, parameter and Adam moment); ms a "
        f"step captured {graph_ms:.3f}, eager {eager_ms:.3f} "
        f"({32 * B * 1e3 / (2 * S * graph_ms):.1f} / "
        f"{B * 1e3 / eager_ms:.1f} train scenes/s); capture "
        f"{stats['capture_s']:.2f} s; replays' launches {nonzero(launches)}")


def restore_world1(dev, ckpt_dir: str, saved) -> str:
    """Phase 21 (g): the NBA recipe's checkpoint that rank 0 saved after 2
    steps at world 2, restored at world 1 over NCCL through
    ``restore_shardings``: the parameters and Adam moments equal the
    saved state bit for bit."""
    import torch.distributed as dist
    from sttode_tpu_torch import bridge
    from sttode_tpu_torch.parallel import make_mesh
    from sttode_tpu_torch.train import (checkpoint_path, load_checkpoint,
                                        restore_shardings)
    path = checkpoint_path(ckpt_dir, 2)
    params_t, opt_t, _, _ = load_checkpoint(path)
    dist.init_process_group(
        "nccl", init_method=f"file://{ckpt_dir}/rendezvous", rank=0,
        world_size=1)
    try:
        shardings = restore_shardings(
            {"params": params_t, "opt_state": opt_t, "epoch": 2},
            make_mesh(dp=1))
        params, opt_state, epoch, _ = load_checkpoint(
            path, dev, shardings=shardings)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    want_p, want_o = saved
    require(epoch == 2 and all(torch.equal(a.cpu(), b) for a, b in zip(
        bridge.tree_leaves(params), bridge.tree_leaves(want_p))),
        "phase 21 (g): the restored parameters differ from the saved ones")
    moments = 0
    for i, st in want_o["state"].items():
        for k, v in st.items():
            require(torch.equal(opt_state["state"][i][k].cpu(), v),
                    f"phase 21 (g): Adam state {i} {k} differs")
            moments += 1
    return (f"phase 21 (g) the NBA recipe's state after 2 steps at world 2 "
            f"(gloo), saved by rank 0 and restored at world 1 over NCCL "
            f"with restore_shardings: {len(bridge.tree_leaves(params))} "
            f"parameter leaves and {moments} Adam state tensors equal the "
            f"saved state bit for bit, on {dev}")


def stage2_world2(dev, ranks) -> str:
    """Phase 21 (d) at world 2 over gloo: the ranks' stage-2 mesh steps
    against the single-process step on the card with the same generator
    seed: losses within TRAIN_TOL, the ranks' metrics and sampler
    parameters equal, P on both ranks."""
    from sttode_tpu_torch.train import make_sampler_train_step
    cfg, scfg, net, sp0, batches = sampler_recipe()
    step = make_sampler_train_step(cfg, scfg, PARALLEL_LR, net, device=dev)
    p, opt = step.init(sp0)
    gen = torch.Generator(device=dev).manual_seed(211)
    ref = [{k: float(v) for k, v in step(p, opt, b.to(dev), gen)[2].items()}
           for b in batches]
    got = [r["stage2"] for r in ranks]
    require(got[0]["metrics"] == got[1]["metrics"]
            and all(g["equal"] for g in got),
            "phase 21 (d) world 2: the ranks' metrics or parameters differ")
    err = 0.0
    for i, (m, w) in enumerate(zip(got[0]["metrics"], ref)):
        for k in w:
            require(abs(m[k] - w[k]) <= TRAIN_TOL * max(1.0, abs(w[k])),
                    f"phase 21 (d) world 2 step {i + 1}: {k} {m[k]} vs "
                    f"single-process {w[k]}")
            err = max(err, abs(m[k] - w[k]) / max(1.0, abs(w[k])))
    for r, g in enumerate(got):
        require(g["launches"]["packed"] > 0, f"phase 21 (d) world 2: rank "
                f"{r} did not launch P {nonzero(g['launches'])}")
        stage2_forward_only(g["launches"], f"phase 21 (d) rank {r}")
    return (f"phase 21 (d) stage 2 at world 2 over gloo (16 scenes a "
            f"rank): 2 steps against the single-process step on the card, "
            f"losses within {err:.3e} (relative), the ranks' sampler "
            f"parameters equal bit for bit; launches rank 0 "
            f"{nonzero(got[0]['launches'])}, rank 1 "
            f"{nonzero(got[1]['launches'])}")


def dopri5_world2(dev, ranks, form) -> str:
    """Phase 21 (f), one dopri5 form at world 2 over gloo against the
    single-process step on the card: every solve's attempted and accepted
    steps and RHS evaluations equal on both ranks, the forward solves'
    equal the single process's (the adjoint's backward solves printed
    beside the single process's: in fp32 their error ratios sit on the
    rounding floor); losses within TRAIN_TOL; the gradients as (b) holds
    them, but the adjoint's, within ADJOINT_GRAD_TOL of each leaf's
    largest magnitude; P (and, with a gradient through the encoder, Q and
    kernel B fp32) on both ranks."""
    _, _, batches, noises = parallel_recipe(*PARALLEL_CASES[0])
    metrics, grads, solves = ode_case_step(form, None, dev, batches, noises)
    got = [r[form] for r in ranks]
    what = f"phase 21 (f) dopri5 {form}"
    require(got[0]["solves"] == got[1]["solves"]
            and got[0]["metrics"] == got[1]["metrics"],
            f"{what}: the ranks' solves {got[0]['solves']} / "
            f"{got[1]['solves']} or metrics differ")
    n_fwd = 1 if form == "while form" else 2
    require(got[0]["solves"][:n_fwd] == solves[:n_fwd]
            and len(got[0]["solves"]) == len(solves),
            f"{what}: the forward solves {got[0]['solves']} differ from the "
            f"single process's {solves}")
    loss_err = 0.0
    for k, w in metrics.items():
        m = got[0]["metrics"][k]
        require(abs(m - w) <= TRAIN_TOL * max(1.0, abs(w)),
                f"{what}: {k} {m} vs single-process {w}")
        loss_err = max(loss_err, abs(m - w) / max(1.0, abs(w)))
    ratio = l2 = 0.0
    for j, (a, b) in enumerate(zip(got[0]["grads"], grads)):
        big = max(float(b.abs().max()), 1e-30)
        r_ = float((a - b).abs().max()) / big
        l_ = float(torch.linalg.vector_norm(a - b)) / max(
            float(torch.linalg.vector_norm(b)), 1e-30)
        require(r_ <= ADJOINT_GRAD_TOL if form == "adjoint" else
                (r_ <= DP_KINK_ELEM and l_ <= DP_KINK_L2),
                f"{what}: gradient leaf {j} differs by {r_:.3e} of its "
                f"largest magnitude, {l_:.3e} in relative L2")
        ratio, l2 = max(ratio, r_), max(l2, l_)
    kernels = ("packed",) if form == "while form" else (
        "packed", "packed_bwd", "select_fp32")
    for r, g in enumerate(got):
        require(all(g["launches"][k] > 0 for k in kernels),
                f"{what}: rank {r} did not launch {kernels} "
                f"{nonzero(g['launches'])}")
    backward = ""
    if form == "adjoint":
        backward = (f"; the backward solves {got[0]['solves'][n_fwd:]} on "
                    f"both ranks, {solves[n_fwd:]} in the single process")
    return (f"{what} (rtol 1e-3, atol 1e-6; NBA 32 x 11, world 2 over "
            f"gloo): solves (attempted, accepted, RHS evaluations) "
            f"{got[0]['solves'][:n_fwd]} on both ranks and in the single "
            f"process{backward}; losses within {loss_err:.3e} (relative), "
            f"gradient leaves within {ratio:.3e} of their largest and "
            f"{l2:.3e} in relative L2; {got[0]['s']:.1f} s a step on "
            f"rank "
            f"0; launches rank 0 {nonzero(got[0]['launches'])}, rank 1 "
            f"{nonzero(got[1]['launches'])}")


def launch_counters():
    """(counts, reset): the kernel wrappers' launch counts by name, and
    setting every one to 0 (in this process)."""
    from sttode_tpu_torch.kernels import mhgsa as km
    from sttode_tpu_torch.kernels import packed_mhgsa as kp
    from sttode_tpu_torch.kernels import select_decode as ks
    bf16 = torch.bfloat16

    def counts():
        return {"attn": km.fused_geodesic_attention.launches,
                "attn_bwd": km.fused_geodesic_attention_backward.launches,
                "flash": km.flash_geodesic_attention.launches,
                "flash_dq": km.flash_geodesic_attention_backward.launches_dq,
                "flash_dkv":
                    km.flash_geodesic_attention_backward.launches_dkv,
                "packed": kp.packed_geodesic_attention.launches,
                "packed_bwd": kp.packed_geodesic_attention_backward.launches,
                "select_fp32": ks.select_decode.launches_by_dtype[
                    torch.float32],
                "select_bf16": ks.select_decode.launches_by_dtype[bf16],
                # the whole-S launches with an additive (key) mask
                "attn_masked": km.fused_geodesic_attention.launches_masked,
                "attn_bwd_masked":
                    km.fused_geodesic_attention_backward.launches_masked,
                # the poincaré launches among the geodesic-attention ones
                **{f"{n}_p": d["poincare"] for n, d in by_metric.items()}}

    by_metric = {
        "attn": km.fused_geodesic_attention.launches_by_metric,
        "attn_bwd": km.fused_geodesic_attention_backward.launches_by_metric,
        "flash": km.flash_geodesic_attention.launches_by_metric,
        "flash_dq":
            km.flash_geodesic_attention_backward.launches_dq_by_metric,
        "flash_dkv":
            km.flash_geodesic_attention_backward.launches_dkv_by_metric}

    def reset():
        km.fused_geodesic_attention.launches = 0
        km.fused_geodesic_attention_backward.launches = 0
        km.flash_geodesic_attention.launches = 0
        km.flash_geodesic_attention_backward.launches_dq = 0
        km.flash_geodesic_attention_backward.launches_dkv = 0
        kp.packed_geodesic_attention.launches = 0
        kp.packed_geodesic_attention_backward.launches = 0
        ks.select_decode.launches = 0
        ks.select_decode.launches_by_dtype.update(
            {torch.float32: 0, bf16: 0})
        ks.select_decode.launches_by_mode.update(dist=0, traj=0)
        km.fused_geodesic_attention.launches_masked = 0
        km.fused_geodesic_attention_backward.launches_masked = 0
        for d in by_metric.values():
            d.update(dict.fromkeys(d, 0))

    return counts, reset


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from sttode_tpu_torch import bridge
    from sttode_tpu_torch.data.preprocess import prepare_scene_group
    from sttode_tpu_torch.data.synthetic import make_social_scenes
    from sttode_tpu_torch.kernels import _build
    from sttode_tpu_torch.kernels import mhgsa as km
    from sttode_tpu_torch.kernels import packed_mhgsa as kp
    from sttode_tpu_torch.kernels import select_decode as ks
    from sttode_tpu_torch.models import sttode as tm
    from sttode_tpu_torch.serving import Predictor
    from sttode_tpu_torch.train import make_train_step

    # every plain matmul and conv in full fp32, as the kernels compute
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    bf16 = torch.bfloat16

    # 1. device and build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    t0 = time.perf_counter()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"({_build.library_path().name}, one nvcc per source)")
    ptxas = build_report(_build.library_path())

    counts, reset = launch_counters()

    rng = np.random.default_rng(0)

    def randn(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(dev)

    def repairs(metric, make_qk, label):
        """The masked whole-S forward beyond shared memory (its key-streaming
        mode) at 8 × 1569² × 16, 8 × 2048² × 64 and 8 × 512² × 256, row 0 of
        every problem all excluded, and the flash forward, dq and dk/dv
        sweeps at Dh = 256 with a ragged key validity, in one metric,
        against their plain versions; returns the worst errors (forward,
        flash forward, dq, dk/dv)."""
        kw = dict(metric=metric, curvature=1.0)
        worst = [0.0, 0.0, 0.0, 0.0]
        for B_, S_, Dh_ in ((8, 1569, 16), (8, 2048, 64), (8, 512, 256)):
            require(km.whole_s_smem_bytes(S_, S_, Dh_, metric)[0]
                    > km.SMEM_OPTIN_BYTES, f"{label}: {S_}² x {Dh_} fits")
            q, k = make_qk(B_, S_, Dh_)
            v = randn(B_, S_, Dh_)
            mask = torch.where(torch.from_numpy(rng.random((B_, S_, S_))
                                                < 0.2).to(dev), fmin,
                               randn(B_, S_, S_))
            mask[:, 0] = fmin
            m3 = km._canonicalize_mask(mask)
            del mask
            with torch.inference_mode():
                got = km.fused_geodesic_attention(q, k, v, mask=m3, **kw)
                want = km.fused_geodesic_attention_reference(q, k, v, m3,
                                                             metric, 1.0)
                torch.cuda.synchronize()
                err = max_err(got, want)
                require(bool(torch.isfinite(got).all()) and err <= ATTN_TOL,
                        f"{label} masked {B_} x {S_}² x {Dh_}: max abs err "
                        f"{err} > {ATTN_TOL}")
                require(bool((got[:, 0] == 0).all()),
                        f"{label}: an all-excluded row must output 0")
                t = paired_ms(
                    lambda: km.fused_geodesic_attention(q, k, v, mask=m3,
                                                        **kw),
                    lambda: km.fused_geodesic_attention_reference(
                        q, k, v, m3, metric, 1.0), calls=3, rounds=4)
            worst[0] = max(worst[0], err)
            nb = attn_fwd_work(B_, S_, S_, Dh_, True, metric)
            print(f"{label} masked whole-S forward {B_} x {S_} x {S_} x "
                  f"{Dh_} (key-streaming mode): max_abs_err {err:.3e}; "
                  f"kernel {t[0]:.4f} ms plain {t[1]:.4f} ms; bound "
                  f"{bound(*nb, FP32_FLOP_PER_S)[0]:.4f} ms  [{card}]")
            del q, k, v, m3, got, want
        B_, L_, S_, Dh_ = 4, 1024, 1100, 256
        q, k = make_qk(B_, L_, Dh_)[0], make_qk(B_, S_, Dh_)[1]
        v, do = randn(B_, S_, Dh_), randn(B_, L_, Dh_)
        val = torch.from_numpy(rng.random((B_, S_)) < 0.7).to(dev).float()
        val[0] = 0.0                                # no valid key at all
        with torch.inference_mode():
            out, lse = km._flash_forward(q, k, v, val, **kw)
            want = km.flash_geodesic_attention_reference(q, k, v, val, **kw)
            args = (q, k, v, val, do, lse, torch.sum(do * out, dim=-1),
                    metric, 1.0)
            got_b = (km._launch_flash_dq(*args), *km._launch_flash_dkv(*args))
            want_b = (km.flash_dq_reference(*args),
                      *km.flash_dkv_reference(*args))
            torch.cuda.synchronize()
        errs = {}
        for g_name, g, w, tol in (
                ("out", out, want[0], ATTN_TOL),
                ("lse", lse, want[1], ATTN_TOL),
                *((n, g, w, ATTN_GRAD_TOL * max(1.0, float(w.abs().max())))
                  for n, g, w in zip(("dq", "dk", "dv"), got_b, want_b))):
            require(bool(torch.isfinite(g).all()), f"{label}: {g_name} NaN")
            errs[g_name] = max_err(g, w)
            require(errs[g_name] <= tol, f"{label} flash Dh 256 {g_name}: "
                    f"max abs err {errs[g_name]} > {tol}")
        require(bool((out[0] == 0).all()) and all(
            bool((g[0] == 0).all()) for g in got_b),
            f"{label}: a problem with no valid key must get exact zeros")
        worst[1] = max(errs["out"], errs["lse"])
        worst[2] = errs["dq"]
        worst[3] = max(errs["dk"], errs["dv"])
        with torch.inference_mode():
            t = {"fwd": paired_ms(
                lambda: km._flash_forward(q, k, v, val, **kw),
                lambda: km.flash_geodesic_attention_reference(q, k, v, val,
                                                              **kw),
                calls=3, rounds=4),
                 "dq": paired_ms(lambda: km._launch_flash_dq(*args),
                                 lambda: km.flash_dq_reference(*args),
                                 calls=3, rounds=4),
                 "dkv": paired_ms(lambda: km._launch_flash_dkv(*args),
                                  lambda: km.flash_dkv_reference(*args),
                                  calls=3, rounds=4)}
        bnd = [bound(*w(B_, L_, S_, Dh_, True, metric), FP32_FLOP_PER_S)[0]
               for w in (flash_fwd_work, flash_dq_work, flash_dkv_work)]
        print(f"{label} flash {B_} x {L_} x {S_} x {Dh_}, ragged validity "
              f"(wide mode): max_abs_err " + ", ".join(
                  f"{k_} {v_:.3e}" for k_, v_ in errs.items()) + "; "
              + ", ".join(f"{k_} kernel {v_[0]:.4f} ms plain {v_[1]:.4f} ms"
                          for k_, v_ in t.items())
              + "; bounds fwd {:.4f}, dq {:.4f}, dkv {:.4f} ms".format(*bnd)
              + f"  [{card}]")
        del q, k, v, do, val, out, lse, want, got_b, want_b, args
        torch.cuda.empty_cache()
        return worst

    # 2. kernel A against its plain version, at the paths' shapes
    def flat_mask(mask, lead, L, S):
        B = int(np.prod(lead))
        return None if mask is None else km._canonicalize_mask(
            torch.broadcast_to(mask, (*lead, L, S)).reshape(B, L, S))

    def attn_plain(q, k, v, mask, metric="oblique", curvature=1.0):
        *lead, L, Dh = q.shape
        S = k.shape[-2]
        B = int(np.prod(lead))
        return km.fused_geodesic_attention_reference(
            q.reshape(B, L, Dh), k.reshape(B, S, Dh), v.reshape(B, S, Dh),
            flat_mask(mask, lead, L, S), metric, curvature).reshape(
                *lead, L, Dh)

    fmin = torch.finfo(torch.float32).min
    # training: reference compat, scene axis (128 scenes × 11 agents), swapped
    qt, kt, vt = (randn(11, 8, 128, 8) for _ in range(3))
    # reference compat, scene axis (32 scenes × 11 agents): q/k swapped
    qa, ka, va = randn(11, 8, 32, 8), randn(11, 8, 32, 8), randn(11, 8, 32, 8)
    # agent axis (64 scenes × 8 agents), key mask with padded agents
    valid = torch.from_numpy(rng.random((64, 8)) < 0.8).to(dev)
    valid[:, 0] = True
    qb, kb, vb = randn(64, 8, 8, 8), randn(64, 8, 8, 8), randn(64, 8, 8, 8)
    mask_b = torch.zeros(64, 1, 1, 8, device=dev).masked_fill(
        ~valid[:, None, None, :], fmin)
    # one scene with every key excluded (rows must output exactly 0)
    mask_c = torch.zeros(2, 1, 8, 8, device=dev)
    mask_c[1] = fmin
    qc, kc, vc = randn(2, 8, 8, 8), randn(2, 8, 8, 8), randn(2, 8, 8, 8)
    attn_cases = {
        "train_scene_axis_q11x8x128x8_swapped": (kt, qt, vt, None),
        "scene_axis_q11x8x32x8_swapped": (ka, qa, va, None),
        "agent_axis_q64x8x8x8_masked": (qb, kb, vb, mask_b),
        "all_excluded_scene": (qc, kc, vc, mask_c),
    }
    attn_err, attn_times = 0.0, {}
    with torch.inference_mode():
        for name, (q, k, v, mask) in attn_cases.items():
            got = km.fused_geodesic_attention(q, k, v, mask=mask)
            want = attn_plain(q, k, v, mask)
            torch.cuda.synchronize()
            err = max_err(got, want)
            require(bool(torch.isfinite(got).all()), f"{name}: non-finite")
            require(err <= ATTN_TOL, f"{name}: max abs err {err} > {ATTN_TOL}")
            attn_err = max(attn_err, err)
            ms, plain_ms = paired_ms(
                lambda: km.fused_geodesic_attention(q, k, v, mask=mask),
                lambda: attn_plain(q, k, v, mask))
            attn_times[name] = (ms, plain_ms)
            print(f"attention {name}: max_abs_err {err:.3e}  kernel "
                  f"{ms:.4f} ms  plain {plain_ms:.4f} ms  [{card}]")
        require(bool((km.fused_geodesic_attention(qc, kc, vc, mask=mask_c)[1]
                      == 0).all()), "all-excluded rows must output 0")

    def select_rate(params, cfg, M, K, mode, ms, dtype):
        """Kernel B's achieved matrix TFLOP/s at ``ms`` and its share of
        the tensor-core bound (and of the fp32-core bound of kernel B's
        earlier, SIMT design)."""
        work = select_work(
            ks.prep_select_weights(params, 2 * cfg.hidden_dim, cfg.zdim,
                                   cfg.past_length, cfg.future_length,
                                   dtype), M, K, 2 * cfg.hidden_dim,
            cfg.zdim, cfg.past_length, cfg.future_length, mode)
        tc, simt = select_bound(work, dtype), select_bound(work, dtype, True)
        return (f"{work[1] / ms / 1e9:.2f} TFLOP/s of matrix products; "
                f"bound {tc[0]:.4f} ms ({tc[1]}; {tc[0] / ms:.3f} of it), "
                f"fp32-core bound {simt[0]:.4f} ms ({simt[0] / ms:.3f})")

    # 3. kernel B (fp32) against its plain version; the training step's
    #    shape (M = 1408, K = 20, 5 / 10 steps) runs in mode "dist"
    select_cases = {}
    for name, (M, K, t_past, t_fut, modes) in {
            "M512_K20": (512, 20, 8, 12, ("traj", "dist")),
            "M352_K20": (352, 20, 5, 10, ("traj", "dist")),
            "M1408_K20": (1408, 20, 5, 10, ("dist",)),
            # the NBA recipe at B = 2304 scenes × 11 agents
            "M25344_K20": (25344, 20, 5, 10, ("dist",))}.items():
        cfg = tm.STTODEConfig(past_length=t_past, future_length=t_fut)
        select_cases[name] = (cfg, bridge.to_device(tm.sttode_init(7, cfg),
                                                    dev), M, K, modes)
    select_err, select_times, select_ops = 0.0, {}, {}
    with torch.inference_mode():
        for name, (cfg, params, M, K, modes) in select_cases.items():
            past = randn(M, cfg.past_length, 2)
            ops = [randn(M, 2 * cfg.hidden_dim), randn(K, M, cfg.zdim),
                   tm.decode_block0_state(params, past), past.reshape(M, -1),
                   randn(M, 2 * cfg.future_length)]
            select_ops[name] = (params, ops)

            def plain(mode, cfg=cfg, params=params, ops=ops, dtype=None):
                return ks.select_decode_reference(
                    ks.prep_select_weights(params, 2 * cfg.hidden_dim,
                                           cfg.zdim, cfg.past_length,
                                           cfg.future_length,
                                           dtype or torch.float32),
                    *ops, mode=mode)

            for mode in modes:
                got = ks.select_decode(params, *ops, mode=mode)
                want = plain(mode)
                torch.cuda.synchronize()
                err = max_err(got, want)
                require(bool(torch.isfinite(got).all()), f"{name}: non-finite")
                require(err <= SELECT_TOL,
                        f"{name} {mode}: max abs err {err} > {SELECT_TOL}")
                select_err = max(select_err, err)
                extra = ""
                if mode == "dist":
                    g_win, w_win = got.argmin(1), want.argmin(1)
                    gap = (want.gather(1, g_win[:, None])
                           - want.gather(1, w_win[:, None])).abs()
                    ties = int((g_win != w_win).sum())
                    require(bool((gap <= 2 * SELECT_TOL).all()),
                            f"{name}: argmin winners differ beyond near-ties")
                    extra = f", winners differ at {ties} near-ties"
                if mode == "traj" or name in ("M1408_K20", "M25344_K20"):
                    big = name == "M25344_K20"
                    ms, plain_ms = paired_ms(
                        lambda: ks.select_decode(params, *ops, mode=mode),
                        lambda: plain(mode), calls=3 if big else 10,
                        rounds=4 if big else 6)
                    select_times[f"{mode}_{name}"] = (ms, plain_ms)
                    extra += (f"  kernel {ms:.4f} ms  plain {plain_ms:.4f} "
                              f"ms; {select_rate(params, cfg, M, K, mode, ms, torch.float32)}"
                              f"  [{card}]")
                print(f"select {mode}_{name}: max_abs_err {err:.3e}{extra}")

    # 4. the serving path, agent axis (64 scenes × 8 agents per call)
    cfg4 = tm.STTODEConfig(compat="tpu", attn_axis="agent").validate()
    params4 = tm.sttode_init(0, cfg4)
    scenes4 = [s["obs"] for s in make_social_scenes(
        64, agents_range=(8, 8), seed=0)]
    kernel4 = Predictor(params4, cfg4, device=dev, max_group=64)
    plain4 = Predictor(params4, cfg4._replace(attn_impl="dense",
                                              select_impl="xla"),
                       device=dev, max_group=64)
    kernel4.warmup([8], scenes_per=64)
    plain4.warmup([8], scenes_per=64)
    reset()   # the plain routes launch no kernel: the counts are the path's
    (out4, p50_4, rate_4), (ref4, p50_4p, rate_4p) = serve_rounds(
        (kernel4, plain4), scenes4, 20)
    torch.cuda.synchronize()
    launches4 = counts()
    require(launches4["attn"] > 0 and launches4["select_fp32"] > 0,
            f"phase 4: a kernel was not launched by the serving path "
            f"{launches4}")
    err4 = compare(out4, ref4, [(20, 8, 12, 2)] * 64, "phase 4")
    print(f"phase 4 agent-axis server, 64 scenes x 8 agents/call: "
          f"max_abs_err vs plain {err4:.3e}; kernels p50 {p50_4:.3f} ms, "
          f"{rate_4:.1f} scenes/s; plain p50 {p50_4p:.3f} ms, "
          f"{rate_4p:.1f} scenes/s; launches {launches4}")

    # 5. reference compat: sttode_inference on 32 scenes × 11 agents, and a
    #    default-config Predictor answering single-scene requests
    cfg5 = tm.STTODEConfig(past_length=5, future_length=10).validate()
    params5 = bridge.to_device(tm.sttode_init(1, cfg5), dev)
    sc5 = make_social_scenes(32, agents_range=(11, 11), obs_len=5,
                             pred_len=10, seed=1)
    obs5 = np.stack([s["obs"] for s in sc5])
    batch5, _ = prepare_scene_group(obs5, np.zeros((32, 11, 10, 2),
                                                   np.float32),
                                    np.ones((32, 11), np.float32),
                                    training=False)
    batch5 = batch5.to(dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    z5 = torch.randn(32 * 11 * 20, cfg5.zdim, device=dev, generator=gen)
    plain_cfg5 = cfg5._replace(attn_impl="dense", select_impl="xla")
    cfg_def = tm.STTODEConfig().validate()
    params_def = tm.sttode_init(2, cfg_def)
    kernel_def = Predictor(params_def, cfg_def, device=dev)
    plain_def = Predictor(params_def, cfg_def._replace(
        attn_impl="dense", select_impl="xla"), device=dev)
    singles = [s["obs"] for s in make_social_scenes(
        8, agents_range=(3, 12), seed=3)]
    kernel_def.warmup([8, 12])
    plain_def.warmup([8, 12])
    with torch.inference_mode():
        tm.sttode_inference(params5, cfg5, batch5, z=z5)
        torch.cuda.synchronize()
        reset()
        got5 = tm.sttode_inference(params5, cfg5, batch5, z=z5)
        (out_def, p50_d, rate_d), (ref_def, p50_dp, rate_dp) = serve_rounds(
            (kernel_def, plain_def), singles, 6, single=True)
        torch.cuda.synchronize()
        launches5 = counts()
        want5 = tm.sttode_inference(params5, plain_cfg5, batch5, z=z5)
        ms5, ms5p = paired_ms(
            lambda: tm.sttode_inference(params5, cfg5, batch5, z=z5),
            lambda: tm.sttode_inference(params5, plain_cfg5, batch5, z=z5),
            calls=5)
    # both are small problems (32 × 32 and, isolated, 1 × 1 per scene): the
    # packed kernel serves them
    require(launches5["packed"] > 0 and launches5["select_fp32"] > 0,
            f"phase 5: a kernel was not launched {launches5}")
    require(tuple(got5.shape) == (20, 352, 10, 2), f"phase 5 shape {got5.shape}")
    require(bool(torch.isfinite(got5).all()), "phase 5: non-finite")
    err5 = max_err(got5, want5)
    require(err5 <= MODEL_TOL, f"phase 5: max abs err {err5} > {MODEL_TOL}")
    err_def = compare(out_def, ref_def,
                      [(20, len(s), 12, 2) for s in singles], "phase 5 server")
    print(f"phase 5 reference compat, sttode_inference 32 scenes x 11 agents: "
          f"max_abs_err vs plain {err5:.3e}; kernels {ms5:.3f} ms/call "
          f"({32e3 / ms5:.1f} scenes/s), plain {ms5p:.3f} ms/call "
          f"({32e3 / ms5p:.1f} scenes/s)")
    print(f"phase 5 default-config server, single-scene requests: "
          f"max_abs_err vs plain {err_def:.3e}; kernels p50 {p50_d:.3f} ms, "
          f"{rate_d:.1f} scenes/s; plain p50 {p50_dp:.3f} ms, "
          f"{rate_dp:.1f} scenes/s; launches {launches5}")

    # 6. kernel C (attention backward) against its plain backward
    def bwd_case(q, k, v, mask, do, lead, L, S):
        B, Dh = int(np.prod(lead)), q.shape[-1]
        return (q.reshape(B, L, Dh), k.reshape(B, S, Dh), v.reshape(B, S, Dh),
                flat_mask(mask, lead, L, S), do.reshape(B, L, Dh))

    mask_e = 2.0 * randn(3, 1, 9, 9)                # finite, with one row
    mask_e[:, :, 0] = fmin                          # all excluded
    bwd_cases = {
        "train_scene_axis_q11x8x128x8_swapped": bwd_case(
            kt, qt, vt, None, randn(11, 8, 128, 8), (11, 8), 128, 128),
        "agent_axis_q64x8x8x8_masked": bwd_case(
            qb, kb, vb, mask_b, randn(64, 8, 8, 8), (64, 8), 8, 8),
        "all_excluded_row_q3x1x9x8": bwd_case(
            randn(3, 1, 9, 8), randn(3, 1, 9, 8), randn(3, 1, 9, 8), mask_e,
            randn(3, 1, 9, 8), (3, 1), 9, 9),
    }
    bwd_err, bwd_times = 0.0, {}
    for name, args in bwd_cases.items():
        got = km.fused_geodesic_attention_backward(*args, need_dmask=True)
        want = km.fused_geodesic_attention_backward_reference(*args, True)
        torch.cuda.synchronize()
        errs = {}
        for g_name, g, w in zip(("dq", "dk", "dv", "dmask"), got, want):
            if w is None:
                require(g is None, f"{name}: {g_name} not asked for")
                continue
            require(bool(torch.isfinite(g).all()), f"{name}: {g_name} NaN")
            err = max_err(g, w)
            tol = ATTN_GRAD_TOL * max(1.0, float(w.abs().max()))
            require(err <= tol, f"{name} {g_name}: max abs err {err} > {tol}")
            errs[g_name] = err
            bwd_err = max(bwd_err, err)
        if name.startswith("all_excluded"):
            require(bool((got[0][:, 0] == 0).all() and
                         (got[3][:, 0] == 0).all()),
                    "an all-excluded row must get a zero gradient")
        ms, plain_ms = paired_ms(
            lambda: km.fused_geodesic_attention_backward(
                *args, need_dmask=args[3] is not None),
            lambda: km.fused_geodesic_attention_backward_reference(
                *args, args[3] is not None))
        bwd_times[name] = (ms, plain_ms)
        print(f"attention backward {name}: max_abs_err " + ", ".join(
            f"{k} {v:.3e}" for k, v in errs.items())
            + f"  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  [{card}]")

    # C at the bench recipe's shape: its mode (the small-S mode of
    # csrc/small_bwd.cuh takes it), wrapper ms, host µs per call and device
    # µs; then its launch-path floor
    c_args = bwd_cases["train_scene_axis_q11x8x128x8_swapped"]
    require(km.small_bwd_mode(128, 128, 8),
            "phase 6: the small-S mode does not take 88 x 128² x 8")
    with torch.inference_mode():
        c_host = host_us(lambda: km.fused_geodesic_attention_backward(
            *c_args))
        c_dev = device_us(lambda: km.fused_geodesic_attention_backward(
            *c_args))
    print("attention backward (C) at 88 x 128 x 128 x 8: small-S mode ("
          + ", ".join(f"{k} {v}" for k, v in
                      km.small_bwd_layout(128, 128, 8).items())
          + f"), wrapper "
          f"{bwd_times['train_scene_axis_q11x8x128x8_swapped'][0]:.4f} ms, "
          f"host {c_host:.1f} µs/call, device "
          + ("not measured" if c_dev is None else f"{c_dev:.2f} µs")
          + f"  [{card}]")
    launch_floor(lambda *a: km.fused_geodesic_attention_backward(*a),
                 (randn(1, 1, 8), randn(1, 1, 8), randn(1, 1, 8), None,
                  randn(1, 1, 8)), c_args, card, "attention backward (C)")

    # the attention route at the training shape, forward + backward: the
    # kernels (the port's route) against the dense plain path (the route the
    # JAX package's TPU crossover would pick at L = S = 128)
    from sttode_tpu_torch.nn.attention import geodesic_attention
    qr, kr, vr = (t.clone().requires_grad_() for t in (qt, kt, vt))
    g_out = randn(11, 8, 128, 8)

    def attn_route(fused):
        out, _ = geodesic_attention(qr, kr, vr, compat="reference",
                                    fused=fused, need_weights=False)
        return torch.autograd.grad(out, (qr, kr, vr), g_out)

    g_kernel, g_dense = attn_route(True), attn_route(False)
    route_err = max(max_err(a, b) for a, b in zip(g_kernel, g_dense))
    route_tol = ATTN_GRAD_TOL * max(1.0, max(float(b.abs().max())
                                             for b in g_dense))
    require(route_err <= route_tol, f"attention route at the training "
            f"shape: gradients differ by {route_err} > {route_tol}")
    route_ms = paired_ms(lambda: attn_route(True), lambda: attn_route(False))
    print(f"attention route at the training shape, forward + backward: "
          f"kernels {route_ms[0]:.4f} ms, dense {route_ms[1]:.4f} ms "
          f"(gradients agree to {route_err:.3e})  [{card}]")

    # 7. kernel B in bf16 against its bf16 plain version: the training
    #    step's shape and the B = 2304 scene batch's
    cfg7 = select_cases["M1408_K20"][0]
    params7, ops7 = select_ops["M1408_K20"]
    weights7 = ks.prep_select_weights(params7, 2 * cfg7.hidden_dim,
                                      cfg7.zdim, cfg7.past_length,
                                      cfg7.future_length, bf16)
    sel16_err, sel16_times = 0.0, {}
    for name in ("M1408_K20", "M25344_K20"):
        params_, ops_ = select_ops[name]
        M_ = ops_[0].shape[0]
        big = name == "M25344_K20"
        with torch.inference_mode():
            got = ks.select_decode(params_, *ops_, mode="dist", dtype=bf16)
            want = ks.select_decode_reference(
                ks.prep_select_weights(params_, 2 * cfg7.hidden_dim,
                                       cfg7.zdim, cfg7.past_length,
                                       cfg7.future_length, bf16),
                *ops_, mode="dist")
            fp32 = ks.select_decode(params_, *ops_, mode="dist")
            torch.cuda.synchronize()
            err = max_err(got, want)
            scale = float(want.abs().max())
            require(bool(torch.isfinite(got).all()),
                    f"bf16 select {name}: non-finite")
            require(err <= SELECT_BF16_TOL * scale,
                    f"bf16 select {name}: max abs err {err} > "
                    f"{SELECT_BF16_TOL} x {scale}")
            sel16_err = max(sel16_err, err)
            rows = torch.arange(got.shape[0], device=dev)
            g_win, w_win = got.argmin(1), want.argmin(1)
            gap = (want[rows, g_win] - want[rows, w_win]).abs()
            flips = int((g_win != w_win).sum())
            require(bool((gap <= 2 * SELECT_BF16_TOL * scale).all()),
                    f"bf16 select {name}: winners differ beyond near-ties")
            vs32 = int((g_win != fp32.argmin(1)).sum())
            ms, plain_ms = paired_ms(
                lambda: ks.select_decode(params_, *ops_, mode="dist",
                                         dtype=bf16),
                lambda: ks.select_decode_reference(
                    ks.prep_select_weights(params_, 2 * cfg7.hidden_dim,
                                           cfg7.zdim, cfg7.past_length,
                                           cfg7.future_length, bf16),
                    *ops_, mode="dist"),
                calls=3 if big else 10, rounds=4 if big else 6)
            sel16_times[name] = (ms, plain_ms)
        print(f"select bf16 dist_{name}: max_abs_err {err:.3e} (distance "
              f"scale {scale:.1f}), winners differ from the bf16 plain "
              f"version at {flips} near-ties (from fp32 at {vs32}); kernel "
              f"{ms:.4f} ms  plain {plain_ms:.4f} ms; "
              f"{select_rate(params_, cfg7, M_, 20, 'dist', ms, bf16)}"
              f"  [{card}]")
    sel16_ms, sel16_plain = sel16_times["M1408_K20"]
    del got, want, fp32

    # 8. the stage-1 training step, B = 128 scenes × 11 agents
    B8, N8 = 128, 11
    M8 = B8 * N8
    cfg8 = tm.STTODEConfig(past_length=5, future_length=10,
                           select_dtype="bfloat16",
                           decode_dtype="bfloat16").validate()
    cfg8_32 = cfg8._replace(select_dtype="float32",
                            decode_dtype="float32").validate()

    def plain_route(c):
        return c._replace(attn_impl="dense", select_impl="xla")

    sc8 = make_social_scenes(B8, agents_range=(N8, N8), obs_len=5,
                             pred_len=10, seed=8)
    batch8, _ = prepare_scene_group(
        np.stack([s["obs"] for s in sc8]), np.stack([s["pred"] for s in sc8]),
        np.ones((B8, N8), np.float32), training=True,
        rng=np.random.default_rng(8))
    batch8 = batch8.to(dev)
    params8 = tm.sttode_init(8, cfg8)
    gen = torch.Generator(device=dev).manual_seed(8)
    D, Z, K = cfg8.hidden_dim, cfg8.zdim, cfg8.sample_k
    noise = tm.TrainNoise(
        torch.rand(M8, 5, D, device=dev, generator=gen) >= cfg8.pe_dropout,
        torch.rand(M8, 10, D, device=dev, generator=gen) >= cfg8.pe_dropout,
        torch.randn(M8, Z, device=dev, generator=gen),
        torch.randn(M8 * K, Z, device=dev, generator=gen))

    step_k = make_train_step(cfg8, 1e-4, device=dev)
    params_k, opt_k = step_k.init(params8)
    reset()   # the main path: fp32 variant once, then the bf16 recipe
    p_k, out_k, g_k = forward_backward(params8, cfg8_32, batch8, noise, dev)
    losses = []
    for _ in range(TRAIN_STEPS):
        params_k, opt_k, m = step_k(params_k, opt_k, batch8, gen)
        losses.append(m)
    torch.cuda.synchronize()
    launches8 = counts()
    require(all(launches8[n] > 0 for n in ("attn", "attn_bwd", "select_fp32",
                                           "select_bf16")),
            f"phase 8: a kernel was not launched by the training path "
            f"{launches8}")
    for i, m in enumerate(losses):
        require(all(bool(torch.isfinite(v)) for v in m.values()),
                f"phase 8: non-finite loss at step {i}: {m}")

    # the fp32 kernel route against the plain route
    _, out_p, g_p = forward_backward(params8, plain_route(cfg8_32), batch8,
                                     noise, dev)
    loss_err, grad_ratio, worst, _ = compare_routes(out_k, g_k, out_p, g_p,
                                                    "phase 8")
    with torch.inference_mode():
        # both routes' winners on the same latents
        pf = out_k.past_feature.detach()
        state0 = tm.decode_block0_state(p_k, batch8.past)
        pz = noise.eps_p
        dist_k = ks.select_decode(
            p_k, pf, pz.reshape(M8, K, -1).transpose(0, 1), state0,
            batch8.past.reshape(M8, -1),
            (batch8.future - batch8.cur_location).reshape(M8, -1))
        rel, _ = tm.decode(p_k, cfg8_32, pf.repeat_interleave(K, 0), pz,
                           batch8.past, batch8.cur_location, K,
                           block0_state=state0)
        dist_p = torch.sum(torch.square(
            batch8.future[:, None] - rel.reshape(M8, K, 10, 2)), dim=(-1, -2))
        d_err = max_err(dist_k, dist_p)
        srt = dist_p.sort(1).values
        near = int(((srt[:, 1] - srt[:, 0]) <= 2 * d_err).sum())
        rows = torch.arange(M8, device=dev)
        w_k, w_p = dist_k.argmin(1), dist_p.argmin(1)
        flips = int((w_k != w_p).sum())
        require(bool(((w_k == w_p) | ((dist_p[rows, w_k] - dist_p[rows, w_p])
                                      .abs() <= 2 * d_err)).all()),
                "phase 8: winners differ beyond near-ties")
    print(f"phase 8 fp32 training forward+backward, kernel vs plain route: "
          f"loss terms within {loss_err:.3e} (relative), gradients within "
          f"{grad_ratio:.3e} of each leaf's largest magnitude (worst leaf "
          f"{worst}); winners differ at {flips} rows, {near} near-ties found "
          f"(distance error {d_err:.3e})")
    print(f"phase 8 bf16 recipe, {TRAIN_STEPS} Adam steps on the kernel "
          f"route: total loss {float(losses[0]['total']):.4f} -> "
          f"{float(losses[-1]['total']):.4f}; launches {launches8}")

    # step time and train scenes/s of both routes (bf16 recipe), alternating
    step_p = make_train_step(plain_route(cfg8), 1e-4, device=dev)
    params_p, opt_p = step_p.init(params8)
    step_times([[step_k, params_k, opt_k], [step_p, params_p, opt_p]],
               batch8, gen, B8, "phase 8 bf16 recipe step", card)

    # 9. the packed kernels (forward and backward) against their plain
    #    versions; kernels A and C at the same shapes are the yardstick of the
    #    route's packed boundary
    kv64 = valid.to(torch.float32)
    kv64[3] = 0.0                                   # a problem with no key
    packed_cases = {
        "nba_recipe_q11x8x32x8_swapped": (ka, qa, va, None),
        "kv_valid_q64x8x8x8_one_all_invalid": (qb, kb, vb, kv64),
        "single_scene_q88x8x1x8": (randn(88, 8, 1, 8), randn(88, 8, 1, 8),
                                   randn(88, 8, 1, 8), None),
        "rectangular_q4x8x16x8_s64": (
            randn(4, 8, 16, 8), randn(4, 8, 64, 8), randn(4, 8, 64, 8),
            torch.from_numpy(rng.random((4, 64)) < 0.7).to(dev).float()),
        "h16_dh8_q2x16x8x8": (
            randn(2, 16, 8, 8), randn(2, 16, 8, 8), randn(2, 16, 8, 8),
            torch.from_numpy(rng.random((2, 8)) < 0.7).to(dev).float()),
    }
    packed_err, packed_bwd_err, packed_times = 0.0, 0.0, {}
    for name, (q, k, v, kv) in packed_cases.items():
        do = randn(*q.shape)
        with torch.inference_mode():
            got = kp.packed_geodesic_attention(q, k, v, kv_valid=kv)
            want = kp.packed_geodesic_attention_reference(q, k, v, kv)
            gots = kp.packed_geodesic_attention_backward(q, k, v, kv, do)
            wants = kp.packed_geodesic_attention_backward_reference(
                q, k, v, kv, do)
            torch.cuda.synchronize()
        err = max_err(got, want)
        require(bool(torch.isfinite(got).all()), f"{name}: non-finite")
        require(err <= ATTN_TOL, f"{name}: max abs err {err} > {ATTN_TOL}")
        packed_err = max(packed_err, err)
        errs = {}
        for g_name, g, w in zip(("dq", "dk", "dv"), gots, wants):
            require(bool(torch.isfinite(g).all()), f"{name}: {g_name} NaN")
            e = max_err(g, w)
            tol = ATTN_GRAD_TOL * max(1.0, float(w.abs().max()))
            require(e <= tol, f"{name} {g_name}: max abs err {e} > {tol}")
            errs[g_name] = e
            packed_bwd_err = max(packed_bwd_err, e)
        if kv is not None and not bool(kv.any(dim=-1).all()):
            dead = ~kv.any(dim=-1)
            require(bool((got[dead] == 0).all()) and all(
                bool((g[dead] == 0).all()) for g in gots),
                f"{name}: a problem with no valid key must output exactly 0 "
                f"and get exactly zero gradients")
        with torch.inference_mode():
            fwd = paired_ms(
                lambda: kp.packed_geodesic_attention(q, k, v, kv_valid=kv),
                lambda: kp.packed_geodesic_attention_reference(q, k, v, kv))
            bwd = paired_ms(
                lambda: kp.packed_geodesic_attention_backward(q, k, v, kv,
                                                              do),
                lambda: kp.packed_geodesic_attention_backward_reference(
                    q, k, v, kv, do))
            h_us = host_us(
                lambda: kp.packed_geodesic_attention(q, k, v, kv_valid=kv))
            hb_us = host_us(lambda: kp.packed_geodesic_attention_backward(
                q, k, v, kv, do))
            d_us = [device_us(fn) for fn in (
                lambda: kp.packed_geodesic_attention(q, k, v, kv_valid=kv),
                lambda: kp.packed_geodesic_attention_backward(q, k, v, kv,
                                                              do))]
        packed_times[name] = (fwd, bwd)
        body = ("small_bwd.cuh's body" if kp.packed_bwd_small(
            q.shape[-2], k.shape[-2], q.shape[-1]) else "the warp kernel")
        print(f"packed {name}: forward max_abs_err {err:.3e}, kernel "
              f"{fwd[0]:.4f} ms (host {h_us:.1f} µs/call, device "
              + ("not measured" if d_us[0] is None else f"{d_us[0]:.2f} µs")
              + f"), plain {fwd[1]:.4f} ms; backward ({body}) max_abs_err "
              + ", ".join(f"{k_} {v_:.3e}" for k_, v_ in errs.items())
              + f", kernel {bwd[0]:.4f} ms (host {hb_us:.1f} µs/call, "
              "device " + ("not measured" if d_us[1] is None else
                           f"{d_us[1]:.2f} µs")
              + f"), plain {bwd[1]:.4f} ms  [{card}]")
    launch_floor(kp.packed_geodesic_attention,
                 (randn(1, 1, 1, 8), randn(1, 1, 1, 8), randn(1, 1, 1, 8)),
                 packed_cases["nba_recipe_q11x8x32x8_swapped"][:3], card,
                 "packed forward (P)")
    # Q's floor, on inputs of their own generator (the later phases' inputs
    # stay those of the script's one stream)
    rng_q = np.random.default_rng(90)

    def randn_q(*shape):
        return torch.from_numpy(rng_q.standard_normal(shape).astype(
            np.float32)).to(dev)
    launch_floor(lambda q, k, v, do: kp.packed_geodesic_attention_backward(
        q, k, v, None, do), tuple(randn_q(1, 1, 1, 8) for _ in range(4)),
        (*packed_cases["nba_recipe_q11x8x32x8_swapped"][:3],
         randn_q(11, 8, 32, 8)), card, "packed backward (Q)")

    def flat3(x):
        return x.reshape(-1, *x.shape[-2:])

    with torch.inference_mode():
        for name, (q, k, v, _) in (
                ("nba_recipe_q11x8x32x8_swapped",
                 packed_cases["nba_recipe_q11x8x32x8_swapped"]),
                ("single_scene_q88x8x1x8",
                 packed_cases["single_scene_q88x8x1x8"])):
            do = randn(*q.shape)
            q3, k3, v3, do3 = (flat3(t) for t in (q, k, v, do))
            fwd = paired_ms(lambda: kp.packed_geodesic_attention(q, k, v),
                            lambda: km.fused_geodesic_attention(q, k, v))
            bwd = paired_ms(
                lambda: kp.packed_geodesic_attention_backward(q, k, v, None,
                                                              do),
                lambda: km.fused_geodesic_attention_backward(q3, k3, v3,
                                                             None, do3))
            dev_us = [device_us(fn) for fn in (
                lambda: kp.packed_geodesic_attention(q, k, v),
                lambda: km.fused_geodesic_attention(q, k, v),
                lambda: kp.packed_geodesic_attention_backward(q, k, v, None,
                                                              do),
                lambda: km.fused_geodesic_attention_backward(q3, k3, v3,
                                                             None, do3))]
            dev_txt = ("device time not measured (no device time in the "
                       "trace)" if None in dev_us else
                       "device µs/launch: forward packed {:.2f} vs A {:.2f}, "
                       "backward packed {:.2f} vs C {:.2f}".format(*dev_us))
            print(f"route yardstick {name}: wrapper forward packed "
                  f"{fwd[0]:.4f} ms vs kernel A {fwd[1]:.4f} ms; backward "
                  f"packed {bwd[0]:.4f} ms vs kernel C {bwd[1]:.4f} ms; "
                  f"{dev_txt}  [{card}]")

    # 10. the slice end to end: the NBA reference recipe through the port's
    #     CLIs (synthetic NBA files in the dataset's format), then the fp32
    #     step at B = 32 on the kernel route against the plain route
    from sttode_tpu_torch.cli import test as cli_test
    from sttode_tpu_torch.cli import train as cli_train
    from sttode_tpu_torch.data.nba import load_nba, nba_batches
    from sttode_tpu_torch.data.preprocess import prepare_nba_batch
    from sttode_tpu_torch.train import step_lr

    def nba_files(tmp, n_train, seed):
        """Synthetic NBA files in the dataset's format ([S, 15, 11, 2] feet,
        random walks from ``seed``): ``n_train`` train and 256 test scenes
        under ``tmp``; returns their directory and the CLIs' flags."""
        nba_dir = os.path.join(tmp, "data", "nba")
        os.makedirs(nba_dir)
        data_rng = np.random.default_rng(seed)
        for fname, n in (("train.npy", n_train), ("test.npy", 2 * 128)):
            start = data_rng.uniform([0.0, 0.0], [94.0, 50.0],
                                     size=(n, 1, 11, 2))
            walk = data_rng.normal(0.0, 1.0, size=(n, 15, 11, 2)).cumsum(1)
            np.save(os.path.join(nba_dir, fname),
                    (start + walk).astype(np.float32))
        return nba_dir, ["--dataset", "nba", "--data_root",
                         os.path.join(tmp, "data"), "--ckpt_dir",
                         os.path.join(tmp, "ck"), "--log_every", "0",
                         "--model_save_epoch", "1"]

    steps10 = 20                                    # train steps per epoch
    with tempfile.TemporaryDirectory(dir=HERE, prefix=".smoke_nba_") as tmp:
        nba_dir, flags = nba_files(tmp, steps10 * 32, 10)
        reset()   # the main path: train, resume, evaluate
        run10 = cli_train.main(flags + ["--num_epochs", "2"])
        resumed = cli_train.main(flags + ["--num_epochs", "2",
                                          "--epoch_continue", "1"])
        torch.cuda.synchronize()
        launches10_train = counts()
        best10 = cli_test.main(flags)
        torch.cuda.synchronize()
        launches10 = counts()
        past10, fut10 = load_nba(nba_dir)
    require(launches10_train["packed"] > 0
            and launches10_train["packed_bwd"] > 0,
            f"phase 10: the packed kernels were not launched by the CLI's "
            f"training path {launches10_train}")
    require(launches10["attn"] > launches10_train["attn"],
            f"phase 10: evaluation at B = 128 did not launch kernel A "
            f"{launches10}")
    for r in (run10, resumed):
        for epoch, lr, means in r.history:
            require(all(np.isfinite(list(means.values()))),
                    f"phase 10: non-finite loss at epoch {epoch}: {means}")
    schedule = step_lr(1e-4, 10, 0.5)
    require(resumed.start_epoch == 1
            and [h[:2] for h in resumed.history] == [(1, schedule(1))]
            and all(g["lr"] == schedule(1)
                    for g in resumed.opt.param_groups)
            and all(int(st["step"]) == 2 * steps10
                    for st in resumed.opt.state_dict()["state"].values()),
            "phase 10: the resumed run did not continue from the saved "
            "epoch, learning rate and Adam state")
    table = best10["table"]
    require(table is not None and table["scenes"] == 256 and all(
        np.isfinite(list(table[p].values())).all() for p in ("ade", "fde")),
        f"phase 10: the horizon table is not finite: {best10}")
    print(f"phase 10 NBA recipe through the CLIs: epochs "
          + "; ".join(f"{e} lr {lr:.1e} total {m['total']:.4f}"
                      for e, lr, m in run10.history + resumed.history)
          + f"; resumed from epoch {resumed.start_epoch}; best epoch "
          f"{best10['epoch']}: "
          + " ".join(f"ADE@{h} {v:.4f}" for h, v in table["ade"].items())
          + " " + " ".join(f"FDE@{h} {v:.4f}" for h, v in table["fde"].items())
          + f"; launches {launches10}")

    cfg10 = run10.cfg
    plain10 = cfg10._replace(attn_impl="dense")
    (data10,) = nba_batches(past10[:32], fut10[:32], 32)
    batch10 = prepare_nba_batch(data10).to(dev)
    params10 = tm.sttode_init(10, cfg10)
    gen10 = torch.Generator(device=dev).manual_seed(10)
    M10 = 32 * 11
    noise10 = tm.TrainNoise(
        torch.rand(M10, 5, D, device=dev, generator=gen10) >= 0.1,
        torch.rand(M10, 10, D, device=dev, generator=gen10) >= 0.1,
        torch.randn(M10, Z, device=dev, generator=gen10),
        torch.randn(M10 * K, Z, device=dev, generator=gen10))
    _, out_k10, g_k10 = forward_backward(params10, cfg10, batch10, noise10,
                                         dev)
    _, out_p10, g_p10 = forward_backward(params10, plain10, batch10, noise10,
                                         dev)
    loss_err10, grad_ratio10, worst10, _ = compare_routes(
        out_k10, g_k10, out_p10, g_p10, "phase 10")
    print(f"phase 10 fp32 NBA-recipe forward+backward at B = 32, packed vs "
          f"plain route: loss terms within {loss_err10:.3e} (relative), "
          f"gradients within {grad_ratio10:.3e} of each leaf's largest "
          f"magnitude (worst leaf {worst10})")
    step_k10 = make_train_step(cfg10, 1e-4, device=dev)
    step_p10 = make_train_step(plain10, 1e-4, device=dev)
    ms10 = step_times([[step_k10, *step_k10.init(params10)],
                       [step_p10, *step_p10.init(params10)]],
                      batch10, gen10, 32, "phase 10 NBA recipe step", card)
    print(f"phase 10 NBA recipe step, kernel route: {ms10[0]:.3f} ms/step "
          f"against {BASELINE_STEP_MS['phase 10']:.3f} {BASELINE}")

    # 11. the flash kernels (forward, dq and dk/dv sweeps) against their
    #     plain versions on the same device; the plain versions replay the
    #     scores as the kernels do, and the sweeps get the kernel forward's
    #     lse and δ = rowsum(do ⊙ out) as their inputs
    def flash_ops(B, L, S, Dh, val=None):
        return (randn(B, L, Dh), randn(B, S, Dh), randn(B, S, Dh), val,
                randn(B, L, Dh))

    qf, kf = randn(88, 2304, 8), randn(88, 2304, 8)
    kv11 = torch.from_numpy(rng.random((8, 700)) < 0.7).to(dev).float()
    kv11[0] = 0.0                                   # a problem with no key
    recipe11 = "nba_b2304_q11x8x2304x8_swapped"
    long11 = "long_context_q8x4096x4096x64"
    flash_cases = {
        recipe11: (kf, qf, randn(88, 2304, 8), None, randn(88, 2304, 8)),
        long11: flash_ops(8, 4096, 4096, 64),
        "ragged_l300_s1100_dh5": flash_ops(1, 300, 1100, 5),
        "kv_valid_q8x90x8_s700_one_all_invalid": flash_ops(8, 90, 700, 8,
                                                           kv11),
        "fault_range_b1152_q11x8x1152x8": flash_ops(88, 1152, 1152, 8),
    }
    flash_err = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    flash_times, flash_dev = {}, {}
    for name, (q, k, v, val, do) in flash_cases.items():
        with torch.inference_mode():
            out, lse = km._flash_forward(q, k, v, val)
            want = km.flash_geodesic_attention_reference(q, k, v, val)
            args = (q, k, v, val, do, lse, torch.sum(do * out, dim=-1))
            got_b = (km._launch_flash_dq(*args), *km._launch_flash_dkv(*args))
            want_b = (km.flash_dq_reference(*args),
                      *km.flash_dkv_reference(*args))
            torch.cuda.synchronize()
        # the lse within 1e-6 × max(1, |lse|), row by row: the sweeps
        # replay every pair from it
        lse_rel = float(((lse - want[1]).abs()
                         / want[1].abs().clamp(min=1.0)).max())
        require(lse_rel <= LSE_REL_TOL, f"{name} lse: max relative err "
                f"{lse_rel} > {LSE_REL_TOL}")
        errs = {}
        for g_name, g, w, tol in (
                ("out", out, want[0], ATTN_TOL), ("lse", lse, want[1],
                                                  ATTN_TOL),
                *((n, g, w, ATTN_GRAD_TOL * max(1.0, float(w.abs().max())))
                  for n, g, w in zip(("dq", "dk", "dv"), got_b, want_b))):
            require(bool(torch.isfinite(g).all()), f"{name}: {g_name} NaN")
            e = max_err(g, w)
            require(e <= tol, f"{name} {g_name}: max abs err {e} > {tol}")
            errs[g_name] = e
        flash_err["fwd"] = max(flash_err["fwd"], errs["out"], errs["lse"])
        flash_err["dq"] = max(flash_err["dq"], errs["dq"])
        flash_err["dkv"] = max(flash_err["dkv"], errs["dk"], errs["dv"])
        if val is not None:
            dead = ~(val > 0).any(dim=-1)
            require(bool(dead.any()) and bool((out[dead] == 0).all()) and all(
                bool((g[dead] == 0).all()) for g in got_b),
                f"{name}: a problem with no valid key must output exactly 0 "
                f"and get exactly zero gradients")
        big = q.numel() * k.shape[1] > 2 ** 26
        calls, rounds = (3, 4) if big else (20, 8)
        with torch.inference_mode():
            t = {"fwd": paired_ms(
                lambda: km._flash_forward(q, k, v, val),
                lambda: km.flash_geodesic_attention_reference(q, k, v, val),
                calls=calls, rounds=rounds),
                 "dq": paired_ms(lambda: km._launch_flash_dq(*args),
                                 lambda: km.flash_dq_reference(*args),
                                 calls=calls, rounds=rounds),
                 "dkv": paired_ms(lambda: km._launch_flash_dkv(*args),
                                  lambda: km.flash_dkv_reference(*args),
                                  calls=calls, rounds=rounds)}
            if name in (recipe11, long11):
                flash_dev[name] = [device_us(fn, calls=5) for fn in (
                    lambda: km._flash_forward(q, k, v, val),
                    lambda: km._launch_flash_dq(*args),
                    lambda: km._launch_flash_dkv(*args))] + [
                    host_us(lambda: km._flash_forward(q, k, v, val),
                            calls=5)]
        if name == long11:
            leaves = [x.clone().requires_grad_() for x in (q, k, v)]

            def fb_kernel():
                o = km.flash_geodesic_attention(*leaves)
                return torch.autograd.grad(o, leaves, do)

            @torch.no_grad()
            def fb_plain():
                o, l_ = km.flash_geodesic_attention_reference(*leaves, None)
                return km.flash_geodesic_attention_backward_reference(
                    *leaves, None, do, l_, torch.sum(do * o, dim=-1))

            t["fwd+bwd"] = paired_ms(fb_kernel, fb_plain, calls=calls,
                                     rounds=rounds)
        flash_times[name] = t
        B_, L_, Dh_ = q.shape
        bnd = [bound(*w(B_, L_, k.shape[1], Dh_, val is not None),
                     FP32_FLOP_PER_S)[0]
               for w in (flash_fwd_work, flash_dq_work, flash_dkv_work)]
        dev_txt = "; bounds fwd {:.4f}, dq {:.4f}, dkv {:.4f} ms".format(*bnd)
        if name in flash_dev:
            dev_txt += ("; device time not measured (no device time in the "
                        "trace)" if None in flash_dev[name] else
                        "; device µs/launch fwd {:.1f}, dq {:.1f}, dkv "
                        "{:.1f}".format(*flash_dev[name]))
            dev_txt += "; fwd host {:.1f} µs/call".format(flash_dev[name][-1])
        dev_txt += f"; lse max rel err {lse_rel:.3e}"
        print(f"flash {name}: max_abs_err " + ", ".join(
            f"{k_} {v_:.3e}" for k_, v_ in errs.items()) + "; " + ", ".join(
            f"{k_} kernel {v_[0]:.4f} ms plain {v_[1]:.4f} ms"
            for k_, v_ in t.items()) + dev_txt + f"  [{card}]")

    # the flash kernels against kernels A and C where those run (C refuses
    # L = S > 1036 at Dh = 8), 88 problems of S × S × 8
    with torch.inference_mode():
        for S_ in (1024, 2048):
            q, k, v, do = (randn(88, S_, 8) for _ in range(4))
            out, lse = km._flash_forward(q, k, v, None)
            fwd = paired_ms(lambda: km._flash_forward(q, k, v, None),
                            lambda: km.fused_geodesic_attention(q, k, v))
            dev_us = [device_us(fn) for fn in (
                lambda: km._flash_forward(q, k, v, None),
                lambda: km.fused_geodesic_attention(q, k, v))]
            txt = (f"forward flash {fwd[0]:.4f} ms vs kernel A {fwd[1]:.4f} "
                   f"ms")
            if max(km.whole_s_smem_bytes(S_, S_, 8)) <= km.SMEM_OPTIN_BYTES:
                bwd = paired_ms(
                    lambda: km.flash_geodesic_attention_backward(
                        q, k, v, None, out, lse, do),
                    lambda: km.fused_geodesic_attention_backward(
                        q, k, v, None, do))
                dev_us += [device_us(fn) for fn in (
                    lambda: km.flash_geodesic_attention_backward(
                        q, k, v, None, out, lse, do),
                    lambda: km.fused_geodesic_attention_backward(
                        q, k, v, None, do))]
                txt += (f"; backward flash (dq + dkv) {bwd[0]:.4f} ms vs "
                        f"kernel C {bwd[1]:.4f} ms")
            else:
                txt += ("; backward: beyond kernel C's shared memory (its "
                        "workspace mode: phase 13)")
            txt += ("; device time not measured (no device time in the "
                    "trace)" if None in dev_us else
                    "; device µs/launch " + ", ".join(
                        f"{x:.1f}" for x in dev_us)
                    + " (flash fwd, A" + (", flash bwd, C)"
                                          if len(dev_us) > 2 else ")"))
            txt += "; bounds ms flash fwd {:.4f}, A {:.4f}, flash bwd {:.4f}, " \
                "C {:.4f}".format(*(bound(*w(88, S_, S_, 8, False),
                                          FP32_FLOP_PER_S)[0]
                                    for w in (flash_fwd_work, attn_fwd_work,
                                              flash_bwd_work, attn_bwd_work)))
            print(f"flash yardstick 88 x {S_} x {S_} x 8: {txt}  [{card}]")
    del flash_cases, qf, kf
    torch.cuda.empty_cache()

    # the two repairs, oblique: the masked whole-S forward beyond shared
    # memory and the flash kernels at Dh = 256
    rep = repairs("oblique", lambda B_, S_, Dh_: (randn(B_, S_, Dh_),
                                                  randn(B_, S_, Dh_)),
                  "phase 11")
    attn_err = max(attn_err, rep[0])
    flash_err["fwd"] = max(flash_err["fwd"], rep[1])
    flash_err["dq"] = max(flash_err["dq"], rep[2])
    flash_err["dkv"] = max(flash_err["dkv"], rep[3])

    # 12. the large-batch path: the NBA recipe at B = 2304 scenes through the
    #     CLIs (the scene-axis attention is 88 problems of 2304² × 8, on
    #     flash), then the step on both routes and at B = 1152
    B12 = 2304
    with tempfile.TemporaryDirectory(dir=HERE, prefix=".smoke_nba_") as tmp:
        nba_dir, flags = nba_files(tmp, 2 * B12, 12)
        reset()   # the main path: train at B = 2304, then evaluate
        run12 = cli_train.main(flags + ["--batch_size", str(B12),
                                        "--num_epochs", "1"])
        torch.cuda.synchronize()
        launches12_train = counts()
        best12 = cli_test.main(flags)
        torch.cuda.synchronize()
        launches12 = counts()
        past12, fut12 = load_nba(nba_dir)
    require(all(launches12_train[n] == 4 for n in ("flash", "flash_dq",
                                                   "flash_dkv"))
            and launches12_train["attn"] == 0
            and launches12_train["attn_bwd"] == 0,
            f"phase 12: the CLI's B = 2304 training (2 steps x 2 trunks) did "
            f"not run on the flash kernels alone {launches12_train}")
    require(launches12["attn"] > 0,
            f"phase 12: evaluation at B = 128 did not launch kernel A "
            f"{launches12}")
    for epoch, lr, means in run12.history:
        require(all(np.isfinite(list(means.values()))),
                f"phase 12: non-finite loss at epoch {epoch}: {means}")
    table12 = best12["table"]
    require(table12 is not None and table12["scenes"] == 256 and all(
        np.isfinite(list(table12[p].values())).all() for p in ("ade", "fde")),
        f"phase 12: the horizon table is not finite: {best12}")
    print(f"phase 12 NBA recipe at B = {B12} through the CLIs: "
          + "; ".join(f"epoch {e} lr {lr:.1e} total {m['total']:.4f}"
                      for e, lr, m in run12.history)
          + "; " + " ".join(f"ADE@{h} {v:.4f}"
                            for h, v in table12["ade"].items())
          + f"; launches {launches12}")

    cfg12 = run12.cfg
    plain12 = cfg12._replace(attn_impl="dense")
    params12 = tm.sttode_init(12, cfg12)
    gen12 = torch.Generator(device=dev).manual_seed(12)
    (data12,) = nba_batches(past12[:B12], fut12[:B12], B12)
    batch12 = prepare_nba_batch(data12).to(dev)
    M12 = B12 * 11
    noise12 = tm.TrainNoise(
        torch.rand(M12, 5, D, device=dev, generator=gen12) >= 0.1,
        torch.rand(M12, 10, D, device=dev, generator=gen12) >= 0.1,
        torch.randn(M12, Z, device=dev, generator=gen12),
        torch.randn(M12 * K, Z, device=dev, generator=gen12))
    _, out_k12, g_k12 = forward_backward(params12, cfg12, batch12, noise12,
                                         dev)
    _, out_p12, g_p12 = forward_backward(params12, plain12, batch12, noise12,
                                         dev)
    loss_err12, grad_ratio12, worst12, l2_12 = compare_routes(
        out_k12, g_k12, out_p12, g_p12, "phase 12", kinks=True)
    print(f"phase 12 fp32 NBA-recipe forward+backward at B = {B12}, flash vs "
          f"dense route: loss terms within {loss_err12:.3e} (relative), "
          f"gradients within {l2_12:.3e} in relative L2, each element within "
          f"{grad_ratio12:.3e} of its leaf's largest magnitude (worst leaf "
          f"{worst12})")
    del out_k12, g_k12, out_p12, g_p12
    torch.cuda.empty_cache()

    # one step at B = 1152: beyond the whole-S backward kernel's shared
    # memory, so a maskless problem goes to flash
    (data1152,) = nba_batches(past12[:1152], fut12[:1152], 1152)
    batch1152 = prepare_nba_batch(data1152).to(dev)
    step1152 = make_train_step(cfg12, 1e-4, device=dev)
    p1152, o1152 = step1152.init(params12)
    before = counts()
    p1152, o1152, m1152 = step1152(p1152, o1152, batch1152, gen12)
    torch.cuda.synchronize()
    moved = {n: counts()[n] - before[n] for n in before}
    require(all(moved[n] == 2 for n in ("flash", "flash_dq", "flash_dkv"))
            and moved["attn"] == 0 and moved["attn_bwd"] == 0
            and all(bool(torch.isfinite(x)) for x in m1152.values()),
            f"phase 12: the B = 1152 step did not run on flash: {moved}, "
            f"{m1152}")
    print(f"phase 12 one step at B = 1152 (beyond the whole-S backward "
          f"kernel): total loss {float(m1152['total']):.4f}; launches "
          f"{moved}")
    del p1152, o1152, batch1152

    step_k12 = make_train_step(cfg12, 1e-4, device=dev)
    step_p12 = make_train_step(plain12, 1e-4, device=dev)
    step_times([[step_k12, *step_k12.init(params12)],
                [step_p12, *step_p12.init(params12)]],
               batch12, gen12, B12, f"phase 12 NBA recipe step at B = {B12}",
               card, rounds=4)

    # the best-of-K selection decode at B = 2304 (506,880 rows) three ways,
    # all on the flash attention kernels: the plain decode (the CLI's
    # default select_impl "xla"), kernel B in fp32 and kernel B in bf16
    auto12 = cfg12._replace(select_impl="auto").validate()
    auto12_16 = auto12._replace(select_dtype="bfloat16").validate()
    require(cfg12.select_impl == "xla", f"phase 12: {cfg12.select_impl}")
    before = counts()
    _, out_a12, g_a12 = forward_backward(params12, auto12, batch12, noise12,
                                         dev)
    _, out_x12, g_x12 = forward_backward(params12, cfg12, batch12, noise12,
                                         dev)
    torch.cuda.synchronize()
    moved = {n: counts()[n] - before[n] for n in before}
    require(moved["select_fp32"] == 1,
            f"phase 12: select_impl='auto' did not launch kernel B {moved}")
    loss_a12, grad_a12, worst_a12, l2_a12 = compare_routes(
        out_a12, g_a12, out_x12, g_x12, "phase 12 select_impl auto vs xla",
        kinks=True)
    print(f"phase 12 fp32 forward+backward at B = {B12}, kernel B vs the "
          f"plain decode: loss terms within {loss_a12:.3e} (relative), "
          f"gradients within {l2_a12:.3e} in relative L2, each element "
          f"within {grad_a12:.3e} of its leaf's largest magnitude (worst "
          f"leaf {worst_a12})")
    del out_a12, g_a12, out_x12, g_x12
    torch.cuda.empty_cache()
    steps12 = [make_train_step(c, 1e-4, device=dev)
               for c in (cfg12, auto12, auto12_16)]
    step_times([[st, *st.init(params12)] for st in steps12], batch12, gen12,
               B12, f"phase 12 NBA recipe step at B = {B12}", card, rounds=4,
               names=("select_impl xla (plain decode)",
                      "select_impl auto fp32 (kernel B)",
                      "select_impl auto bf16 (kernel B)"))
    del steps12
    torch.cuda.empty_cache()

    # 13. the poincaré kernels against their plain versions, on ball points
    #     (the attention layer's map of rows of norm ~0.5: mid-ball, where
    #     fp32 summation orders agree to the tolerances), then the masked
    #     whole-S backward beyond shared memory (its workspace mode) in both
    #     metrics
    from sttode_tpu_torch.nn.attention import to_ball
    C = 1.0                                         # the CLIs' default
    P = dict(metric="poincare", curvature=C)

    def ball(*shape):
        return to_ball(randn(*shape) * (0.5 / shape[-1] ** 0.5), C)

    q32, k32 = ball(11, 8, 32, 8), ball(11, 8, 32, 8)
    v32 = randn(11, 8, 32, 8)
    qe, ke, ve = ball(11, 8, 128, 8), ball(11, 8, 128, 8), randn(11, 8, 128, 8)
    p32 = "nba_b32_q11x8x32x8_swapped"
    pcases = {
        p32: (k32, q32, v32, None),
        "nba_eval_q11x8x128x8_swapped": (ke, qe, ve, None),
        "agent_axis_q64x8x8x8_masked": (ball(64, 8, 8, 8), ball(64, 8, 8, 8),
                                        vb, mask_b),
    }
    # and the general form of the epilogue (c = 0.7) at the recipe's shape,
    # on inputs of their own generator
    rng_c07 = np.random.default_rng(92)

    def ball_c07(*shape):
        return to_ball(torch.from_numpy(rng_c07.standard_normal(shape).astype(
            np.float32)).to(dev) * (0.5 / (0.7 * shape[-1]) ** 0.5), 0.7)
    p32c07 = "nba_b32_q11x8x32x8_swapped_c0.7"
    pcases[p32c07] = (ball_c07(11, 8, 32, 8), ball_c07(11, 8, 32, 8), v32,
                      None)
    do_c07 = torch.from_numpy(rng_c07.standard_normal((11, 8, 32, 8)).astype(
        np.float32)).to(dev)
    pcurv = {name: 0.7 if name == p32c07 else C for name in pcases}
    perr = {"fwd": 0.0, "bwd": 0.0}
    ptimes, pargs = {}, {}
    for name, (q, k, v, mask) in pcases.items():
        *lead, L, Dh = q.shape
        S = k.shape[-2]
        P = dict(metric="poincare", curvature=pcurv[name])
        small = km.small_bwd_mode(L, S, Dh, metric="poincare")
        body2p = ("the small-S mode, " + ptxas.get(
            f"mhgsa_small_bwd_kernel<{max(8, 1 << (Dh - 1).bit_length())}, "
            f"true, {'true' if pcurv[name] == 1.0 else 'false'}>",
            "registers not in the build log") if small else
            "the kernel of before, " + ptxas.get(
                "mhgsa_bwd_kernel<true>", "registers not in the build log"))
        args = bwd_case(q, k, v, mask, do_c07 if name == p32c07
                        else randn(*q.shape), lead, L, S)
        pargs[name] = args
        need = mask is not None
        with torch.inference_mode():
            got = km.fused_geodesic_attention(q, k, v, mask=mask, **P)
            want = attn_plain(q, k, v, mask, **P)
            got_b = km.fused_geodesic_attention_backward(
                *args, need_dmask=need, **P)
            want_b = km.fused_geodesic_attention_backward_reference(
                *args, need, "poincare", pcurv[name])
            torch.cuda.synchronize()
        errs = {"out": max_err(got, want)}
        require(bool(torch.isfinite(got).all()), f"{name}: non-finite")
        require(errs["out"] <= ATTN_TOL,
                f"{name}: max abs err {errs['out']} > {ATTN_TOL}")
        for g_name, g, w in zip(("dq", "dk", "dv", "dmask"), got_b, want_b):
            if w is None:
                continue
            require(bool(torch.isfinite(g).all()), f"{name}: {g_name} NaN")
            errs[g_name] = max_err(g, w)
            tol = ATTN_GRAD_TOL * max(1.0, float(w.abs().max()))
            require(errs[g_name] <= tol,
                    f"{name} {g_name}: max abs err {errs[g_name]} > {tol}")
        perr["fwd"] = max(perr["fwd"], errs["out"])
        perr["bwd"] = max([perr["bwd"]] + [e for n, e in errs.items()
                                          if n != "out"])
        with torch.inference_mode():
            t = (paired_ms(
                lambda: km.fused_geodesic_attention(q, k, v, mask=mask, **P),
                lambda: attn_plain(q, k, v, mask, **P)),
                paired_ms(
                lambda: km.fused_geodesic_attention_backward(
                    *args, need_dmask=need, **P),
                lambda: km.fused_geodesic_attention_backward_reference(
                    *args, need, "poincare", pcurv[name])))
            us = [device_us(fn) for fn in (
                lambda: km.fused_geodesic_attention(q, k, v, mask=mask, **P),
                lambda: km.fused_geodesic_attention_backward(
                    *args, need_dmask=need, **P))]
            h_us = host_us(lambda: km.fused_geodesic_attention(
                q, k, v, mask=mask, **P))
            hb_us = host_us(lambda: km.fused_geodesic_attention_backward(
                *args, need_dmask=need, **P))
        ptimes[name] = t
        print(f"poincare whole-S {name}: max_abs_err " + ", ".join(
            f"{k_} {v_:.3e}" for k_, v_ in errs.items())
            + f"; forward kernel {t[0][0]:.4f} ms (host {h_us:.1f} µs/call) "
            f"plain {t[0][1]:.4f} ms, "
            f"backward kernel {t[1][0]:.4f} ms (host {hb_us:.1f} µs/call) "
            f"plain {t[1][1]:.4f} ms; "
            + ("device time not measured (no device time in the trace)"
               if None in us else
               "device µs/launch forward {:.2f}, backward {:.2f}".format(*us))
            + f"; c = {pcurv[name]}, backward (2p) on {body2p}  [{card}]")

    P = dict(metric="poincare", curvature=C)
    # 2p at the recipe's shape runs on small_bwd.cuh's body: its mode takes
    # the problem, and the profiler's trace names the kernel
    require(km.small_bwd_mode(32, 32, 8, metric="poincare"),
            "phase 13: the small-S mode does not take 88 x 32² x 8 (2p)")
    with torch.inference_mode():
        names2p = kernel_names(lambda: km.fused_geodesic_attention_backward(
            *pargs[p32], **P))
    require(names2p == {"mhgsa_small_bwd_kernel"},
            f"phase 13: 2p at 88 x 32² x 8 launched {names2p}")
    print("poincare whole-S backward (2p) at 88 x 32 x 32 x 8: small-S mode ("
          + ", ".join(f"{k_} {v_}" for k_, v_ in km.small_bwd_layout(
              32, 32, 8, metric="poincare").items())
          + "), the trace's kernel "
          + (", ".join(sorted(names2p)) if names2p else "not measured (no "
             "kernel in the trace)") + f"  [{card}]")

    launch_floor(lambda q, k, v: km.fused_geodesic_attention(q, k, v, **P),
                 (ball(1, 1, 1, 8), ball(1, 1, 1, 8), randn(1, 1, 1, 8)),
                 pcases[p32][:3], card, "poincare whole-S forward (1p)")
    # 2p's floor, on inputs of their own generator
    rng_2p = np.random.default_rng(91)

    def randn_2p(*shape):
        return torch.from_numpy(rng_2p.standard_normal(shape).astype(
            np.float32)).to(dev)
    one2p = (to_ball(0.3 * randn_2p(1, 1, 8), C),
             to_ball(0.3 * randn_2p(1, 1, 8), C), randn_2p(1, 1, 8), None,
             randn_2p(1, 1, 8))
    launch_floor(lambda *a: km.fused_geodesic_attention_backward(*a, **P),
                 one2p, bwd_case(*pcases[p32][:3], None,
                                 randn_2p(11, 8, 32, 8), (11, 8), 32, 32),
                 card, "poincare whole-S backward (2p)")

    qf, kf = ball(88, 2304, 8), ball(88, 2304, 8)
    pf2304 = "nba_b2304_q11x8x2304x8_swapped"
    pflash = {
        pf2304: (kf, qf, randn(88, 2304, 8), randn(88, 2304, 8)),
        "long_context_q8x4096x4096x64": (ball(8, 4096, 64), ball(8, 4096, 64),
                                         randn(8, 4096, 64),
                                         randn(8, 4096, 64)),
    }
    pflash_err = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    pflash_times = {}
    for name, (q, k, v, do) in pflash.items():
        with torch.inference_mode():
            out, lse = km._flash_forward(q, k, v, None, **P)
            want = km.flash_geodesic_attention_reference(q, k, v, None, **P)
            args = (q, k, v, None, do, lse, torch.sum(do * out, dim=-1),
                    "poincare", C)
            got_b = (km._launch_flash_dq(*args), *km._launch_flash_dkv(*args))
            want_b = (km.flash_dq_reference(*args),
                      *km.flash_dkv_reference(*args))
            torch.cuda.synchronize()
        errs = {}
        for g_name, g, w, tol in (
                ("out", out, want[0], ATTN_TOL),
                ("lse", lse, want[1], ATTN_TOL),
                *((n, g, w, ATTN_GRAD_TOL * max(1.0, float(w.abs().max())))
                  for n, g, w in zip(("dq", "dk", "dv"), got_b, want_b))):
            require(bool(torch.isfinite(g).all()), f"{name}: {g_name} NaN")
            errs[g_name] = max_err(g, w)
            require(errs[g_name] <= tol,
                    f"{name} {g_name}: max abs err {errs[g_name]} > {tol}")
        pflash_err["fwd"] = max(pflash_err["fwd"], errs["out"], errs["lse"])
        pflash_err["dq"] = max(pflash_err["dq"], errs["dq"])
        pflash_err["dkv"] = max(pflash_err["dkv"], errs["dk"], errs["dv"])
        with torch.inference_mode():
            t = {"fwd": paired_ms(
                lambda: km._flash_forward(q, k, v, None, **P),
                lambda: km.flash_geodesic_attention_reference(q, k, v, None,
                                                              **P),
                calls=3, rounds=4),
                 "dq": paired_ms(lambda: km._launch_flash_dq(*args),
                                 lambda: km.flash_dq_reference(*args),
                                 calls=3, rounds=4),
                 "dkv": paired_ms(lambda: km._launch_flash_dkv(*args),
                                  lambda: km.flash_dkv_reference(*args),
                                  calls=3, rounds=4)}
            us = [device_us(fn, calls=5) for fn in (
                lambda: km._flash_forward(q, k, v, None, **P),
                lambda: km._launch_flash_dq(*args),
                lambda: km._launch_flash_dkv(*args))]
        pflash_times[name] = t
        B_, L_, Dh_ = q.shape
        bnd = [bound(*w(B_, L_, k.shape[1], Dh_, False, "poincare"),
                     FP32_FLOP_PER_S)[0]
               for w in (flash_fwd_work, flash_dq_work, flash_dkv_work)]
        print(f"poincare flash {name}: max_abs_err " + ", ".join(
            f"{k_} {v_:.3e}" for k_, v_ in errs.items()) + "; " + ", ".join(
            f"{k_} kernel {v_[0]:.4f} ms plain {v_[1]:.4f} ms"
            for k_, v_ in t.items())
            + "; bounds fwd {:.4f}, dq {:.4f}, dkv {:.4f} ms".format(*bnd)
            + ("; device time not measured (no device time in the trace)"
               if None in us else
               "; device µs/launch fwd {:.1f}, dq {:.1f}, dkv {:.1f}".format(
                   *us)) + f"  [{card}]")
    del pflash, qf, kf, out, lse, want, got_b, want_b, args
    torch.cuda.empty_cache()

    # the sweeps' general form (c ≠ 1) at the recipe's shape, timed; then
    # rows at the ball's edge (every zc clamped at 1 − 1e-5) and close
    # pairs (k = q + 1e-4·noise), on an exact-Gram grid: dv to the
    # tolerance, dq and dk finite (there the plain formulas' own dq and dk
    # move by more than the tolerance when one fp32 rounding moves;
    # tests/test_torch_poincare_sweep.py)
    def grid(x, c):
        s_ = 2.0 ** np.floor(12 + np.log2(c) / 2)
        return torch.trunc(x * s_) / s_

    def sweeps(q, k, v, do, c):
        with torch.inference_mode():
            out, lse = km._flash_forward(q, k, v, None, "poincare", c)
            want_f = km.flash_geodesic_attention_reference(q, k, v, None,
                                                           "poincare", c)
            a = (q, k, v, None, do, lse, torch.sum(do * out, dim=-1),
                 "poincare", c)
            got = (km._launch_flash_dq(*a), *km._launch_flash_dkv(*a))
            want = (km.flash_dq_reference(*a), *km.flash_dkv_reference(*a))
            torch.cuda.synchronize()
        f_err = max(max_err(out, want_f[0]), max_err(lse, want_f[1]))
        return a, got, want, f_err

    axis = torch.zeros(8, device=dev)
    axis[0] = 1.0
    for c_, kind in ((0.7, "mid"), (0.05, "mid"), (1.0, "edge"),
                     (0.7, "edge"), (1.0, "close"), (0.7, "close")):
        if kind == "mid":
            shape = (88, 2304, 8)
            q = to_ball(randn(*shape) * (0.5 / (8 * c_) ** 0.5), c_)
            k = to_ball(randn(*shape) * (0.5 / (8 * c_) ** 0.5), c_)
        elif kind == "edge":
            shape = (8, 1100, 8)
            q, k = (grid(to_ball(40.0 * (sgn * axis + 0.2 / 8 ** 0.5
                                         * randn(*shape)), c_), c_)
                    for sgn in (1.0, -1.0))
        else:
            shape = (8, 1100, 8)
            q = grid(to_ball(randn(*shape) * (0.5 / (8 * c_) ** 0.5), c_), c_)
            k = grid(q + 1e-4 * randn(*shape), c_)
        a, got, want, f_err = sweeps(q, k, randn(*shape), randn(*shape), c_)
        label = f"poincare flash sweeps {kind} c = {c_} {shape}"
        require(all(bool(torch.isfinite(g).all()) for g in got),
                f"{label}: non-finite gradient")
        require(f_err <= ATTN_TOL,
                f"{label}: forward max abs err {f_err} > {ATTN_TOL}")
        pflash_err["fwd"] = max(pflash_err["fwd"], f_err)
        if kind == "edge":
            zc = km._poincare_pieces(q[:1], k[:1], c_)[-1]
            require(bool(torch.all(zc == float(np.float32(1.0 - km.ARTANH_EPS)))),
                    f"{label}: a pair does not clamp")
        errs = {}
        for g_name, g, w in zip(("dq", "dk", "dv"), got, want):
            errs[g_name] = max_err(g, w)
            if kind == "mid" or g_name == "dv":
                tol = ATTN_GRAD_TOL * max(1.0, float(w.abs().max()))
                require(errs[g_name] <= tol, f"{label} {g_name}: max abs "
                        f"err {errs[g_name]} > {tol}")
                part = "dq" if g_name == "dq" else "dkv"
                pflash_err[part] = max(pflash_err[part], errs[g_name])
        line = f"{label}: max_abs_err fwd {f_err:.3e}, " + ", ".join(
            f"{k_} {v_:.3e}" for k_, v_ in errs.items()) + (
            " (dq, dk held to finiteness)" if kind != "mid" else "")
        if kind == "mid":
            with torch.inference_mode():
                t = {"fwd": paired_ms(
                    lambda: km._flash_forward(*a[:4], "poincare", c_),
                    lambda: km.flash_geodesic_attention_reference(
                        *a[:4], "poincare", c_), calls=3, rounds=4),
                     "dq": paired_ms(lambda: km._launch_flash_dq(*a),
                                     lambda: km.flash_dq_reference(*a),
                                     calls=3, rounds=4),
                     "dkv": paired_ms(lambda: km._launch_flash_dkv(*a),
                                      lambda: km.flash_dkv_reference(*a),
                                      calls=3, rounds=4)}
            line += "; " + ", ".join(
                f"{k_} kernel {v_[0]:.4f} ms plain {v_[1]:.4f} ms"
                for k_, v_ in t.items())
        print(line + f"  [{card}]")
        del a, got, want, q, k
    torch.cuda.empty_cache()

    # the masked whole-S backward at 8 × 1500² × 8: its staging (224·S + 256
    # bytes) passes the block's shared memory, so the kernel stages each
    # problem in a device workspace; one row of each problem is all excluded
    ws_err, ws_times = {}, {}
    for metric in ("oblique", "poincare"):
        L = 1500
        q, k = ((ball(8, L, 8), ball(8, L, 8)) if metric == "poincare"
                else (randn(8, L, 8), randn(8, L, 8)))
        mask = torch.where(torch.from_numpy(rng.random((8, L, L)) < 0.2)
                           .to(dev), fmin, randn(8, L, L))
        mask[:, 0] = fmin
        args = (q, k, randn(8, L, 8), km._canonicalize_mask(mask),
                randn(8, L, 8))
        require(km.whole_s_smem_bytes(L, L, 8, metric)[1]
                > km.SMEM_OPTIN_BYTES, "phase 13: 1500² fits shared memory")
        kw = dict(metric=metric, curvature=C)
        with torch.inference_mode():
            got = km.fused_geodesic_attention_backward(*args, need_dmask=True,
                                                       **kw)
            want = km.fused_geodesic_attention_backward_reference(
                *args, True, metric, C)
            torch.cuda.synchronize()
        errs = {}
        for g_name, g, w in zip(("dq", "dk", "dv", "dmask"), got, want):
            require(bool(torch.isfinite(g).all()), f"{metric}: {g_name} NaN")
            errs[g_name] = max_err(g, w)
            tol = ATTN_GRAD_TOL * max(1.0, float(w.abs().max()))
            require(errs[g_name] <= tol, f"phase 13 masked 1500² {metric} "
                    f"{g_name}: max abs err {errs[g_name]} > {tol}")
        require(bool((got[0][:, 0] == 0).all() and (got[3][:, 0] == 0).all()),
                "phase 13: an all-excluded row must get a zero gradient")
        ws_err[metric] = max(errs.values())
        with torch.inference_mode():
            ws_times[metric] = paired_ms(
                lambda: km.fused_geodesic_attention_backward(
                    *args, need_dmask=True, **kw),
                lambda: km.fused_geodesic_attention_backward_reference(
                    *args, True, metric, C), calls=3, rounds=4)
        print(f"masked whole-S backward 8 x 1500 x 1500 x 8 {metric} "
              f"(device workspace): max_abs_err " + ", ".join(
                  f"{k_} {v_:.3e}" for k_, v_ in errs.items())
              + f"; kernel {ws_times[metric][0]:.4f} ms plain "
              f"{ws_times[metric][1]:.4f} ms  [{card}]")
    bwd_err = max(bwd_err, ws_err["oblique"])
    perr["bwd"] = max(perr["bwd"], ws_err["poincare"])

    # the two repairs, poincaré, on ball points
    rep = repairs("poincare", lambda B_, S_, Dh_: (ball(B_, S_, Dh_),
                                                   ball(B_, S_, Dh_)),
                  "phase 13 poincare")
    perr["fwd"] = max(perr["fwd"], rep[0])
    pflash_err["fwd"] = max(pflash_err["fwd"], rep[1])
    pflash_err["dq"] = max(pflash_err["dq"], rep[2])
    pflash_err["dkv"] = max(pflash_err["dkv"], rep[3])
    del mask, args, got, want
    torch.cuda.empty_cache()

    # 14. the poincaré path end to end: the NBA recipe with
    #     --attn_metric poincare through the CLIs at B = 32 and at B = 2304,
    #     both routes' steps, and the agent-axis server
    from sttode_tpu_torch.train import checkpoint as tck
    poincare_flags = ["--attn_metric", "poincare", "--curvature", str(C)]
    with tempfile.TemporaryDirectory(dir=HERE, prefix=".smoke_nba_") as tmp:
        nba_dir, flags = nba_files(tmp, 10 * 32, 14)
        flags += poincare_flags
        reset()   # the main path: train, resume, evaluate the checkpoint
        run14 = cli_train.main(flags + ["--num_epochs", "2"])
        resumed14 = cli_train.main(flags + ["--num_epochs", "2",
                                            "--epoch_continue", "1"])
        torch.cuda.synchronize()
        launches14_train = counts()
        best14 = cli_test.main(flags)
        torch.cuda.synchronize()
        launches14 = counts()
        ck14 = tck.load_checkpoint(tck.checkpoint_path(
            os.path.join(tmp, "ck", "nba"), 2))[3]
        past14, fut14 = load_nba(nba_dir)
    require((ck14.attn_metric, ck14.curvature) == ("poincare", C)
            and [h[0] for h in resumed14.history] == [1]
            and resumed14.cfg.attn_metric == "poincare",
            f"phase 14: the checkpoint's config says {ck14.attn_metric}, "
            f"c = {ck14.curvature}; the resumed run {resumed14.history}")
    require(launches14_train["attn_p"] > 0
            and launches14_train["attn_bwd_p"] > 0
            and launches14_train["attn"] == launches14_train["attn_p"]
            and launches14_train["attn_bwd"] == launches14_train["attn_bwd_p"]
            and launches14_train["packed"] == 0
            and launches14_train["flash"] == 0,
            f"phase 14: the CLI's poincaré training at B = 32 did not run on "
            f"the poincaré whole-S kernels alone {launches14_train}")
    require(launches14["attn_p"] > launches14_train["attn_p"],
            f"phase 14: evaluation did not launch the poincaré forward "
            f"{launches14}")
    for epoch, lr, means in run14.history + resumed14.history:
        require(all(np.isfinite(list(means.values()))),
                f"phase 14: non-finite loss at epoch {epoch}: {means}")
    table14 = best14["table"]
    require(table14 is not None and table14["scenes"] == 256 and all(
        np.isfinite(list(table14[p].values())).all() for p in ("ade", "fde")),
        f"phase 14: the horizon table is not finite: {best14}")
    print(f"phase 14 poincaré NBA recipe through the CLIs (c = {C}): "
          + "; ".join(f"epoch {e} lr {lr:.1e} total {m['total']:.4f}"
                      for e, lr, m in run14.history + resumed14.history)
          + f" (resumed from epoch 1); best epoch {best14['epoch']}: "
          + " ".join(f"ADE@{h} {v:.4f}" for h, v in table14["ade"].items())
          + f"; launches {launches14}")

    def nba_step_inputs(past, fut, B, seed):
        (data,) = nba_batches(past[:B], fut[:B], B)
        gen_ = torch.Generator(device=dev).manual_seed(seed)
        M_ = B * 11
        return prepare_nba_batch(data).to(dev), gen_, tm.TrainNoise(
            torch.rand(M_, 5, D, device=dev, generator=gen_) >= 0.1,
            torch.rand(M_, 10, D, device=dev, generator=gen_) >= 0.1,
            torch.randn(M_, Z, device=dev, generator=gen_),
            torch.randn(M_ * K, Z, device=dev, generator=gen_))

    cfg14 = run14.cfg
    dense14 = cfg14._replace(attn_impl="dense")
    params14 = tm.sttode_init(14, cfg14)
    batch14, gen14, noise14 = nba_step_inputs(past14, fut14, 32, 14)
    _, out_k14, g_k14 = forward_backward(params14, cfg14, batch14, noise14,
                                         dev)
    _, out_p14, g_p14 = forward_backward(params14, dense14, batch14, noise14,
                                         dev)
    loss_err14, grad_ratio14, worst14, _ = compare_routes(
        out_k14, g_k14, out_p14, g_p14, "phase 14")
    f64 = torch.float64
    _, _, g_o14 = forward_backward(
        bridge.tree_map(lambda t: t.to(f64), params14), dense14,
        batch14.to(f64), tm.TrainNoise(noise14[0], noise14[1],
                                       noise14[2].to(f64),
                                       noise14[3].to(f64)), dev)
    oracle14 = [max(float((a.to(f64) - o).abs().max())
                    / max(float(o.abs().max()), 1e-30)
                    for a, o in zip(g, g_o14)) for g in (g_k14, g_p14)]
    print(f"phase 14 fp32 poincaré NBA-recipe forward+backward at B = 32, "
          f"whole-S kernels vs dense route: loss terms within "
          f"{loss_err14:.3e} (relative), gradients within {grad_ratio14:.3e} "
          f"of each leaf's largest magnitude (worst leaf {worst14}); against "
          f"the float64 dense route the kernel route's worst leaf differs by "
          f"{oracle14[0]:.3e}, the fp32 dense route's by {oracle14[1]:.3e}")
    del g_o14
    step_k14 = make_train_step(cfg14, 1e-4, device=dev)
    step_p14 = make_train_step(dense14, 1e-4, device=dev)
    ms14 = step_times([[step_k14, *step_k14.init(params14)],
                       [step_p14, *step_p14.init(params14)]],
                      batch14, gen14, 32, "phase 14 poincaré NBA recipe step",
                      card)
    print(f"phase 14 poincaré NBA recipe step at B = 32, kernel route: "
          f"{ms14[0]:.3f} ms/step against "
          f"{BASELINE_STEP_MS['phase 14']:.3f} {BASELINE}")

    B14 = 2304
    with tempfile.TemporaryDirectory(dir=HERE, prefix=".smoke_nba_") as tmp:
        nba_dir, flags = nba_files(tmp, 2 * B14, 15)
        reset()   # the main path: train at B = 2304
        run14L = cli_train.main(flags + poincare_flags + [
            "--batch_size", str(B14), "--num_epochs", "1"])
        torch.cuda.synchronize()
        launches14L = counts()
        past14L, fut14L = load_nba(nba_dir)
    require(all(launches14L[n] == launches14L[f"{n}_p"] == 4
                for n in ("flash", "flash_dq", "flash_dkv"))
            and launches14L["attn"] == 0 and launches14L["attn_bwd"] == 0
            and launches14L["packed"] == 0,
            f"phase 14: the CLI's poincaré B = 2304 training (2 steps x 2 "
            f"trunks) did not run on the poincaré flash kernels alone "
            f"{launches14L}")
    for epoch, lr, means in run14L.history:
        require(all(np.isfinite(list(means.values()))),
                f"phase 14: non-finite loss at epoch {epoch}: {means}")
    print(f"phase 14 poincaré NBA recipe at B = {B14} through the CLI: "
          + "; ".join(f"epoch {e} lr {lr:.1e} total {m['total']:.4f}"
                      for e, lr, m in run14L.history)
          + f"; launches {launches14L}")

    # the flash route against the dense route, at the largest batch whose
    # dense route fits the card's memory (its poincaré score tensors are
    # 88 × B² floats each, a dozen of them kept for the backward)
    cfg14L = run14L.cfg
    dense14L = cfg14L._replace(attn_impl="dense")
    params14L = tm.sttode_init(15, cfg14L)
    oom = []
    for B_cmp in (B14, 1152):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        batchL, genL, noiseL = nba_step_inputs(past14L, fut14L, B_cmp, 15)
        try:
            _, out_kL, g_kL = forward_backward(params14L, cfg14L, batchL,
                                               noiseL, dev)
            _, out_pL, g_pL = forward_backward(params14L, dense14L, batchL,
                                               noiseL, dev)
            break
        except torch.cuda.OutOfMemoryError:
            oom.append(B_cmp)
    else:
        raise AssertionError("phase 14: the dense route fits neither batch")
    peak14L = torch.cuda.max_memory_allocated() / 2 ** 30
    loss_errL, grad_ratioL, worstL, l2L = compare_routes(
        out_kL, g_kL, out_pL, g_pL, "phase 14 large batch", kinks=True)
    print(f"phase 14 fp32 poincaré NBA-recipe forward+backward at B = "
          f"{B_cmp} (dense route out of memory at {oom or 'none'}; peak "
          f"{peak14L:.2f} GiB allocated), flash vs dense route: loss terms "
          f"within {loss_errL:.3e} (relative), gradients within {l2L:.3e} in "
          f"relative L2, each element within {grad_ratioL:.3e} of its leaf's "
          f"largest magnitude (worst leaf {worstL})")
    del out_kL, g_kL, out_pL, g_pL
    torch.cuda.empty_cache()
    # both poincaré routes and, beside them in the same rounds, the oblique
    # flash route on the same parameters and batch
    step_kL = make_train_step(cfg14L, 1e-4, device=dev)
    step_pL = make_train_step(dense14L, 1e-4, device=dev)
    step_oL = make_train_step(cfg14L._replace(attn_metric="oblique"), 1e-4,
                              device=dev)
    step_times([[step_kL, *step_kL.init(params14L)],
                [step_pL, *step_pL.init(params14L)],
                [step_oL, *step_oL.init(params14L)]],
               batchL, genL, B_cmp,
               f"phase 14 poincaré NBA recipe step at B = {B_cmp}", card,
               rounds=4, names=("kernel route", "plain route",
                                "oblique kernel route"))
    del batchL, noiseL
    torch.cuda.empty_cache()

    # the agent-axis server with the poincaré metric: key validity as an
    # additive mask, on the poincaré whole-S forward
    cfg14a = cfg4._replace(attn_metric="poincare", curvature=C).validate()
    params14a = tm.sttode_init(0, cfg14a)
    kernel14a = Predictor(params14a, cfg14a, device=dev, max_group=64)
    plain14a = Predictor(params14a, cfg14a._replace(attn_impl="dense",
                                                    select_impl="xla"),
                         device=dev, max_group=64)
    kernel14a.warmup([8], scenes_per=64)
    plain14a.warmup([8], scenes_per=64)
    reset()   # the main path: serving
    (out14a, p50_a, rate_a), (ref14a, p50_ap, rate_ap) = serve_rounds(
        (kernel14a, plain14a), scenes4, 6)
    torch.cuda.synchronize()
    launches14a = counts()
    require(launches14a["attn_p"] > 0
            and launches14a["attn"] == launches14a["attn_p"]
            and launches14a["select_fp32"] > 0,
            f"phase 14: the poincaré agent-axis server did not launch the "
            f"poincaré forward {launches14a}")
    err14a = compare(out14a, ref14a, [(20, 8, 12, 2)] * 64, "phase 14 server")
    print(f"phase 14 poincaré agent-axis server, 64 scenes x 8 agents/call: "
          f"max_abs_err vs dense {err14a:.3e}; kernels p50 {p50_a:.3f} ms, "
          f"{rate_a:.1f} scenes/s; dense p50 {p50_ap:.3f} ms, "
          f"{rate_ap:.1f} scenes/s; launches {launches14a}")

    # 15. the ETH-UCY and SDD path through the CLIs; in its directory, on its
    #     stage-1 checkpoints, phase 16's stage-2 CLIs
    #     and phase 18's scan_steps CLIs
    eth15 = eth_phase(dev, card, counts, reset,
                      inside=lambda tmp, flags, n_train: {
                          "stage2": stage2_cli(tmp, flags, n_train, counts,
                                               reset),
                          "scan": scan_cli(tmp, flags, n_train, counts,
                                           reset)})
    launches15 = eth15["launches"]

    # 16. stage 2, the DLow sampler
    launches16 = sampler_phase(dev, card, counts, reset,
                               eth15["inside"]["stage2"])["launches"]

    # 17. the adaptive and adjoint ODE encoder, learn_prior and dropout
    launches17 = ode_phase(dev, card, counts, reset, nba_files)["launches"]

    # 18. scan_steps: S optimizer steps captured as one CUDA graph
    launches18 = scan_phase(dev, card, counts, reset, eth15["inside"]["scan"],
                            eth15["resume_s"])["launches"]

    # 19. the decoder side (forced kernel routes at L != S, bias_kv) and the
    #     training options --supervise, --profile_dir and the rollback
    launches19 = decoder_phase(dev, card, counts, reset,
                               nba_files)["launches"]

    # 20. the last single-process modules: the NBA step under riemannian_sgd
    #     eager against captured, each new function on the card against the
    #     CPU, δ-hyperbolicity at full size
    launches20 = riemannian_phase(dev, card, counts, reset)["launches"]

    # 21. data parallelism, the ring and Ulysses over torch.distributed:
    #     world 1 over NCCL bit for bit (stage 1, stage 2, the captured mesh
    #     step, a restore; Ulysses against "auto", captured), world 2 on the
    #     one card over gloo (stage 1 on auto, ring and ulysses, stage 2,
    #     dopri5's three forms, the save, a data x seq mesh on the agent
    #     axis), --distributed
    launches21 = parallel_phase(dev, card, counts, reset,
                                nba_files)["launches"]

    a_ms, a_plain = attn_times["train_scene_axis_q11x8x128x8_swapped"]
    b_ms, b_plain = bwd_times["train_scene_axis_q11x8x128x8_swapped"]
    s_ms, s_plain = select_times["dist_M1408_K20"]
    w32 = ks.prep_select_weights(params7, 2 * cfg7.hidden_dim, cfg7.zdim,
                                 5, 10)
    a_bound = bound(*attn_fwd_work(88, 128, 128, 8, False), FP32_FLOP_PER_S)
    b_bound = bound(*attn_bwd_work(88, 128, 128, 8, False), FP32_FLOP_PER_S)
    s_bound = select_bound(select_work(w32, 1408, 20, 128, 32, 5, 10,
                                       "dist"), torch.float32)
    s16_bound = select_bound(select_work(weights7, 1408, 20, 128, 32, 5, 10,
                                         "dist"), bf16)

    (p_ms, p_plain), (pb_ms, pb_plain) = \
        packed_times["nba_recipe_q11x8x32x8_swapped"]
    p_bound = bound(*attn_fwd_work(88, 32, 32, 8, False), FP32_FLOP_PER_S)
    pb_bound = bound(*attn_bwd_work(88, 32, 32, 8, False), FP32_FLOP_PER_S)

    rec11 = flash_times[recipe11]
    f_bound = bound(*flash_fwd_work(88, 2304, 2304, 8, False),
                    FP32_FLOP_PER_S)
    fdq_bound = bound(*flash_dq_work(88, 2304, 2304, 8, False),
                      FP32_FLOP_PER_S)
    fdkv_bound = bound(*flash_dkv_work(88, 2304, 2304, 8, False),
                       FP32_FLOP_PER_S)

    def entry(name, source, replaces, launches, err, ms, plain_ms, bnd):
        return {"name": name, "route": "cuda",
                "source": f"sttode_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None}

    print(json.dumps({"kernels": [
        entry("fused_geodesic_attention", "mhgsa_fwd.cu",
              "sttode_tpu/kernels/mhgsa.py:407",
              launches4["attn"] + launches5["attn"] + launches8["attn"]
              + launches10["attn"] + launches12["attn"] + launches15["attn"]
              + launches16["attn"] - launches16["attn_p"]
              + launches17["attn"] - launches17["attn_p"]
              + launches18["attn"] + launches19["attn"] + launches21["attn"],
              attn_err, a_ms,
              a_plain, a_bound),
        entry("fused_geodesic_attention_backward", "mhgsa_bwd.cu",
              "sttode_tpu/kernels/mhgsa.py:455",
              launches8["attn_bwd"] + launches15["attn_bwd"]
              + launches17["attn_bwd"] - launches17["attn_bwd_p"]
              + launches18["attn_bwd"] + launches19["attn_bwd"]
              + launches21["attn_bwd"], bwd_err,
              b_ms,
              b_plain, b_bound),
        entry("select_decode_fp32", "select_decode.cu",
              "sttode_tpu/kernels/select_decode.py:270",
              launches4["select_fp32"] + launches5["select_fp32"]
              + launches8["select_fp32"] + launches15["select_fp32"]
              + launches17["select_fp32"] + launches18["select_fp32"]
              + launches19["select_fp32"] + launches20["select_fp32"]
              + launches21["select_fp32"],
              select_err, s_ms, s_plain, s_bound),
        entry("select_decode_bf16", "select_decode.cu",
              "sttode_tpu/kernels/select_decode.py:270",
              launches8["select_bf16"] + launches18["select_bf16"]
              + launches21["select_bf16"],
              sel16_err, sel16_ms, sel16_plain,
              s16_bound),
        entry("packed_geodesic_attention", "packed_mhgsa_fwd.cu",
              "sttode_tpu/kernels/packed_mhgsa.py:340",
              launches5["packed"] + launches10["packed"]
              + launches15["packed"] + launches16["packed"]
              + launches17["packed"] + launches18["packed"]
              + launches19["packed"] + launches20["packed"]
              + launches21["packed"], packed_err,
              p_ms,
              p_plain, p_bound),
        entry("packed_geodesic_attention_backward", "packed_mhgsa_bwd.cu",
              "sttode_tpu/kernels/packed_mhgsa.py:370",
              launches10["packed_bwd"] + launches15["packed_bwd"]
              + launches17["packed_bwd"] + launches18["packed_bwd"]
              + launches19["packed_bwd"] + launches20["packed_bwd"]
              + launches21["packed_bwd"],
              packed_bwd_err, pb_ms, pb_plain,
              pb_bound),
        entry("flash_geodesic_attention", "flash_mhgsa_fwd.cu",
              "sttode_tpu/kernels/mhgsa.py:776",
              launches12_train["flash"] + launches19["flash"],
              flash_err["fwd"], *rec11["fwd"], f_bound),
        entry("flash_geodesic_attention_dq", "flash_mhgsa_bwd.cu",
              "sttode_tpu/kernels/mhgsa.py:847",
              launches12_train["flash_dq"] + launches19["flash_dq"],
              flash_err["dq"], *rec11["dq"],
              fdq_bound),
        entry("flash_geodesic_attention_dkv", "flash_mhgsa_bwd.cu",
              "sttode_tpu/kernels/mhgsa.py:880",
              launches12_train["flash_dkv"] + launches19["flash_dkv"],
              flash_err["dkv"],
              *rec11["dkv"], fdkv_bound),
        entry("fused_geodesic_attention_poincare", "mhgsa_fwd.cu",
              "sttode_tpu/kernels/mhgsa.py:407",
              launches14["attn_p"] + launches14a["attn_p"]
              + launches16["attn_p"], perr["fwd"],
              *ptimes[p32][0], bound(*attn_fwd_work(88, 32, 32, 8, False,
                                                    "poincare"),
                                     FP32_FLOP_PER_S)),
        entry("fused_geodesic_attention_backward_poincare", "mhgsa_bwd.cu",
              "sttode_tpu/kernels/mhgsa.py:455",
              launches14_train["attn_bwd_p"], perr["bwd"], *ptimes[p32][1],
              bound(*attn_bwd_work(88, 32, 32, 8, False, "poincare"),
                    FP32_FLOP_PER_S)),
        *(entry(f"flash_geodesic_attention{suffix}_poincare", source,
                f"sttode_tpu/kernels/mhgsa.py:{line}",
                launches14L[f"flash{suffix}_p"],
                pflash_err[part], *pflash_times[pf2304][part],
                bound(*work(88, 2304, 2304, 8, False, "poincare"),
                      FP32_FLOP_PER_S))
          for suffix, part, source, line, work in (
              ("", "fwd", "flash_mhgsa_fwd.cu", 776, flash_fwd_work),
              ("_dq", "dq", "flash_mhgsa_bwd.cu", 605, flash_dq_work),
              ("_dkv", "dkv", "flash_mhgsa_bwd.cu", 641, flash_dkv_work)))]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
