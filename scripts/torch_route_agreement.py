"""How closely two attention routes of the port agree in training, at large
scene batches, on one GPU.

    python3 scripts/torch_route_agreement.py [--batches 1152 2304]

For each scene batch B (synthetic scenes of 11 agents, 5/10 steps, the
model at full width, random weights and noise from a seed) it runs the fp32
training forward and backward on the kernel route (at B > 1036 the flash
kernels) and on the dense route, with the same parameters, batch and
injected noise and the plain selection decode on both, and prints: the
worst relative difference of the loss terms; how many best-of-K winners
differ between the routes; and, for the worst gradient leaf, its shape, its
largest element difference over its largest magnitude, how many of its
elements differ by more than 1e-5 of that magnitude, and the worst relative
L2 difference over all leaves. A difference confined to a few elements of
a leaf, with no winner differing, is the signature of a ReLU whose input
lies within rounding of 0 switching between the routes. Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sttode_tpu_torch import bridge  # noqa: E402
from sttode_tpu_torch.data.preprocess import prepare_scene_group  # noqa: E402
from sttode_tpu_torch.data.synthetic import make_social_scenes  # noqa: E402
from sttode_tpu_torch.models import sttode as tm  # noqa: E402

LOSSES = ("total_loss", "loss_pred", "loss_recover", "loss_kl",
          "loss_diverse")


def run_route(params0, cfg, batch, noise, dev):
    """(output, gradient of every leaf, the selection's distances)."""
    seen = {}
    real = tm._select_dist

    def spy(*a, **kw):
        out = real(*a, **kw)
        seen["dist"] = out[0]
        return out

    tm._select_dist = spy
    try:
        p = bridge.to_device(params0, dev)
        leaves = [t.requires_grad_() for t in bridge.tree_leaves(p)]
        out = tm.sttode_forward(p, cfg, batch, noise=noise)
        out.total_loss.backward()
    finally:
        tm._select_dist = real
    return out, [t.grad for t in leaves], seen["dist"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", type=int, nargs="+", default=[1152, 2304])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_route_agreement: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    N = 11
    cfg = tm.STTODEConfig(past_length=5, future_length=10, min_clip=0.0,
                          select_impl="xla").validate()
    for B in args.batches:
        scenes = make_social_scenes(B, agents_range=(N, N), obs_len=5,
                                    pred_len=10, seed=9)
        batch, _ = prepare_scene_group(
            np.stack([s["obs"] for s in scenes]),
            np.stack([s["pred"] for s in scenes]),
            np.ones((B, N), np.float32), training=True,
            rng=np.random.default_rng(9))
        batch = batch.to(dev)
        M = B * N
        gen = torch.Generator(device=dev).manual_seed(9)
        D, Z = cfg.hidden_dim, cfg.zdim
        noise = tm.TrainNoise(
            torch.rand(M, 5, D, device=dev, generator=gen) >= 0.1,
            torch.rand(M, 10, D, device=dev, generator=gen) >= 0.1,
            torch.randn(M, Z, device=dev, generator=gen),
            torch.randn(M * cfg.sample_k, Z, device=dev, generator=gen))
        params0 = tm.sttode_init(9, cfg)
        out_k, g_k, d_k = run_route(params0, cfg, batch, noise, dev)
        out_p, g_p, d_p = run_route(params0, cfg._replace(attn_impl="dense"),
                                    batch, noise, dev)
        loss_err = max(
            abs(float(getattr(out_k, n).detach())
                - float(getattr(out_p, n).detach()))
            / max(1.0, abs(float(getattr(out_p, n).detach())))
            for n in LOSSES)
        flips = int((d_k.argmin(1) != d_p.argmin(1)).sum())
        ratios, l2 = [], 0.0
        for a, b in zip(g_k, g_p):
            scale = max(float(b.abs().max()), 1e-30)
            ratios.append(float((a - b).abs().max()) / scale)
            l2 = max(l2, float(torch.linalg.vector_norm(a - b)) / max(
                float(torch.linalg.vector_norm(b)), 1e-30))
        i = int(np.argmax(ratios))
        scale = float(g_p[i].abs().max())
        beyond = int(((g_k[i] - g_p[i]).abs() > 1e-5 * scale).sum())
        print(f"B = {B} scenes x {N} agents, kernel vs dense route: losses "
              f"within {loss_err:.3e} (relative); best-of-K winners differ "
              f"at {flips} of {M} agents; worst leaf {i} "
              f"{tuple(g_k[i].shape)}: element {ratios[i]:.3e} of its "
              f"largest magnitude, {beyond} of {g_k[i].numel()} elements "
              f"beyond 1e-5 of it; worst relative L2 over all leaves "
              f"{l2:.3e}  [{card}]")
        del out_k, g_k, d_k, out_p, g_p, d_p
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
