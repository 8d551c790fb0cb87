"""Time kernel B, the best-of-K selection decode, on one NVIDIA GPU.

    python3 scripts/torch_select_bench.py [--rounds 6] [--out FILE]

Times ``sttode_tpu_torch.kernels.select_decode.select_decode`` (the
wrapper: weight preparation, launch and the kernels; CUDA events around
back-to-back calls, median of ``--rounds`` samples) in both storage types at
the decode shapes of the port's paths: mode "dist" at the bench recipe's
training step (M = 1408 agents, K = 20, 5 past / 10 future steps) and at
the NBA recipe's B = 2304 scene batch (M = 25,344), mode "traj" at the
agent-axis server (M = 512, 8 / 12 steps) and the reference-compat
inference (M = 352, 5 / 10). Each result is checked against the plain
version at M ≤ 1408 (fp32 within 1e-4; bf16 within 1e-3 of the distance
scale) and printed as one JSON line with the matrix products' achieved
TFLOP/s. It uses whichever ``sttode_tpu_torch`` the working directory
holds, so the same script times two checkouts in one run. Random weights
from a seed, full model width. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

SHAPES = {   # name: (M, K, T_p, T_f, mode)
    "dist_M1408_K20": (1408, 20, 5, 10, "dist"),
    "dist_M25344_K20": (25344, 20, 5, 10, "dist"),
    "traj_M512_K20": (512, 20, 8, 12, "traj"),
    "traj_M352_K20": (352, 20, 5, 10, "traj"),
}


def matrix_flops(M, K, D2, Z, Tp, Tf):
    """The decode's matrix-product operations (as chip_smoke.select_work)."""
    pro = 2 * M * (3 * D2 * 512 + 2 * 96 * 512)
    row = 2 * (2 * Z * 512 + 2 * 512 * 256 + 256 * 2 * Tf + 256 * 2 * Tp
               + Tp * (32 + 96) * 288 + (Z + 96) * 512 + 512 * 256
               + 256 * 2 * Tf)
    return pro + M * K * row


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_select_bench: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    from sttode_tpu_torch import bridge
    from sttode_tpu_torch.kernels import select_decode as ks
    from sttode_tpu_torch.models import sttode as tm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    lines = []
    for name, (M, K, tp, tf, mode) in SHAPES.items():
        cfg = tm.STTODEConfig(past_length=tp, future_length=tf)
        params = bridge.to_device(tm.sttode_init(7, cfg), dev)

        def randn(*shape):
            return torch.from_numpy(
                rng.standard_normal(shape).astype(np.float32)).to(dev)

        past = randn(M, tp, 2)
        with torch.inference_mode():
            ops = [randn(M, 2 * cfg.hidden_dim), randn(K, M, cfg.zdim),
                   tm.decode_block0_state(params, past), past.reshape(M, -1),
                   randn(M, 2 * tf)]
        for dtype in (torch.float32, torch.bfloat16):
            with torch.inference_mode():
                def call():
                    return ks.select_decode(params, *ops, mode=mode,
                                            dtype=dtype)
                got = call()
                err = None
                if M <= 1408:
                    want = ks.select_decode_reference(
                        ks.prep_select_weights(params, 2 * cfg.hidden_dim,
                                               cfg.zdim, tp, tf, dtype),
                        *ops, mode=mode)
                    err = float((got - want).abs().max())
                    scale = 1.0 if dtype == torch.float32 else max(
                        1.0, float(want.abs().max()))
                    tol = 1e-4 if dtype == torch.float32 else 1e-3 * scale
                    if not err <= tol:
                        raise AssertionError(f"{name} {dtype}: max abs err "
                                             f"{err} > {tol}")
                calls = 3 if M * K > 100_000 else 10
                call()
                torch.cuda.synchronize()
                times = []
                for _ in range(args.rounds):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    for _ in range(calls):
                        call()
                    end.record()
                    torch.cuda.synchronize()
                    times.append(start.elapsed_time(end) / calls)
            ms = statistics.median(times)
            flops = matrix_flops(M, K, 2 * cfg.hidden_dim, cfg.zdim, tp, tf)
            line = {"shape": name, "dtype": str(dtype).split(".")[-1],
                    "ms": ms, "ms_samples": times, "max_abs_err": err,
                    "matrix_tflops": flops / ms / 1e9, "card": card}
            lines.append(line)
            print(json.dumps(line), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(json.dumps(x) for x in lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
