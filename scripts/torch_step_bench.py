"""Time the port's eager training step (one optimizer step a call) at the
bench recipe (B = 128 × 11, 5/10 steps, bf16 selection and decode storage)
and the NBA recipe (the CLI's ``--dataset nba`` config at B = 32 × 11), for
one checkout or two.

    python3 scripts/torch_step_bench.py                    # this checkout
    python3 scripts/torch_step_bench.py --parent DIR --out chiprun_out/s.jsonl

``--parent DIR`` (an unpacked ``git archive`` of another commit) times both
checkouts, each in its own child process, in the order parent, change,
change, parent, and prints the median ms/step of each checkout and recipe.
Each child builds its checkout's kernels, runs 3 warm-up steps and then
``--rounds`` rounds of ``--steps`` synchronized steps a recipe. Needs a
CUDA device; prints the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def child(root: str, rounds: int, steps: int) -> dict:
    """{recipe: [ms/step of each round]} for the checkout at ``root``."""
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from sttode_tpu_torch.cli import common
    from sttode_tpu_torch.data.preprocess import prepare_scene_group
    from sttode_tpu_torch.data.synthetic import make_social_scenes
    from sttode_tpu_torch.kernels import _build
    from sttode_tpu_torch.models import sttode as tm
    from sttode_tpu_torch.train import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load()
    dev = torch.device("cuda")

    def batch(B, N, seed):
        sc = make_social_scenes(B, agents_range=(N, N), obs_len=5,
                                pred_len=10, seed=seed)
        b, _ = prepare_scene_group(
            np.stack([s["obs"] for s in sc]),
            np.stack([s["pred"] for s in sc]), np.ones((B, N), np.float32),
            training=True, rng=np.random.default_rng(seed))
        return b.to(dev)

    nba_args = common.base_parser("bench").parse_args(["--dataset", "nba"])
    recipes = {
        "bench": (tm.STTODEConfig(past_length=5, future_length=10,
                                  select_dtype="bfloat16",
                                  decode_dtype="bfloat16"), 128),
        "nba": (common.model_config(nba_args), 32)}
    out = {}
    for name, (cfg, B) in recipes.items():
        step = make_train_step(cfg.validate(), 1e-4, device=dev)
        params, opt = step.init(tm.sttode_init(0, cfg))
        b = batch(B, 11, 16)
        gen = torch.Generator(device=dev).manual_seed(16)
        for _ in range(3):
            params, opt, _ = step(params, opt, b, gen)
        ms = []
        for _ in range(rounds):
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(steps):
                params, opt, _ = step(params, opt, b, gen)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) / steps * 1e3)
        out[name] = ms
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="an unpacked checkout to compare")
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--out", help="append one JSON line per child here")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.child, args.rounds, args.steps)))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("torch_step_bench: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    roots = ([("parent", os.path.abspath(args.parent)), ("change", HERE),
              ("change", HERE), ("parent", os.path.abspath(args.parent))]
             if args.parent else [("change", HERE)])
    runs: dict = {}
    for label, root in roots:
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", root,
             "--rounds", str(args.rounds), "--steps", str(args.steps)],
            capture_output=True, text=True, cwd=root)
        if res.returncode:
            print(res.stdout[-4000:], res.stderr[-4000:], file=sys.stderr)
            return res.returncode
        got = json.loads(res.stdout.strip().splitlines()[-1])
        line = {"checkout": label, "card": card, "ms_per_step": got}
        print(json.dumps(line))
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        for name, ms in got.items():
            runs.setdefault((label, name), []).extend(ms)
    for (label, name), ms in sorted(runs.items()):
        print(f"{name} recipe, {label}: median {statistics.median(ms):.3f} "
              f"ms/step over {len(ms)} rounds, min {min(ms):.3f}  [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
