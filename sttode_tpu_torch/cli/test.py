"""Stage-1 evaluation CLI of the port (port of ``sttode_tpu/cli/test.py``).

    python -m sttode_tpu_torch.cli.test --dataset eth --data_root D --ckpt_dir C

Evaluates the newest ``--sweep`` checkpoints on the test split, each with
the model config stored in it, and returns the best epoch by ADE. ETH-UCY
and SDD: one scene a batch, padded to its agent bucket; prints the
best-of-``--sample_k`` ADE, FDE and miss rate (FDE > 1) over the real
agents. NBA: batches of 128 scenes unless ``--batch_size``; prints the
horizon table (best-of-K prefix ADE and step FDE at 1-4 s), the best epoch
by 4 s ADE. The K latents come from a ``torch.Generator`` seeded by
``--seed`` on the device. ``--save_plots`` is not ported.
"""

from __future__ import annotations

import math

import torch

from sttode_tpu_torch import bridge
from sttode_tpu_torch.cli import common
from sttode_tpu_torch.data.nba import nba_batches
from sttode_tpu_torch.evaluation import evaluate_nba, evaluate_scenes
from sttode_tpu_torch.train import (checkpoint_epochs, checkpoint_path,
                                    load_checkpoint)


def main(argv=None) -> dict:
    parser = common.base_parser("STTODE stage-1 evaluation (PyTorch)")
    parser.add_argument("--sweep", type=int, default=2,
                        help="evaluate the last N checkpoints")
    parser.add_argument("--save_plots", default="",
                        help="not ported: court renderings")
    parser.add_argument("--max_plots", type=int, default=20)
    args = parser.parse_args(argv)
    common.refuse_unported(args, {"save_plots": ""})
    device = bridge.resolve_device(args.device)
    common.model_config(args)              # refuses unported flag values
    data = common.load_scenes(args, "test")
    cdir = common.ckpt_dir(args)
    epochs = checkpoint_epochs(cdir)[-args.sweep:]
    if not epochs:
        raise SystemExit(f"no checkpoints under {cdir}")

    best = {"ade": math.inf, "fde": math.inf, "epoch": -1, "table": None}
    for epoch in epochs:
        params, _, _, cfg = load_checkpoint(checkpoint_path(cdir, epoch),
                                            device=device)
        gen = torch.Generator(device=device).manual_seed(args.seed)
        table = None
        if args.dataset == "nba":
            past, fut = data
            table = evaluate_nba(params, cfg,
                                 nba_batches(past, fut,
                                             args.batch_size or 128),
                                 gen, sample_k=args.sample_k)
            print(f"epoch {epoch}: " + " ".join(
                f"ADE@{h}: {v:.4f}" for h, v in table["ade"].items()))
            print(" " * 11 + " ".join(
                f"FDE@{h}: {v:.4f}" for h, v in table["fde"].items()))
            ade, fde = table["ade"]["4.0s"], table["fde"]["4.0s"]
        else:
            m = evaluate_scenes(params, cfg, data, gen,
                                sample_k=args.sample_k)
            ade, fde = m["ade"], m["fde"]
            print(f"epoch {epoch}: ADE {ade:.4f} FDE {fde:.4f} "
                  f"miss {m['miss_rate']:.4f} ({m['agents']} agents)")
        if ade < best["ade"]:
            best = {"ade": ade, "fde": fde, "epoch": epoch, "table": table}
    print(f"best (epoch {best['epoch']}): ADE: {best['ade']:.4f} "
          f"FDE: {best['fde']:.4f}")
    return best


if __name__ == "__main__":
    main()
