"""Stage-1 evaluation CLI of the port (port of ``sttode_tpu/cli/test.py``).

    python -m sttode_tpu_torch.cli.test --dataset eth --data_root D --ckpt_dir C

Evaluates the newest ``--sweep`` checkpoints on the test split, each with
the model config stored in it, and returns the best epoch by ADE. ETH-UCY
and SDD: one scene a batch, padded to its agent bucket; prints the
best-of-``--sample_k`` ADE, FDE and miss rate (FDE > 1) over the real
agents. NBA: batches of 128 scenes unless ``--batch_size``; prints the
horizon table (best-of-K prefix ADE and step FDE at 1-4 s), the best epoch
by 4 s ADE. The K latents come from a ``torch.Generator`` seeded by
``--seed`` on the device. ``--save_plots D`` renders the best epoch's
forecasts of the first ``--max_plots`` scenes into D as PNG files
(``utils.visualize``; matplotlib needed): NBA a court per scene with the
first of its K samples, as the JAX package draws it; ETH-UCY and SDD the
K samples of every agent with the best one bold.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from sttode_tpu_torch import bridge
from sttode_tpu_torch.cli import common
from sttode_tpu_torch.data.nba import nba_batches
from sttode_tpu_torch.data.preprocess import prepare_nba_batch, prepare_scene
from sttode_tpu_torch.evaluation import evaluate_nba, evaluate_scenes
from sttode_tpu_torch.models.sttode import sttode_inference
from sttode_tpu_torch.train import (checkpoint_epochs, checkpoint_path,
                                    load_checkpoint)


def main(argv=None) -> dict:
    parser = common.base_parser("STTODE stage-1 evaluation (PyTorch)")
    parser.add_argument("--sweep", type=int, default=2,
                        help="evaluate the last N checkpoints")
    parser.add_argument("--save_plots", default="",
                        help="directory for best-of-K trajectory renderings "
                             "(the reference's show.py / vis_result role)")
    parser.add_argument("--max_plots", type=int, default=20)
    args = parser.parse_args(argv)
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
            best = {"ade": ade, "fde": fde, "epoch": epoch, "table": table,
                    "params": params, "cfg": cfg}
    print(f"best (epoch {best['epoch']}): ADE: {best['ade']:.4f} "
          f"FDE: {best['fde']:.4f}")
    if args.save_plots:
        render = _render_nba_plots if args.dataset == "nba" else _render_plots
        render(best["params"], best["cfg"], data, args, device)
    best.pop("params", None)
    best.pop("cfg", None)
    return best


def _infer(params, cfg, batch, gen, sample_k) -> np.ndarray:
    with torch.inference_mode():
        return sttode_inference(params, cfg, batch, generator=gen,
                                sample_k=sample_k).cpu().numpy()


def _render_nba_plots(params, cfg, data, args, device):
    """Court renderings of the first ``--max_plots`` scenes, one a batch
    (the reference's vis_result). The drawn forecast is sample 0 of the K,
    named the best prediction, as the JAX package draws it."""
    from sttode_tpu_torch.utils.visualize import plot_nba_court

    os.makedirs(args.save_plots, exist_ok=True)
    past, fut = data
    gen = torch.Generator(device=device).manual_seed(args.seed)
    n_plotted = 0
    for d in nba_batches(past, fut, 1):
        if n_plotted >= args.max_plots:
            break
        preds = _infer(params, cfg, prepare_nba_batch(d).to(device), gen,
                       args.sample_k)
        best_pred = preds[0].reshape(11, cfg.future_length, 2)
        out = os.path.join(args.save_plots, f"court_{n_plotted:04d}.png")
        plot_nba_court(d["past_traj"][0], d["future_traj"][0], best_pred,
                       save_path=out, title=f"scene {n_plotted}")
        n_plotted += 1
    print(f"wrote {n_plotted} court plots to {args.save_plots}")


def _render_plots(params, cfg, scenes, args, device):
    """Best-of-K fan renderings of the first ``--max_plots`` scenes."""
    from sttode_tpu_torch.utils.visualize import plot_best_of_k

    os.makedirs(args.save_plots, exist_ok=True)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    for i, scene in enumerate(scenes[:args.max_plots]):
        batch, orig = prepare_scene(scene, training=False)
        preds = _infer(params, cfg, batch.to(device), gen, args.sample_k)
        pred_k = np.transpose(preds, (1, 0, 2, 3)) + orig   # [N, K, T, 2]
        out = os.path.join(args.save_plots, f"scene_{i:04d}.png")
        plot_best_of_k(np.asarray(scene["obs"]), np.asarray(scene["pred"]),
                       pred_k, save_path=out,
                       title=f"{args.dataset} frame {scene['frame']:.0f}")
    print(f"wrote {min(len(scenes), args.max_plots)} plots to "
          f"{args.save_plots}")


if __name__ == "__main__":
    main()
