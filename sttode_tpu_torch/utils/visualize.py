"""Trajectory visualization (port of ``sttode_tpu/utils/visualize.py``:
the reference's show.py and its NBA court plots).

Three matplotlib renderers that take numpy data in and write where told:

- ``plot_scene``     — observed / ground-truth / predicted trajectories of
  one scene, with the reference's per-dataset camera-frame presets
  (``SCENE_PRESETS``: axis swap, background extent, figure size);
- ``plot_best_of_k`` — all K samples faint, the best-ADE sample bold;
- ``plot_nba_court`` — a half court and team-coloured agent tracks.

matplotlib is imported lazily with the Agg backend, so importing this
module needs no display and no matplotlib.
"""

from __future__ import annotations

import numpy as np


def _plt():
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    return plt


# Per-dataset camera-frame conventions (reference show.py:140-260): ETH and
# Hotel render with world axes SWAPPED (the reference scatters (y, x)) and
# upside-down camera extents; UCY scenes render unswapped on the [0,15]x[0,14]
# student/zara frames. ``extent`` is matplotlib's [left, right, bottom, top]
# for the background image — an inverted pair encodes the y-flip exactly as
# the reference's hard-coded imshow calls do. figsize matches show_eth's
# per-dataset subplots.
SCENE_PRESETS = {
    "eth": {"swap_xy": True, "extent": (-9, 20, 12.5, -3),
            "figsize": (6.40, 4.80)},
    "hotel": {"swap_xy": True, "extent": (-10, 5, 5.8, -7),
              "figsize": (7.20, 5.76)},
    "univ": {"swap_xy": False, "extent": (0, 15, 0, 14),
             "figsize": (7.20, 5.76)},
    "zara1": {"swap_xy": False, "extent": (0, 15, 0, 14),
              "figsize": (7.20, 5.76)},
    "zara2": {"swap_xy": False, "extent": (0, 15, 0, 14),
              "figsize": (7.20, 5.76)},
}


def scene_preset(dataset: str) -> dict:
    """Reference show.py rendering convention for ``dataset`` (empty dict for
    datasets without one — SDD/NBA have their own plotters)."""
    return dict(SCENE_PRESETS.get(dataset, {}))


def plot_scene(obs: np.ndarray, gt: np.ndarray | None = None,
               pred: np.ndarray | None = None, *, save_path: str | None = None,
               background: np.ndarray | None = None,
               extent: tuple | None = None, flip_y: bool = False,
               swap_xy: bool = False, figsize: tuple = (8, 6),
               dataset: str | None = None,
               title: str | None = None):
    """obs [N, T_p, 2]; gt [N, T_f, 2]; pred [N, T_f, 2] (one sample).
    Returns the figure (saved + closed if save_path given).

    ``dataset`` applies the reference's per-dataset camera-frame preset
    (axis swap + background extent + figure size, ``SCENE_PRESETS``);
    explicit ``extent``/``swap_xy``/``figsize`` arguments win over it."""
    if dataset is not None and dataset in SCENE_PRESETS:
        preset = SCENE_PRESETS[dataset]
        swap_xy = preset["swap_xy"] if not swap_xy else swap_xy
        extent = preset["extent"] if extent is None else extent
        figsize = preset["figsize"] if figsize == (8, 6) else figsize
    if swap_xy:
        obs = obs[..., ::-1]
        gt = None if gt is None else gt[..., ::-1]
        pred = None if pred is None else pred[..., ::-1]
    plt = _plt()
    fig, ax = plt.subplots(figsize=figsize)
    if background is not None:
        ax.imshow(background, extent=extent, aspect="auto")
    for i in range(obs.shape[0]):
        ax.plot(obs[i, :, 0], obs[i, :, 1], "-o", color="tab:blue",
                markersize=2, linewidth=1, alpha=0.8,
                label="observed" if i == 0 else None)
        if gt is not None:
            g = np.concatenate([obs[i, -1:], gt[i]], axis=0)
            ax.plot(g[:, 0], g[:, 1], "-o", color="tab:green", markersize=2,
                    linewidth=1, alpha=0.8,
                    label="ground truth" if i == 0 else None)
        if pred is not None:
            p = np.concatenate([obs[i, -1:], pred[i]], axis=0)
            ax.plot(p[:, 0], p[:, 1], "--s", color="tab:red", markersize=2,
                    linewidth=1, alpha=0.8,
                    label="prediction" if i == 0 else None)
    if flip_y:
        ax.invert_yaxis()
    if title:
        ax.set_title(title)
    ax.legend(loc="best", fontsize=8)
    if background is None:
        # camera-frame presets keep the reference's aspect='auto'; pure
        # trajectory plots stay metric
        ax.set_aspect("equal", adjustable="datalim")
    if save_path:
        fig.savefig(save_path, bbox_inches="tight", dpi=120)
        plt.close(fig)
    return fig


def plot_best_of_k(obs: np.ndarray, gt: np.ndarray, pred_k: np.ndarray, *,
                   save_path: str | None = None, title: str | None = None):
    """pred_k [N, K, T_f, 2]: K samples faint, best-ADE sample bold."""
    plt = _plt()
    from sttode_tpu_torch.utils.metrics import best_sample_indices
    best = best_sample_indices(pred_k, gt)
    fig, ax = plt.subplots(figsize=(8, 6))
    N, K = pred_k.shape[:2]
    for i in range(N):
        ax.plot(obs[i, :, 0], obs[i, :, 1], "-", color="tab:blue", lw=1.5)
        g = np.concatenate([obs[i, -1:], gt[i]], axis=0)
        ax.plot(g[:, 0], g[:, 1], "-", color="tab:green", lw=1.5)
        for s in range(K):
            p = np.concatenate([obs[i, -1:], pred_k[i, s]], axis=0)
            ax.plot(p[:, 0], p[:, 1], "-", color="tab:red",
                    lw=2.0 if s == best[i] else 0.5,
                    alpha=0.9 if s == best[i] else 0.15)
    if title:
        ax.set_title(title)
    ax.set_aspect("equal", adjustable="datalim")
    if save_path:
        fig.savefig(save_path, bbox_inches="tight", dpi=120)
        plt.close(fig)
    return fig


def plot_nba_court(past: np.ndarray, future: np.ndarray | None = None,
                   pred: np.ndarray | None = None, *,
                   court_image: np.ndarray | None = None,
                   save_path: str | None = None, title: str | None = None):
    """NBA scene [N=11, T, 2] in meters (court 28.65m × 15.24m): first five
    agents team A, next five team B, last the ball (reference vis_result
    coloring; the category convention add_category marks slot N-1)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(10, 5.5))
    court_m = (28.65, 15.24)
    if court_image is not None:
        ax.imshow(court_image, extent=(0, court_m[0], 0, court_m[1]))
    else:
        ax.add_patch(plt.Rectangle((0, 0), *court_m, fill=False, lw=1.5,
                                   color="k"))
    N = past.shape[0]
    colors = ["#1f77b4"] * 5 + ["#d62728"] * 5 + ["#ff7f0e"]
    for i in range(N):
        c = colors[i] if i < len(colors) else "gray"
        ax.plot(past[i, :, 0], past[i, :, 1], "-o", color=c, markersize=3,
                lw=1.2)
        if future is not None:
            f = np.concatenate([past[i, -1:], future[i]], axis=0)
            ax.plot(f[:, 0], f[:, 1], "-", color=c, lw=1.2, alpha=0.6)
        if pred is not None:
            p = np.concatenate([past[i, -1:], pred[i]], axis=0)
            ax.plot(p[:, 0], p[:, 1], "--", color=c, lw=1.0, alpha=0.8)
    if title:
        ax.set_title(title)
    ax.set_xlim(-1, court_m[0] + 1)
    ax.set_ylim(-1, court_m[1] + 1)
    ax.set_aspect("equal")
    if save_path:
        fig.savefig(save_path, bbox_inches="tight", dpi=120)
        plt.close(fig)
    return fig
