"""ETH-UCY trajectories (port of ``sttode_tpu/data/eth_ucy.py``).

Per file, sliding windows over the frame-grouped rows of a ``frame,ped,x,y``
CSV (the reference's ``TrajectoryDataset``): a pedestrian is kept when it
has exactly one row in every frame of the obs+pred window, and a scene when
strictly more than ``min_ped`` pedestrians are kept. Coordinates are rounded
to 4 decimals and divided by ``traj_scale`` before the relative steps, and
cast to float32 after. Numpy copies of the JAX package's functions: the
port does not import it.

``load_eth_ucy(backend=...)``: "native" and "auto" window with the port's
C++ engine (``sttode_tpu_torch.native``, built with g++ at first use; a
failed build raises), "python" with the numpy loop below.
"""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np

BACKENDS = ("auto", "native", "python")


def poly_fit_nonlinear(traj_xy: np.ndarray, pred_len: int,
                       threshold: float) -> float:
    """1.0 if the trailing ``pred_len`` steps have quadratic-fit residual ≥
    threshold, else 0.0. traj_xy: [T, 2]."""
    t = np.linspace(0, pred_len - 1, pred_len)
    tail = traj_xy[-pred_len:]
    res_x = np.polyfit(t, tail[:, 0], 2, full=True)[1]
    res_y = np.polyfit(t, tail[:, 1], 2, full=True)[1]
    total = (res_x + res_y).sum() if len(res_x) and len(res_y) else 0.0
    return 1.0 if total >= threshold else 0.0


def read_trajectory_csv(path: str) -> np.ndarray:
    """Comma-delimited rows of [frame, ped_id, x, y] → [R, 4]."""
    return np.loadtxt(path, delimiter=",").reshape(-1, 4)


def _file_scenes(data: np.ndarray, obs_len: int, pred_len: int, skip: int,
                 threshold: float, min_ped: int, traj_scale: float,
                 seq_name: str) -> Iterator[dict]:
    seq_len = obs_len + pred_len
    frames = np.unique(data[:, 0])
    rows_by_frame = {f: data[data[:, 0] == f] for f in frames}
    n_windows = len(frames) - seq_len + 1
    for start in range(0, max(n_windows, 0), skip):
        window_frames = frames[start:start + seq_len]
        window_rows = np.concatenate([rows_by_frame[f] for f in window_frames])
        kept_xy, kept_ids, kept_nl = [], [], []
        for ped in np.unique(window_rows[:, 1]):
            ped_rows = np.around(window_rows[window_rows[:, 1] == ped],
                                 decimals=4)
            # exactly one row per window frame: a duplicated row in one
            # frame beside a missing interior frame passes a span-and-count
            # test and would stack a time-shifted trajectory
            if len(ped_rows) != seq_len or \
                    not np.array_equal(ped_rows[:, 0], window_frames):
                continue
            xy = ped_rows[:, 2:4] / traj_scale            # [seq_len, 2]
            kept_xy.append(xy)
            kept_ids.append(ped)
            kept_nl.append(poly_fit_nonlinear(xy, pred_len, threshold))
        if len(kept_xy) > min_ped:
            traj = np.stack(kept_xy).astype(np.float32)   # [N, seq_len, 2]
            rel = np.zeros_like(traj)
            rel[:, 1:] = traj[:, 1:] - traj[:, :-1]
            yield {
                "obs": traj[:, :obs_len],
                "pred": traj[:, obs_len:],
                "obs_rel": rel[:, :obs_len],
                "pred_rel": rel[:, obs_len:],
                "non_linear": np.asarray(kept_nl, np.float32),
                "ped_ids": np.asarray(kept_ids, np.float32),
                "obs_mask": np.ones((traj.shape[0], obs_len), np.float32),
                "pred_mask": np.ones((traj.shape[0], pred_len), np.float32),
                "frame": float(window_frames[obs_len]),
                "seq_name": seq_name,
            }


def load_eth_ucy(data_dir: str, *, obs_len: int = 8, pred_len: int = 12,
                 skip: int = 1, threshold: float = 0.002, min_ped: int = 1,
                 traj_scale: float = 1.0, backend: str = "auto") -> list[dict]:
    """Every file under ``data_dir`` (sorted by name) → one list of scene
    dicts, ``seq_name`` the file's name."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if backend != "python":
        from sttode_tpu_torch.native import window_file
    scenes: list[dict] = []
    for fname in sorted(os.listdir(data_dir)):
        path = os.path.join(data_dir, fname)
        if not os.path.isfile(path):
            continue
        data = read_trajectory_csv(path)
        if backend == "python":
            scenes.extend(_file_scenes(data, obs_len, pred_len, skip,
                                       threshold, min_ped, traj_scale, fname))
            continue
        file_scenes = window_file(
            data, obs_len=obs_len, pred_len=pred_len, skip=skip,
            min_ped=min_ped, traj_scale=traj_scale, threshold=threshold)
        for s in file_scenes:
            s["seq_name"] = fname
        scenes.extend(file_scenes)
    return scenes
