"""Stanford Drone Dataset (port of ``sttode_tpu/data/sdd.py``).

One pickle of pre-grouped trajectory arrays in pixels, each [N_i, 2, T]
(the reference's layout) or [N_i, T, 2], divided by ``traj_scale = 50``,
into the ETH loader's scene contract with all-ones masks and seq name
"sdd". A numpy copy of the JAX package's function."""

from __future__ import annotations

import os
import pickle

import numpy as np


def load_sdd(data_dir: str, *, obs_len: int = 8, pred_len: int = 12,
             traj_scale: float = 50.0, filename: str | None = None) -> list[dict]:
    """Scene dicts of ``filename`` (default: the first file under
    ``data_dir`` by name)."""
    if filename is None:
        candidates = sorted(os.listdir(data_dir))
        if not candidates:
            raise FileNotFoundError(f"no pickle under {data_dir}")
        filename = candidates[0]
    with open(os.path.join(data_dir, filename), "rb") as f:
        groups = pickle.load(f)

    scenes = []
    for i, group in enumerate(groups):
        traj = np.asarray(group, np.float32) / traj_scale
        # coordinate-major [N, 2, seq_len] → [N, seq_len, 2]
        if traj.ndim == 3 and traj.shape[1] == 2 and traj.shape[2] != 2:
            traj = np.transpose(traj, (0, 2, 1))
        rel = np.zeros_like(traj)
        rel[:, 1:] = traj[:, 1:] - traj[:, :-1]
        N = traj.shape[0]
        scenes.append({
            "obs": traj[:, :obs_len],
            "pred": traj[:, obs_len:],
            "obs_rel": rel[:, :obs_len],
            "pred_rel": rel[:, obs_len:],
            "non_linear": np.ones((N,), np.float32),
            "ped_ids": np.arange(N, dtype=np.float32),
            "obs_mask": np.ones((N, obs_len), np.float32),
            "pred_mask": np.ones((N, pred_len), np.float32),
            "frame": float(i + 1),
            "seq_name": "sdd",
        })
    return scenes
