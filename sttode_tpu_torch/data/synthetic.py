"""Synthetic multi-agent scenes (port of ``sttode_tpu/data/synthetic.py``):
goal-directed agents with social repulsion and noise, made from a seed with
numpy, for smoke runs and tests; and ETH-style CSV files of such agents for
the windowing loader (the repository holds no dataset)."""

from __future__ import annotations

import os

import numpy as np


def make_social_scene(rng: np.random.Generator, *, n_agents: int,
                      seq_len: int = 20, dt: float = 0.4,
                      arena: float = 10.0, repulsion: float = 1.2,
                      noise: float = 0.03) -> np.ndarray:
    """One scene [N, seq_len, 2]."""
    pos = rng.uniform(-arena, arena, (n_agents, 2))
    goals = rng.uniform(-arena, arena, (n_agents, 2))
    speed = rng.uniform(0.8, 1.6, (n_agents, 1))
    traj = np.empty((n_agents, seq_len, 2), np.float32)
    for t in range(seq_len):
        to_goal = goals - pos
        dist_goal = np.linalg.norm(to_goal, axis=-1, keepdims=True) + 1e-6
        vel = speed * to_goal / dist_goal
        diff = pos[:, None] - pos[None, :]                     # [N, N, 2]
        d2 = np.sum(diff ** 2, axis=-1) + 1e-6
        np.fill_diagonal(d2, np.inf)
        force = np.sum(diff / d2[..., None]
                       * np.exp(-d2 / 2.0)[..., None], axis=1)
        vel = vel + repulsion * force
        pos = pos + vel * dt + rng.normal(0, noise, pos.shape)
        traj[:, t] = pos
    return traj


def make_social_scenes(n_scenes: int, *, agents_range=(3, 8),
                       obs_len: int = 8, pred_len: int = 12,
                       seed: int = 0) -> list[dict]:
    """Scene dicts in the data layer's contract (the ETH-UCY loader's ten
    keys), from the same draws as the JAX package's generator for the same
    seed."""
    rng = np.random.default_rng(seed)
    seq_len = obs_len + pred_len
    scenes = []
    for i in range(n_scenes):
        n = int(rng.integers(agents_range[0], agents_range[1] + 1))
        traj = make_social_scene(rng, n_agents=n, seq_len=seq_len)
        rel = np.zeros_like(traj)
        rel[:, 1:] = traj[:, 1:] - traj[:, :-1]
        scenes.append({
            "obs": traj[:, :obs_len],
            "pred": traj[:, obs_len:],
            "obs_rel": rel[:, :obs_len],
            "pred_rel": rel[:, obs_len:],
            "non_linear": np.ones((n,), np.float32),
            "ped_ids": np.arange(n, dtype=np.float32),
            "obs_mask": np.ones((n, obs_len), np.float32),
            "pred_mask": np.ones((n, pred_len), np.float32),
            "frame": float(i),
            "seq_name": "synthetic",
        })
    return scenes


def write_eth_style_csvs(data_root: str, *, n_files: int = 2,
                         frames_per_file: int = 200,
                         agents: int = 12, seed: int = 0) -> None:
    """Write ``n_files`` continuous ETH-style streams of ``frame,ped,x,y``
    rows (``synthetic_<i>.csv``: frames 0, 10, 20, …, every agent in every
    frame) under ``data_root``, for the windowing loader."""
    rng = np.random.default_rng(seed)
    os.makedirs(data_root, exist_ok=True)
    for f_idx in range(n_files):
        traj = make_social_scene(rng, n_agents=agents,
                                 seq_len=frames_per_file)
        rows = []
        for t in range(frames_per_file):
            for p in range(agents):
                rows.append([t * 10.0, p + 1.0, traj[p, t, 0], traj[p, t, 1]])
        np.savetxt(os.path.join(data_root, f"synthetic_{f_idx}.csv"),
                   np.asarray(rows), delimiter=",")
