"""Synthetic multi-agent scenes (port of
``sttode_tpu/data/synthetic.py::make_social_scenes``): goal-directed agents
with social repulsion and noise, made from a seed with numpy, for smoke
runs and tests."""

from __future__ import annotations

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
    """Scene dicts with "obs" [N, obs_len, 2] and "pred" [N, pred_len, 2]
    (the same draws as the JAX package's generator for the same seed)."""
    rng = np.random.default_rng(seed)
    scenes = []
    for _ in range(n_scenes):
        n = int(rng.integers(agents_range[0], agents_range[1] + 1))
        traj = make_social_scene(rng, n_agents=n, seq_len=obs_len + pred_len)
        scenes.append({"obs": traj[:, :obs_len], "pred": traj[:, obs_len:]})
    return scenes
