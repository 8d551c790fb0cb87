"""Scene → model-Batch preparation (port of
``sttode_tpu/data/preprocess.py::prepare_scene_group`` and ``_velocities``).

Numpy on the host, as in the JAX package; the result is the port's ``Batch``
of CPU tensors (``Batch.to(device)`` moves it). Copied rather than imported:
``sttode_tpu.data`` imports the JAX model.
"""

from __future__ import annotations

import numpy as np
import torch

from sttode_tpu_torch.models.sttode import Batch


def _velocities(past: np.ndarray, future: np.ndarray):
    past_vel = np.concatenate([past[:, 1:2] - past[:, 0:1],
                               past[:, 1:] - past[:, :-1]], axis=1)
    prev = np.concatenate([past[:, -1:], future[:, :-1]], axis=1)
    future_vel = future - prev
    return past_vel.astype(np.float32), future_vel.astype(np.float32)


def prepare_scene_group(obs: np.ndarray, pred: np.ndarray, valid: np.ndarray,
                        *, training: bool,
                        rng: np.random.Generator | None = None,
                        rand_rot: bool = True):
    """Vectorized multi-scene preparation over [B, Np, T, 2] stacks: scene
    origin = mean last observed position of the valid agents, optional
    random rotation (training with an rng), positions relative to the
    origin, velocities, padded rows zeroed.

    Returns (Batch [B·Np rows], scene_origs [B, 2])."""
    obs = np.asarray(obs, np.float32)       # [B, Np, Tp, 2]
    pred = np.asarray(pred, np.float32)     # [B, Np, Tf, 2]
    valid = np.asarray(valid, np.float32)   # [B, Np]
    B, Np = obs.shape[:2]

    denom = np.maximum(valid.sum(axis=1, keepdims=True), 1.0)       # [B, 1]
    orig = (obs[:, :, -1] * valid[..., None]).sum(axis=1) / denom   # [B, 2]

    if training and rand_rot and rng is not None:
        theta = rng.uniform(0.0, 2.0 * np.pi, size=(B,)).astype(np.float32)
        c = np.cos(theta)[:, None, None]
        s = np.sin(theta)[:, None, None]

        def rot(x):
            rel = x - orig[:, None, None, :]
            out = np.stack([rel[..., 0] * c - rel[..., 1] * s,
                            rel[..., 0] * s + rel[..., 1] * c], axis=-1)
            return out + orig[:, None, None, :], out

        obs_abs, obs_norm = rot(obs)
        pred_abs, pred_norm = rot(pred)
    else:
        obs_abs, obs_norm = obs, obs - orig[:, None, None, :]
        pred_abs, pred_norm = pred, pred - orig[:, None, None, :]

    obs_norm = obs_norm * valid[..., None, None]
    pred_norm = pred_norm * valid[..., None, None]

    flat = lambda x: x.reshape(B * Np, *x.shape[2:])  # noqa: E731
    past_vel, future_vel = _velocities(flat(obs_abs), flat(pred_abs))
    vmask = valid.reshape(B * Np, 1, 1)
    past_vel = past_vel * vmask
    future_vel = future_vel * vmask

    t = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32))  # noqa: E731
    batch = Batch(past=t(flat(obs_norm)), past_vel=t(past_vel),
                  future=t(flat(pred_norm)), future_vel=t(future_vel),
                  valid=t(valid.reshape(B * Np)), batch_size=B, agent_num=Np)
    return batch, orig
