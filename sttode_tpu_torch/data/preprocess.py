"""Scene → model-Batch preparation (port of ``sttode_tpu/data/preprocess.py``:
``rotate_2d``, ``prepare_scene``, ``stack_scenes``, ``prepare_scene_group``,
``prepare_nba_batch`` and ``_velocities``).

Numpy on the host, as in the JAX package; the result is the port's ``Batch``
of CPU tensors (``Batch.to(device)`` moves it). Copied rather than imported:
``sttode_tpu.data`` imports the JAX model.

The reference's semantics (its ``set_data``): training subsamples agents
above ``max_train_agent`` with replacement (quirk Q6); the scene origin is
the mean last observed position; training rotates the scene about it by a
random angle; velocities repeat the first past step, and the future's start
from the last past position.
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


def rotate_2d(xy: np.ndarray, theta: float, origin: np.ndarray):
    """Rotate points about ``origin``. Returns (absolute, origin-relative)."""
    rel = xy - origin
    c, s = np.cos(theta), np.sin(theta)
    rot = np.stack([rel[..., 0] * c - rel[..., 1] * s,
                    rel[..., 0] * s + rel[..., 1] * c], axis=-1)
    return rot + origin, rot


def prepare_scene(scene: dict, *, training: bool,
                  rng: np.random.Generator | None = None,
                  max_train_agent: int = 100, rand_rot: bool = True,
                  pad_to: int | None = None):
    """One ETH/SDD scene dict → (Batch [B = 1], scene_orig [2]).

    ``pad_to`` zero-pads the agent axis to a bucket size, the padded rows
    marked invalid."""
    obs = np.asarray(scene["obs"], np.float32)       # [N, T_p, 2]
    pred = np.asarray(scene["pred"], np.float32)     # [N, T_f, 2]
    N = obs.shape[0]

    if training and rng is None and (N > max_train_agent or rand_rot):
        raise ValueError(
            "prepare_scene(training=True) needs an rng for agent "
            "subsampling / rotation augmentation; pass "
            "rng=np.random.default_rng(seed), or rand_rot=False with "
            f"N <= max_train_agent (got N={N}, max={max_train_agent})")

    if training and rng is not None and N > max_train_agent:
        idx = rng.choice(N, max_train_agent)          # with replacement (Q6)
        obs, pred = obs[idx], pred[idx]
        N = max_train_agent

    scene_orig = obs[:, -1].mean(axis=0)              # [2]

    if training and rand_rot and rng is not None:
        theta = rng.uniform(0.0, 2.0 * np.pi)
        obs_abs, obs_norm = rotate_2d(obs, theta, scene_orig)
        pred_abs, pred_norm = rotate_2d(pred, theta, scene_orig)
    else:
        obs_abs, obs_norm = obs, obs - scene_orig
        pred_abs, pred_norm = pred, pred - scene_orig

    past_vel, future_vel = _velocities(obs_abs, pred_abs)
    valid = np.ones((N,), np.float32)

    if pad_to is not None and pad_to < N:
        raise ValueError(f"pad_to={pad_to} smaller than agent count {N}")
    if pad_to is not None and pad_to > N:
        def pad(x):
            width = [(0, pad_to - N)] + [(0, 0)] * (x.ndim - 1)
            return np.pad(x, width)
        obs_norm, pred_norm = pad(obs_norm), pad(pred_norm)
        past_vel, future_vel, valid = pad(past_vel), pad(future_vel), pad(valid)
        N = pad_to

    batch = Batch(past=_t(obs_norm), past_vel=_t(past_vel),
                  future=_t(pred_norm), future_vel=_t(future_vel),
                  valid=_t(valid), batch_size=1, agent_num=N)
    return batch, scene_orig


def stack_scenes(batches: list[Batch]) -> Batch:
    """Stack single-scene Batches of one padded size into one [B·N] Batch
    (multi-scene batching; use with ``attn_axis="agent"``)."""
    if len({b.agent_num for b in batches}) != 1:
        raise ValueError("stack_scenes needs one agent_num: pad to a common "
                         "size first")
    cat = lambda xs: torch.cat(xs, dim=0)  # noqa: E731
    return Batch(
        past=cat([b.past for b in batches]),
        past_vel=cat([b.past_vel for b in batches]),
        future=cat([b.future for b in batches]),
        future_vel=cat([b.future_vel for b in batches]),
        valid=cat([b.valid for b in batches]),
        batch_size=len(batches),
        agent_num=batches[0].agent_num,
    )


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

    batch = Batch(past=_t(flat(obs_norm)), past_vel=_t(past_vel),
                  future=_t(flat(pred_norm)), future_vel=_t(future_vel),
                  valid=_t(valid.reshape(B * Np)), batch_size=B, agent_num=Np)
    return batch, orig


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


def prepare_nba_batch(data: dict) -> Batch:
    """NBA collated dict {'past_traj': [B, N, T_p, 2], 'future_traj': ...}
    → Batch in absolute coordinates, every agent real (the reference's
    ``set_data_nba``)."""
    past = np.asarray(data["past_traj"], np.float32)
    future = np.asarray(data["future_traj"], np.float32)
    B, N = past.shape[:2]
    past = past.reshape(B * N, *past.shape[2:])
    future = future.reshape(B * N, *future.shape[2:])
    past_vel, future_vel = _velocities(past, future)
    return Batch(past=_t(past), past_vel=_t(past_vel), future=_t(future),
                 future_vel=_t(future_vel),
                 valid=torch.ones(B * N, dtype=torch.float32),
                 batch_size=B, agent_num=N)
