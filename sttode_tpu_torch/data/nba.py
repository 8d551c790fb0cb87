"""NBA SportVU trajectories (port of ``sttode_tpu/data/nba.py``).

``train.npy`` / ``test.npy`` hold [S, seq_len, N = 11, 2] positions in feet
(the reference's ``data/dataloader_nba.py``); they are converted to metres
by ÷(94/28), capped at 32500 train / 12500 test samples and returned
agent-major. Numpy copies of the JAX package's functions: the port does not
import it.
"""

from __future__ import annotations

import os

import numpy as np

FEET_TO_METERS = 94.0 / 28.0   # court feet → metres divisor
TRAIN_CAP = 32500
TEST_CAP = 12500


def load_nba(data_dir: str, *, obs_len: int = 5, pred_len: int = 10,
             training: bool = True, cap: int | None = None):
    """Returns (past [S, N, obs_len, 2], future [S, N, pred_len, 2]) in
    metres."""
    fname = "train.npy" if training else "test.npy"
    trajs = np.load(os.path.join(data_dir, fname)).astype(np.float32)
    trajs = trajs / FEET_TO_METERS
    if cap is None:
        cap = TRAIN_CAP if training else TEST_CAP
    trajs = trajs[:cap]
    # stored [S, seq_len, N, 2] → agent-major [S, N, seq_len, 2]
    trajs = np.transpose(trajs, (0, 2, 1, 3))
    return trajs[:, :, :obs_len], trajs[:, :, obs_len:obs_len + pred_len]


def nba_batches(past: np.ndarray, future: np.ndarray, batch_size: int, *,
                rng: np.random.Generator | None = None, drop_last: bool = True):
    """Yield dict batches {'past_traj': [B, N, T_p, 2], 'future_traj': ...,
    'seq': 'nba'}, shuffled by ``rng`` when given; the last partial batch is
    dropped unless ``drop_last=False``."""
    S = past.shape[0]
    order = np.arange(S)
    if rng is not None:
        rng.shuffle(order)
    end = S - (S % batch_size) if drop_last else S
    for i in range(0, end, batch_size):
        idx = order[i:i + batch_size]
        yield {"past_traj": past[idx], "future_traj": future[idx],
               "seq": "nba"}
