"""Evaluation metrics of the port (numpy): the best-of-K metrics of
``sttode_tpu/utils/metrics.py`` (the reference's ``utils/metrics.py``,
vectorized over [N, K, T, 2]: per agent the min over samples of the
time-averaged (ADE) or final (FDE) L2 error, averaged over agents), the
streaming ``AverageMeter``, and the NBA horizon table of
``sttode_tpu/evaluation.py::evaluate_nba`` (the reference's
``test_model_all``)."""

from __future__ import annotations

import numpy as np

def _dists(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """pred [N, K, T, 2], gt [N, T, 2] → L2 per step [N, K, T]."""
    return np.linalg.norm(pred - gt[:, None], axis=-1)


def compute_ade(pred: np.ndarray, gt: np.ndarray,
                valid: np.ndarray | None = None) -> float:
    """Best-of-K ADE averaged over the (valid) agents."""
    best = _dists(pred, gt).mean(axis=-1).min(axis=-1)      # [N]
    if valid is not None:
        return float((best * valid).sum() / max(valid.sum(), 1.0))
    return float(best.mean())


def compute_fde(pred: np.ndarray, gt: np.ndarray,
                valid: np.ndarray | None = None) -> float:
    """Best-of-K FDE averaged over the (valid) agents."""
    best = _dists(pred, gt)[..., -1].min(axis=-1)           # [N]
    if valid is not None:
        return float((best * valid).sum() / max(valid.sum(), 1.0))
    return float(best.mean())


def best_sample_indices(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """Each agent's sample index of least ADE [N]."""
    return _dists(pred, gt).mean(axis=-1).argmin(axis=-1)


def count_miss_samples(pred: np.ndarray, gt: np.ndarray,
                       mr_threshold: float = 1.0) -> int:
    """Agents whose best-of-K FDE exceeds ``mr_threshold``."""
    best_fde = _dists(pred, gt)[..., -1].min(axis=-1)
    return int((best_fde > mr_threshold).sum())


class AverageMeter:
    """Streaming weighted average."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)


# rows of the NBA table: 10 steps of 0.4 s; 1.0 s and 3.0 s fall between two
# steps and are the mean of the two adjacent ones, as in the reference
NBA_FUTURE_LENGTH = 10


def nba_horizon_table(avg: np.ndarray, dest: np.ndarray,
                      n_scenes: int) -> dict:
    """The reference's NBA table from the per-step best-of-K prefix ADE
    ``avg`` [10] and step FDE ``dest`` [10] (means over agents)."""
    T = NBA_FUTURE_LENGTH
    return {
        "ade": {"1.0s": (avg[1] + avg[2]) / 2, "2.0s": avg[4],
                "3.0s": (avg[6] + avg[7]) / 2, "4.0s": avg[T - 1]},
        "fde": {"1.0s": (dest[1] + dest[2]) / 2, "2.0s": dest[4],
                "3.0s": (dest[6] + dest[7]) / 2, "4.0s": dest[T - 1]},
        "scenes": n_scenes,
    }
