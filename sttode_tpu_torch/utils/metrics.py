"""Evaluation metrics of the port: the NBA horizon table of
``sttode_tpu/evaluation.py::evaluate_nba`` (the reference's
``test_model_all``). The ETH-UCY / SDD metrics of
``sttode_tpu/utils/metrics.py`` come with ``evaluate_scenes``, not ported
yet."""

from __future__ import annotations

import numpy as np

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
