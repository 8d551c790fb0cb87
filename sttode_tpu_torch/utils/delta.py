"""Gromov δ-hyperbolicity (port of ``sttode_tpu/utils/delta.py``): an
analysis tool for choosing the curvature, or checking that a feature space
is hyperbolic.

``delta_hyp`` is the exact O(n³) max–min over Gromov products on a distance
matrix, on the matrix's device. JAX's form materializes the [n, n, n]
minimum, 27 GB in float64 at the default subsample of 1,500 points; the
port computes the same max–min a block of rows at a time, at most
``BLOCK_ELEMS`` elements a block, so the default size runs on the card.
``batched_delta_hyp`` and ``features_delta`` draw their subsample indices
with the caller's numpy ``Generator`` exactly as JAX does, so both
frameworks pick the same rows; the distances are computed in the points'
dtype on their device.
"""

from __future__ import annotations

from typing import Callable, Iterable

import numpy as np
import torch

BLOCK_ELEMS = 1 << 27     # elements of one block's [rows, n, n] minimum


def delta_hyp(dismat: torch.Tensor) -> float:
    """δ-hyperbolicity of a metric space from its distance matrix [n, n],
    through the Gromov products with respect to the base point 0."""
    row = dismat[0, :][None, :]
    col = dismat[:, 0][:, None]
    gromov = 0.5 * (row + col - dismat)
    n = gromov.shape[0]
    rows = max(1, BLOCK_ELEMS // max(n * n, 1))
    delta = None
    for i in range(0, n, rows):
        g = gromov[i:i + rows]
        maxmin = torch.minimum(g[:, :, None], gromov[None, :, :]).amax(dim=1)
        block = (maxmin - g).max()
        delta = block if delta is None else torch.maximum(delta, block)
    return float(delta)


def _pairwise(x: torch.Tensor) -> torch.Tensor:
    """‖x_i − x_j‖ for every pair of rows of x [n, D], a block of rows at a
    time (the difference form, as JAX's numpy computes it)."""
    n = x.shape[0]
    rows = max(1, BLOCK_ELEMS // max(n * x.shape[1], 1))
    return torch.cat([torch.linalg.vector_norm(x[i:i + rows, None] - x[None],
                                               dim=-1)
                      for i in range(0, n, rows)])


def _subsample(x: torch.Tensor, size: int,
               rng: np.random.Generator) -> torch.Tensor:
    idx = rng.choice(len(x), min(size, len(x)), replace=False)
    return x[torch.as_tensor(idx, device=x.device)]


def batched_delta_hyp(X: torch.Tensor, n_tries: int = 10,
                      batch_size: int = 1500,
                      rng: np.random.Generator | None = None
                      ) -> tuple[float, float]:
    """Mean and standard deviation of the diameter-relative δ over
    ``n_tries`` random subsamples of ``batch_size`` rows of X [N, D]."""
    if rng is None:
        rng = np.random.default_rng(0)
    vals = []
    for _ in range(n_tries):
        d = _pairwise(_subsample(X, batch_size, rng))
        vals.append(delta_hyp(d) / max(float(d.max()), 1e-12))
    return float(np.mean(vals)), float(np.std(vals))


def features_delta(batches: Iterable,
                   feature_fn: Callable[..., torch.Tensor],
                   sample: int = 1500,
                   rng: np.random.Generator | None = None
                   ) -> tuple[float, float]:
    """(δ, diameter) of the features that ``feature_fn`` makes of each of
    ``batches`` (rows [n_b, D], concatenated), on a subsample of ``sample``
    rows."""
    if rng is None:
        rng = np.random.default_rng(0)
    feats = torch.cat([feature_fn(b) for b in batches])
    d = _pairwise(_subsample(feats, sample, rng))
    return delta_hyp(d), float(d.max())
