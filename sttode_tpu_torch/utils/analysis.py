"""Analysis toolbox (port of ``sttode_tpu/utils/analysis.py``): similarity
kernels, label-smoothed cross-entropy and accuracy, the 95 % confidence
interval of episode metrics, and the Grassmannian distance between feature
matrices. Functions on tensors, on the inputs' device; the matmuls and the
SVDs run in full fp32 (TF32 off, the port's default).
"""

from __future__ import annotations

import numpy as np
import torch


def compute_similarity(x1: torch.Tensor, x2: torch.Tensor, *,
                       metric: str = "euclidean", normalize: bool = True,
                       centering: bool = True) -> torch.Tensor:
    """Pairwise similarity [B, P, R] of x1 [B, P, M] and x2 [B, R, M].

    - "euclidean": the reciprocal of the (optionally centred and
      M-normalized) squared distance, through the Gram expansion
      ‖a − b‖² = ‖a‖² − 2⟨a, b⟩ + ‖b‖²;
    - "cosine": the cosine similarity of L2-normalized rows;
    - "cosine_v2": the cosine rescaled to [0, 1]."""
    if metric == "euclidean":
        if centering:
            x1 = x1 - x1.mean(dim=1, keepdim=True)
            x2 = x2 - x2.mean(dim=1, keepdim=True)
        ab = x1 @ x2.transpose(1, 2)
        aa = torch.sum(x1 * x1, dim=2, keepdim=True)            # [B, P, 1]
        bb = torch.sum(x2 * x2, dim=2)[:, None, :]               # [B, 1, R]
        distance = aa - 2.0 * ab + bb
        if normalize:
            distance = distance / x1.shape[-1]
        return 1.0 / (distance + 1e-8)
    if metric in ("cosine", "cosine_v2"):
        n1 = x1 / torch.clamp(torch.linalg.vector_norm(x1, dim=-1,
                                                       keepdim=True),
                              min=1e-12)
        n2 = x2 / torch.clamp(torch.linalg.vector_norm(x2, dim=-1,
                                                       keepdim=True),
                              min=1e-12)
        sim = n1 @ n2.transpose(1, 2)
        return (sim + 1.0) / 2.0 if metric == "cosine_v2" else sim
    raise NotImplementedError(metric)


def smooth_one_hot(labels: torch.Tensor, num_classes: int,
                   smoothing: float = 0.1) -> torch.Tensor:
    """Label-smoothed one-hot targets [N, C]: 1 − s on the true class,
    s / (C − 1) elsewhere."""
    assert 0.0 <= smoothing < 1.0
    off = smoothing / (num_classes - 1)
    out = torch.full((labels.shape[0], num_classes), off,
                     device=labels.device)
    return out.scatter(1, labels[:, None].long(), 1.0 - smoothing)


def cross_entropy(logits: torch.Tensor,
                  one_hot_targets: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy against (possibly soft) targets."""
    logp = torch.log_softmax(logits, dim=1)
    return -torch.mean(torch.sum(one_hot_targets * logp, dim=1))


def compute_acc(logits: torch.Tensor,
                one_hot_gts: torch.Tensor) -> torch.Tensor:
    """Argmax accuracy against one-hot targets."""
    pred = logits.argmax(dim=-1)
    gts = one_hot_gts.argmax(dim=-1)
    return (pred == gts).float().mean()


def label_smoothing_loss_acc(logits: torch.Tensor, labels: torch.Tensor,
                             num_classes: int, smoothing: float = 0.1,
                             softmaxed: bool = False
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """(loss, accuracy) with label smoothing; ``softmaxed`` logits are
    probabilities already."""
    logp = torch.log(logits) if softmaxed else torch.log_softmax(logits,
                                                                 dim=1)
    targets = smooth_one_hot(labels, num_classes, smoothing)
    loss = torch.mean(torch.sum(-targets * logp, dim=1))
    acc = (logits.argmax(dim=-1) == labels).float().mean()
    return loss, acc


def compute_confidence_interval(data) -> tuple[float, float]:
    """(mean, ±95 % half-width) of per-episode scalars, on the host in
    float64."""
    a = np.asarray(data, dtype=np.float64)
    m = float(a.mean())
    pm = float(1.96 * a.std() / np.sqrt(len(a)))
    return m, pm


def grassmann_distance(x1: torch.Tensor, x2: torch.Tensor,
                       p: int = 5) -> torch.Tensor:
    """Grassmannian distance between the column spaces of two feature
    matrices [N, M], the reference's recipe: mean((s1 − s2)²) over their
    singular values plus mean(σ²) over the singular values σ of the
    overlap U2[:, :p]ᵀ U1[:, :p] of their principal p-dim subspaces."""
    u1, s1, _ = torch.linalg.svd(x1, full_matrices=False)
    u2, s2, _ = torch.linalg.svd(x2, full_matrices=False)
    overlap = u2[:, :p].T @ u1[:, :p]                          # [p, p]
    s = torch.linalg.svdvals(overlap)
    return torch.mean((s1 - s2) ** 2) + torch.mean(s * s)
