"""Multi-head geodesic self-attention (port of ``sttode_tpu/nn/attention.py``).

Scores are negated geodesic distances on the oblique manifold,
``score(q, k) = -acos(clip(q̂·k̂, ±(1-1e-4)))``, in one of two orientations:

- ``compat="reference"`` (quirk Q3): the square case uses
  ``scores[i, j] = -d(k_i, q_j)``; rectangular shapes use the corrected one.
  Masks never reach attention in this mode (quirk Q2, dropped by the caller).
- ``compat="tpu"``: ``scores[i, j] = -d(q_i, k_j)`` with an additive mask.

Routing (``geodesic_attention``): a CUDA tensor with ``fused`` "auto" or True
goes to the hand-written kernels ``kernels.mhgsa.fused_geodesic_attention``
(forward and, when a gradient is taken, backward; Q3 is the kernel with q
and k swapped); ``fused=False`` ("dense") or a CPU tensor takes the plain
path, a max-subtracted softmax over the dense scores. No size threshold is
applied: the JAX package's TPU crossover would send the training shape
(L = S = 128) to XLA, while the port sends it to the kernel;
``chip_smoke.py`` times both routes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sttode_tpu_torch.kernels.mhgsa import fused_geodesic_attention
from sttode_tpu_torch.manifolds import oblique
from sttode_tpu_torch.nn import core


class MHGSAParams(NamedTuple):
    """Packed projections in the JAX layout: ``in_proj_w`` [E, 3E] (q, k, v
    column blocks), ``out_proj_w`` [E, E]."""
    in_proj_w: torch.Tensor
    in_proj_b: torch.Tensor
    out_proj_w: torch.Tensor
    out_proj_b: torch.Tensor


def mhgsa_init(gen, embed_dim: int, dtype=torch.float32) -> MHGSAParams:
    return MHGSAParams(
        in_proj_w=core.xavier_uniform(gen, embed_dim, 3 * embed_dim, dtype),
        in_proj_b=torch.zeros(3 * embed_dim, dtype=dtype),
        out_proj_w=core.torch_linear_weight(gen, embed_dim, embed_dim, dtype),
        out_proj_b=torch.zeros(embed_dim, dtype=dtype))


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[..., L, E] -> [..., H, L, Dh]."""
    *lead, L, E = x.shape
    return x.reshape(*lead, L, num_heads, E // num_heads).movedim(-2, -3)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[..., H, L, Dh] -> [..., L, E]."""
    x = x.movedim(-3, -2)
    *lead, L, H, Dh = x.shape
    return x.reshape(*lead, L, H * Dh)


def geodesic_scores(q: torch.Tensor, k: torch.Tensor, *,
                    compat: str = "reference",
                    metric: str = "oblique") -> torch.Tensor:
    """Negated geodesic distances: q [..., L, Dh], k [..., S, Dh] →
    [..., L, S] (square reference-compat case: the Q3 orientation)."""
    if metric != "oblique":
        raise NotImplementedError("the poincaré metric is not ported yet")
    qn = oblique.proj(q)
    kn = oblique.proj(k)
    if compat == "reference":
        d = oblique.dist(kn, qn)                 # [..., S, L]
        if q.shape[-2] != k.shape[-2]:
            d = d.transpose(-1, -2)
        return -d
    return -oblique.dist(qn, kn)


def geodesic_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       mask: torch.Tensor | None = None,
                       compat: str = "reference",
                       fused: str | bool = "auto",
                       need_weights: bool = True,
                       metric: str = "oblique"):
    """Core attention: scores → (+mask) → softmax → @v.

    q [..., L, Dh], k/v [..., S, Dh], additive mask broadcastable to
    [..., L, S]. Returns (out [..., L, Dh], weights [..., L, S] or None on
    the kernel route). ``fused``: "auto" (kernel on CUDA unless weights are
    wanted), True (kernel on CUDA), False (plain path)."""
    if fused not in ("auto", True, False):
        raise NotImplementedError(
            f"attention route {fused!r} is not ported (only auto/fused/dense)")
    use_kernel = q.is_cuda and (fused is True or
                                (fused == "auto" and not need_weights))
    if use_kernel:
        swapped = compat == "reference" and q.shape[-2] == k.shape[-2]
        qq, kk = (k, q) if swapped else (q, k)
        return fused_geodesic_attention(qq, kk, v, mask=mask,
                                        metric=metric), None
    scores = geodesic_scores(q, k, compat=compat, metric=metric)
    if mask is not None:
        scores = scores + mask
    w = torch.softmax(scores, dim=-1)
    return w @ v, w


def mhgsa(params: MHGSAParams, query: torch.Tensor, key: torch.Tensor,
          value: torch.Tensor, num_heads: int, *,
          mask: torch.Tensor | None = None,
          compat: str = "reference",
          need_weights: bool = False,
          fused: str | bool = "auto",
          metric: str = "oblique"):
    """Full multi-head geodesic attention: query [..., L, E], key/value
    [..., S, E] → (out [..., L, E], head-averaged weights or None). One
    packed [E, 3E] projection when query, key and value are the same tensor,
    split projections otherwise."""
    E = query.shape[-1]
    head_dim = E // num_heads
    if head_dim * num_heads != E:
        raise ValueError(f"embed dim {E} must divide num_heads {num_heads}")
    if query is key and key is value:
        q, k, v = (query @ params.in_proj_w + params.in_proj_b).chunk(3, -1)
    else:
        wq, wk, wv = params.in_proj_w.chunk(3, dim=1)
        bq, bk, bv = params.in_proj_b.chunk(3)
        q, k, v = query @ wq + bq, key @ wk + bk, value @ wv + bv
    # quirk Q10: a forward no-op after the row normalization, kept so the
    # numerics follow the reference's operation order
    if metric == "oblique":
        q = q * (head_dim ** -0.5)
    if mask is not None:
        mask = mask[..., None, :, :]            # broadcast over heads
    out_h, w = geodesic_attention(
        split_heads(q, num_heads), split_heads(k, num_heads),
        split_heads(v, num_heads), mask=mask, compat=compat,
        fused=fused, need_weights=need_weights, metric=metric)
    out = merge_heads(out_h) @ params.out_proj_w + params.out_proj_b
    if need_weights and w is not None:
        return out, w.mean(dim=-3)
    return out, None
