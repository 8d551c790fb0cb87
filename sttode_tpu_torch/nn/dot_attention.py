"""Scaled dot-product attention, the geodesic attention's A/B baseline (port
of ``sttode_tpu/nn/dot_attention.py``): the same call shape and parameters
as ``nn.attention.mhgsa``, scores q·kᵀ/√Dh instead of −acos(q̂·k̂ᵀ).

Written as JAX writes it (matmul, additive mask, softmax, dropout, matmul)
rather than with ``scaled_dot_product_attention``, which returns no weights
and draws its own dropout. The dropout of the weights takes the keep-mask
``dropout_mask`` (the tests hand both frameworks the same draw) or draws
from ``generator``; at ``dropout_rate`` 0 (JAX's ``deterministic``) there
is none.
"""

from __future__ import annotations

import torch

from sttode_tpu_torch.nn import core
from sttode_tpu_torch.nn.attention import (MHGSAParams, merge_heads,
                                           mhgsa_init, split_heads)

# the module shares the packed-projection parameters
dot_mhsa_init = mhgsa_init


def dot_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  mask: torch.Tensor | None = None,
                  dropout_rate: float = 0.0,
                  dropout_mask: torch.Tensor | None = None,
                  generator: torch.Generator | None = None):
    """q [..., L, Dh], k / v [..., S, Dh] → (out [..., L, Dh], weights
    [..., L, S]); ``mask`` is added to the scores."""
    scores = (q @ k.transpose(-1, -2)) * (q.shape[-1] ** -0.5)
    if mask is not None:
        scores = scores + mask
    w = torch.softmax(scores, dim=-1)
    w = core.dropout(w, dropout_rate, keep_mask=dropout_mask,
                     generator=generator)
    return w @ v, w


def dot_mhsa(params: MHGSAParams, query: torch.Tensor, key: torch.Tensor,
             value: torch.Tensor, num_heads: int, *,
             mask: torch.Tensor | None = None, dropout_rate: float = 0.0,
             dropout_mask: torch.Tensor | None = None,
             generator: torch.Generator | None = None,
             need_weights: bool = False):
    """Multi-head dot-product attention: query [..., L, E], key / value
    [..., S, E] → (out [..., L, E], the heads' mean weights [..., L, S] or
    None). One packed [E, 3E] projection when query, key and value are the
    same tensor, split projections otherwise; ``mask`` [..., L, S] is
    shared by the heads, ``dropout_mask`` is [..., H, L, S]."""
    if query is key and key is value:
        q, k, v = (query @ params.in_proj_w + params.in_proj_b).chunk(3, -1)
    else:
        wq, wk, wv = params.in_proj_w.chunk(3, dim=1)
        bq, bk, bv = params.in_proj_b.chunk(3)
        q, k, v = query @ wq + bq, key @ wk + bk, value @ wv + bv
    if mask is not None:
        mask = mask[..., None, :, :]
    out_h, w = dot_attention(split_heads(q, num_heads),
                             split_heads(k, num_heads),
                             split_heads(v, num_heads), mask=mask,
                             dropout_rate=dropout_rate,
                             dropout_mask=dropout_mask, generator=generator)
    out = merge_heads(out_h) @ params.out_proj_w + params.out_proj_b
    if need_weights:
        return out, w.mean(dim=-3)
    return out, None
