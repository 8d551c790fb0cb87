"""Ulysses sequence-parallel geodesic attention (port of
``sttode_tpu/parallel/ulysses.py``).

The second sequence-parallel decomposition beside the ring
(``ring_attention``): instead of passing key and value blocks around the
ranks, one all-to-all on each side of the attention trades heads for
tokens (DeepSpeed-Ulysses):

    tokens split, every head   [B, H,   L/n, Dh]
      -- all_to_all (scatter heads, gather tokens) -->
    heads split, every token   [B, H/n, L,   Dh]
      -- the attention over the whole key axis, on this rank -->
      -- all_to_all (scatter tokens, gather heads) -->
    tokens split, every head   [B, H,   L/n, Dh]

Every rank sees the whole key axis, so the core is the dense attention
with no online-softmax state, and the key validity is gathered whole. The
core is the port's own ``nn.attention.geodesic_attention`` at compat
"tpu" with that validity: on a CUDA tensor the kernel its local shapes
pick (P / Q for the small problems, A / C whole-S, F / Fdq / Fdkv beyond
2048 keys), on the CPU the plain path. JAX computes the same function
with plain ``jnp`` (scores, a softmax, an einsum). The exchange is
``collectives.all_to_all``, its backward the inverse exchange: NCCL's
native all-to-all (captured in a CUDA graph with the step), gloo's staged
through host memory for CUDA tensors. Heads bound the degree (H % n),
where the ring scales with the tokens alone. The poincaré ball map is
pointwise a token, so it commutes with the exchange: the core applies it
after the exchange, where JAX's wrapper applies it before.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from sttode_tpu_torch.nn.attention import geodesic_attention
from sttode_tpu_torch.parallel import collectives
from sttode_tpu_torch.parallel.ring_attention import resolve_sp_axes


def _ulysses_body(q, k, v, group, kv_valid=None, metric: str = "oblique",
                  curvature: float = 1.0) -> torch.Tensor:
    """This rank's blocks q [B, H, Lb, Dh], k / v [B, H, Sb, Dh] (the token
    axes split over ``group``, every head) and ``kv_valid`` [B, Sb] → its
    rows of the attention, [B, H, Lb, Dh]."""
    qh, kh, vh = (collectives.all_to_all(x, group, 1, 2) for x in (q, k, v))
    val = None if kv_valid is None else collectives.all_gather(
        kv_valid, group, 1)
    out, _ = geodesic_attention(qh, kh, vh, compat="tpu", need_weights=False,
                                metric=metric, curvature=curvature,
                                kv_valid=val)
    return collectives.all_to_all(out, group, 2, 1)


def ulysses_geodesic_attention(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, mesh, *, axis: str = "data",
                               kv_valid: torch.Tensor | None = None,
                               metric: str = "oblique",
                               curvature: float = 1.0) -> torch.Tensor:
    """Sequence-parallel geodesic attention over the ranks of ``mesh[axis]``
    (``resolve_sp_axes``: "seq" on a 3-axis mesh) by a head ↔ token
    all-to-all. Each rank passes its blocks of the token axes: q [B, H,
    L/n, Dh], k / v [B, H, S/n, Dh] (block r on the axis' rank r) and
    ``kv_valid`` [B, S/n] (1 = a real key) or None; on a 3-axis mesh B is
    this rank's block of the batch over "data". The heads must divide over
    the axis (ValueError), the tokens divide by construction. Returns this
    rank's rows of softmax_j(score(q_i, k_j))·v_j, [B, H, L/n, Dh], in
    either metric ("oblique", or "poincare" at ``curvature``); a row with
    no valid key averages all of its values, as in JAX. Differentiable in
    q, k and v."""
    axis, _ = resolve_sp_axes(mesh, axis)
    group = mesh.get_group(axis)
    n = dist.get_world_size(group)
    if q.shape[1] % n:
        raise ValueError(f"ulysses attention splits the {q.shape[1]} heads "
                         f"over {axis} = {n}: they must divide")
    return _ulysses_body(q, k, v, group, kv_valid, metric, curvature)
