"""Ring sequence-parallel geodesic attention (port of
``sttode_tpu/parallel/ring_attention.py``).

The token axes of q and of k/v are split over a mesh axis: each rank keeps
its block of queries and accumulates the online-softmax statistics (the
running max m, the normalizer l and the weighted sum acc) while the key,
value and key-validity blocks travel around the ring of ranks
(``collectives.ring_shift``: one send and one receive a hop), so that no
rank holds the whole [L, S] score matrix. The running max is kept, not the
attention kernels' maxless sum, so the ring serves the poincaré metric at
any curvature.

The backward pass is a ``torch.autograd.Function`` that runs the ring
again: each block's probabilities are recomputed from the saved m and l,
dq accumulates on its rank, and the dk / dv accumulators travel with their
blocks and are home after n hops (JAX gets the same from differentiating
``scan`` over ``ppermute``). The per-block arithmetic is the plain
PyTorch of the S-tiled kernels' plain versions (``kernels.mhgsa``): JAX's
ring is plain ``jnp`` too, and no TPU kernel is behind it.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from sttode_tpu_torch.kernels import mhgsa as kmhgsa
from sttode_tpu_torch.manifolds import pmath
from sttode_tpu_torch.parallel import collectives

NEG_INF = -1e30


def _block_scores(q, k, metric: str = "oblique", curvature: float = 1.0):
    """Negated geodesic scores of one block: [B, L, D] × [B, S, D] →
    [B, L, S]; "oblique" −acos of the clipped unit-row Gram, "poincare"
    the negated Möbius distance of ball points (the caller maps them
    once, ``_map_to_ball``)."""
    return kmhgsa._scores(q, k, metric, curvature)[1]


def _map_to_ball(x, metric: str, curvature: float):
    """The poincaré metric's input map project(expmap0(x)); the identity
    for the oblique metric, whose normalization is in the scores."""
    if metric != "poincare":
        return x
    return pmath.project(pmath.expmap0(x, c=curvature), c=curvature)


def _block_grads(q, k, v, val, do, m, l, delta, metric, c):
    """One block's (dq, dk, dv) from the saved statistics: p = exp(s − m)/l,
    dv = pᵀ·do, ds = p ⊙ (do·vᵀ − δ) on the valid keys, then the metric's
    score VJP."""
    state, s = kmhgsa._flash_scores(q, k, val, metric, c)
    p = torch.exp(s - m[..., None]) / l[..., None]
    ds = p * (do @ v.transpose(-1, -2) - delta[..., None])
    ds = torch.where(val[:, None, :] > 0, ds, 0.0)
    dq, dk = kmhgsa._qk_grads(state, ds, q, k, metric, c)
    return dq, dk, p.transpose(-1, -2) @ do


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, val, group, metric, c):
        n = dist.get_world_size(group)
        B, L, D = q.shape
        m = q.new_full((B, L), NEG_INF)
        l = q.new_zeros((B, L))
        acc = q.new_zeros((B, L, v.shape[-1]))
        kb, vb, valb = k, v, val
        for step in range(n):
            _, s = kmhgsa._flash_scores(q, kb, valb, metric, c)
            m_new = torch.maximum(m, s.amax(dim=-1))
            scale = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * scale + p.sum(dim=-1)
            acc = acc * scale[..., None] + p @ vb
            m = m_new
            if step < n - 1:
                kb, vb, valb = collectives.ring_shift([kb, vb, valb], group)
        l = torch.clamp(l, min=1e-30)
        out = acc / l[..., None]
        ctx.save_for_backward(q, k, v, val, out, m, l)
        ctx.group, ctx.metric, ctx.c = group, metric, c
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, val, out, m, l = ctx.saved_tensors
        group = ctx.group
        n = dist.get_world_size(group)
        do = do.contiguous()
        delta = torch.sum(do * out, dim=-1)
        dq = torch.zeros_like(q)
        dk, dv = torch.zeros_like(k), torch.zeros_like(v)
        kb, vb, valb = k, v, val
        for step in range(n):
            gq, gk, gv = _block_grads(q, kb, vb, valb, do, m, l, delta,
                                      ctx.metric, ctx.c)
            dq += gq
            dk, dv = dk + gk, dv + gv
            if n == 1:
                break
            # the accumulators ride with their blocks: home after n hops
            if step < n - 1:
                kb, vb, valb, dk, dv = collectives.ring_shift(
                    [kb, vb, valb, dk, dv], group)
            else:
                dk, dv = collectives.ring_shift([dk, dv], group)
        return dq, dk, dv, None, None, None, None


def resolve_sp_axes(mesh, axis: str) -> tuple[str, str | None]:
    """(token axis, batch axis) of the sequence-parallel paths on ``mesh``:
    on a 3-axis mesh the tokens ride "seq" and the batch is split over
    "data" (data and sequence parallelism compose); on the 2-axis mesh the
    tokens ride ``axis`` and the batch is whole on every rank."""
    names = mesh.mesh_dim_names
    if axis == "data" and "seq" in names:
        axis = "seq"
    batch_axis = "data" if axis != "data" and "data" in names else None
    return axis, batch_axis


def ring_geodesic_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, mesh, *, axis: str = "data",
                            kv_valid: torch.Tensor | None = None,
                            metric: str = "oblique",
                            curvature: float = 1.0) -> torch.Tensor:
    """Sequence-parallel geodesic attention over the ranks of
    ``mesh[axis]`` (``resolve_sp_axes``). Each rank passes its blocks: q
    [B, L/n, D] and k, v [B, S/n, D] of the token axes (block r on the
    axis' rank r) and ``kv_valid`` [B, S/n] (1 = a real key); on a 3-axis
    mesh B is this rank's block of the batch over "data". Returns this
    rank's rows of softmax_j(score(q_i, k_j))·v_j [B, L/n, D], within fp32
    rounding of the dense computation in either metric ("oblique" or
    "poincare" at ``curvature``); a row with no valid key averages all of
    its values, as in JAX. Differentiable in q, k and v."""
    axis, _ = resolve_sp_axes(mesh, axis)
    group = mesh.get_group(axis)
    q = _map_to_ball(q, metric, curvature).to(torch.float32)
    k = _map_to_ball(k, metric, curvature).to(torch.float32)
    v = v.to(torch.float32)
    val = (torch.ones(k.shape[:2], dtype=torch.float32, device=k.device)
           if kv_valid is None else kv_valid.to(torch.float32))
    return _Ring.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                       val.contiguous(), group, metric, float(curvature))


def dense_reference(q, k, v, kv_valid=None, metric="oblique", curvature=1.0):
    """The unsharded oracle: softmax_j(scores)·V on whole tensors."""
    q = _map_to_ball(q, metric, curvature)
    k = _map_to_ball(k, metric, curvature)
    s = _block_scores(q, k, metric, curvature)
    if kv_valid is not None:
        s = torch.where(kv_valid[:, None, :] > 0, s, NEG_INF)
    return torch.softmax(s, dim=-1) @ v
