"""Geodesic attention: the CUDA kernels' wrappers and their plain versions.

Port of ``sttode_tpu/kernels/mhgsa.py::fused_geodesic_attention`` (oblique
metric), forward and backward. The kernels are ``csrc/mhgsa_fwd.cu`` and
``csrc/mhgsa_bwd.cu``; their source notes say which TPU kernel each
replaces, what bounds it on the H100 and what its design does about it.

``fused_geodesic_attention`` keeps the JAX entry's contract: leading dims are
flattened into the problem axis, the additive mask is canonicalized in plain
torch before the launch (``_canonicalize_mask``), and the kernel computes
``softmax_j(-acos(clip(q̂_i·k̂_j, ±(1-1e-4))) + mask)·V`` with a maxless
softmax whose denominator is floored at 1e-30 (an all-excluded row outputs
0). The gradient is a ``torch.autograd.Function`` (``_FusedCore``, the JAX
``custom_vjp``): it saves q, k, v and the canonicalized mask and recomputes
the scores in its backward (``fused_geodesic_attention_backward``), which
returns the mask cotangent only when the mask needs one; the
canonicalization itself stays differentiable plain torch, as in JAX. On a
CPU tensor each direction runs its plain version
(``fused_geodesic_attention_reference``,
``fused_geodesic_attention_backward_reference``); on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from sttode_tpu_torch.kernels import _build

EPS = 1e-4            # fp32 acos clip
NORM_FLOOR = 1e-12
NEG_INF = -1e30       # exclusion sentinel after canonicalization


def _canonicalize_mask(m: torch.Tensor) -> torch.Tensor:
    """Make an additive mask safe for the maxless softmax: subtract each
    row's max over its finite entries (softmax-invariant), floor the rest at
    -30, and map entries ≤ -1e29 (the exclusion sentinel, e.g.
    ``finfo(float32).min``) to -1e30."""
    m = m.to(torch.float32)
    finite = m > -1e29
    row_max = torch.where(finite, m, -3e38).amax(dim=-1, keepdim=True)
    row_max = torch.where(finite.any(dim=-1, keepdim=True), row_max, 0.0)
    shifted = torch.clamp(torch.where(finite, m, 0.0) - row_max, min=-30.0)
    return torch.where(finite, shifted, NEG_INF)


def fused_geodesic_attention_reference(q: torch.Tensor, k: torch.Tensor,
                                       v: torch.Tensor,
                                       mask: torch.Tensor | None
                                       ) -> torch.Tensor:
    """Plain PyTorch version of the kernel on flattened operands: q [B,L,Dh],
    k/v [B,S,Dh], canonicalized mask [B,L,S] or None."""
    qn = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True),
                         min=NORM_FLOOR)
    kn = k / torch.clamp(torch.linalg.vector_norm(k, dim=-1, keepdim=True),
                         min=NORM_FLOOR)
    g = torch.clamp(qn @ kn.transpose(-1, -2), -1.0 + EPS, 1.0 - EPS)
    s = -torch.arccos(g)
    if mask is not None:
        s = s + mask
    e = torch.exp(s)
    p = e / torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-30)
    return p @ v


def fused_geodesic_attention_backward_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        mask: torch.Tensor | None, do: torch.Tensor, need_dmask: bool):
    """Plain PyTorch version of the backward kernel, the formula of the JAX
    ``_fused_bwd``: recompute p; dv = pᵀ·do; ds = p ⊙ (dp − rowsum(dp ⊙ p));
    dg = ds / √(1 − gc²) gated by the unclipped |g| < 1 − ε; dq̂ = dg·k̂,
    dk̂ = dgᵀ·q̂; the row-normalize VJP of each side. Returns (dq, dk, dv,
    dmask or None) on flattened operands."""
    q_norm = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    k_norm = torch.linalg.vector_norm(k, dim=-1, keepdim=True)
    qn = q / torch.clamp(q_norm, min=NORM_FLOOR)
    kn = k / torch.clamp(k_norm, min=NORM_FLOOR)
    g = qn @ kn.transpose(-1, -2)
    gc = torch.clamp(g, -1.0 + EPS, 1.0 - EPS)
    s = -torch.arccos(gc)
    if mask is not None:
        s = s + mask
    e = torch.exp(s)
    p = e / torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-30)
    dp = do @ v.transpose(-1, -2)
    ds = p * (dp - torch.sum(dp * p, dim=-1, keepdim=True))
    dg = torch.where(g.abs() < 1.0 - EPS,
                     ds * torch.rsqrt(torch.clamp(1.0 - gc * gc, min=1e-12)),
                     0.0)

    def normalize_vjp(dxn, xn, norm):
        return (dxn - xn * torch.sum(dxn * xn, dim=-1, keepdim=True)) / \
            torch.clamp(norm, min=NORM_FLOOR)

    dq = normalize_vjp(dg @ kn, qn, q_norm)
    dk = normalize_vjp(dg.transpose(-1, -2) @ qn, kn, k_norm)
    dv = p.transpose(-1, -2) @ do
    return dq, dk, dv, (ds if need_dmask and mask is not None else None)


def _check_devices(q, *others):
    for t in others:
        if t is not None and t.device != q.device:
            raise ValueError(f"operand on {t.device}, q on {q.device}")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            mask: torch.Tensor | None) -> torch.Tensor:
    _check_devices(q, k, v, mask)
    B, L, Dh = q.shape
    S = k.shape[1]
    out = torch.empty_like(q)
    lib = _build.load()
    with torch.cuda.device(q.device):
        err = lib.mhgsa_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(),
            B, L, S, Dh, _build.stream())
    _build.check(err, f"mhgsa_fwd(B={B}, L={L}, S={S}, Dh={Dh})")
    fused_geodesic_attention.launches += 1
    return out


def _launch_bwd(q, k, v, mask, do, need_dmask):
    _check_devices(q, k, v, mask, do)
    B, L, Dh = q.shape
    S = k.shape[1]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dmask = torch.empty((B, L, S), device=q.device, dtype=torch.float32) \
        if need_dmask and mask is not None else None
    lib = _build.load()
    with torch.cuda.device(q.device):
        err = lib.mhgsa_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(), do.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            None if dmask is None else dmask.data_ptr(),
            B, L, S, Dh, _build.stream())
    _build.check(err, f"mhgsa_bwd(B={B}, L={L}, S={S}, Dh={Dh})")
    fused_geodesic_attention_backward.launches += 1
    return dq, dk, dv, dmask


def _forward(q, k, v, mask):
    if q.device.type == "cpu":
        return fused_geodesic_attention_reference(q, k, v, mask)
    if q.device.type == "cuda":
        return _launch(q, k, v, mask)
    raise ValueError(f"unsupported device {q.device}")


def fused_geodesic_attention_backward(q: torch.Tensor, k: torch.Tensor,
                                      v: torch.Tensor,
                                      mask: torch.Tensor | None,
                                      do: torch.Tensor, *,
                                      need_dmask: bool = False):
    """Backward of the flattened core: q [B,L,Dh], k/v [B,S,Dh], the
    canonicalized mask [B,L,S] or None, the output cotangent do [B,L,Dh].
    Returns (dq, dk, dv, dmask), dmask None unless ``need_dmask`` and a mask
    is given. CPU tensors run the plain version; CUDA tensors launch
    ``csrc/mhgsa_bwd.cu`` or raise."""
    do = do.to(torch.float32).contiguous()
    if q.device.type == "cpu":
        return fused_geodesic_attention_backward_reference(q, k, v, mask, do,
                                                           need_dmask)
    if q.device.type == "cuda":
        return _launch_bwd(q, k, v, mask, do, need_dmask)
    raise ValueError(f"unsupported device {q.device}")


class _FusedCore(torch.autograd.Function):
    """softmax(−acos(q̂·k̂ᵀ) + mask)·V on flattened, contiguous fp32 operands,
    with the hand-derived backward. Saves its inputs, as the JAX residuals
    (q, k, v, mask) do; nothing of the forward's intermediates."""

    @staticmethod
    def forward(ctx, q, k, v, mask):
        ctx.save_for_backward(q, k, v, mask)
        return _forward(q, k, v, mask)

    @staticmethod
    def backward(ctx, do):
        q, k, v, mask = ctx.saved_tensors
        dq, dk, dv, dmask = fused_geodesic_attention_backward(
            q, k, v, mask, do, need_dmask=ctx.needs_input_grad[3])
        return dq, dk, dv, dmask


def fused_geodesic_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *,
                             mask: torch.Tensor | None = None,
                             metric: str = "oblique") -> torch.Tensor:
    """softmax_j(-acos(q̂_i·k̂_j) + mask)·V over q [..., L, Dh], k/v
    [..., S, Dh] and an additive mask broadcastable to [..., L, S]; fp32.

    MASK CONTRACT (as in the JAX package): entries ≤ -1e29 exclude a key
    (weight exactly 0; a row with every key excluded outputs 0); other finite
    values are shifted per row and floored at -30 before the kernel sees
    them, which leaves the softmax weights unchanged up to ~1e-13."""
    if metric != "oblique":
        raise NotImplementedError("the poincaré metric is not ported yet")
    *lead, L, Dh = q.shape
    S = k.shape[-2]
    B = 1
    for d in lead:
        B *= d
    q3 = q.reshape(B, L, Dh).to(torch.float32).contiguous()
    k3 = k.reshape(B, S, Dh).to(torch.float32).contiguous()
    v3 = v.reshape(B, S, Dh).to(torch.float32).contiguous()
    m3 = None if mask is None else _canonicalize_mask(
        torch.broadcast_to(mask, (*lead, L, S)).reshape(B, L, S)).contiguous()
    return _FusedCore.apply(q3, k3, v3, m3).reshape(*lead, L, Dh)


# kernel launches, counted in _launch and _launch_bwd
fused_geodesic_attention.launches = 0
fused_geodesic_attention_backward.launches = 0
