"""Geodesic attention forward: the CUDA kernel's wrapper and its plain version.

Port of ``sttode_tpu/kernels/mhgsa.py::fused_geodesic_attention`` (forward,
oblique metric). The kernel is ``csrc/mhgsa_fwd.cu``; its source note says
which TPU kernel it replaces, what bounds it on the H100 and what its design
does about it.

``fused_geodesic_attention`` keeps the JAX entry's contract: leading dims are
flattened into the problem axis, the additive mask is canonicalized in plain
torch before the launch (``_canonicalize_mask``), and the kernel computes
``softmax_j(-acos(clip(q̂_i·k̂_j, ±(1-1e-4))) + mask)·V`` with a maxless
softmax whose denominator is floored at 1e-30 (an all-excluded row outputs
0). On a CPU tensor it runs ``fused_geodesic_attention_reference``, the same
function in plain torch; on a CUDA tensor it launches the kernel or raises.
The backward pass is not ported: a call that would need it raises.
"""

from __future__ import annotations

import ctypes

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


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            mask: torch.Tensor | None) -> torch.Tensor:
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (q, k, v, mask)):
        raise NotImplementedError(
            "the CUDA geodesic-attention kernel is forward-only; its backward "
            "is not ported yet (run under torch.no_grad()/inference_mode(), "
            "or use attn_impl='dense')")
    dev = q.device
    for name, t in (("k", k), ("v", v), ("mask", mask)):
        if t is not None and t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    B, L, Dh = q.shape
    S = k.shape[1]
    out = torch.empty_like(q)
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.mhgsa_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(),
            B, L, S, Dh, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    _build.check(err, f"mhgsa_fwd(B={B}, L={L}, S={S}, Dh={Dh})")
    fused_geodesic_attention.launches += 1
    return out


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
    if q.device.type == "cpu":
        out = fused_geodesic_attention_reference(q3, k3, v3, m3)
    elif q.device.type == "cuda":
        out = _launch(q3, k3, v3, m3)
    else:
        raise ValueError(f"unsupported device {q.device}")
    return out.reshape(*lead, L, Dh)


fused_geodesic_attention.launches = 0   # kernel launches, counted in _launch
