"""Small-shape geodesic attention with key validity: the CUDA kernels'
wrappers and their plain versions.

Port of ``sttode_tpu/kernels/packed_mhgsa.py::packed_geodesic_attention``,
forward and backward. The kernels are ``csrc/packed_mhgsa_fwd.cu`` and
``csrc/packed_mhgsa_bwd.cu``; their source notes say which TPU kernel each
replaces, what bounds it on the H100 and what its design does about it. The
TPU kernel's lane packing (heads in the 128 lanes, block-diagonal key and
value matrices, the VMEM chunk planner) served the TPU's matrix unit and is
not carried over: the wrapper hands the kernels [B·H] independent problems.

``packed_geodesic_attention`` keeps the JAX entry's contract: q [..., H, L,
Dh], k/v [..., H, S, Dh] with H·Dh ≤ 128, and ``kv_valid`` [..., S] (no head
axis; 1 marks a real key) or None; it computes ``softmax_j(-acos(clip(q̂_i·
k̂_j, ±(1-1e-4))))·V`` with a maxless softmax in which a key's exp is
multiplied by its validity and the denominator is floored at 1e-30, so a
problem with no valid key outputs 0. The gradient is a
``torch.autograd.Function`` (``_PackedCore``, the JAX ``custom_vjp``): it
saves q, k, v and the validity and recomputes the scores in its backward
(``packed_geodesic_attention_backward``); the validity gets no gradient. On
a CPU tensor each direction runs its plain version
(``packed_geodesic_attention_reference``,
``packed_geodesic_attention_backward_reference``); on a CUDA tensor it
launches the kernel or raises. A call that no gradient can flow through
(grad mode off, or no input requiring one: evaluation and serving) runs the
forward without the Function.
"""

from __future__ import annotations

import torch

from sttode_tpu_torch.kernels import _build
from sttode_tpu_torch.kernels.mhgsa import (EPS, SMEM_OPTIN_BYTES,
                                            _check_devices, _normalize_vjp,
                                            _score_grad, _unit,
                                            small_bwd_layout)


def _probs(qn, kn, val):
    """(g, p) of the flattened core: Gram [B,H,L,S] and the maxless softmax
    with each key's exp multiplied by its validity."""
    g = qn @ kn.transpose(-1, -2)
    e = torch.exp(-torch.arccos(torch.clamp(g, -1.0 + EPS, 1.0 - EPS)))
    if val is not None:
        e = e * val[:, None, None, :]
    return g, e / torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-30)


def packed_geodesic_attention_reference(q: torch.Tensor, k: torch.Tensor,
                                        v: torch.Tensor,
                                        val: torch.Tensor | None
                                        ) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel on q [B,H,L,Dh], k/v
    [B,H,S,Dh] and the validity [B,S] (float) or None."""
    qn, _ = _unit(q)
    kn, _ = _unit(k)
    _, p = _probs(qn, kn, val)
    return p @ v


def packed_geodesic_attention_backward_reference(q, k, v, val, do):
    """Plain PyTorch version of the backward kernel, the formula of the JAX
    ``_make_packed_bwd_kernel``: recompute p; dv = pᵀ·do; ds = p ⊙ (dp −
    rowsum(dp ⊙ p)); dg = ds / √(1 − gc²) gated by the unclipped |g| < 1 − ε;
    dq̂ = dg·k̂, dk̂ = dgᵀ·q̂; the row-normalize VJP of each side. Returns
    (dq, dk, dv)."""
    qn, q_norm = _unit(q)
    kn, k_norm = _unit(k)
    g, p = _probs(qn, kn, val)
    gc = torch.clamp(g, -1.0 + EPS, 1.0 - EPS)
    dp = do @ v.transpose(-1, -2)
    ds = p * (dp - torch.sum(dp * p, dim=-1, keepdim=True))
    dg = _score_grad(g, gc, ds)
    return (_normalize_vjp(dg @ kn, qn, q_norm),
            _normalize_vjp(dg.transpose(-1, -2) @ qn, kn, k_norm),
            p.transpose(-1, -2) @ do)


def packed_bwd_small(L: int, S: int, Dh: int) -> bool:
    """Whether the backward kernel runs a problem of L rows, S keys at head
    dim Dh on ``csrc/small_bwd.cuh``'s block-per-problem body (with the key
    validity): head dims up to 32 whose staging fits shared memory
    (``small_bwd_layout(..., val=True)``); else the warp kernel of
    ``csrc/packed_mhgsa_bwd.cu``."""
    lay = small_bwd_layout(L, S, Dh, val=True)
    return lay["DH"] > 0 and lay["smem_bytes"] <= SMEM_OPTIN_BYTES


_FWD = _build.Entry("packed_mhgsa_fwd")
_BWD = _build.Entry("packed_mhgsa_bwd")


def _launch(q, k, v, val):
    _check_devices(q, k, v, val)
    B, H, L, Dh = q.shape
    S = k.shape[2]
    out = torch.empty_like(q)
    err = _build.launch(_FWD, q.device, q.data_ptr(), k.data_ptr(),
                        v.data_ptr(), None if val is None else val.data_ptr(),
                        out.data_ptr(), B, H, L, S, Dh)
    if err:
        _build.check(err, f"packed_mhgsa_fwd(B={B}, H={H}, L={L}, S={S}, "
                          f"Dh={Dh})")
    packed_geodesic_attention.launches += 1
    return out


def _launch_bwd(q, k, v, val, do):
    _check_devices(q, k, v, val, do)
    B, H, L, Dh = q.shape
    S = k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    err = _build.launch(_BWD, q.device, q.data_ptr(), k.data_ptr(),
                        v.data_ptr(), None if val is None else val.data_ptr(),
                        do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                        dv.data_ptr(), B, H, L, S, Dh)
    if err:
        _build.check(err, f"packed_mhgsa_bwd(B={B}, H={H}, L={L}, S={S}, "
                          f"Dh={Dh})")
    packed_geodesic_attention_backward.launches += 1
    return dq, dk, dv


def _forward(q, k, v, val):
    if q.device.type == "cpu":
        return packed_geodesic_attention_reference(q, k, v, val)
    if q.device.type == "cuda":
        return _launch(q, k, v, val)
    raise ValueError(f"unsupported device {q.device}")


def packed_geodesic_attention_backward(q: torch.Tensor, k: torch.Tensor,
                                       v: torch.Tensor,
                                       val: torch.Tensor | None,
                                       do: torch.Tensor):
    """Backward of the flattened core: q [B,H,L,Dh], k/v [B,H,S,Dh], the
    validity [B,S] or None, the output cotangent do [B,H,L,Dh]. Returns
    (dq, dk, dv). CPU tensors run the plain version; CUDA tensors launch
    ``csrc/packed_mhgsa_bwd.cu`` or raise."""
    if do.dtype != torch.float32 or not do.is_contiguous():
        do = do.to(torch.float32).contiguous()
    if q.device.type == "cpu":
        return packed_geodesic_attention_backward_reference(q, k, v, val, do)
    if q.device.type == "cuda":
        return _launch_bwd(q, k, v, val, do)
    raise ValueError(f"unsupported device {q.device}")


class _PackedCore(torch.autograd.Function):
    """softmax(−acos(q̂·k̂ᵀ))·V with key validity on [B,H,L,Dh] contiguous
    fp32 operands, with the hand-derived backward. Saves its inputs, as the
    JAX residuals (q, k, v, val) do."""

    @staticmethod
    def forward(ctx, q, k, v, val):
        ctx.save_for_backward(q, k, v, val)
        return _forward(q, k, v, val)

    @staticmethod
    def backward(ctx, do):
        q, k, v, val = ctx.saved_tensors
        dq, dk, dv = packed_geodesic_attention_backward(q, k, v, val, do)
        return dq, dk, dv, None


def packed_geodesic_attention(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *,
                              kv_valid: torch.Tensor | None = None
                              ) -> torch.Tensor:
    """softmax_j(-acos(q̂_i·k̂_j))·V over q [..., H, L, Dh], k/v [..., H, S,
    Dh] (H·Dh ≤ 128) with key validity ``kv_valid`` [..., S] (shared by the
    heads; 1 = real key) or None. Returns [..., H, L, Dh], fp32."""
    *lead, H, L, Dh = q.shape
    S = k.shape[-2]
    if H * Dh > 128:
        raise ValueError(f"packed kernel needs H*Dh <= 128, got {H}*{Dh}")
    B = 1
    for d in lead:
        B *= d

    def flat(x, n):
        if (x.shape == (B, H, n, Dh) and x.dtype == torch.float32
                and x.is_contiguous()):
            return x
        return x.reshape(B, H, n, Dh).to(torch.float32).contiguous()

    val = None if kv_valid is None else torch.broadcast_to(
        kv_valid, (*lead, S)).reshape(B, S).to(torch.float32).contiguous()
    q4, k4, v4 = flat(q, L), flat(k, S), flat(v, S)
    if torch.is_grad_enabled() and (q4.requires_grad or k4.requires_grad
                                    or v4.requires_grad):
        out = _PackedCore.apply(q4, k4, v4, val)
    else:   # no gradient can flow: the launch without the Function
        out = _forward(q4, k4, v4, val)
    return out if len(lead) == 1 else out.reshape(*lead, H, L, Dh)


# kernel launches, counted in _launch and _launch_bwd
packed_geodesic_attention.launches = 0
packed_geodesic_attention_backward.launches = 0
