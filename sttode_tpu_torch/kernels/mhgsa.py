"""Geodesic attention: the CUDA kernels' wrappers and their plain versions.

Port of ``sttode_tpu/kernels/mhgsa.py``, oblique metric, forward and
backward, in two forms whose kernels' source notes say which TPU kernel each
replaces, what bounds it on the H100 and what its design does about it:

- ``fused_geodesic_attention``, the whole-S kernels ``csrc/mhgsa_fwd.cu``
  and ``csrc/mhgsa_bwd.cu``: every key of a problem sits in shared memory,
  so they refuse long contexts (``whole_s_smem_bytes``); additive masks.
- ``flash_geodesic_attention``, the S-tiled kernels
  ``csrc/flash_mhgsa_fwd.cu`` (forward, with the per-row lse) and
  ``csrc/flash_mhgsa_bwd.cu`` (the dq and the dk/dv sweeps, which replay
  the scores from the lse): any L and S, key validity only.

Both keep the JAX entries' contracts: leading dims are flattened into the
problem axis; the scores are ``-acos(clip(q̂_i·k̂_j, ±(1-1e-4)))`` and the
softmax is maxless with its denominator floored at 1e-30, so an
all-excluded row outputs 0. ``fused_geodesic_attention`` canonicalizes its
additive mask in plain torch before the launch (``_canonicalize_mask``);
``flash_geodesic_attention`` takes ``kv_valid`` (a key with validity ≤ 0
gets weight exactly 0). Each gradient is a ``torch.autograd.Function``, the
JAX ``custom_vjp``: ``_FusedCore`` saves q, k, v and the canonicalized mask
and recomputes the scores in its backward, which returns the mask cotangent
only when the mask needs one (the canonicalization itself stays
differentiable plain torch, as in JAX); ``_FlashCore`` saves q, k, v, the
validity, out and the per-row lse, as the JAX residuals do, and nothing of
size L·S. On a CPU tensor each direction runs its plain version (the
``*_reference`` functions); on a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

import torch

from sttode_tpu_torch.kernels import _build

EPS = 1e-4            # fp32 acos clip
NORM_FLOOR = 1e-12
NEG_INF = -1e30       # exclusion sentinel after canonicalization
SMEM_OPTIN_BYTES = 232_448   # shared memory one block may opt in to (H100)


def whole_s_smem_bytes(L: int, S: int, Dh: int) -> tuple[int, int]:
    """Shared memory the whole-S kernels ask for at one problem's shape:
    (forward, backward), as ``csrc/mhgsa_fwd.cu`` and ``csrc/mhgsa_bwd.cu``
    compute it at launch; each refuses a shape above ``SMEM_OPTIN_BYTES``
    (at Dh = 8: S > 2765 forward, L = S > 1036 backward)."""
    ld = Dh | 1
    fwd = 4 * (S * ld + S * Dh + 4 * Dh + 4 * S)
    bwd = 4 * (2 * (L + S) * ld + 3 * L + S + 2 * 8 * max(L, S) + 8 * Dh)
    return fwd, bwd


def _unit(x: torch.Tensor):
    norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.clamp(norm, min=NORM_FLOOR), norm


def _normalize_vjp(dxn, xn, norm):
    """VJP of the row normalization x ↦ x / max(‖x‖, floor), given the
    cotangent of the normalized rows, those rows and the row norms."""
    return (dxn - xn * torch.sum(dxn * xn, dim=-1, keepdim=True)) / \
        torch.clamp(norm, min=NORM_FLOOR)


def _score_grad(g, gc, ds):
    """dg = ds / √(1 − gc²), gated by the unclipped |g| < 1 − ε."""
    return torch.where(g.abs() < 1.0 - EPS,
                       ds * torch.rsqrt(torch.clamp(1.0 - gc * gc, min=1e-12)),
                       0.0)


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
    qn, _ = _unit(q)
    kn, _ = _unit(k)
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
    qn, q_norm = _unit(q)
    kn, k_norm = _unit(k)
    g = qn @ kn.transpose(-1, -2)
    gc = torch.clamp(g, -1.0 + EPS, 1.0 - EPS)
    s = -torch.arccos(gc)
    if mask is not None:
        s = s + mask
    e = torch.exp(s)
    p = e / torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-30)
    dp = do @ v.transpose(-1, -2)
    ds = p * (dp - torch.sum(dp * p, dim=-1, keepdim=True))
    dg = _score_grad(g, gc, ds)
    dq = _normalize_vjp(dg @ kn, qn, q_norm)
    dk = _normalize_vjp(dg.transpose(-1, -2) @ qn, kn, k_norm)
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


# --------------------------------------------------------------------------- #
# S-tiled (flash) attention with key validity                                 #
# --------------------------------------------------------------------------- #

def _flash_scores(qn, kn, val):
    """(g, gc, s) of the flattened flash core: the Gram [B,L,S], its clip and
    the scores, an invalid key's at NEG_INF (its exp is exactly 0)."""
    g = qn @ kn.transpose(-1, -2)
    gc = torch.clamp(g, -1.0 + EPS, 1.0 - EPS)
    s = -torch.arccos(gc)
    if val is not None:
        s = torch.where(val[:, None, :] > 0, s, NEG_INF)
    return g, gc, s


def flash_geodesic_attention_reference(q: torch.Tensor, k: torch.Tensor,
                                       v: torch.Tensor,
                                       val: torch.Tensor | None):
    """Plain PyTorch version of the forward kernel on q [B,L,Dh], k/v
    [B,S,Dh] and the validity [B,S] or None: (out [B,L,Dh], lse [B,L]) with
    the maxless softmax, l = max(Σ_j e_ij, 1e-30), out = Σ_j e_ij v_j / l and
    lse = log l; a row with no valid key outputs exactly 0."""
    qn, _ = _unit(q)
    kn, _ = _unit(k)
    _, _, s = _flash_scores(qn, kn, val)
    e = torch.exp(s)
    l = torch.clamp(e.sum(dim=-1), min=1e-30)
    return (e @ v) / l[..., None], torch.log(l)


def _flash_replay(q, k, v, val, do, lse, delta):
    """What both backward sweeps replay: the unit rows and norms, the
    probabilities p = exp(s − lse) and the clip-gated score cotangent
    dg = ds / √(1 − gc²), ds = p ⊙ (do·vᵀ − δ)."""
    qn, q_norm = _unit(q)
    kn, k_norm = _unit(k)
    g, gc, s = _flash_scores(qn, kn, val)
    p = torch.exp(s - lse[..., None])
    dg = _score_grad(g, gc, p * (do @ v.transpose(-1, -2) - delta[..., None]))
    return qn, q_norm, kn, k_norm, p, dg


def flash_dq_reference(q, k, v, val, do, lse, delta):
    """Plain PyTorch version of the dq sweep: dq̂ = dg·k̂, then the q-side
    row-normalize VJP."""
    qn, q_norm, kn, _, _, dg = _flash_replay(q, k, v, val, do, lse, delta)
    return _normalize_vjp(dg @ kn, qn, q_norm)


def flash_dkv_reference(q, k, v, val, do, lse, delta):
    """Plain PyTorch version of the dk/dv sweep: dk̂ = dgᵀ·q̂ with the
    k-side row-normalize VJP, and dv = pᵀ·do."""
    qn, _, kn, k_norm, p, dg = _flash_replay(q, k, v, val, do, lse, delta)
    return (_normalize_vjp(dg.transpose(-1, -2) @ qn, kn, k_norm),
            p.transpose(-1, -2) @ do)


def flash_geodesic_attention_backward_reference(q, k, v, val, do, lse,
                                                delta):
    """Plain PyTorch version of the two backward sweeps, the formula of the
    JAX ``_make_flash_dq_kernel``/``_make_flash_dkv_kernel``: the replayed
    p = exp(s − lse); dv = pᵀ·do; ds = p ⊙ (do·vᵀ − δ) with δ = rowsum(do ⊙
    out); dg = ds / √(1 − gc²) gated by the unclipped |g| < 1 − ε; dq̂ =
    dg·k̂, dk̂ = dgᵀ·q̂; the row-normalize VJP of each side last. Each sweep
    replays the scores, as the kernels do. Returns (dq, dk, dv)."""
    args = (q, k, v, val, do, lse, delta)
    return (flash_dq_reference(*args), *flash_dkv_reference(*args))


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch_flash(q, k, v, val):
    _check_devices(q, k, v, val)
    B, L, Dh = q.shape
    S = k.shape[1]
    out = torch.empty_like(q)
    lse = torch.empty((B, L), device=q.device, dtype=torch.float32)
    lib = _build.load()
    with torch.cuda.device(q.device):
        err = lib.flash_mhgsa_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(val),
            out.data_ptr(), lse.data_ptr(), B, L, S, Dh, _build.stream())
    _build.check(err, f"flash_mhgsa_fwd(B={B}, L={L}, S={S}, Dh={Dh})")
    flash_geodesic_attention.launches += 1
    return out, lse


def _launch_flash_dq(q, k, v, val, do, lse, delta):
    _check_devices(q, k, v, val, do, lse, delta)
    B, L, Dh = q.shape
    S = k.shape[1]
    dq = torch.empty_like(q)
    lib = _build.load()
    with torch.cuda.device(q.device):
        err = lib.flash_mhgsa_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(val),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            B, L, S, Dh, _build.stream())
    _build.check(err, f"flash_mhgsa_dq(B={B}, L={L}, S={S}, Dh={Dh})")
    flash_geodesic_attention_backward.launches_dq += 1
    return dq


def _launch_flash_dkv(q, k, v, val, do, lse, delta):
    _check_devices(q, k, v, val, do, lse, delta)
    B, L, Dh = q.shape
    S = k.shape[1]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = _build.load()
    with torch.cuda.device(q.device):
        err = lib.flash_mhgsa_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(val),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), B, L, S, Dh, _build.stream())
    _build.check(err, f"flash_mhgsa_dkv(B={B}, L={L}, S={S}, Dh={Dh})")
    flash_geodesic_attention_backward.launches_dkv += 1
    return dk, dv


def _flash_forward(q, k, v, val):
    if q.device.type == "cpu":
        return flash_geodesic_attention_reference(q, k, v, val)
    if q.device.type == "cuda":
        return _launch_flash(q, k, v, val)
    raise ValueError(f"unsupported device {q.device}")


def flash_geodesic_attention_backward(q: torch.Tensor, k: torch.Tensor,
                                      v: torch.Tensor,
                                      val: torch.Tensor | None,
                                      out: torch.Tensor, lse: torch.Tensor,
                                      do: torch.Tensor):
    """Backward of the flattened flash core from its residuals: q [B,L,Dh],
    k/v [B,S,Dh], the validity [B,S] or None, the forward's out [B,L,Dh] and
    lse [B,L], the output cotangent do [B,L,Dh]. δ = rowsum(do ⊙ out) is one
    plain reduction here (JAX takes it outside its kernels too). Returns
    (dq, dk, dv). CPU tensors run the plain version; CUDA tensors launch the
    dq and dk/dv sweeps of ``csrc/flash_mhgsa_bwd.cu`` or raise."""
    do = do.to(torch.float32).contiguous()
    delta = torch.sum(do * out, dim=-1)
    if q.device.type == "cpu":
        return flash_geodesic_attention_backward_reference(q, k, v, val, do,
                                                           lse, delta)
    if q.device.type == "cuda":
        args = (q, k, v, val, do, lse, delta)
        return (_launch_flash_dq(*args), *_launch_flash_dkv(*args))
    raise ValueError(f"unsupported device {q.device}")


class _FlashCore(torch.autograd.Function):
    """softmax(−acos(q̂·k̂ᵀ))·V with key validity on flattened, contiguous
    fp32 operands, with the hand-derived backward. Saves q, k, v, the
    validity, out and the per-row lse, as the JAX residuals do."""

    @staticmethod
    def forward(ctx, q, k, v, val):
        out, lse = _flash_forward(q, k, v, val)
        ctx.save_for_backward(q, k, v, val, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, val, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_geodesic_attention_backward(q, k, v, val, out, lse,
                                                       do)
        return dq, dk, dv, None


def flash_geodesic_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *,
                             kv_valid: torch.Tensor | None = None,
                             metric: str = "oblique") -> torch.Tensor:
    """S-tiled softmax_j(-acos(q̂_i·k̂_j))·V over q [..., L, Dh], k/v [..., S,
    Dh] with key validity ``kv_valid`` broadcastable to [..., S] (1 = real
    key) or None; fp32. Any L and S: the context is bounded by device
    memory, not shared memory."""
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
    val = None if kv_valid is None else torch.broadcast_to(
        kv_valid, (*lead, S)).reshape(B, S).to(torch.float32).contiguous()
    return _FlashCore.apply(q3, k3, v3, val).reshape(*lead, L, Dh)


# kernel launches, counted in _launch_flash, _launch_flash_dq and
# _launch_flash_dkv
flash_geodesic_attention.launches = 0
flash_geodesic_attention_backward.launches_dq = 0
flash_geodesic_attention_backward.launches_dkv = 0
