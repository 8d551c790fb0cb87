"""Geodesic attention: the CUDA kernels' wrappers and their plain versions.

Port of ``sttode_tpu/kernels/mhgsa.py``, both metrics, forward and
backward, in two forms whose kernels' source notes say which TPU kernel each
replaces, what bounds it on the H100 and what its design does about it:

- ``fused_geodesic_attention``, the whole-S kernels ``csrc/mhgsa_fwd.cu``
  and ``csrc/mhgsa_bwd.cu``: every key of a problem is staged at once
  (``whole_s_smem_bytes``); where shared memory is too small the forward
  streams the keys, values and mask in tiles (any head dim) and the backward
  stages in a device workspace; at small S the forward and the backward
  run small-S modes (``small_s_mode``, ``small_bwd_mode``); additive
  masks.
- ``flash_geodesic_attention``, the S-tiled kernels
  ``csrc/flash_mhgsa_fwd.cu`` (forward, with the per-row lse) and
  ``csrc/flash_mhgsa_bwd.cu`` (the dq and the dk/dv sweeps, which replay
  the scores from the lse): any L and S, key validity only.

Scores: ``metric="oblique"`` scores ``-acos(clip(q̂_i·k̂_j, ±(1-1e-4)))``;
``metric="poincare"`` scores the negated Möbius geodesic distance of ball
points at curvature c from the Gram closed form (``_poincare_pieces``): q
and k must already be ball points (``nn.attention`` applies
``pmath.project(pmath.expmap0(·))`` outside the kernels, so that map's
gradient stays plain autograd). Both keep the JAX entries' contracts:
leading dims are flattened into the problem axis; the softmax is maxless
with its denominator floored at 1e-30, so an all-excluded row outputs 0,
which needs the scores bounded below: poincaré requires
c ≥ ``MIN_MAXLESS_CURVATURE`` (``_check_maxless_bounds``).
``fused_geodesic_attention`` canonicalizes its additive mask in plain torch
before the launch (``_canonicalize_mask``); ``flash_geodesic_attention``
takes ``kv_valid`` (a key with validity ≤ 0 gets weight exactly 0). Each
gradient is a ``torch.autograd.Function``, the JAX ``custom_vjp``:
``_FusedCore`` saves q, k, v and the canonicalized mask and recomputes the
scores in its backward, which returns the mask cotangent only when the mask
needs one (the canonicalization itself stays differentiable plain torch, as
in JAX); ``_FlashCore`` saves q, k, v, the validity, out and the per-row
lse, as the JAX residuals do, and nothing of size L·S. On a CPU tensor each
direction runs its plain version (the ``*_reference`` functions); on a CUDA
tensor it launches the kernel or raises. Each wrapper counts its launches,
in all and per metric (``launches_by_metric``). A call of
``fused_geodesic_attention`` that no gradient can flow through (grad mode
off, or no input requiring one: evaluation and serving) runs the forward
without the Function.
"""

from __future__ import annotations

import torch

from sttode_tpu_torch.kernels import _build

EPS = 1e-4            # fp32 acos clip
NORM_FLOOR = 1e-12
NEG_INF = -1e30       # exclusion sentinel after canonicalization
SMEM_OPTIN_BYTES = 232_448   # shared memory one block may opt in to (H100)
METRICS = ("oblique", "poincare")   # index = the C entry points' metric
ARTANH_EPS = 1e-5     # poincaré: zc ≤ 1 − 1e-5
DENOM_EPS = 1e-5      # poincaré: the Möbius denominator guard

# The maxless softmax needs the scores bounded below: poincaré scores are
# ≥ −(2/√c)·artanh(1 − 1e-5) = −12.21/√c, and a row whose every valid key
# sits there has denominator ≈ S·e^{−12.21/√c}, which must stay above the
# 1e-30 floor: c ≥ 0.03124, with a margin (the JAX package's constant).
MIN_MAXLESS_CURVATURE = 0.032


def _check_maxless_bounds(metric: str, curvature: float) -> None:
    if metric not in METRICS:
        raise ValueError(f"metric {metric!r} (oblique/poincare)")
    if metric == "poincare" and curvature < MIN_MAXLESS_CURVATURE:
        raise ValueError(
            f"the geodesic-attention kernels require curvature >= "
            f"{MIN_MAXLESS_CURVATURE} for metric='poincare': their maxless "
            f"softmax relies on the score lower bound -12.21/sqrt(c) staying "
            f"above the 1e-30 denominator floor (got c={curvature}). Use the "
            f"dense route (attn_impl='dense') for smaller curvature.")


def whole_s_smem_bytes(L: int, S: int, Dh: int,
                       metric: str = "oblique") -> tuple[int, int]:
    """Bytes the whole-S kernels stage per problem: (forward, backward), as
    ``csrc/mhgsa_fwd.cu`` and ``csrc/mhgsa_bwd.cu`` compute them at launch.
    Above ``SMEM_OPTIN_BYTES`` (forward at Dh = 8: S > 2765 oblique,
    S > 2640 poincaré, which also stages the keys' squared norms; at Dh = 16
    from S = 1569, at Dh = 64 from S = 436 oblique, 432 poincaré) the
    forward streams the keys, values and the mask's row segments through
    shared memory 32 keys at a time, a block per (problem, 16 query rows),
    with q and the accumulator sized by Dh (``csrc/stream_fwd.cuh``); the
    backward stages in a device workspace of its size per problem instead
    of shared memory (at Dh = 8: L = S > 1036, both metrics — poincaré
    keeps squared norms where oblique keeps norms)."""
    ld = Dh | 1
    fwd = 4 * (S * ld + S * Dh + 4 * Dh + 4 * S
               + (S if metric == "poincare" else 0))
    bwd = 4 * (2 * (L + S) * ld + 3 * L + S + 2 * 8 * max(L, S) + 8 * Dh)
    return fwd, bwd


def small_s_mode(L: int, S: int, Dh: int) -> bool:
    """Whether the whole-S forward runs a problem in its small-S mode
    (``csrc/mhgsa_fwd.cu::small_s_mode``, the measured crossover): at
    Dh ≤ 8 up to S = 2048, at Dh ≤ 64 from S = 32 to 256."""
    if -(-L // 32) > 65535 or Dh > 128:
        return False
    return S <= 2048 if Dh <= 8 else Dh <= 64 and 32 <= S <= 256


def small_fwd_layout(L: int, S: int, Dh: int) -> dict:
    """The block layout of the small-shape forward (``csrc/small_fwd.cuh``,
    kernel P and the whole-S forward's small-S mode), as ``layout`` and
    ``smem_bytes`` there compute it: ``rows`` query rows a block (lane =
    row), ``slices`` key slices (thread t takes row t % rows and, of each
    tile of ``tile`` staged keys, those ≡ t // rows mod slices), the
    template head dim ``DH``, ``blocks_per_problem`` and the unmasked
    block's shared-memory bytes. At 32 × 32 × 8: 32 rows × 8 slices of 4
    keys, one warp per slice."""
    DH = max(8, 1 << (Dh - 1).bit_length())
    tile = 128 if DH <= 16 else 2048 // DH
    rows = 1 << (min(L, 32) - 1).bit_length() if L > 0 else 1
    want = 1 << (max(-(-S // 4), 1) - 1).bit_length()
    slices = min(want, (256 if DH <= 32 else 128) // rows, tile)
    ld = DH | 1
    smem = 4 * max(tile * (2 * ld + 1),
                   rows * slices * (DH + 1) if slices > 1 else 0)
    return dict(rows=rows, slices=slices, tile=tile, DH=DH,
                blocks_per_problem=-(-L // rows), smem_bytes=smem)


def small_bwd_layout(L: int, S: int, Dh: int, val: bool = False,
                     metric: str = "oblique") -> dict:
    """The block layout of the whole-S backward's small-S mode
    (``csrc/small_bwd.cuh``, ``layout`` and ``smem_bytes`` there): one
    block per problem of ``threads`` threads; pass 1 takes ``rows1`` query
    rows at a time (lane = row) with the keys split into ``slices1`` slices
    (key j ≡ slice mod slices1), pass 2 ``keys2`` keys at a time with the
    rows split into ``slices2`` slices, within 1024 threads at Dh ≤ 8 (512
    for ``metric="poincare"``), 512 at 16, 256 at 32, halved while the
    block's shared memory would pass ``SMEM_OPTIN_BYTES``; the template head
    dim ``DH`` (0 beyond the mode's 32) and the block's shared-memory bytes.
    ``val``: the packed backward's form, which stages the key validity too
    (S more floats). The poincaré form leaves two floats more a thread for
    the slices' combine (the squared norms' sums). At 128² × 8: 128 rows ×
    8 slices, then 128 keys × 8 slices, 1024 threads (poincaré 4 slices,
    512); at the NBA recipe's 32² × 8: 32 × 8 and 32 × 8, 256 threads."""
    if metric not in METRICS:
        raise ValueError(f"metric {metric!r} (oblique/poincare)")
    ball = metric == "poincare"
    DH = next((d for d in (8, 16, 32) if Dh <= d), 0)
    p2 = lambda x: 1 << (max(x, 1) - 1).bit_length()  # noqa: E731

    def of(nt):
        rows1, keys2 = min(p2(L), nt), min(p2(S), nt)
        slices1 = min(p2(-(-S // 4)), nt // rows1)
        slices2 = min(p2(-(-L // 4)), nt // keys2)
        n = max(rows1 * slices1, keys2 * slices2)
        smem = 4 * (2 * (L + S) * (DH | 1) + 3 * L + (2 if val else 1) * S
                    + n * (2 * DH + (5 if ball else 3)))
        return dict(rows1=rows1, slices1=slices1, keys2=keys2,
                    slices2=slices2, threads=-(-n // 32) * 32, DH=DH,
                    smem_bytes=smem)

    nt = (512 if ball else 1024) if DH <= 8 else 512 if DH <= 16 else 256
    lay = of(nt)
    while nt > 32 and lay["smem_bytes"] > SMEM_OPTIN_BYTES:
        nt //= 2
        lay = of(nt)
    return lay


def small_bwd_mode(L: int, S: int, Dh: int, metric: str = "oblique") -> bool:
    """Whether the whole-S backward runs a problem in its small-S mode
    (``csrc/small_bwd.cuh::mode``): where its staging fits shared memory
    (the poincaré layout's, for that metric), within the crossover measured
    for both metrics (PERF.md §6): at Dh ≤ 8 every S, at Dh ≤ 16 from
    S = 16, at Dh ≤ 32 from S = 32."""
    lay = small_bwd_layout(L, S, Dh, metric=metric)
    if lay["DH"] == 0 or lay["smem_bytes"] > SMEM_OPTIN_BYTES:
        return False
    return Dh <= 8 or (Dh <= 16 and S >= 16) or S >= 32


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


# --------------------------------------------------------------------------- #
# the poincaré score epilogue (plain versions of the kernels' arithmetic)     #
# --------------------------------------------------------------------------- #

def _poincare_pieces(qb, kb, c: float):
    """The score recompute on ball points qb [B,L,D], kb [B,S,D]:
    (g, x2, y2, m, den, n2, n, zc) with g = qb·kbᵀ, x2 [B,L,1], y2 [B,1,S],
    m = max(x2 − 2g + y2, 0), den = 1 − 2c·g + c²·x2·y2,
    n² = m·den/(den + 1e-5)², n = √(n² + 1e-15), zc = min(√c·n, 1 − 1e-5)."""
    g = qb @ kb.transpose(-1, -2)
    x2 = torch.sum(qb * qb, dim=-1, keepdim=True)
    y2 = torch.sum(kb * kb, dim=-1)[..., None, :]
    m = torch.clamp(x2 - 2.0 * g + y2, min=0.0)
    den = 1.0 - 2.0 * c * g + (c * c) * x2 * y2
    n2 = m * den / ((den + DENOM_EPS) ** 2)
    n = torch.sqrt(n2 + 1e-15)
    zc = torch.clamp((c ** 0.5) * n, max=1.0 - ARTANH_EPS)
    return g, x2, y2, m, den, n2, n, zc


def _poincare_score_from_pieces(zc, c: float):
    """s = −(2/√c)·artanh(zc), artanh from one log."""
    return -(2.0 / c ** 0.5) * 0.5 * torch.log((1.0 + zc) / (1.0 - zc))


def _poincare_grad_pieces(pieces, ds, c: float):
    """The VJP of the score epilogue for the score cotangent ds [B,L,S]:
    (dg [B,L,S], dx2 [B,L,1], dy2 [B,S,1]). ds/dn = −2/(1 − zc²) passes
    through the clamp; dn/dn² = 1/(2n); n² = m·den/(den + ε)² with
    m = relu(x2 − 2g + y2) gated by the unclipped x2 − 2g + y2 > 0."""
    g, x2, y2, m, den, n2, n, zc = pieces
    dn = ds * (-2.0 / torch.clamp(1.0 - zc * zc, min=1e-12))
    dn2 = dn * (0.5 / n)
    dA = den / ((den + DENOM_EPS) ** 2)
    dB = m * (DENOM_EPS - den) / ((den + DENOM_EPS) ** 3)
    gate = (x2 - 2.0 * g + y2 > 0.0).to(ds.dtype)
    dg = dn2 * (dA * (-2.0 * gate) + dB * (-2.0 * c))
    dx2 = torch.sum(dn2 * (dA * gate + dB * (c * c) * y2), dim=-1,
                    keepdim=True)
    dy2 = torch.sum(dn2 * (dA * gate + dB * (c * c) * x2),
                    dim=-2)[..., None]
    return dg, dx2, dy2


def _poincare_assemble(dg, dx2, dy2, qb, kb):
    """dq = dg·kb + 2·dx2⊙qb, dk = dgᵀ·qb + 2·dy2⊙kb (x2 = Σ qb², y2 =
    Σ kb²): no normalize VJP, the ball points are the kernels' inputs."""
    return (dg @ kb + 2.0 * dx2 * qb,
            dg.transpose(-1, -2) @ qb + 2.0 * dy2 * kb)


def _scores(q, k, metric: str, c: float):
    """The replay the plain versions share: (state, s) with the scores
    s [B,L,S] and what the gradient needs — (q̂, ‖q‖, k̂, ‖k‖, g, gc)
    oblique, the ``_poincare_pieces`` poincaré."""
    if metric == "poincare":
        pieces = _poincare_pieces(q, k, c)
        return pieces, _poincare_score_from_pieces(pieces[-1], c)
    qn, q_norm = _unit(q)
    kn, k_norm = _unit(k)
    g = qn @ kn.transpose(-1, -2)
    gc = torch.clamp(g, -1.0 + EPS, 1.0 - EPS)
    return (qn, q_norm, kn, k_norm, g, gc), -torch.arccos(gc)


def _qk_grads(state, ds, q, k, metric: str, c: float):
    """(dq, dk) from the score cotangent ds and ``_scores``' state."""
    if metric == "poincare":
        return _poincare_assemble(*_poincare_grad_pieces(state, ds, c), q, k)
    qn, q_norm, kn, k_norm, g, gc = state
    dg = _score_grad(g, gc, ds)
    return (_normalize_vjp(dg @ kn, qn, q_norm),
            _normalize_vjp(dg.transpose(-1, -2) @ qn, kn, k_norm))


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
                                       mask: torch.Tensor | None,
                                       metric: str = "oblique",
                                       curvature: float = 1.0
                                       ) -> torch.Tensor:
    """Plain PyTorch version of the kernel on flattened operands: q [B,L,Dh],
    k/v [B,S,Dh], canonicalized mask [B,L,S] or None."""
    _, s = _scores(q, k, metric, curvature)
    if mask is not None:
        s = s + mask
    e = torch.exp(s)
    p = e / torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-30)
    return p @ v


def fused_geodesic_attention_backward_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        mask: torch.Tensor | None, do: torch.Tensor, need_dmask: bool,
        metric: str = "oblique", curvature: float = 1.0):
    """Plain PyTorch version of the backward kernel, the formula of the JAX
    ``_fused_bwd``: recompute p; dv = pᵀ·do; ds = p ⊙ (dp − rowsum(dp ⊙ p));
    oblique: dg = ds / √(1 − gc²) gated by the unclipped |g| < 1 − ε,
    dq̂ = dg·k̂, dk̂ = dgᵀ·q̂ and the row-normalize VJP of each side;
    poincaré: the epilogue's VJP (``_poincare_grad_pieces``) and
    ``_poincare_assemble``. Returns (dq, dk, dv, dmask or None) on flattened
    operands."""
    state, s = _scores(q, k, metric, curvature)
    if mask is not None:
        s = s + mask
    e = torch.exp(s)
    p = e / torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-30)
    dp = do @ v.transpose(-1, -2)
    ds = p * (dp - torch.sum(dp * p, dim=-1, keepdim=True))
    dq, dk = _qk_grads(state, ds, q, k, metric, curvature)
    dv = p.transpose(-1, -2) @ do
    return dq, dk, dv, (ds if need_dmask and mask is not None else None)


def _check_devices(q, *others):
    for t in others:
        if t is not None and t.device != q.device:
            raise ValueError(f"operand on {t.device}, q on {q.device}")


def _count(fn, metric: str, attr: str = "launches") -> None:
    setattr(fn, attr, getattr(fn, attr) + 1)
    getattr(fn, f"{attr}_by_metric")[metric] += 1


_FWD = _build.Entry("mhgsa_fwd")
_BWD = _build.Entry("mhgsa_bwd")
_FLASH_FWD = _build.Entry("flash_mhgsa_fwd")
_FLASH_DQ = _build.Entry("flash_mhgsa_dq")
_FLASH_DKV = _build.Entry("flash_mhgsa_dkv")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            mask: torch.Tensor | None, metric: str = "oblique",
            curvature: float = 1.0) -> torch.Tensor:
    _check_devices(q, k, v, mask)
    L, Dh = q.shape[-2:]
    S = k.shape[-2]
    B = q.shape[:-2].numel()
    out = torch.empty_like(q)
    err = _build.launch(_FWD, q.device, q.data_ptr(), k.data_ptr(),
                        v.data_ptr(), _ptr(mask), out.data_ptr(), B, L, S, Dh,
                        METRICS.index(metric), curvature)
    if err:
        _build.check(err, f"mhgsa_fwd(B={B}, L={L}, S={S}, Dh={Dh}, "
                          f"{metric})")
    _count(fused_geodesic_attention, metric)
    fused_geodesic_attention.launches_masked += mask is not None
    return out


def _launch_bwd(q, k, v, mask, do, need_dmask, metric="oblique",
                curvature=1.0):
    _check_devices(q, k, v, mask, do)
    B, L, Dh = q.shape
    S = k.shape[1]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dmask = torch.empty((B, L, S), device=q.device, dtype=torch.float32) \
        if need_dmask and mask is not None else None
    # beyond shared memory the kernel of before stages each problem in this
    # workspace; the small-S mode needs none
    _, staged = whole_s_smem_bytes(L, S, Dh, metric)
    ws = torch.empty(B * staged // 4, device=q.device, dtype=torch.float32) \
        if staged > SMEM_OPTIN_BYTES and not small_bwd_mode(
            L, S, Dh, metric) else None
    err = _build.launch(
        _BWD, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        _ptr(mask), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), _ptr(dmask), _ptr(ws), B, L, S, Dh,
        METRICS.index(metric), curvature)
    if err:
        _build.check(err, f"mhgsa_bwd(B={B}, L={L}, S={S}, Dh={Dh}, "
                          f"{metric})")
    _count(fused_geodesic_attention_backward, metric)
    fused_geodesic_attention_backward.launches_masked += mask is not None
    return dq, dk, dv, dmask


def _forward(q, k, v, mask, metric="oblique", curvature=1.0):
    if q.device.type == "cpu":
        return fused_geodesic_attention_reference(q, k, v, mask, metric,
                                                  curvature)
    if q.device.type == "cuda":
        return _launch(q, k, v, mask, metric, curvature)
    raise ValueError(f"unsupported device {q.device}")


def fused_geodesic_attention_backward(q: torch.Tensor, k: torch.Tensor,
                                      v: torch.Tensor,
                                      mask: torch.Tensor | None,
                                      do: torch.Tensor, *,
                                      need_dmask: bool = False,
                                      metric: str = "oblique",
                                      curvature: float = 1.0):
    """Backward of the flattened core: q [B,L,Dh], k/v [B,S,Dh], the
    canonicalized mask [B,L,S] or None, the output cotangent do [B,L,Dh].
    Returns (dq, dk, dv, dmask), dmask None unless ``need_dmask`` and a mask
    is given. CPU tensors run the plain version; CUDA tensors launch
    ``csrc/mhgsa_bwd.cu`` or raise."""
    _check_maxless_bounds(metric, curvature)
    do = do.to(torch.float32).contiguous()
    if q.device.type == "cpu":
        return fused_geodesic_attention_backward_reference(
            q, k, v, mask, do, need_dmask, metric, curvature)
    if q.device.type == "cuda":
        return _launch_bwd(q, k, v, mask, do, need_dmask, metric, curvature)
    raise ValueError(f"unsupported device {q.device}")


class _FusedCore(torch.autograd.Function):
    """softmax(score(q_i, k_j) + mask)·V on flattened, contiguous fp32
    operands, with the hand-derived backward. Saves its inputs, as the JAX
    residuals (q, k, v, mask) do; nothing of the forward's intermediates.
    The metric and curvature are not differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, mask, metric, curvature):
        ctx.save_for_backward(q, k, v, mask)
        ctx.metric, ctx.curvature = metric, curvature
        return _forward(q, k, v, mask, metric, curvature)

    @staticmethod
    def backward(ctx, do):
        q, k, v, mask = ctx.saved_tensors
        dq, dk, dv, dmask = fused_geodesic_attention_backward(
            q, k, v, mask, do, need_dmask=ctx.needs_input_grad[3],
            metric=ctx.metric, curvature=ctx.curvature)
        return dq, dk, dv, dmask, None, None


def _flatten(q, k, v):
    *lead, L, Dh = q.shape
    S = k.shape[-2]
    B = 1
    for d in lead:
        B *= d
    return lead, B, L, S, Dh, (
        x.reshape(B, n, Dh).to(torch.float32).contiguous()
        for x, n in ((q, L), (k, S), (v, S)))


def fused_geodesic_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *,
                             mask: torch.Tensor | None = None,
                             metric: str = "oblique",
                             curvature: float = 1.0) -> torch.Tensor:
    """softmax_j(score(q_i, k_j) + mask)·V over q [..., L, Dh], k/v
    [..., S, Dh] and an additive mask broadcastable to [..., L, S]; fp32.
    ``metric``: "oblique" (−acos of the unit rows) or "poincare" (the
    negated Möbius distance at ``curvature`` ≥ ``MIN_MAXLESS_CURVATURE``;
    q and k must be ball points).

    MASK CONTRACT (as in the JAX package): entries ≤ -1e29 exclude a key
    (weight exactly 0; a row with every key excluded outputs 0); other finite
    values are shifted per row and floored at -30 before the kernel sees
    them, which leaves the softmax weights unchanged up to ~1e-13."""
    _check_maxless_bounds(metric, curvature)
    *lead, L, Dh = q.shape
    S = k.shape[-2]
    m = None if mask is None else _canonicalize_mask(
        torch.broadcast_to(mask, (*lead, L, S))).contiguous()
    if not torch.is_grad_enabled() or not any(
            t is not None and t.requires_grad for t in (q, k, v, mask)):
        # no gradient can flow: the forward without the Function, on the
        # operands as they are when they are contiguous fp32 (the kernel
        # takes any leading dims as its problem axis)
        if (k.shape == v.shape and k.shape[:-2] == q.shape[:-2]
                and k.shape[-1] == Dh and all(
                    t.dtype == torch.float32 and t.is_contiguous()
                    for t in (q, k, v))):
            return _forward(q, k, v, m, metric, float(curvature))
    lead, B, L, S, Dh, (q3, k3, v3) = _flatten(q, k, v)
    m3 = None if m is None else m.reshape(B, L, S)
    out = _FusedCore.apply(q3, k3, v3, m3, metric, float(curvature))
    return out if len(lead) == 1 else out.reshape(*lead, L, Dh)


# kernel launches, counted in _launch and _launch_bwd: all of them, per
# metric, and those with an additive mask
fused_geodesic_attention.launches = 0
fused_geodesic_attention.launches_by_metric = dict.fromkeys(METRICS, 0)
fused_geodesic_attention.launches_masked = 0
fused_geodesic_attention_backward.launches = 0
fused_geodesic_attention_backward.launches_by_metric = dict.fromkeys(METRICS,
                                                                     0)
fused_geodesic_attention_backward.launches_masked = 0


# --------------------------------------------------------------------------- #
# S-tiled (flash) attention with key validity                                 #
# --------------------------------------------------------------------------- #

def _flash_scores(q, k, val, metric, c):
    """``_scores`` with an invalid key's score at NEG_INF (its exp is
    exactly 0)."""
    state, s = _scores(q, k, metric, c)
    if val is not None:
        s = torch.where(val[:, None, :] > 0, s, NEG_INF)
    return state, s


def flash_geodesic_attention_reference(q: torch.Tensor, k: torch.Tensor,
                                       v: torch.Tensor,
                                       val: torch.Tensor | None,
                                       metric: str = "oblique",
                                       curvature: float = 1.0):
    """Plain PyTorch version of the forward kernel on q [B,L,Dh], k/v
    [B,S,Dh] and the validity [B,S] or None: (out [B,L,Dh], lse [B,L]) with
    the maxless softmax, l = max(Σ_j e_ij, 1e-30), out = Σ_j e_ij v_j / l and
    lse = log l; a row with no valid key outputs exactly 0."""
    _, s = _flash_scores(q, k, val, metric, curvature)
    e = torch.exp(s)
    l = torch.clamp(e.sum(dim=-1), min=1e-30)
    return (e @ v) / l[..., None], torch.log(l)


def _flash_replay(q, k, v, val, do, lse, delta, metric, c):
    """What both backward sweeps replay: the scores' state, the
    probabilities p = exp(s − lse) and the score cotangent
    ds = p ⊙ (do·vᵀ − δ)."""
    state, s = _flash_scores(q, k, val, metric, c)
    p = torch.exp(s - lse[..., None])
    return state, p, p * (do @ v.transpose(-1, -2) - delta[..., None])


def flash_dq_reference(q, k, v, val, do, lse, delta, metric="oblique",
                       curvature=1.0):
    """Plain PyTorch version of the dq sweep."""
    state, _, ds = _flash_replay(q, k, v, val, do, lse, delta, metric,
                                 curvature)
    return _qk_grads(state, ds, q, k, metric, curvature)[0]


def flash_dkv_reference(q, k, v, val, do, lse, delta, metric="oblique",
                        curvature=1.0):
    """Plain PyTorch version of the dk/dv sweep: (dk, dv = pᵀ·do)."""
    state, p, ds = _flash_replay(q, k, v, val, do, lse, delta, metric,
                                 curvature)
    return (_qk_grads(state, ds, q, k, metric, curvature)[1],
            p.transpose(-1, -2) @ do)


def flash_geodesic_attention_backward_reference(q, k, v, val, do, lse,
                                                delta, metric="oblique",
                                                curvature=1.0):
    """Plain PyTorch version of the two backward sweeps, the formula of the
    JAX ``_make_flash_dq_kernel``/``_make_flash_dkv_kernel`` and their
    poincaré counterparts: the replayed p = exp(s − lse); dv = pᵀ·do;
    ds = p ⊙ (do·vᵀ − δ) with δ = rowsum(do ⊙ out); then each metric's
    score VJP (``_qk_grads``). Each sweep replays the scores, as the
    kernels do. Returns (dq, dk, dv)."""
    args = (q, k, v, val, do, lse, delta, metric, curvature)
    return (flash_dq_reference(*args), *flash_dkv_reference(*args))


def _launch_flash(q, k, v, val, metric="oblique", curvature=1.0):
    _check_devices(q, k, v, val)
    B, L, Dh = q.shape
    S = k.shape[1]
    out = torch.empty_like(q)
    lse = torch.empty((B, L), device=q.device, dtype=torch.float32)
    err = _build.launch(_FLASH_FWD, q.device, q.data_ptr(), k.data_ptr(),
                        v.data_ptr(), _ptr(val), out.data_ptr(),
                        lse.data_ptr(), B, L, S, Dh, METRICS.index(metric),
                        curvature)
    if err:
        _build.check(err, f"flash_mhgsa_fwd(B={B}, L={L}, S={S}, Dh={Dh}, "
                          f"{metric})")
    _count(flash_geodesic_attention, metric)
    return out, lse


def _launch_flash_dq(q, k, v, val, do, lse, delta, metric="oblique",
                     curvature=1.0):
    _check_devices(q, k, v, val, do, lse, delta)
    B, L, Dh = q.shape
    S = k.shape[1]
    dq = torch.empty_like(q)
    err = _build.launch(_FLASH_DQ, q.device, q.data_ptr(), k.data_ptr(),
                        v.data_ptr(), _ptr(val), do.data_ptr(),
                        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B, L,
                        S, Dh, METRICS.index(metric), curvature)
    if err:
        _build.check(err, f"flash_mhgsa_dq(B={B}, L={L}, S={S}, Dh={Dh}, "
                          f"{metric})")
    _count(flash_geodesic_attention_backward, metric, "launches_dq")
    return dq


def _launch_flash_dkv(q, k, v, val, do, lse, delta, metric="oblique",
                      curvature=1.0):
    _check_devices(q, k, v, val, do, lse, delta)
    B, L, Dh = q.shape
    S = k.shape[1]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = _build.launch(_FLASH_DKV, q.device, q.data_ptr(), k.data_ptr(),
                        v.data_ptr(), _ptr(val), do.data_ptr(),
                        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                        dv.data_ptr(), B, L, S, Dh, METRICS.index(metric),
                        curvature)
    if err:
        _build.check(err, f"flash_mhgsa_dkv(B={B}, L={L}, S={S}, Dh={Dh}, "
                          f"{metric})")
    _count(flash_geodesic_attention_backward, metric, "launches_dkv")
    return dk, dv


def _flash_forward(q, k, v, val, metric="oblique", curvature=1.0):
    if q.device.type == "cpu":
        return flash_geodesic_attention_reference(q, k, v, val, metric,
                                                  curvature)
    if q.device.type == "cuda":
        return _launch_flash(q, k, v, val, metric, curvature)
    raise ValueError(f"unsupported device {q.device}")


def flash_geodesic_attention_backward(q: torch.Tensor, k: torch.Tensor,
                                      v: torch.Tensor,
                                      val: torch.Tensor | None,
                                      out: torch.Tensor, lse: torch.Tensor,
                                      do: torch.Tensor,
                                      metric: str = "oblique",
                                      curvature: float = 1.0):
    """Backward of the flattened flash core from its residuals: q [B,L,Dh],
    k/v [B,S,Dh], the validity [B,S] or None, the forward's out [B,L,Dh] and
    lse [B,L], the output cotangent do [B,L,Dh]. δ = rowsum(do ⊙ out) is one
    plain reduction here (JAX takes it outside its kernels too). Returns
    (dq, dk, dv). CPU tensors run the plain version; CUDA tensors launch the
    dq and dk/dv sweeps of ``csrc/flash_mhgsa_bwd.cu`` or raise."""
    _check_maxless_bounds(metric, curvature)
    do = do.to(torch.float32).contiguous()
    delta = torch.sum(do * out, dim=-1)
    args = (q, k, v, val, do, lse, delta, metric, curvature)
    if q.device.type == "cpu":
        return flash_geodesic_attention_backward_reference(*args)
    if q.device.type == "cuda":
        return (_launch_flash_dq(*args), *_launch_flash_dkv(*args))
    raise ValueError(f"unsupported device {q.device}")


class _FlashCore(torch.autograd.Function):
    """softmax(score(q_i, k_j))·V with key validity on flattened, contiguous
    fp32 operands, with the hand-derived backward. Saves q, k, v, the
    validity, out and the per-row lse, as the JAX residuals do. The metric
    and curvature are not differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, val, metric, curvature):
        out, lse = _flash_forward(q, k, v, val, metric, curvature)
        ctx.save_for_backward(q, k, v, val, out, lse)
        ctx.metric, ctx.curvature = metric, curvature
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, val, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_geodesic_attention_backward(
            q, k, v, val, out, lse, do, ctx.metric, ctx.curvature)
        return dq, dk, dv, None, None, None


def flash_geodesic_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *,
                             kv_valid: torch.Tensor | None = None,
                             metric: str = "oblique",
                             curvature: float = 1.0) -> torch.Tensor:
    """S-tiled softmax_j(score(q_i, k_j))·V over q [..., L, Dh], k/v [..., S,
    Dh] with key validity ``kv_valid`` broadcastable to [..., S] (1 = real
    key) or None; fp32; the metric as in ``fused_geodesic_attention``. Any L
    and S: the context is bounded by device memory, not shared memory; any
    head dim (above 128 the kernels keep the row vectors in shared memory
    instead of registers)."""
    _check_maxless_bounds(metric, curvature)
    lead, B, L, S, Dh, (q3, k3, v3) = _flatten(q, k, v)
    val = None if kv_valid is None else torch.broadcast_to(
        kv_valid, (*lead, S)).reshape(B, S).to(torch.float32).contiguous()
    return _FlashCore.apply(q3, k3, v3, val, metric, float(curvature)) \
        .reshape(*lead, L, Dh)


# kernel launches, counted in _launch_flash, _launch_flash_dq and
# _launch_flash_dkv
flash_geodesic_attention.launches = 0
flash_geodesic_attention.launches_by_metric = dict.fromkeys(METRICS, 0)
flash_geodesic_attention_backward.launches_dq = 0
flash_geodesic_attention_backward.launches_dq_by_metric = \
    dict.fromkeys(METRICS, 0)
flash_geodesic_attention_backward.launches_dkv = 0
flash_geodesic_attention_backward.launches_dkv_by_metric = \
    dict.fromkeys(METRICS, 0)
