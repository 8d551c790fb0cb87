"""Multi-head geodesic self-attention (port of ``sttode_tpu/nn/attention.py``).

Scores are negated geodesic distances, on the oblique manifold
(``metric="oblique"``, the reference's live path:
``score(q, k) = -acos(clip(q̂·k̂, ±(1-1e-4)))``) or on the Poincaré ball of
curvature c (``metric="poincare"``, the paper's framing: q and k mapped onto
the ball by ``pmath.project(pmath.expmap0(·))`` and scored by the negated
Möbius distance, ``pmath.dist_matrix_gram``), in one of two orientations:

- ``compat="reference"`` (quirk Q3): the square case uses
  ``scores[i, j] = -d(k_i, q_j)``; rectangular shapes use the corrected one.
  Masks never reach attention in this mode (quirk Q2, dropped by the caller).
- ``compat="tpu"``: ``scores[i, j] = -d(q_i, k_j)`` with an additive mask.

Routing (``_kernel_route``, a pure function of shapes and flags): on a CUDA
tensor ``fused="auto"`` sends
- the small problems of the model's hot shapes to the key-validity kernel
  ``kernels.packed_mhgsa`` ("packed": oblique metric, no additive mask, an
  explicit head axis with H·Dh ≤ 128 and L·S ≤ 32², the JAX predicate
  without its TPU VMEM guard);
- every other maskless problem (a key validity allowed) to the S-tiled
  kernel ``kernels.mhgsa.flash_geodesic_attention`` ("flash") where JAX's
  rule S > 2048 says so or where the whole-S kernels would not stage it in
  shared memory (``kernels.mhgsa.whole_s_smem_bytes`` of the metric: at
  Dh = 8 their backward's rows pass the opt-in limit at L = S > 1036, so
  scene-axis training at 1037 ≤ B ≤ 2048 scenes goes to flash on the card
  where JAX runs its fused kernel — an H100 routing decision, flash being
  ~10× faster there; the backward's fit is used since the route cannot
  know whether a gradient follows);
- an additive mask with S > 2048 to the plain path, as in JAX; up to 2048
  to the whole-S kernel, whatever the head dim, as JAX sends it to its fused
  kernel: where a problem does not fit in shared memory the forward streams
  its keys, values and mask in tiles and the backward stages it in a device
  workspace;
- poincaré below ``MIN_MAXLESS_CURVATURE`` to the plain path, as in JAX:
  the kernels' maxless softmax needs the scores bounded below;
- everything else to the whole-S kernel
  ``kernels.mhgsa.fused_geodesic_attention`` ("fused"), also the small
  poincaré problems that JAX leaves to XLA on the TPU (L·S < 256²): an
  H100 routing choice, the kernels of either metric staying on the card.
``fused=True``, ``fused="packed"`` and ``fused="flash"`` force one kernel,
``fused=False`` ("dense") takes the plain path, a max-subtracted softmax over
the dense scores, and the only one with attention-weight dropout: active
dropout sends "auto" there, and a forced kernel raises ValueError, as in
JAX. Every kernel takes the forward and, when a gradient is
taken, the backward; Q3 is the kernel with q and k swapped, under which a
key validity becomes an additive mask (so it goes to the whole-S kernel, and
the packed and flash kernels refuse it). Under poincaré the ball map is
applied to q and k (after the swap) in plain differentiable torch before a
kernel sees them, as in JAX. On a CPU tensor every route but a forced
"packed" or "flash" takes the plain dense path; those two run their
kernel's plain version. The packed boundary is the JAX package's starting
point, not an H100 crossover: ``chip_smoke.py`` times the kernels at the NBA
recipe's shapes.

Under a ``mesh`` (``parallel``) the tensors are each rank's part of the
attention, its block of the token axes over ``ring_axis`` (or, with
``ring_axis=None``, the whole token axes and its block of the batch over
"data"). ``fused="ring"`` runs ``parallel.ring_attention`` and
``fused="ulysses"`` ``parallel.ulysses`` (JAX's sequence-parallel
routes) in their layout (``_into_sp``): the tokens split over the token
axis of ``resolve_sp_axes`` ("data", or "seq" on a data × sequence mesh),
the batch rows over "data" on that mesh, as JAX's ``shard_map`` lays them
out. Every other route attends the rank's queries to the keys and values
gathered from every rank of ``ring_axis`` (``_mesh_attention``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sttode_tpu_torch.kernels.mhgsa import (MIN_MAXLESS_CURVATURE,
                                            SMEM_OPTIN_BYTES,
                                            flash_geodesic_attention,
                                            fused_geodesic_attention,
                                            whole_s_smem_bytes)
from sttode_tpu_torch.kernels.packed_mhgsa import packed_geodesic_attention
from sttode_tpu_torch.manifolds import oblique, pmath
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


def to_ball(x: torch.Tensor, c: float) -> torch.Tensor:
    """The poincaré metric's map onto the ball: project(expmap0(x))."""
    return pmath.project(pmath.expmap0(x, c=c), c=c)


def geodesic_scores(q: torch.Tensor, k: torch.Tensor, *,
                    compat: str = "reference",
                    metric: str = "oblique",
                    curvature: float = 1.0) -> torch.Tensor:
    """Negated geodesic distances: q [..., L, Dh], k [..., S, Dh] →
    [..., L, S] (square reference-compat case: the Q3 orientation)."""
    if metric == "poincare":
        d = pmath.dist_matrix_gram(to_ball(q, curvature),
                                   to_ball(k, curvature), c=curvature)
        if compat == "reference" and q.shape[-2] == k.shape[-2]:
            d = d.transpose(-1, -2)
        return -d
    if metric != "oblique":
        raise ValueError(f"metric {metric!r} (oblique/poincare)")
    qn = oblique.proj(q)
    kn = oblique.proj(k)
    if compat == "reference":
        d = oblique.dist(kn, qn)                 # [..., S, L]
        if q.shape[-2] != k.shape[-2]:
            d = d.transpose(-1, -2)
        return -d
    return -oblique.dist(qn, kn)


def _kv_valid_mask(kv_valid: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Additive mask from key validity, aligned to the score shape
    [..., (H,) L, S]: axes are inserted before S until kv_valid aligns with
    q's batch (and head) dims, then the query-row axis is added."""
    kvv = kv_valid
    while kvv.ndim < q.ndim - 1:
        kvv = kvv[..., None, :]
    neg = torch.finfo(q.dtype).min
    return torch.where(kvv[..., None, :] > 0, 0.0, neg).to(q.dtype)


def _kernel_route(q_shape: tuple, k_shape: tuple, *, has_mask: bool,
                  has_kv_valid: bool, compat: str, fused: str | bool,
                  need_weights: bool, metric: str, on_cuda: bool,
                  curvature: float = 1.0,
                  dropout_active: bool = False) -> str | None:
    """The kernel that serves one attention call: "packed", "flash",
    "fused" or None (the plain path). Under reference compat the square
    case is the kernel with q and k swapped, and a key validity then counts
    as an additive mask. No kernel implements attention-weight dropout:
    active dropout sends "auto" to the plain path, and a forced kernel
    raises, as in JAX."""
    if fused not in ("auto", True, False, "packed", "flash"):
        raise NotImplementedError(
            f"attention route {fused!r} is not ported "
            "(auto/fused/packed/flash/dense/ring/ulysses)")
    if dropout_active and fused in (True, "packed", "flash"):
        route = "fused" if fused is True else fused
        raise ValueError(
            f"attn_impl='{route}' does not implement attention dropout; "
            "set dropout=0 (the reference default) or use a dense route")
    if dropout_active:
        return None
    if fused == "packed":
        if metric != "oblique":
            raise ValueError("the packed kernel implements the oblique "
                             "metric only")
        return "packed"
    if fused == "flash":
        return "flash"
    if fused is False or not on_cuda:
        return None
    if fused is True:
        return "fused"
    if need_weights:
        return None
    if metric == "poincare" and curvature < MIN_MAXLESS_CURVATURE:
        return None
    L, S, Dh = q_shape[-2], k_shape[-2], q_shape[-1]
    swapped = compat == "reference" and L == S
    has_mask = has_mask or (has_kv_valid and swapped)
    if (metric == "oblique" and not has_mask and len(q_shape) >= 4
            and q_shape[-3] * Dh <= 128 and L * S <= 32 * 32):
        return "packed"
    if has_mask:
        # JAX's rule, any head dim: beyond shared memory the whole-S forward
        # streams keys, values and mask in tiles, the backward stages in a
        # device workspace
        return None if S > 2048 else "fused"
    if S > 2048 or max(whole_s_smem_bytes(L, S, Dh, metric)) > \
            SMEM_OPTIN_BYTES:
        return "flash"
    return "fused"


def geodesic_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       mask: torch.Tensor | None = None,
                       compat: str = "reference",
                       fused: str | bool = "auto",
                       need_weights: bool = True,
                       metric: str = "oblique",
                       curvature: float = 1.0,
                       kv_valid: torch.Tensor | None = None,
                       dropout_rate: float = 0.0,
                       dropout_mask: torch.Tensor | None = None,
                       mesh=None, ring_axis: str | None = "data"):
    """Core attention: scores → (+mask) → softmax → dropout → @v.

    q [..., L, Dh], k/v [..., S, Dh], additive mask broadcastable to
    [..., L, S], key validity ``kv_valid`` [..., S] (1 = real key; no head
    axis). Returns (out [..., L, Dh], weights [..., L, S] or None on a kernel
    route). ``fused``: "auto" (routed by ``_kernel_route``), True (the
    whole-S kernel on CUDA), "packed" (the small-shape key-validity kernel)
    or "flash" (the S-tiled key-validity kernel), both refusing additive
    masks, False (plain path). Attention-weight dropout at ``dropout_rate``
    applies where ``dropout_mask`` (bool keep-mask of the weights' shape)
    is given, on the plain path only.

    Under a ``mesh`` (``parallel.make_mesh``) q, k, v and ``kv_valid`` hold
    this rank's block of the token axes, split over ``mesh[ring_axis]``,
    or with ``ring_axis=None`` the whole token axes and this rank's block
    of the batch over "data" (the agent axis on a mesh); the result is
    this rank's part alike. ``fused="ring"`` runs the ring
    (``parallel.ring_attention``) and ``fused="ulysses"`` the head ↔ token
    all-to-all (``parallel.ulysses``; an explicit head axis [..., H, L,
    Dh]): no dropout, key validity only (a singleton head axis of
    ``kv_valid`` is squeezed for ulysses), in their layout
    (``_into_sp``). Every other route attends this rank's queries to the
    keys and values gathered from every rank of ``ring_axis``, on the
    route the local shapes pick (``_mesh_attention``). Quirk Q3's swap is
    decided on the global shapes in all of them: the token axes are split
    alike."""
    dropout_active = dropout_rate > 0.0 and dropout_mask is not None
    if fused in ("ring", "ulysses"):
        return _sp_attention(q, k, v, mesh, ring_axis, fused, mask=mask,
                             compat=compat, metric=metric,
                             curvature=curvature, kv_valid=kv_valid,
                             dropout_active=dropout_active)
    if mesh is not None and ring_axis is not None:
        return _mesh_attention(q, k, v, mesh, ring_axis, mask=mask,
                               compat=compat, fused=fused,
                               need_weights=need_weights, metric=metric,
                               curvature=curvature, kv_valid=kv_valid,
                               dropout_rate=dropout_rate,
                               dropout_mask=dropout_mask)
    route = _kernel_route(tuple(q.shape), tuple(k.shape),
                          has_mask=mask is not None,
                          has_kv_valid=kv_valid is not None, compat=compat,
                          fused=fused, need_weights=need_weights,
                          metric=metric, on_cuda=q.is_cuda,
                          curvature=curvature,
                          dropout_active=dropout_active)
    swapped = compat == "reference" and q.shape[-2] == k.shape[-2]
    kv_as_mask = kv_valid is not None and (
        swapped or route not in ("packed", "flash"))
    if kv_as_mask:
        # under the Q3 swap "key validity" would mark the wrong axis of the
        # swapped kernel: it becomes an additive mask on the unswapped
        # scores, merged with any mask given (dropping either would attend
        # to padding)
        kvm = _kv_valid_mask(kv_valid, q)
        mask = kvm if mask is None else mask + kvm
        kv_valid = None
    hint = (" (compat='reference' square attention expresses kv_valid as "
            "an additive mask: quirk Q3's swap)" if swapped and kv_as_mask
            else "")
    if route is not None:
        qq, kk = (k, q) if swapped else (q, k)
        if metric == "poincare":
            qq, kk = to_ball(qq, curvature), to_ball(kk, curvature)
        if route == "packed":
            if mask is not None:
                raise ValueError(
                    "packed kernel supports key-validity masks only; pass "
                    "kv_valid instead of an additive mask, or fused=False"
                    + hint)
            return packed_geodesic_attention(qq, kk, v,
                                             kv_valid=kv_valid), None
        if route == "flash":
            if mask is not None:
                raise ValueError(
                    "flash kernel supports key-validity masks only; pass "
                    "kv_valid instead of an additive mask, or use fused=True "
                    "(S ≤ ~2k) / fused=False" + hint)
            if kv_valid is not None:
                while kv_valid.ndim < qq.ndim - 1:   # insert axes before S
                    kv_valid = kv_valid[..., None, :]   # (e.g. the heads)
            return flash_geodesic_attention(qq, kk, v, kv_valid=kv_valid,
                                            metric=metric,
                                            curvature=curvature), None
        return fused_geodesic_attention(qq, kk, v, mask=mask, metric=metric,
                                        curvature=curvature), None
    scores = geodesic_scores(q, k, compat=compat, metric=metric,
                             curvature=curvature)
    if mask is not None:
        scores = scores + mask
    w = torch.softmax(scores, dim=-1)
    if dropout_active:
        w = core.dropout(w, dropout_rate, keep_mask=dropout_mask)
    return w @ v, w


def _sp_axes(mesh, ring_axis: str | None) -> tuple[str, str | None]:
    """(token axis, batch axis) of the sequence-parallel routes on
    ``mesh`` for tokens given split over ``ring_axis`` (None: whole, the
    batch rows split over "data"); ValueError for another layout."""
    from sttode_tpu_torch.parallel.ring_attention import resolve_sp_axes
    tok, bat = resolve_sp_axes(mesh, ring_axis or "data")
    if ring_axis not in (tok, "data", None):
        raise ValueError(f"ring_axis {ring_axis!r}: the tokens lie split over "
                         f"{tok!r} or 'data', or whole (None)")
    return tok, bat


def _split_size(size: int, mesh, axis: str, route: str, what: str) -> None:
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    if size % n:
        raise ValueError(f"attn_impl={route!r} splits the {size} {what} over "
                         f"{axis} = {n}: they must divide")


def _into_sp(x, mesh, ring_axis: str | None, tdim: int, route: str):
    """``x`` (the batch rows on dim 0, the tokens on ``tdim``) from this
    rank's part as given (``geodesic_attention``'s mesh layout) to its
    part in the sequence-parallel layout: the tokens split over the token
    axis, the rows over the batch axis (``_sp_axes``). From tokens split
    over "data" on a data × sequence mesh: every token gathered over
    "data", this rank's rows taken, its "seq" block of tokens split off;
    from whole tokens (rows over "data"): the "seq" block, or on a 2-axis
    mesh every row gathered and the "data" block of tokens taken. The
    gather's, take's and split's backward rules make each rank's
    cotangent whole for its part (``parallel.collectives``)."""
    from sttode_tpu_torch.parallel import collectives
    tok, bat = _sp_axes(mesh, ring_axis)
    if ring_axis == tok:
        return x
    data = mesh.get_group("data")
    if bat is None:
        x = collectives.gather(x, data, 0)
        _split_size(x.shape[tdim], mesh, "data", route, "tokens")
        return collectives.take(x, data, tdim)
    if ring_axis == "data":
        x = collectives.gather(x, data, tdim)
        _split_size(x.shape[0], mesh, "data", route,
                    "rows of the attention's batch")
        x = collectives.take(x, data, 0)
    _split_size(x.shape[tdim], mesh, tok, route, "tokens")
    return collectives.split(x, mesh.get_group(tok), tdim)


def _from_sp(x, mesh, ring_axis: str | None, tdim: int):
    """``_into_sp``'s inverse: the output back to this rank's part as
    given."""
    from sttode_tpu_torch.parallel import collectives
    tok, bat = _sp_axes(mesh, ring_axis)
    if ring_axis == tok:
        return x
    data = mesh.get_group("data")
    if bat is None:
        return collectives.take(collectives.gather(x, data, tdim), data, 0)
    x = collectives.unsplit(x, mesh.get_group(tok), tdim)
    if ring_axis == "data":
        x = collectives.take(collectives.gather(x, data, 0), data, tdim)
    return x


def _sp_attention(q, k, v, mesh, ring_axis: str | None, route: str, *, mask,
                  compat: str, metric: str, curvature: float, kv_valid,
                  dropout_active: bool):
    """The routes "ring" and "ulysses" (JAX's): q [..., L, Dh], k / v [...,
    S, Dh] folded to the route's batch rows (the ring's every leading
    axis, ulysses' those before the heads), ``kv_valid`` broadcast over
    them; q and k swap under quirk Q3; the route runs in its layout
    (``_into_sp``) and the output comes back (``_from_sp``)."""
    if dropout_active:
        # loud, not silent: the sequence-parallel routes have no
        # attention-weight dropout
        raise ValueError(
            f"attn_impl='{route}' does not implement attention dropout; "
            "set dropout=0 (the reference default) or use a dense route")
    if mesh is None:
        raise ValueError(f"attn_impl='{route}' needs a mesh — pass it "
                         "through sttode_forward(..., mesh=) / "
                         "make_train_step")
    if mask is not None:
        raise ValueError(f"{route} path supports key-validity masks only; "
                         "pass kv_valid instead of an additive mask")
    if route == "ulysses" and q.dim() < 4:
        raise ValueError("ulysses attention needs an explicit head axis: "
                         "q/k/v must be [..., H, L, Dh]")
    from sttode_tpu_torch.parallel.ring_attention import \
        ring_geodesic_attention
    from sttode_tpu_torch.parallel.ulysses import ulysses_geodesic_attention
    *lead, L, Dh = q.shape
    S = k.shape[-2]
    # both token axes are split alike: square locally iff globally
    qq, kk = (k, q) if (compat == "reference" and L == S) else (q, k)
    batch = lead if route == "ring" else lead[:-1]
    B = 1
    for d in batch:
        B *= d
    val = None
    if kv_valid is not None:
        kvv = kv_valid
        if route == "ulysses":
            # no head axis at rest: squeeze a singleton one
            while kvv.dim() > len(batch) + 1 and kvv.shape[-2] == 1:
                kvv = kvv.squeeze(-2)
        while kvv.dim() < len(batch) + 1:   # insert axes before S (e.g. the
            kvv = kvv[..., None, :]         # ring's folded head axis)
        val = _into_sp(torch.broadcast_to(kvv, (*batch, S)).reshape(B, S),
                       mesh, ring_axis, 1, route)
    rows = (B,) if route == "ring" else (B, lead[-1])
    tdim = len(rows)
    qq, kk, vv = (_into_sp(x.reshape(*rows, x.shape[-2], Dh), mesh,
                           ring_axis, tdim, route) for x in (qq, kk, v))
    attend = ring_geodesic_attention if route == "ring" else \
        ulysses_geodesic_attention
    # the route's token axis: the given one, else resolved from "data"
    out = attend(qq, kk, vv, mesh, axis=ring_axis or "data", kv_valid=val,
                 metric=metric, curvature=curvature)
    return _from_sp(out, mesh, ring_axis, tdim).reshape(*lead, L, Dh), None


def _mesh_attention(q, k, v, mesh, ring_axis: str, *, mask, compat: str,
                    fused, need_weights: bool, metric: str,
                    curvature: float, kv_valid, dropout_rate: float,
                    dropout_mask):
    """Every route but the ring under a mesh: this rank's query block
    against the key and value blocks of every rank, gathered along the
    token axis (``collectives.gather``, whose backward sums the gathered
    cotangent over the ranks). Under quirk Q3's swap, decided on the
    global shapes, the kernel's queries are the keys: q and v are
    gathered, not k, and the validity marks q's tokens, as the swapped
    single-process call does. The call then runs unswapped on the route
    its local shapes pick. ``dropout_mask`` is this rank's rows of the
    global one."""
    from sttode_tpu_torch.parallel import collectives
    if mask is not None:
        raise ValueError("under a mesh the attention supports key-validity "
                         "masks only; pass kv_valid instead of an additive "
                         "mask")
    group = mesh.get_group(ring_axis)
    # both token axes are split alike: square locally iff globally
    qq, kk = (k, q) if (compat == "reference" and
                        q.shape[-2] == k.shape[-2]) else (q, k)
    kk = collectives.gather(kk, group, kk.dim() - 2)
    vv = collectives.gather(v, group, v.dim() - 2)
    if kv_valid is not None:
        kv_valid = collectives.all_gather(kv_valid, group, kv_valid.dim() - 1)
    return geodesic_attention(qq, kk, vv, compat="tpu", fused=fused,
                              need_weights=need_weights, metric=metric,
                              curvature=curvature, kv_valid=kv_valid,
                              dropout_rate=dropout_rate,
                              dropout_mask=dropout_mask)


def mhgsa(params: MHGSAParams, query: torch.Tensor, key: torch.Tensor,
          value: torch.Tensor, num_heads: int, *,
          mask: torch.Tensor | None = None,
          compat: str = "reference",
          need_weights: bool = False,
          fused: str | bool = "auto",
          metric: str = "oblique",
          curvature: float = 1.0,
          kv_valid: torch.Tensor | None = None,
          dropout_rate: float = 0.0,
          dropout_mask: torch.Tensor | None = None,
          bias_kv: tuple | None = None,
          add_zero_attn: bool = False,
          mesh=None, ring_axis: str | None = "data"):
    """Full multi-head geodesic attention: query [..., L, E], key/value
    [..., S, E] → (out [..., L, E], head-averaged weights or None). One
    packed [E, 3E] projection when query, key and value are the same tensor,
    split projections otherwise. ``kv_valid`` [..., S] marks real keys and
    is shared by the heads. ``dropout_mask`` [..., H, L, S'] is the
    keep-mask of the attention weights' dropout at ``dropout_rate``.

    ``bias_kv`` (bias_k [E], bias_v [E]) appends one learned key/value
    position after the projections, ``add_zero_attn`` an all-zero one
    (both: bias first), so S' = S + 1 or S + 2: the additive mask gets a 0
    column and ``kv_valid`` a valid key for each. The route and the Q3 swap
    are decided on the new shape: a square reference-compat self-attention
    runs swapped, the same call with an appended position unswapped.
    ``mesh`` and ``ring_axis``: see ``geodesic_attention`` (the tokens of
    query, key and value are this rank's blocks)."""
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
    extra = ([bias_kv] if bias_kv is not None else []) + (
        [(k.new_zeros(k.shape[-1]),) * 2] if add_zero_attn else [])
    for k_extra, v_extra in extra:
        shape = (*k.shape[:-2], 1, k.shape[-1])
        k = torch.cat([k, k_extra.expand(shape)], dim=-2)
        v = torch.cat([v, v_extra.expand(shape)], dim=-2)
        if mask is not None:
            mask = torch.cat([mask, torch.zeros_like(mask[..., :1])], dim=-1)
        if kv_valid is not None:
            kv_valid = torch.cat([kv_valid, torch.ones_like(kv_valid[..., :1])],
                                 dim=-1)
    # quirk Q10: a forward no-op after the row normalization, kept so the
    # numerics follow the reference's operation order; oblique only: under
    # poincaré it would pull q toward the ball's origin and skew distances
    if metric == "oblique":
        q = q * (head_dim ** -0.5)
    if mask is not None:
        mask = mask[..., None, :, :]            # broadcast over heads
    out_h, w = geodesic_attention(
        split_heads(q, num_heads), split_heads(k, num_heads),
        split_heads(v, num_heads), mask=mask, compat=compat,
        fused=fused, need_weights=need_weights, metric=metric,
        curvature=curvature, kv_valid=kv_valid, dropout_rate=dropout_rate,
        dropout_mask=dropout_mask, mesh=mesh, ring_axis=ring_axis)
    out = merge_heads(out_h) @ params.out_proj_w + params.out_proj_b
    if need_weights and w is not None:
        return out, w.mean(dim=-3)
    return out, None
