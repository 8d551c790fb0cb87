"""The poincaré whole-S backward's small-S mode (kernel 2p), on the CPU.

At small shapes the poincaré whole-S backward (``csrc/mhgsa_bwd.cu``) runs
the body of ``csrc/small_bwd.cuh`` under its poincaré policy: one block per
problem; pass 1 gives each thread a query row and a slice of the keys and,
since the score's gradient is linear in ds (dg = ds·f_ij, dx2_i +=
ds·(α + β·y2_j)) and ds = p (dp − δ) with δ = Σ_j p dp, sums in one pass
den = Σ e, Σ e·dp, A = Σ f·e·dp·k_j, B = Σ f·e·k_j, X = Σ (α + β·y2_j)·e·dp
and Y = Σ (α + β·y2_j)·e, so that δ = Σ e·dp / den, dq = (A − δ·B) / den +
2·dx2·q with dx2 = (X − δ·Y) / den; pass 2 gives each thread a key and a
slice of the rows and replays p = e·(1/den) and ds for dv, dk (+ 2·dy2·k)
and dmask. The pair epilogue is ``poincare::bwd_terms`` (``csrc/
poincare.cuh``): zc in IEEE fp32, the weight e = exp(s + m) as
(1 − zc)·rcp(1 + zc) at c = 1 or ex2(−lg2((1 + zc)·rcp(1 − zc))/√c), the
mask entry as one more ex2, and the gradient factors from
w = rcp((1 − zc)(1 + zc)), ½/n = ½·rsqrt(n²) and r = rcp(den + ε).

- ``small_bwd_layout(..., metric="poincare")`` and ``small_bwd_mode(...,
  metric="poincare")`` at the paths' shapes and the mode's bounds;
- the epilogue in float64, each SFU op either exact or moved by its PTX
  error bound (rcp, rsqrt and ex2 by 2⁻²¹ relative, lg2 by 2⁻²² absolute,
  signs at random), against the plain per-pair terms of
  ``kernels/mhgsa.py`` (``_poincare_pieces``, the score,
  ``_poincare_grad_pieces``): e against exp(s + m) within 3e-6 relative
  (the bounds' sum, ~1.5e-6), and f, α + β·y2 and α + β·x2 within 4e-6 of
  their two terms' magnitudes (the two terms have opposite signs and cancel
  near the ball's edge, for any implementation), at c = 1 and 0.7, mid-ball
  and near the edge; with every piece exact (and each piece in turn taken
  back to IEEE) the algebra is the plain formulas within 1e-12;
- ``poincare_small_bwd_model``, a float32 torch model of the two passes
  (the slices' partial sums added in slice order, the SFU ops at their
  bounds), against ``jax.grad`` of the JAX package's fused kernel with
  ``metric="poincare"`` in interpret mode (dq, dk, dv) and the port's plain
  backward (dq, dk, dv, dmask), within the card's tolerance 5e-5 × max(1,
  max |g|), at (3, 32, 32, 8), (2, 40, 24, 16) and (2, 17, 33, 32), masked
  and unmasked, c = 1 and 0.7; an all-excluded row's gradients exactly 0;
  q = k rows finite.

Ball points are made once in numpy (rows of norm 0.35–0.65/√c, two rows
of each problem at 0.95/√c) and fed to both sides. The JAX package is
only read.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sttode_tpu.kernels import mhgsa as jm
from sttode_tpu_torch.kernels import mhgsa as km

# one intra-op thread: pytest-xdist runs 6 workers on 8 cores, and
# torch's default of one thread a core each oversubscribes them
torch.set_num_threads(1)

LOG2E = 1.4426950408889634
SFU_REL = 2.0 ** -21      # rcp, rsqrt, ex2: PTX bounds of 1–2 ulp
LG2_ABS = 2.0 ** -22      # lg2.approx: absolute error bound
E_TOL = 3e-6              # e, relative
TERM_TOL = 4e-6           # f, α + β·y2, α + β·x2, × their terms' magnitude
GRAD_TOL = 5e-5           # the card's gradient tolerance, × max(1, max |g|)
PIECES = {"weight": 1, "w": 2, "half_over_n": 4, "r": 8}


def _sfu(perturb, seed=0):
    """The SFU ops of the model: correctly rounded, or each result moved by
    its error bound with a random sign."""
    gen = torch.Generator().manual_seed(seed)

    def op(name, x):
        y = {"rcp": lambda: 1.0 / x, "rsqrt": lambda: torch.rsqrt(x),
             "lg2": lambda: torch.log2(x),
             "ex2": lambda: torch.exp2(x)}[name]()
        if not perturb:
            return y
        sign = torch.randint(0, 2, y.shape, generator=gen).to(y.dtype) * 2 - 1
        if name == "lg2":
            return y + sign * LG2_ABS
        return y * (1 + sign * SFU_REL)
    return op


def bwd_terms(g, x2, y2, m, masked, c, sfu, ieee=0):
    """Model of ``poincare::bwd_terms`` in g's dtype: (e, f, a, b) per
    pair, so that dg = ds·f, dx2 += ds·(a + b·y2), dy2 += ds·(a + b·x2).
    ``ieee``: the bits of the pieces taken back to IEEE (``PIECES``)."""
    dt = g.dtype
    c_ = torch.tensor(c, dtype=dt)
    c2 = c_ * c_
    sqrt_c = torch.sqrt(c_)
    inv_sqrt_c = 1.0 / sqrt_c
    raw = x2 - 2.0 * g + y2
    mm = torch.clamp(raw, min=0.0)
    den = 1.0 - 2.0 * c_ * g + c2 * x2 * y2
    de = den + km.DENOM_EPS
    t = mm * den / (de * de) + 1e-15
    n = torch.sqrt(t)
    zc = torch.clamp(sqrt_c * n, max=1.0 - km.ARTANH_EPS)
    om, op = 1.0 - zc, 1.0 + zc
    if ieee & 1:
        e = torch.exp(-inv_sqrt_c * torch.log(op / om) + m)
    else:
        e = (om * sfu("rcp", op) if c == 1.0 else
             sfu("ex2", -inv_sqrt_c * sfu("lg2", op * sfu("rcp", om))))
        if masked:
            e = e * sfu("ex2", torch.as_tensor(m, dtype=dt) * LOG2E)
    if ieee & 8:
        A = den / (de * de)
        Bd = mm * (km.DENOM_EPS - den) / (de * de * de)
    else:
        r = sfu("rcp", de)
        A = den * (r * r)
        Bd = mm * (km.DENOM_EPS - den) * (r * r * r)
    w2 = (-2.0 / torch.clamp(1.0 - zc * zc, min=1e-12) if ieee & 2 else
          -2.0 * sfu("rcp", torch.clamp(om * op, min=1e-12)))
    hn = 0.5 / n if ieee & 4 else 0.5 * sfu("rsqrt", t)
    F = w2 * hn
    a = torch.where(raw > 0.0, F * A, 0.0)
    b = F * c2 * Bd
    return e, -2.0 * a - 2.0 * c_ * F * Bd, a, b


def _slice_sum(x, slices, dim):
    """Σ over ``dim`` as the kernel takes it: each slice its entries
    ≡ slice (mod slices), the slices' partials added in slice order."""
    parts = [x.index_select(dim, torch.arange(s, x.shape[dim], slices))
             .sum(dim) for s in range(slices)]
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def poincare_small_bwd_model(q, k, v, mask, do, c, sfu):
    """Model of the small-S mode's poincaré policy on ball points q
    [B,L,Dh], k [B,S,Dh], v [B,S,Dh], a canonicalized mask [B,L,S] or
    None and do [B,L,Dh]: (dq, dk, dv, dmask)."""
    L, S, Dh = q.shape[1], k.shape[1], q.shape[2]
    lay = km.small_bwd_layout(L, S, Dh, metric="poincare")
    g = q @ k.transpose(-1, -2)
    x2 = torch.sum(q * q, dim=-1)[..., None]
    y2 = torch.sum(k * k, dim=-1)[..., None, :]
    dp = do @ v.transpose(-1, -2)
    e, f, a, b = bwd_terms(g, x2, y2, 0.0 if mask is None else mask,
                           mask is not None, c, sfu)
    # pass 1: a row's sums over its keys, in one pass
    s1 = lay["slices1"]
    w = f * e
    ab = (a + b * y2) * e
    den = _slice_sum(e, s1, 2)
    edp = _slice_sum(e * dp, s1, 2)
    A = _slice_sum((w * dp)[..., None] * k[:, None], s1, 2)
    Bv = _slice_sum(w[..., None] * k[:, None], s1, 2)
    X = _slice_sum(ab * dp, s1, 2)
    Y = _slice_sum(ab, s1, 2)
    dn = torch.clamp(den, min=1e-30)
    dl = edp / dn
    dq = (A - dl[..., None] * Bv) / dn[..., None] \
        + 2.0 * ((X - dl * Y) / dn)[..., None] * q
    # pass 2: a key's sums over the rows, p and ds replayed
    p = e * (1.0 / dn)[..., None]
    ds = p * (dp - dl[..., None])
    s2 = lay["slices2"]
    dv = _slice_sum(p[..., None] * do[:, :, None], s2, 1)
    dkh = _slice_sum((f * ds)[..., None] * q[:, :, None], s2, 1)
    dy2 = _slice_sum(ds * (a + b * x2), s2, 1)
    return dq, dkh + 2.0 * dy2[..., None] * k, dv, ds


def _ball(rng, c, *shape, edge_rows=2):
    """Ball points [*shape]: random directions at norms 0.35–0.65/√c, the
    first ``edge_rows`` rows of each problem at 0.95/√c."""
    x = rng.standard_normal(shape)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    r = 0.35 + 0.3 * rng.random(shape[:-1] + (1,))
    r[..., :edge_rows, :] = 0.95
    return (x * r / math.sqrt(c)).astype(np.float32)


def _arr(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _max_err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


# --------------------------------------------------------------------------- #
# the layout and the mode                                                     #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("L,S,Dh,rows1,slices1,keys2,slices2,threads", [
    (32, 32, 8, 32, 8, 32, 8, 256),           # the NBA recipe, B = 32
    (128, 128, 8, 128, 4, 128, 4, 512),       # NBA evaluation (512 at Dh 8)
    (8, 8, 8, 8, 2, 8, 2, 32),                # the agent-axis server
    (1, 1, 8, 1, 1, 1, 1, 32),                # the launch floor
    (1024, 1024, 8, 512, 1, 512, 1, 512),
    (1200, 1200, 8, 256, 1, 256, 1, 256),     # halved to fit shared memory
    (700, 40, 16, 512, 1, 64, 8, 512),        # two row rounds in pass 1
    (256, 256, 32, 256, 1, 256, 1, 256)])
def test_poincare_small_bwd_layout(L, S, Dh, rows1, slices1, keys2, slices2,
                                   threads):
    """The poincaré layout: at most 512 threads at Dh ≤ 8, two floats more
    a thread in the slices' combine than the oblique one."""
    lay = km.small_bwd_layout(L, S, Dh, metric="poincare")
    assert (lay["rows1"], lay["slices1"], lay["keys2"], lay["slices2"],
            lay["threads"]) == (rows1, slices1, keys2, slices2, threads)
    assert lay["threads"] <= {8: 512, 16: 512, 32: 256}[lay["DH"]]
    assert max(rows1 * slices1, keys2 * slices2) <= lay["threads"]
    assert lay["smem_bytes"] <= km.SMEM_OPTIN_BYTES
    n = max(rows1 * slices1, keys2 * slices2)
    ob = km.small_bwd_layout(L, S, Dh)
    if (ob["rows1"], ob["slices1"], ob["keys2"], ob["slices2"]) == \
            (rows1, slices1, keys2, slices2):
        assert lay["smem_bytes"] == ob["smem_bytes"] + 4 * 2 * n


@pytest.mark.parametrize("L,S,Dh,taken", [
    (32, 32, 8, True),               # the NBA recipe, B = 32
    (128, 128, 8, True), (8, 8, 8, True), (1, 1, 8, True),
    (1024, 1024, 8, True),
    (1400, 1400, 8, True),           # 32-thread blocks, still within
    (1500, 1500, 8, False),          # beyond shared memory: the workspace
    (8, 8, 16, False), (16, 16, 16, True),     # Dh ≤ 16 from S = 16
    (16, 16, 32, False), (32, 32, 32, True),   # Dh ≤ 32 from S = 32
    (512, 512, 32, False),           # beyond shared memory
    (64, 64, 33, False), (64, 64, 64, False)])
def test_poincare_small_bwd_mode(L, S, Dh, taken):
    assert km.small_bwd_mode(L, S, Dh, metric="poincare") is taken


def test_small_bwd_layout_refuses_unknown_metric():
    with pytest.raises(ValueError):
        km.small_bwd_layout(32, 32, 8, metric="euclid")


# --------------------------------------------------------------------------- #
# the epilogue in float64                                                     #
# --------------------------------------------------------------------------- #

def _pairs(c, n=4000, seed=0):
    """n independent 1 × 1 problems of ball points (q [n,1,8], k [n,1,8]):
    mid-ball, near the edge, and the two in opposite cones at the edge
    (zc clamped), in float64."""
    rng = np.random.default_rng(seed)
    q = _ball(rng, c, n, 1, 8, edge_rows=0).astype(np.float64)
    k = _ball(rng, c, n, 1, 8, edge_rows=0).astype(np.float64)
    q[: n // 4] *= 0.999 / 0.5                     # near the edge
    k[n // 8: n // 4] *= 0.999 / 0.5
    q[n // 4: n // 2, :, 0] = 0.999 / math.sqrt(c)  # opposite cones
    k[n // 4: n // 2, :, 0] = -0.999 / math.sqrt(c)
    q[n // 4: n // 2, :, 1:] *= 0.01
    k[n // 4: n // 2, :, 1:] *= 0.01
    q, k = _t(q), _t(k)
    scale = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    q = torch.where(scale * math.sqrt(c) >= 1.0,
                    q * (0.999 / math.sqrt(c)) / scale, q)
    scale = torch.linalg.vector_norm(k, dim=-1, keepdim=True)
    k = torch.where(scale * math.sqrt(c) >= 1.0,
                    k * (0.999 / math.sqrt(c)) / scale, k)
    return q, k


def _plain(q, k, c, mask):
    """The plain per-pair terms: exp(s + m), dg, dx2 and dy2 at ds = 1."""
    pieces = km._poincare_pieces(q, k, c)
    s = km._poincare_score_from_pieces(pieces[-1], c)
    dg, dx2, dy2 = km._poincare_grad_pieces(pieces, torch.ones_like(s), c)
    return pieces, torch.exp(s + mask), dg, dx2[..., 0], dy2[..., 0]


def _term_err(got, want, c, x2, y2):
    """The largest error of f, α + β·y2 and α + β·x2 (``got`` as (f, a,
    b)) against the plain dg, dx2, dy2, each over its two terms' magnitudes
    (|2α| + |2c·F·Bd|, |α| + |β·y2|, |α| + |β·x2|, F·Bd = β/c²)."""
    f, a, b = got
    dg, dx2, dy2 = want
    fbd = b / (c * c)
    return max(float(((g_ - w_).abs() / s_).max()) for g_, w_, s_ in (
        (f, dg, 2.0 * a.abs() + 2.0 * c * fbd.abs()),
        (a + b * y2, dx2[..., None], a.abs() + (b * y2).abs()),
        (a + b * x2, dy2[..., None], a.abs() + (b * x2).abs())))


@pytest.mark.parametrize("ieee", [0, *PIECES.values(), 15])
@pytest.mark.parametrize("c", [1.0, 0.7])
def test_bwd_terms_algebra_equals_plain_formulas_in_float64(c, ieee):
    """With exact SFU ops, and each piece in turn (or all) in its IEEE
    form, the model is the plain formulas within 1e-12 (e relative, the
    gradient terms over their terms' magnitudes)."""
    q, k = _pairs(c, seed=int(c * 10) + ieee)
    pieces, e_want, dg, dx2, dy2 = _plain(q, k, c, 0.0)
    g, x2, y2 = pieces[:3]
    e, f, a, b = bwd_terms(g, x2, y2, 0.0, False, c, _sfu(False), ieee)
    assert float(((e - e_want) / e_want).abs().max()) <= 1e-12
    assert _term_err((f, a, b), (dg, dx2, dy2), c, x2, y2) <= 1e-12


@pytest.mark.parametrize("m", [0.0, -3.7, -30.0, km.NEG_INF])
@pytest.mark.parametrize("c", [1.0, 0.7])
def test_bwd_terms_sfu_bounds(c, m):
    """Each SFU op moved by its bound: e within 3e-6 relative of
    exp(s + m) (exactly 0 for an excluded entry), f and the squared norms'
    terms within 4e-6 of their terms' magnitudes."""
    q, k = _pairs(c, seed=7 + int(-m) % 31)
    masked = m != 0.0
    pieces, e_want, dg, dx2, dy2 = _plain(q, k, c, m)
    g, x2, y2 = pieces[:3]
    e, f, a, b = bwd_terms(g, x2, y2, m, masked, c, _sfu(True, seed=3))
    if m == km.NEG_INF:
        assert bool(torch.all(e == 0))
    else:
        assert float(((e - e_want) / e_want).abs().max()) <= E_TOL
    assert _term_err((f, a, b), (dg, dx2, dy2), c, x2, y2) <= TERM_TOL
    # the pairs near the edge are there: some zc clamped, all finite
    assert bool((pieces[-1] == 1.0 - km.ARTANH_EPS).any())
    assert all(bool(torch.isfinite(x).all()) for x in (e, f, a, b))


# --------------------------------------------------------------------------- #
# the two passes against JAX                                                  #
# --------------------------------------------------------------------------- #

def _raw_mask(rng, B, L, S):
    """An additive mask with finite entries, finfo.min exclusions and one
    all-excluded row per problem."""
    m = np.where(rng.random((B, L, S)) < 0.3, np.finfo(np.float32).min,
                 3.0 * _arr(rng, B, L, S) + 2.0).astype(np.float32)
    m[:, 3, :] = np.finfo(np.float32).min
    return m


@pytest.mark.parametrize("c", [1.0, 0.7])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("B,L,S,Dh", [(3, 32, 32, 8), (2, 40, 24, 16),
                                      (2, 17, 33, 32)])
def test_poincare_small_bwd_model_matches_jax(B, L, S, Dh, masked, c):
    rng = np.random.default_rng(L * 7 + S + masked + int(10 * c))
    q, k = _ball(rng, c, B, L, Dh), _ball(rng, c, B, S, Dh)
    v = _arr(rng, B, S, Dh)
    w = _arr(rng, B, L, Dh)                       # the output's cotangent
    raw = _raw_mask(rng, B, L, S) if masked else None
    assert km.small_bwd_mode(L, S, Dh, metric="poincare")

    def loss(q_, k_, v_):
        o = jm.fused_geodesic_attention(
            q_, k_, v_, mask=None if raw is None else jnp.asarray(raw),
            interpret=True, metric="poincare", curvature=c)
        return jnp.sum(o * jnp.asarray(w))

    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    mask = None if raw is None else km._canonicalize_mask(_t(raw))
    got = poincare_small_bwd_model(_t(q), _t(k), _t(v), mask, _t(w), c,
                                   _sfu(True, seed=L + S))
    plain = km.fused_geodesic_attention_backward_reference(
        _t(q), _t(k), _t(v), mask, _t(w), masked, "poincare", c)
    for name, g_, jw, pw in zip(("dq", "dk", "dv", "dmask"), got,
                                (*want, None), plain):
        if pw is None:
            continue
        assert bool(torch.isfinite(g_).all()), name
        for r in (np.asarray(x) for x in (jw, pw) if x is not None):
            tol = GRAD_TOL * max(1.0, float(np.abs(r).max()))
            assert _max_err(g_.numpy(), r) <= tol, name
    if masked:
        assert bool(torch.all(got[0][:, 3] == 0))
        assert bool(torch.all(got[3][:, 3] == 0))


@pytest.mark.parametrize("c", [1.0, 0.7])
def test_poincare_small_bwd_model_q_equals_k_rows(c):
    """q = k: each diagonal pair's x2 − 2g + y2 is rounding noise, which
    the 1e-15 guard keeps finite; the gradients stay finite (their diagonal
    terms are fp32 cancellation noise, so finite is all that is held)."""
    rng = np.random.default_rng(5)
    q = _ball(rng, c, 2, 12, 8)
    v, w = _arr(rng, 2, 12, 8), _arr(rng, 2, 12, 8)
    got = poincare_small_bwd_model(_t(q), _t(q.copy()), _t(v), None, _t(w),
                                   c, _sfu(True, seed=6))
    assert all(bool(torch.isfinite(g_).all()) for g_ in got)
