"""The oblique whole-S backward's small-S mode, on the CPU.

At small shapes kernel C (``csrc/mhgsa_bwd.cu``) runs the small-S mode of
``csrc/small_bwd.cuh``: one block per problem; pass 1 gives each thread a
query row and a slice of the keys and, since ds = p (dp − δ) with
δ = Σ_j p dp, sums in one pass den = Σ e, Σ e·dp, A = Σ gate·e·dp·k̂_j and
B = Σ gate·e·k̂_j, so that δ = Σ e·dp / den and dq̂ = (A − δ·B) / den; pass 2
gives each thread a key and a slice of the rows and replays p = e·(1/den)
and ds = p (dp − δ) for dv, dk̂ and dmask. The pair epilogue is the TPU
kernel's own (``sttode_tpu/kernels/mhgsa.py::_acos``): acos from the
Abramowitz & Stegun 4.4.46 polynomial with √x as x·rsqrt(x), e = exp(−acos
+ m) as one ex2, and the gate rsqrt(max(1 − gc², 1e-12)) where the
unclipped |g| < 1 − 1e-4.

- ``small_bwd_layout`` and ``small_bwd_mode`` (the Python forms of the
  kernel's ``layout`` and ``mode``) at the paths' shapes and the mode's
  bounds;
- the epilogue in float64, each SFU op (rsqrt, ex2) moved by its PTX error
  bound (2⁻²¹ relative, signs at random), against exp(−acos(gc) + m) within
  2e-6 relative (the bound's 2⁻²¹ three times over, and the polynomial's
  2e-8) and the gate against 1/√(1 − gc²) within 1e-6 relative, exactly 0
  outside the clip; an excluded entry's weight exactly 0;
- ``small_bwd_model``, a float32 torch model of the two passes (the slices'
  partial sums added in slice order, the SFU ops at their bounds), against
  ``jax.grad`` of the JAX package's fused kernel in interpret mode (dq, dk,
  dv) and the port's plain backward (dq, dk, dv, dmask) within the card's
  tolerance 5e-5 × max(1, max |g|); an all-excluded row's gradients exactly
  0;
- the packed backward (kernel Q, ``csrc/packed_mhgsa_bwd.cu``), which runs
  the same body with a key validity in place of the mask (each pair's e
  multiplied by val[b, j]): ``small_bwd_layout(..., val=True)`` and
  ``packed_bwd_small`` at Q's shapes, and the model with the validity
  against ``jax.grad`` of the JAX package's ``packed_geodesic_attention``
  in interpret mode and the port's plain packed backward, within 5e-5 ×
  max(1, max |g|), at the NBA recipe's 11 × 8 × 32² × 8, 64 × 8 × 8² × 8
  with a validity and an all-invalid problem, a rectangular 4 × 8 × 16 × 8
  with S = 64 and 2 × 16 × 8² × 8 (H·Dh = 128); an all-invalid problem's
  gradients exactly 0, and q = k rows an exactly zero, finite gradient.

Inputs from numpy seeds.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sttode_tpu.kernels import mhgsa as jm
from sttode_tpu.kernels import packed_mhgsa as jpacked
from sttode_tpu_torch.kernels import mhgsa as km
from sttode_tpu_torch.kernels import packed_mhgsa as kp

# one intra-op thread: pytest-xdist runs 6 workers on 8 cores, and
# torch's default of one thread a core each oversubscribes them
torch.set_num_threads(1)

LOG2E = 1.4426950408889634
SFU_REL = 2.0 ** -21      # rsqrt, ex2: PTX bounds of 1–2 ulp
GRAD_TOL = 5e-5           # the card's gradient tolerance, × max(1, max |g|)
# sttode_tpu/kernels/mhgsa.py::_ACOS_COEFFS, highest degree last
ACOS = (1.5707963050, -0.2145988016, 0.0889789874, -0.0501743046,
        0.0308918810, -0.0170881256, 0.0066700901, -0.0012624911)


def _sfu(perturb, seed=0):
    """rsqrt and ex2: exact, or each result moved by its error bound with a
    random sign."""
    gen = torch.Generator().manual_seed(seed)

    def op(name, x):
        y = torch.rsqrt(x) if name == "rsqrt" else torch.exp2(x)
        if not perturb:
            return y
        sign = torch.randint(0, 2, y.shape, generator=gen).to(y.dtype) * 2 - 1
        return y * (1 + sign * SFU_REL)
    return op


def pair_terms(g, m, sfu):
    """Model of ``small_bwd::pair_terms`` in g's dtype: (e, gate)."""
    gc = torch.clamp(g, -1.0 + km.EPS, 1.0 - km.EPS)
    a = gc.abs()
    p = torch.full_like(a, ACOS[-1])
    for coef in ACOS[-2::-1]:
        p = p * a + coef
    x = 1.0 - a
    r = x * sfu("rsqrt", x) * p                   # acos(|gc|)
    s = torch.where(gc >= 0, -r, r - math.pi)     # −acos(gc)
    e = sfu("ex2", (s + m) * LOG2E)
    gate = torch.where(g.abs() < 1.0 - km.EPS,
                       sfu("rsqrt", torch.clamp(1.0 - gc * gc, min=1e-12)),
                       0.0)
    return e, gate


def _slice_sum(x, slices, dim):
    """Σ over ``dim`` as the kernel takes it: each slice its entries
    ≡ slice (mod slices), the slices' partials added in slice order."""
    parts = [x.index_select(dim, torch.arange(s, x.shape[dim], slices))
             .sum(dim) for s in range(slices)]
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def small_bwd_model(q, k, v, mask, do, sfu, val=None):
    """Model of the small-S mode on q [B,L,Dh], k/v [B,S,Dh], a
    canonicalized mask [B,L,S] or None and do [B,L,Dh]: (dq, dk, dv,
    dmask). ``val`` [B,S] (the packed backward's key validity, one row a
    problem) multiplies each pair's e, and the layout is then the packed
    one."""
    L, S, Dh = q.shape[1], k.shape[1], q.shape[2]
    lay = km.small_bwd_layout(L, S, Dh, val=val is not None)
    qn, q_norm = km._unit(q)
    kn, k_norm = km._unit(k)
    g = qn @ kn.transpose(-1, -2)
    dp = do @ v.transpose(-1, -2)
    e, gate = pair_terms(g, 0.0 if mask is None else mask, sfu)
    if val is not None:
        e = e * val[:, None, :]
    # pass 1: a row's sums over its keys, in one pass
    w = gate * e
    s1 = lay["slices1"]
    den = _slice_sum(e, s1, 2)
    edp = _slice_sum(e * dp, s1, 2)
    A = _slice_sum((w * dp)[..., None] * kn[:, None], s1, 2)
    Bv = _slice_sum(w[..., None] * kn[:, None], s1, 2)
    dn = torch.clamp(den, min=1e-30)
    dl = edp / dn
    dq = km._normalize_vjp((A - dl[..., None] * Bv) / dn[..., None], qn,
                           q_norm)
    # pass 2: a key's sums over the rows, p and ds replayed
    p = e * (1.0 / dn)[..., None]
    ds = p * (dp - dl[..., None])
    s2 = lay["slices2"]
    dv = _slice_sum(p[..., None] * do[:, :, None], s2, 1)
    dkh = _slice_sum((gate * ds)[..., None] * qn[:, :, None], s2, 1)
    return dq, km._normalize_vjp(dkh, kn, k_norm), dv, ds


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
    (128, 128, 8, 128, 8, 128, 8, 1024),      # the bench recipe's training
    (8, 8, 8, 8, 2, 8, 2, 32),                # the agent-axis server
    (32, 32, 8, 32, 8, 32, 8, 256),           # the NBA recipe
    (1, 1, 8, 1, 1, 1, 1, 32),
    (1024, 1024, 8, 512, 1, 512, 1, 512),     # halved to fit shared memory
    (700, 40, 16, 512, 1, 64, 8, 512),        # two row rounds in pass 1
    (512, 512, 16, 512, 1, 512, 1, 512),
    (256, 256, 32, 256, 1, 256, 1, 256)])
def test_small_bwd_layout(L, S, Dh, rows1, slices1, keys2, slices2, threads):
    lay = km.small_bwd_layout(L, S, Dh)
    assert (lay["rows1"], lay["slices1"], lay["keys2"], lay["slices2"],
            lay["threads"]) == (rows1, slices1, keys2, slices2, threads)
    assert lay["threads"] <= {8: 1024, 16: 512, 32: 256}[lay["DH"]]
    assert max(rows1 * slices1, keys2 * slices2) <= lay["threads"]
    assert lay["threads"] % 32 == 0
    assert lay["smem_bytes"] <= km.SMEM_OPTIN_BYTES


@pytest.mark.parametrize("L,S,Dh,taken", [
    (128, 128, 8, True), (8, 8, 8, True), (1, 1, 8, True),
    (1024, 1024, 8, True),           # 10× faster there (PERF.md §6)
    (2048, 2048, 8, False),          # beyond shared memory
    (300, 1100, 5, True),
    (8, 8, 16, False), (16, 16, 16, True),     # Dh ≤ 16 from S = 16
    (16, 16, 32, False), (32, 32, 32, True),   # Dh ≤ 32 from S = 32
    (512, 512, 32, False),           # beyond shared memory
    (64, 64, 33, False), (64, 64, 64, False)])
def test_small_bwd_mode(L, S, Dh, taken):
    assert km.small_bwd_mode(L, S, Dh) is taken


# --------------------------------------------------------------------------- #
# the epilogue in float64                                                     #
# --------------------------------------------------------------------------- #

# m = −lse of a flash sweep's row (oblique.cuh's sweep_p shares this
# epilogue): a row of 2304 keys at g = 1 (lse = log 2304) and a row whose
# one key sits at g = −1 (lse = −π)
@pytest.mark.parametrize("m", [0.0, -3.7, -30.0, km.NEG_INF,
                               -math.log(2304.0), math.pi])
@pytest.mark.parametrize("perturb", [False, True])
def test_epilogue_is_exp_neg_acos_and_gate(m, perturb):
    g = torch.linspace(-1.2, 1.2, 40001, dtype=torch.float64)
    gc = torch.clamp(g, -1.0 + km.EPS, 1.0 - km.EPS)
    e, gate = pair_terms(g, m, _sfu(perturb, seed=int(-m) % 97))
    want = torch.exp(-torch.arccos(gc) + m)
    if m == km.NEG_INF:
        assert bool(torch.all(e == 0))
    else:
        assert float(((e - want) / want).abs().max()) <= 2e-6
    inside = g.abs() < 1.0 - km.EPS
    want_gate = 1.0 / torch.sqrt(1.0 - gc * gc)
    assert float(((gate - want_gate) / want_gate)[inside].abs().max()) \
        <= 1e-6
    assert bool(torch.all(gate[~inside] == 0))


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


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("B,L,S,Dh", [(3, 32, 32, 8), (2, 40, 24, 16),
                                      (2, 9, 130, 8)])
def test_small_bwd_model_matches_jax(B, L, S, Dh, masked):
    rng = np.random.default_rng(L * 7 + S + masked)
    q, k, v = _arr(rng, B, L, Dh), _arr(rng, B, S, Dh), _arr(rng, B, S, Dh)
    w = _arr(rng, B, L, Dh)                       # the output's cotangent
    raw = _raw_mask(rng, B, L, S) if masked else None
    assert km.small_bwd_mode(L, S, Dh)

    def loss(q_, k_, v_):
        o = jm.fused_geodesic_attention(
            q_, k_, v_, mask=None if raw is None else jnp.asarray(raw),
            interpret=True)
        return jnp.sum(o * jnp.asarray(w))

    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    mask = None if raw is None else km._canonicalize_mask(_t(raw))
    got = small_bwd_model(_t(q), _t(k), _t(v), mask, _t(w),
                          _sfu(True, seed=L + S))
    plain = km.fused_geodesic_attention_backward_reference(
        _t(q), _t(k), _t(v), mask, _t(w), masked)
    for name, g_, jw, pw in zip(("dq", "dk", "dv", "dmask"), got,
                                (*want, None), plain):
        if pw is None:
            continue
        ref = [np.asarray(x) for x in (jw, pw) if x is not None]
        for r in ref:
            tol = GRAD_TOL * max(1.0, float(np.abs(r).max()))
            assert _max_err(g_.numpy(), r) <= tol, name
    if masked:
        assert bool(torch.all(got[0][:, 3] == 0))
        assert bool(torch.all(got[3][:, 3] == 0))


# --------------------------------------------------------------------------- #
# the packed backward (kernel Q) on the same body, with the key validity      #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("L,S,Dh,rows1,slices1,keys2,slices2,threads,small", [
    (32, 32, 8, 32, 8, 32, 8, 256, True),     # the NBA recipe
    (8, 8, 8, 8, 2, 8, 2, 32, True),          # 64 × 8 agent problems
    (16, 64, 8, 16, 16, 64, 4, 256, True),    # rectangular
    (1, 1, 8, 1, 1, 1, 1, 32, True),          # the launch floor
    (1, 1024, 8, 1, 256, 1024, 1, 1024, True),  # L·S = 32², S > 32
    (32, 32, 32, 32, 8, 32, 8, 256, True),    # H = 4, Dh = 32
    (1024, 1, 32, 32, 1, 1, 32, 32, False)])   # beyond shared memory
def test_packed_small_bwd_layout(L, S, Dh, rows1, slices1, keys2, slices2,
                                 threads, small):
    """``small_bwd_layout(..., val=True)`` at Q's shapes: the layout of the
    mask-free body, S floats more shared memory for the validity, and
    ``packed_bwd_small`` whether the body takes the problem."""
    lay = km.small_bwd_layout(L, S, Dh, val=True)
    plain = km.small_bwd_layout(L, S, Dh)
    assert (lay["rows1"], lay["slices1"], lay["keys2"], lay["slices2"],
            lay["threads"]) == (rows1, slices1, keys2, slices2, threads)
    assert lay["smem_bytes"] == plain["smem_bytes"] + 4 * S
    assert kp.packed_bwd_small(L, S, Dh) is small
    assert (lay["smem_bytes"] <= km.SMEM_OPTIN_BYTES) is small
    assert not kp.packed_bwd_small(8, 8, 64)      # Dh > 32: the warp kernel


def _packed_case(rng, B, H, L, S, Dh, validity):
    """q, k, v, do [B,H,·,Dh] and the validity [B,S] (or None): random,
    and with ``one_dead`` the first batch row without a valid key."""
    q, k, v = (_arr(rng, B, H, n, Dh) for n in (L, S, S))
    do = _arr(rng, B, H, L, Dh)
    val = None
    if validity is not None:
        val = (rng.random((B, S)) < 0.7).astype(np.float32)
        if validity == "one_dead":
            val[0] = 0.0
    return q, k, v, do, val


def _packed_model(q, k, v, do, val, sfu):
    """The model on the [B·H] problems of a packed call, each taking its
    batch row's validity: (dq, dk, dv) [B,H,·,Dh]."""
    B, H, L, Dh = q.shape
    S = k.shape[2]
    flat = [_t(x).reshape(B * H, -1, Dh) for x in (q, k, v, do)]
    vf = None if val is None else _t(val).repeat_interleave(H, dim=0)
    dq, dk, dv, _ = small_bwd_model(*flat[:3], None, flat[3], sfu, val=vf)
    return (dq.reshape(B, H, L, Dh), dk.reshape(B, H, S, Dh),
            dv.reshape(B, H, S, Dh))


@pytest.mark.parametrize("B,H,L,S,Dh,validity", [
    (11, 8, 32, 32, 8, None),                 # the NBA recipe
    (64, 8, 8, 8, 8, "one_dead"),             # validity, a dead problem
    (4, 8, 16, 64, 8, "random"),              # rectangular
    (2, 16, 8, 8, 8, "random")])              # H·Dh = 128
def test_packed_model_matches_jax(B, H, L, S, Dh, validity):
    """The model with the validity (float32, SFU ops at their bounds)
    against ``jax.grad`` of the JAX package's packed kernel in interpret
    mode and the port's plain packed backward, within 5e-5 × max(1, max
    |g|); a problem with no valid key gets exactly zero gradients."""
    rng = np.random.default_rng(B * 7 + L + S)
    q, k, v, do, val = _packed_case(rng, B, H, L, S, Dh, validity)
    assert kp.packed_bwd_small(L, S, Dh)
    kv = None if val is None else jnp.asarray(val)

    def loss(q_, k_, v_):
        o = jpacked.packed_geodesic_attention(q_, k_, v_, kv_valid=kv,
                                              interpret=True)
        return jnp.sum(o * jnp.asarray(do))

    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = _packed_model(q, k, v, do, val, _sfu(True, seed=B + H))
    plain = kp.packed_geodesic_attention_backward_reference(
        _t(q), _t(k), _t(v), None if val is None else _t(val), _t(do))
    for name, g_, jw, pw in zip(("dq", "dk", "dv"), got, want, plain):
        assert bool(torch.isfinite(g_).all()), name
        for r in (np.asarray(jw), pw.numpy()):
            tol = GRAD_TOL * max(1.0, float(np.abs(r).max()))
            assert _max_err(g_.numpy(), r) <= tol, name
    if validity == "one_dead":
        assert all(bool(torch.all(g_[0] == 0)) for g_ in got)


def test_packed_model_q_equals_k_rows():
    """q = k: every diagonal pair has g ≥ 1 − 1e-4 in float32, so its gate
    is exactly 0 and adds exactly nothing to dq and dk; the gradients stay
    finite and equal the plain backward's. A problem of one row whose one
    key is its query gets dq = dk = 0 exactly."""
    rng = np.random.default_rng(3)
    q, _, v, do, val = _packed_case(rng, 2, 2, 6, 6, 8, "random")
    k = q.copy()
    qn = km._unit(_t(q).reshape(4, 6, 8))[0]
    _, gate = pair_terms(qn @ qn.transpose(-1, -2), 0.0, _sfu(False))
    assert bool(torch.all(torch.diagonal(gate, dim1=-2, dim2=-1) == 0))
    got = _packed_model(q, k, v, do, val, _sfu(True, seed=4))
    plain = kp.packed_geodesic_attention_backward_reference(
        _t(q), _t(k), _t(v), _t(val), _t(do))
    for g_, w in zip(got, plain):
        assert bool(torch.isfinite(g_).all())
        assert _max_err(g_.numpy(), w.numpy()) <= \
            GRAD_TOL * max(1.0, float(w.abs().max()))
    one = _arr(rng, 1, 1, 1, 8)
    dq, dk, _ = _packed_model(one, one.copy(), _arr(rng, 1, 1, 1, 8),
                              _arr(rng, 1, 1, 1, 8), None, _sfu(True))
    assert bool(torch.all(dq == 0)) and bool(torch.all(dk == 0))
