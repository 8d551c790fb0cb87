"""The oblique flash backward sweeps' epilogue and assembly, on the CPU.

The oblique register sweeps of ``csrc/flash_mhgsa_bwd.cu`` (the dq sweep
and the dk/dv sweep) replay each pair's probability and score cotangent
with ``oblique::sweep_p`` (``csrc/oblique.cuh``), the TPU kernel's own
epilogue (``sttode_tpu/kernels/mhgsa.py::_acos``) on the SFU:

  gc = clip(g, ±(1 − 1e-4)), a = |gc|, x = 1 − a
  acos(a) = x·rsqrt(x)·Σ a_i a^i            (Abramowitz & Stegun 4.4.46)
  s = −acos(a) where gc ≥ 0, else acos(a) − π
  p = ex2(s·log2 e − lse·log2 e)           (lse·log2 e once per row)
  gate = rsqrt(max(1 − gc², 1e-12)) where the unclipped |g| < 1 − 1e-4,
         else 0
  dg = p·(do·v − δ)·gate

and assemble dq̂_i = Σ_j dg_ij k̂_j, dk̂_j = Σ_i dg_ij q̂_i and
dv_j = Σ_i p_ij do_i a tile of the other axis at a time, each pair added in
order, then the normalize VJP. ``oblique_sweeps`` below is a torch model of
that, with each SFU op (rsqrt, ex2) either exact or moved by its PTX error
bound (2⁻²¹ relative, signs at random). From numpy-seeded inputs it is held

- in float64 with exact SFU ops to the plain formulas with the TPU kernel's
  polynomial acos: each pair's p and dg and the assembled dq, dk, dv within
  1e-9 of their largest magnitude;
- in float32, SFU ops exact or at their bounds, to the port's
  ``flash_dq_reference`` and ``flash_dkv_reference`` within the card's
  tolerance 5e-5 × max(1, max |g|);
- to ``jax.grad`` of the JAX package's ``flash_geodesic_attention`` in
  interpret mode, within the same tolerance.

Cases: head dims 8, 16 and 64 (one, two and two tiles of the other axis),
ragged L ≠ S, a random key validity with one problem whose keys are all
invalid (its dq, dk and dv exactly 0) and q = k (every diagonal pair at the
clip: a finite, exactly zero gate).
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
SFU_REL = 2.0 ** -21      # rsqrt, ex2: PTX bounds of 1–2 ulp
GRAD_TOL = 5e-5           # the sweeps' card tolerance, × max(1, max |g|)
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


def _poly(a):
    p = torch.full_like(a, ACOS[-1])
    for coef in ACOS[-2::-1]:
        p = p * a + coef
    return p


def sweep_p(g, row, sfu):
    """Model of ``oblique::sweep_p`` in g's dtype: (p, gate), ``row`` the
    row's lse·log2 e."""
    gc = torch.clamp(g, -1.0 + km.EPS, 1.0 - km.EPS)
    a = gc.abs()
    x = 1.0 - a
    r = x * sfu("rsqrt", x) * _poly(a)            # acos(|gc|)
    s = torch.where(gc >= 0, -r, r - math.pi)     # −acos(gc)
    p = sfu("ex2", s * LOG2E - row)
    gate = torch.where(g.abs() < 1.0 - km.EPS,
                       sfu("rsqrt", torch.clamp(1.0 - gc * gc, min=1e-12)),
                       0.0)
    return p, gate


def _tile(Dh):
    """Rows of the other axis a sweep stages at a time
    (``flash_tile::sweep_tile``)."""
    DH = next(d for d in (8, 16, 32, 64, 128) if Dh <= d)
    return 128 if DH <= 32 else 4096 // DH


def _pairs(q, k, v, val, do, lse, delta, sfu):
    """The unit rows, their norms, and each pair's p and dg as the sweeps
    replay them (an invalid key's pairs p = dg = 0: the kernels skip it)."""
    qh, qn = km._unit(q)
    kh, kn = km._unit(k)
    p, gate = sweep_p(qh @ kh.transpose(-1, -2), (lse * LOG2E)[..., None],
                      sfu)
    if val is not None:
        p = torch.where(val[:, None, :] > 0, p, 0.0)
    dg = p * (do @ v.transpose(-1, -2) - delta[..., None]) * gate
    return qh, qn, kh, kn, p, dg, gate


def oblique_sweeps(q, k, v, val, do, lse, delta, sfu):
    """Model of the two oblique register sweeps on q [B,L,Dh], k/v [B,S,Dh],
    val [B,S] or None, do [B,L,Dh], lse and δ [B,L]: (dq, dk, dv), each sum
    taken a staged tile at a time, pair after pair in the kernels' order."""
    qh, qn, kh, kn, p, dg, _ = _pairs(q, k, v, val, do, lse, delta, sfu)
    L, S, T = q.shape[1], k.shape[1], _tile(q.shape[2])
    dqh = torch.zeros_like(q)
    for j0 in range(0, S, T):                     # dq sweep: key tiles
        for j in range(j0, min(j0 + T, S)):
            dqh = dqh + dg[:, :, j, None] * kh[:, None, j, :]
    dkh, dv = torch.zeros_like(k), torch.zeros_like(v)
    for i0 in range(0, L, T):                     # dk/dv sweep: row tiles
        for i in range(i0, min(i0 + T, L)):
            dv = dv + p[:, i, :, None] * do[:, None, i, :]
            dkh = dkh + dg[:, i, :, None] * qh[:, None, i, :]
    return km._normalize_vjp(dqh, qh, qn), km._normalize_vjp(dkh, kh, kn), dv


def _plain(q, k, v, val, do, lse, delta):
    """The plain formulas with the TPU kernel's polynomial acos: p, dg and
    (dq, dk, dv) by matrix products."""
    qh, qn = km._unit(q)
    kh, kn = km._unit(k)
    g = qh @ kh.transpose(-1, -2)
    gc = torch.clamp(g, -1.0 + km.EPS, 1.0 - km.EPS)
    r = torch.sqrt(1.0 - gc.abs()) * _poly(gc.abs())
    p = torch.exp(-torch.where(gc >= 0, r, math.pi - r) - lse[..., None])
    if val is not None:
        p = torch.where(val[:, None, :] > 0, p, 0.0)
    ds = p * (do @ v.transpose(-1, -2) - delta[..., None])
    dg = km._score_grad(g, gc, ds)
    return p, dg, (km._normalize_vjp(dg @ kh, qh, qn),
                   km._normalize_vjp(dg.transpose(-1, -2) @ qh, kh, kn),
                   p.transpose(-1, -2) @ do)


# (name, B, L, S, Dh, validity)
CASES = [
    ("dh8", 2, 40, 56, 8, None),
    ("dh16_ragged_two_tiles", 1, 33, 150, 16, None),
    ("dh64_two_tiles", 2, 20, 70, 64, None),
    ("kv_valid_all_invalid_problem", 3, 24, 140, 8, "random"),
    ("q_equals_k", 2, 30, 30, 8, "identical"),
]


def _case(case, dtype=torch.float32, seed=0):
    """q, k, v, val and do of a case (do also the forward output's
    cotangent of the JAX loss), from a numpy seed."""
    _, B, L, S, Dh, validity = case
    rng = np.random.default_rng(seed + L * 7 + S + Dh)

    def arr(*s):
        return rng.standard_normal(s).astype(np.float32)

    q, k, v, do = arr(B, L, Dh), arr(B, S, Dh), arr(B, S, Dh), arr(B, L, Dh)
    val = None
    if validity == "random":
        val = (rng.random((B, S)) < 0.7).astype(np.float32)
        val[-1] = 0.0                     # the last problem has no valid key
    elif validity == "identical":
        k = q.copy()
    t = [torch.from_numpy(x).to(dtype) for x in (q, k, v, do)]
    return (*t[:3], None if val is None else torch.from_numpy(val), t[3])


def _replay(q, k, v, val, do):
    """The sweeps' lse and δ = rowsum(do ⊙ out) from the plain forward."""
    out, lse = km.flash_geodesic_attention_reference(q, k, v, val)
    return lse, torch.sum(do * out, dim=-1)


def _rel(a, b):
    return float((a.double() - b.double()).abs().max()) / max(
        float(b.double().abs().max()), 1e-30)


def _grad_err(got, want):
    """Each gradient's max abs error over max(1, max |g|)."""
    return [float((g.double() - w.double()).abs().max())
            / max(1.0, float(w.abs().max())) for g, w in zip(got, want)]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_sweep_model_equals_plain_formulas_in_float64(case):
    """With exact SFU ops in float64, x·rsqrt(x) is √x and the ex2 of
    s·log2 e − lse·log2 e is exp(s − lse): each pair's p and dg and the
    tile-by-tile sums equal the plain formulas (the same polynomial acos,
    matrix products) within 1e-9 of each one's largest magnitude."""
    q, k, v, val, do = _case(case, torch.float64)
    lse, delta = _replay(q, k, v, val, do)
    p, dg, want = _plain(q, k, v, val, do, lse, delta)
    *_, p_m, dg_m, _ = _pairs(q, k, v, val, do, lse, delta, _sfu(False))
    assert _rel(p_m, p) <= 1e-9
    assert _rel(dg_m, dg) <= 1e-9
    got = oblique_sweeps(q, k, v, val, do, lse, delta, _sfu(False))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert _rel(g, w) <= 1e-9, name


@pytest.mark.parametrize("perturb", [False, True])
@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_sweep_model_matches_flash_references(case, perturb):
    """In float32, the SFU ops exact or at their error bounds, the model
    against ``flash_dq_reference`` and ``flash_dkv_reference`` (torch's
    acos and exp) on the same lse and δ, within 5e-5 × max(1, max |g|); a
    problem with no valid key gets exactly zero gradients."""
    q, k, v, val, do = _case(case)
    lse, delta = _replay(q, k, v, val, do)
    got = oblique_sweeps(q, k, v, val, do, lse, delta,
                         _sfu(perturb, seed=len(case[0])))
    args = (q, k, v, val, do, lse, delta)
    want = (km.flash_dq_reference(*args), *km.flash_dkv_reference(*args))
    assert all(bool(torch.isfinite(g).all()) for g in got)
    assert max(_grad_err(got, want)) <= GRAD_TOL
    if val is not None:
        assert all(bool(torch.all(g[-1] == 0)) for g in got)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_sweep_model_matches_jax_interpret(case):
    """The model (SFU ops at their error bounds, float32, on the port's
    plain forward's lse and δ) against ``jax.grad`` of the JAX package's
    flash kernel in interpret mode, within 5e-5 × max(1, max |g|)."""
    q, k, v, val, do = _case(case)
    lse, delta = _replay(q, k, v, val, do)
    got = oblique_sweeps(q, k, v, val, do, lse, delta, _sfu(True, seed=3))
    kv = None if val is None else jnp.asarray(val.numpy())

    def loss(q_, k_, v_):
        out = jm.flash_geodesic_attention(q_, k_, v_, kv_valid=kv,
                                          interpret=True)
        return jnp.sum(out * jnp.asarray(do.numpy()))

    want = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(x.numpy()) for x in (q, k, v)))
    want = [torch.from_numpy(np.array(w)) for w in want]
    assert max(_grad_err(got, want)) <= GRAD_TOL


def test_q_equals_k_gate_is_exactly_zero_and_finite():
    """q = k: every diagonal pair has g = q̂·q̂ ≥ 1 − 1e-4 in float32, so its
    gate is exactly 0 (no 1/√(1 − gc²) of a clipped g) and its dg exactly
    0; every gradient stays finite."""
    case = next(c for c in CASES if c[0] == "q_equals_k")
    q, k, v, val, do = _case(case)
    lse, delta = _replay(q, k, v, val, do)
    *_, p, dg, gate = _pairs(q, k, v, val, do, lse, delta, _sfu(True))
    diag = torch.diagonal(gate, dim1=-2, dim2=-1)
    assert bool(torch.all(diag == 0))
    assert bool(torch.all(torch.diagonal(dg, dim1=-2, dim2=-1) == 0))
    assert bool(torch.all(torch.diagonal(p, dim1=-2, dim2=-1) > 0))
    got = oblique_sweeps(q, k, v, val, do, lse, delta, _sfu(True))
    assert all(bool(torch.isfinite(g).all()) for g in got)
