"""The oblique flash forward's epilogue and row sums, on the CPU.

The oblique register forward of ``csrc/flash_mhgsa_fwd.cu`` (F: the
metric policy ``ObliqueFwd`` of ``flash_fwd_kernel``) gives each thread a
query row q̂_i and walks the keys a staged tile at a time
(``flash_tile::sweep_tile``), each key's unit form k̂_j made in shared memory
once its tile has landed; every valid key adds its weight to the row's sum
and its weighted value to the row's accumulator, in key order. The weight
is ``oblique::weight`` (``csrc/oblique.cuh``), the TPU kernel's own epilogue
(``sttode_tpu/kernels/mhgsa.py::_acos``) on the SFU:

  gc = clip(g, ±(1 − 1e-4)), a = |gc|, x = 1 − a
  r = acos(a) = x·rsqrt(x)·Σ a_i a^i        (Abramowitz & Stegun 4.4.46)
  e = ex2(−r·log2 e) where gc ≥ 0, else e^(−π)·ex2(r·log2 e)

and the row ends with out = acc / max(l, 1e-30), lse = log(max(l, 1e-30))
in IEEE. ``flash_fwd_model`` below is a torch model of that, each SFU op
(rsqrt, ex2) exact or moved by its PTX error bound (2⁻²¹ relative, signs
at random). From numpy-seeded inputs it is held

- in float64 with exact SFU ops, the weight to exp(−acos(gc)) within 1e-7
  relative (the polynomial's 2e-8), and within 2e-6 with the SFU ops at
  their bounds;
- in float32, SFU ops at their bounds, to ``_flash_fwd`` of the JAX package
  in interpret mode and to the port's plain ``flash_geodesic_attention_
  reference``: out within 1e-5, lse within 1e-6 × max(1, |lse|) row by row;
- a problem with no valid key: out exactly 0, lse = log(1e-30);
- the model's lse and out, fed to the oblique sweeps' model
  (``tests/test_torch_oblique_sweep.py::oblique_sweeps``), against
  ``jax.grad`` of the JAX flash kernel in interpret mode within
  5e-5 × max(1, max |g|): the forward and the sweeps that replay its lse
  share one acos.

Cases: head dims 8, 16 and 64, L and S not multiples of the staged tile
(128 keys at Dh ≤ 32, 64 at Dh = 64), a random key validity with one
problem whose keys are all invalid.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sttode_tpu.kernels import mhgsa as jm
from sttode_tpu_torch.kernels import mhgsa as km
from tests.test_torch_oblique_sweep import _poly, _sfu, _tile, oblique_sweeps

# one intra-op thread: pytest-xdist runs 6 workers on 8 cores, and
# torch's default of one thread a core each oversubscribes them
torch.set_num_threads(1)

LOG2E = 1.4426950408889634
EXP_NEG_PI = math.exp(-math.pi)
OUT_TOL = 1e-5            # attention outputs, the port's tolerance
LSE_TOL = 1e-6            # lse, × max(1, |lse|) row by row
GRAD_TOL = 5e-5           # the sweeps' tolerance, × max(1, max |g|)


def weight(g, sfu):
    """Model of ``oblique::weight`` in g's dtype: exp(−acos(clip(g)))."""
    gc = torch.clamp(g, -1.0 + km.EPS, 1.0 - km.EPS)
    a = gc.abs()
    x = 1.0 - a
    r = x * sfu("rsqrt", x) * _poly(a)            # acos(|gc|)
    e = sfu("ex2", torch.where(gc >= 0, -r, r) * LOG2E)
    return torch.where(gc >= 0, e, EXP_NEG_PI * e)


def flash_fwd_model(q, k, v, val, sfu):
    """Model of F on q [B,L,Dh], k/v [B,S,Dh] and val [B,S] or None:
    (out, lse), each row's sums taken key after key, a staged tile at a
    time, an invalid key skipped."""
    qh, _ = km._unit(q)
    kh, _ = km._unit(k)
    B, L, Dh = q.shape
    S, T = k.shape[1], _tile(Dh)
    l = torch.zeros(B, L, dtype=q.dtype)
    acc = torch.zeros_like(q)
    for j0 in range(0, S, T):
        for j in range(j0, min(j0 + T, S)):
            e = weight((qh * kh[:, None, j, :]).sum(-1), sfu)
            if val is not None:
                e = torch.where(val[:, j, None] > 0, e, 0.0)
            l = l + e
            acc = acc + e[..., None] * v[:, None, j, :]
    lf = torch.clamp(l, min=1e-30)
    return acc / lf[..., None], torch.log(lf)


# (name, B, L, S, Dh, validity)
CASES = [
    ("dh8_two_tiles", 2, 37, 150, 8, None),
    ("dh16_three_tiles_ragged", 1, 45, 300, 16, None),
    ("dh64_three_tiles", 2, 20, 150, 64, None),
    ("kv_valid_no_key_problem", 3, 24, 140, 8, "random"),
]


def _case(case, seed=0):
    """q, k, v, val and do of a case, from a numpy seed (the last problem
    of a random validity has no valid key)."""
    _, B, L, S, Dh, validity = case
    rng = np.random.default_rng(seed + L * 11 + S + Dh)

    def arr(*s):
        return torch.from_numpy(rng.standard_normal(s).astype(np.float32))

    q, k, v, do = arr(B, L, Dh), arr(B, S, Dh), arr(B, S, Dh), arr(B, L, Dh)
    val = None
    if validity == "random":
        val = torch.from_numpy((rng.random((B, S)) < 0.7).astype(np.float32))
        val[-1] = 0.0
    return q, k, v, val, do


def _assert_fwd(out, lse, want_out, want_lse):
    assert float((out - want_out).abs().max()) <= OUT_TOL
    rel = (lse.double() - want_lse.double()).abs() / \
        want_lse.double().abs().clamp(min=1.0)
    assert float(rel.max()) <= LSE_TOL


def _jax_fwd(q, k, v, val):
    """out and lse of the JAX package's flash forward in interpret mode."""
    out, res = jm._flash_fwd(
        *(jnp.asarray(x.numpy()) for x in (q, k, v)),
        None if val is None else jnp.asarray(val.numpy()), True)
    return (torch.from_numpy(np.array(out)),
            torch.from_numpy(np.array(res[-1])[:, :q.shape[1], 0]))


@pytest.mark.parametrize("perturb", [False, True])
def test_weight_is_exp_neg_acos_in_float64(perturb):
    """The weight model in float64 against exp(−acos(gc)): within 1e-7
    relative with exact SFU ops (the polynomial's 2e-8 in acos), 2e-6 with
    rsqrt and ex2 at their error bounds; a negative Gram's e^(−π)·2^(r·log2
    e) is exp(−(π − r))."""
    g = torch.linspace(-1.2, 1.2, 40001, dtype=torch.float64)
    gc = torch.clamp(g, -1.0 + km.EPS, 1.0 - km.EPS)
    e = weight(g, _sfu(perturb, seed=5))
    want = torch.exp(-torch.arccos(gc))
    assert float(((e - want) / want).abs().max()) <= (2e-6 if perturb
                                                       else 1e-7)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_fwd_model_matches_jax_interpret(case):
    """The model (float32, SFU ops at their bounds) against the JAX
    package's ``_flash_fwd`` in interpret mode: out within 1e-5, lse within
    1e-6 × max(1, |lse|)."""
    q, k, v, val, _ = _case(case)
    out, lse = flash_fwd_model(q, k, v, val, _sfu(True, seed=len(case[0])))
    _assert_fwd(out, lse, *_jax_fwd(q, k, v, val))


@pytest.mark.parametrize("perturb", [False, True])
@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_fwd_model_matches_plain_forward(case, perturb):
    """The model against the port's plain flash forward (torch's acos and
    exp, a matrix product): out within 1e-5, lse within 1e-6 × max(1,
    |lse|)."""
    q, k, v, val, _ = _case(case, seed=1)
    out, lse = flash_fwd_model(q, k, v, val, _sfu(perturb, seed=7))
    _assert_fwd(out, lse,
                *km.flash_geodesic_attention_reference(q, k, v, val))


def test_problem_with_no_valid_key():
    """A problem whose keys are all invalid: out exactly 0 and lse exactly
    log(1e-30) in float32 (the floored sum), as in JAX."""
    case = next(c for c in CASES if c[5] == "random")
    q, k, v, val, _ = _case(case)
    out, lse = flash_fwd_model(q, k, v, val, _sfu(True))
    assert bool(torch.all(out[-1] == 0))
    assert bool(torch.all(lse[-1] == torch.log(torch.tensor(1e-30))))
    _, jlse = _jax_fwd(q, k, v, val)
    assert bool(torch.all(lse[-1] == jlse[-1]))


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_sweeps_from_the_model_lse_match_jax_grad(case):
    """The oblique sweeps' model replayed from this model's lse and
    δ = rowsum(do ⊙ out), SFU ops at their bounds in both, against
    ``jax.grad`` of the JAX flash kernel in interpret mode, within
    5e-5 × max(1, max |g|)."""
    q, k, v, val, do = _case(case, seed=2)
    out, lse = flash_fwd_model(q, k, v, val, _sfu(True, seed=11))
    got = oblique_sweeps(q, k, v, val, do, lse, torch.sum(do * out, dim=-1),
                         _sfu(True, seed=13))
    kv = None if val is None else jnp.asarray(val.numpy())

    def loss(q_, k_, v_):
        o = jm.flash_geodesic_attention(q_, k_, v_, kv_valid=kv,
                                        interpret=True)
        return jnp.sum(o * jnp.asarray(do.numpy()))

    want = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(x.numpy()) for x in (q, k, v)))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        w = torch.from_numpy(np.array(w))
        assert bool(torch.isfinite(g).all()), name
        err = float((g.double() - w.double()).abs().max())
        assert err <= GRAD_TOL * max(1.0, float(w.abs().max())), name
