"""The small-shape attention forward kernels' arithmetic, on the CPU.

Kernel P (``csrc/packed_mhgsa_fwd.cu``) and the whole-S forward's small-S
mode (``csrc/mhgsa_fwd.cu``: 1p, and A at the same shapes) run the body of
``csrc/small_fwd.cuh``: lane = query row, the keys split into ``slices``
(``kernels.mhgsa.small_fwd_layout``) whose partial sums are combined in
slice order, and epilogues on the SFU's approximate ops:

- oblique: e = exp(−acos(clip(g))) from the TPU kernel's own Abramowitz &
  Stegun 4.4.46 polynomial (``sttode_tpu/kernels/mhgsa.py::_acos``),
  r = √(1 − |gc|)·poly(|gc|) with √x = x·rsqrt(x), e = 2^(−r·log2 e), or
  e^(−π)·2^(r·log2 e) for gc < 0;
- poincaré (``poincare::fwd_weight``): zc as the plain formulas compute it
  (IEEE fp32: n² = m·den/(den + ε)², zc = min(√c·√(n² + 1e-15), 1 − 1e-5)),
  then e = (1 − zc)·rcp(1 + zc) at c = 1, else
  2^(−lg2((1 + zc)·rcp(1 − zc))/√c);
- key validity multiplies e; a mask entry m multiplies it by 2^(m·log2 e).

``small_fwd_model`` below is a torch model of that body, step by step, with
each SFU op correctly rounded or moved by its PTX error bound (rcp, rsqrt
and ex2 by 2⁻²¹ relative, lg2 by 2⁻²² absolute, signs drawn at random),
summed in the kernels' key-split order. It is held to the JAX package's
Pallas kernels in interpret mode (``packed_geodesic_attention`` for P,
``fused_geodesic_attention`` for 1p and A) within the card tolerance 1e-5;
the epilogues' algebra is held to the plain formulas in float64 (1e-9). The
last tests hold the wrappers' lean launch path (the forward without the
autograd Function when no gradient can flow) to the Function path and, with
gradients, to ``jax.grad`` of the interpret kernels (5e-5 × max(1, max |g|),
the port's attention-gradient tolerance). Inputs from numpy seeds.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sttode_tpu.kernels import mhgsa as jm
from sttode_tpu.kernels import packed_mhgsa as jp
from sttode_tpu_torch.kernels import mhgsa as km
from sttode_tpu_torch.kernels import packed_mhgsa as kp
from sttode_tpu_torch.nn.attention import to_ball

# one intra-op thread: pytest-xdist runs 6 workers on 8 cores, and
# torch's default of one thread a core each oversubscribes them
torch.set_num_threads(1)

LOG2E = 1.4426950408889634
EXP_NEG_PI = math.exp(-math.pi)
SFU_REL = 2.0 ** -21      # rcp, rsqrt, ex2: PTX bounds of 1–2 ulp
LG2_ABS = 2.0 ** -22      # lg2.approx: absolute error bound
ATTN_TOL = 1e-5           # the card's forward tolerance
GRAD_TOL = 5e-5           # × max(1, max |g|)
# sttode_tpu/kernels/mhgsa.py::_ACOS_COEFFS, highest degree last
ACOS = (1.5707963050, -0.2145988016, 0.0889789874, -0.0501743046,
        0.0308918810, -0.0170881256, 0.0066700901, -0.0012624911)


def _sfu(perturb, seed=0):
    """The SFU ops of the model: correctly rounded, or each result moved by
    its error bound with a random sign."""
    gen = torch.Generator().manual_seed(seed)

    def op(name, x):
        y = {"rcp": lambda: 1.0 / x, "rsqrt": lambda: torch.rsqrt(x),
             "lg2": lambda: torch.log2(x), "ex2": lambda: torch.exp2(x)}[name]()
        if not perturb:
            return y
        sign = torch.randint(0, 2, y.shape, generator=gen).to(y.dtype) * 2 - 1
        return y + sign * LG2_ABS if name == "lg2" else y * (1 + sign * SFU_REL)
    return op


def oblique_weight(g, sfu):
    """Model of ``small_fwd::oblique_weight`` in g's dtype."""
    gc = torch.clamp(g, -1.0 + km.EPS, 1.0 - km.EPS)
    a = gc.abs()
    p = torch.full_like(a, ACOS[-1])
    for coef in ACOS[-2::-1]:
        p = p * a + coef
    x = 1.0 - a
    r = x * sfu("rsqrt", x) * p
    e = sfu("ex2", torch.where(gc >= 0, -r, r) * LOG2E)
    return torch.where(gc >= 0, e, EXP_NEG_PI * e)


def poincare_weight(g, x2, y2, c, sfu):
    """Model of ``poincare::fwd_weight`` in g's dtype (the c = 1 form when
    c == 1, as the kernel chooses at launch): zc from ``poincare::pair``
    (IEEE), the tail on the SFU."""
    m = torch.clamp(x2 - 2.0 * g + y2, min=0.0)
    den = 1.0 - 2.0 * c * g + (c * c) * x2 * y2
    n = torch.sqrt(m * den / ((den + km.DENOM_EPS) * (den + km.DENOM_EPS))
                   + 1e-15)
    zc = torch.clamp(c ** 0.5 * n, max=1.0 - km.ARTANH_EPS)
    if c == 1.0:
        return (1.0 - zc) * sfu("rcp", 1.0 + zc)
    return sfu("ex2", -(1.0 / c ** 0.5) * sfu("lg2", (1.0 + zc)
                                                * sfu("rcp", 1.0 - zc)))


def small_fwd_model(q, k, v, *, val=None, H=1, mask=None, metric="oblique",
                    c=1.0, sfu=None):
    """Model of ``small_fwd::body`` on q [P,L,Dh], k/v [P,S,Dh], the
    validity [P/H,S] or None and a canonicalized mask [P,L,S] or None:
    each slice sums its keys (j ≡ slice mod slices) in order, the slices
    are added in order, one division ends the row."""
    sfu = sfu or _sfu(False)
    P, L, Dh = q.shape
    S = k.shape[1]
    slices = km.small_fwd_layout(L, S, Dh)["slices"]
    if metric == "oblique":
        qn, _ = km._unit(q)
        kn, _ = km._unit(k)
        e = oblique_weight(qn @ kn.transpose(-1, -2), sfu)
    else:
        x2 = torch.sum(q * q, dim=-1, keepdim=True)
        y2 = torch.sum(k * k, dim=-1)[:, None, :]
        e = poincare_weight(q @ k.transpose(-1, -2), x2, y2, c, sfu)
    if val is not None:
        e = e * val.repeat_interleave(H, dim=0)[:, None, :]
    if mask is not None:
        e = e * sfu("ex2", mask * LOG2E)
    acc = torch.zeros(P, L, slices, Dh, dtype=q.dtype)
    den = torch.zeros(P, L, slices, dtype=q.dtype)
    for j in range(S):
        s = j % slices
        acc[:, :, s] = acc[:, :, s] + e[:, :, j, None] * v[:, None, j]
        den[:, :, s] = den[:, :, s] + e[:, :, j]
    a, d = acc[:, :, 0], den[:, :, 0]
    for s in range(1, slices):
        a, d = a + acc[:, :, s], d + den[:, :, s]
    return a / torch.clamp(d, min=1e-30)[..., None]


def _arr(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _max_err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def _raw_mask(rng, B, L, S):
    """An additive mask with finite entries, finfo.min exclusions and one
    all-excluded row per problem."""
    m = np.where(rng.random((B, L, S)) < 0.3, np.finfo(np.float32).min,
                 3.0 * _arr(rng, B, L, S) + 2.0).astype(np.float32)
    m[:, 3, :] = np.finfo(np.float32).min
    return m


# --------------------------------------------------------------------------- #
# the layout                                                                  #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("L,S,Dh,rows,slices,blocks", [
    (32, 32, 8, 32, 8, 1),        # the NBA recipe: one warp per slice
    (8, 128, 8, 8, 32, 1),        # the route's extremes, L·S ≤ 32²
    (1024, 1, 8, 32, 1, 32),
    (1, 1024, 8, 1, 128, 1),
    (8, 8, 8, 8, 2, 1),           # the agent-axis server
    (1, 1, 8, 1, 1, 1),
    (128, 128, 8, 32, 8, 4),      # the NBA recipe's evaluation
    (32, 32, 128, 32, 4, 1)])
def test_small_fwd_layout(L, S, Dh, rows, slices, blocks):
    lay = km.small_fwd_layout(L, S, Dh)
    assert (lay["rows"], lay["slices"], lay["blocks_per_problem"]) == \
        (rows, slices, blocks)
    threads = lay["rows"] * lay["slices"]
    assert threads <= (256 if lay["DH"] <= 32 else 128)
    assert lay["tile"] % lay["slices"] == 0
    assert lay["smem_bytes"] <= 227 * 1024


# --------------------------------------------------------------------------- #
# the epilogues' algebra in float64                                           #
# --------------------------------------------------------------------------- #

def test_oblique_weight_is_exp_neg_acos():
    """The polynomial epilogue with exact ops is exp(−acos(gc)) within the
    A&S bound (|Δacos| ≤ 2e-8, so e moves by ≤ 2e-8 relative)."""
    g = torch.linspace(-1.2, 1.2, 20001, dtype=torch.float64)
    gc = torch.clamp(g, -1.0 + km.EPS, 1.0 - km.EPS)
    got = oblique_weight(g, _sfu(False))
    want = torch.exp(-torch.arccos(gc))
    assert float(((got - want) / want).abs().max()) <= 2.5e-8


@pytest.mark.parametrize("c", [1.0, 0.7, 0.05])
def test_poincare_weight_is_exp_score(c):
    """In float64 with exact ops, fwd_weight is exp of the plain score
    (``_poincare_pieces``, ``_poincare_score_from_pieces``) to 1e-9: at
    c = 1 the identity e = (1 − zc)/(1 + zc), no log or exp."""
    rng = np.random.default_rng(3)
    q = to_ball(_t(_arr(rng, 4, 32, 8)).double() * (0.5 / (8 * c) ** 0.5), c)
    k = to_ball(_t(_arr(rng, 4, 32, 8)).double() * (0.5 / (8 * c) ** 0.5), c)
    k[:, :4] = q[:, :4]                         # equal points: zc at 0
    pieces = km._poincare_pieces(q, k, c)
    g, x2, y2 = pieces[:3]
    want = torch.exp(km._poincare_score_from_pieces(pieces[-1], c))
    got = poincare_weight(g, x2, y2, c, _sfu(False))
    assert float((got - want).abs().max()) <= 1e-9
    if c == 1.0:
        zc = pieces[-1]
        assert float(((1 - zc) / (1 + zc) - want).abs().max()) <= 1e-9


# --------------------------------------------------------------------------- #
# the models against the JAX package                                          #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("perturb", [False, True])
@pytest.mark.parametrize("B,H,L,S", [(2, 2, 32, 32), (1, 2, 8, 128)])
def test_packed_model_matches_jax(B, H, L, S, perturb):
    """P's model against JAX's packed kernel (interpret) with a key validity
    whose problem 0 has no valid key: within 1e-5, and that problem exactly
    0 (validity multiplies e, the denominator is floored at 1e-30)."""
    rng = np.random.default_rng(5 + S)
    q, k, v = (_arr(rng, B, H, n, 8) for n in (L, S, S))
    val = (rng.random((B, S)) < 0.7).astype(np.float32)
    val[0] = 0.0
    want = np.asarray(jp.packed_geodesic_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        kv_valid=jnp.asarray(val), interpret=True))
    got = small_fwd_model(*(_t(x).reshape(B * H, -1, 8) for x in (q, k, v)),
                          val=_t(val), H=H, sfu=_sfu(perturb, seed=S))
    got = got.reshape(B, H, L, 8).numpy()
    assert _max_err(got, want) <= ATTN_TOL
    assert np.all(got[0] == 0.0)
    plain = kp.packed_geodesic_attention(_t(q), _t(k), _t(v),
                                         kv_valid=_t(val))
    assert _max_err(got, plain.numpy()) <= ATTN_TOL


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("c", [1.0, 0.7, 0.05])
def test_poincare_small_model_matches_jax(c, masked):
    """1p's model (SFU ops at their bounds) against JAX's fused kernel
    (interpret, metric "poincare") on ball points, with and without a
    canonicalized mask: within 1e-5; an all-excluded row is exactly 0."""
    rng = np.random.default_rng(int(c * 100) + masked)
    B, L, S = 3, 32, 32
    q = to_ball(_t(_arr(rng, B, L, 8)) * (0.5 / (8 * c) ** 0.5), c).numpy()
    k = to_ball(_t(_arr(rng, B, S, 8)) * (0.5 / (8 * c) ** 0.5), c).numpy()
    v = _arr(rng, B, S, 8)
    raw = _raw_mask(rng, B, L, S) if masked else None
    want = np.asarray(jm.fused_geodesic_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        mask=None if raw is None else jnp.asarray(raw), interpret=True,
        metric="poincare", curvature=c))
    mask = None if raw is None else km._canonicalize_mask(_t(raw))
    got = small_fwd_model(_t(q), _t(k), _t(v), mask=mask, metric="poincare",
                          c=c, sfu=_sfu(True, seed=7)).numpy()
    assert _max_err(got, want) <= ATTN_TOL
    if masked:
        assert np.all(got[:, 3] == 0.0)
    plain = km.fused_geodesic_attention(
        _t(q), _t(k), _t(v), mask=None if raw is None else _t(raw),
        metric="poincare", curvature=c)
    assert _max_err(got, plain.numpy()) <= ATTN_TOL


@pytest.mark.parametrize("masked", [False, True])
def test_oblique_small_model_matches_jax(masked):
    """The small-S mode's oblique branch (kernel A at these shapes) against
    JAX's fused kernel (interpret): within 1e-5."""
    rng = np.random.default_rng(11 + masked)
    B, L, S = 3, 32, 32
    q, k, v = _arr(rng, B, L, 8), _arr(rng, B, S, 8), _arr(rng, B, S, 8)
    raw = _raw_mask(rng, B, L, S) if masked else None
    want = np.asarray(jm.fused_geodesic_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        mask=None if raw is None else jnp.asarray(raw), interpret=True))
    mask = None if raw is None else km._canonicalize_mask(_t(raw))
    got = small_fwd_model(_t(q), _t(k), _t(v), mask=mask,
                          sfu=_sfu(True, seed=9)).numpy()
    assert _max_err(got, want) <= ATTN_TOL
    if masked:
        assert np.all(got[:, 3] == 0.0)


# --------------------------------------------------------------------------- #
# the lean launch path                                                        #
# --------------------------------------------------------------------------- #

def _loss_weights(rng, shape):
    return _arr(rng, *shape)


def test_packed_lean_path_and_gradients():
    """Without a gradient the packed wrapper calls the forward directly (no
    autograd node); with one it goes through the Function, with the same
    output, and its gradients equal ``jax.grad`` of JAX's packed kernel."""
    rng = np.random.default_rng(21)
    q, k, v = (_arr(rng, 2, 4, 32, 8) for _ in range(3))
    val = (rng.random((2, 32)) < 0.8).astype(np.float32)
    w = _loss_weights(rng, q.shape)
    direct = kp.packed_geodesic_attention(_t(q), _t(k), _t(v),
                                          kv_valid=_t(val))
    assert direct.grad_fn is None
    tq, tk, tv = (_t(x).clone().requires_grad_(True) for x in (q, k, v))
    with torch.no_grad():
        assert kp.packed_geodesic_attention(tq, tk, tv,
                                            kv_valid=_t(val)).grad_fn is None
    out = kp.packed_geodesic_attention(tq, tk, tv, kv_valid=_t(val))
    assert "_PackedCore" in type(out.grad_fn).__name__
    assert torch.equal(out.detach(), direct)
    (out * _t(w)).sum().backward()

    def loss(q_, k_, v_):
        o = jp.packed_geodesic_attention(q_, k_, v_,
                                         kv_valid=jnp.asarray(val),
                                         interpret=True)
        return jnp.sum(o * jnp.asarray(w))

    grads = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for got, want in zip((tq.grad, tk.grad, tv.grad), grads):
        want = np.asarray(want)
        assert _max_err(got.numpy(), want) <= \
            GRAD_TOL * max(1.0, float(np.abs(want).max()))


def test_fused_poincare_lean_path_and_gradients():
    """The same for the whole-S wrapper, poincaré at c = 1 with a mask:
    direct call without a gradient, the Function with one, gradients
    (q, k, v) against ``jax.grad`` of JAX's fused kernel (interpret)."""
    rng = np.random.default_rng(22)
    B, L, S, c = 3, 32, 32, 1.0
    q = to_ball(_t(_arr(rng, B, L, 8)) * (0.5 / 8 ** 0.5), c).numpy()
    k = to_ball(_t(_arr(rng, B, S, 8)) * (0.5 / 8 ** 0.5), c).numpy()
    v = _arr(rng, B, S, 8)
    raw = _raw_mask(rng, B, L, S)
    w = _loss_weights(rng, q.shape)
    kw = dict(metric="poincare", curvature=c)
    direct = km.fused_geodesic_attention(_t(q), _t(k), _t(v), mask=_t(raw),
                                         **kw)
    assert direct.grad_fn is None
    tq, tk, tv = (_t(x).clone().requires_grad_(True) for x in (q, k, v))
    with torch.inference_mode():
        assert km.fused_geodesic_attention(tq, tk, tv, mask=_t(raw),
                                           **kw).grad_fn is None
    out = km.fused_geodesic_attention(tq, tk, tv, mask=_t(raw), **kw)
    assert "_FusedCore" in type(out.grad_fn).__name__
    assert torch.equal(out.detach(), direct)
    (out * _t(w)).sum().backward()

    def loss(q_, k_, v_):
        o = jm.fused_geodesic_attention(q_, k_, v_, mask=jnp.asarray(raw),
                                        interpret=True, **kw)
        return jnp.sum(o * jnp.asarray(w))

    grads = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for got, want in zip((tq.grad, tk.grad, tv.grad), grads):
        want = np.asarray(want)
        assert _max_err(got.numpy(), want) <= \
            GRAD_TOL * max(1.0, float(np.abs(want).max()))
