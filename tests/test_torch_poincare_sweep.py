"""The poincaré flash backward sweeps' epilogue algebra, on the CPU.

The register sweeps of ``csrc/flash_mhgsa_bwd.cu`` replay each pair's score
and its VJP with ``poincare::sweep_grad`` (``csrc/poincare.cuh``), which
trades the plain formulas' divisions, sqrt, log and exp for the SFU's
approximate reciprocal, rsqrt, log2 and exp2:

  r = 1/(den + ε), A = den·r², n² = m·A; ρ = 1/√(n² + 1e-15), n = (n² +
  1e-15)·ρ, ½/n = ½ρ; w = 1/max((1 − zc)(1 + zc), 1e-12) and (1 + zc)/(1 −
  zc) = (1 + zc)²·w; p = 2^(−log2((1 + zc)/(1 − zc))/√c − lse·log2 e), or
  e^(−lse)·(1 − zc)²·w at c = 1; dn2 = −p·(dp − δ)·w·ρ, Bd = m·(ε − den)·r³.

``sweep_grad`` below is a torch model of that function, step by step, with
each SFU op either correctly rounded or moved by its PTX error bound (rcp,
rsqrt and ex2 by 2⁻²¹ relative, lg2 by 2⁻²² absolute, signs drawn at
random). It is held to the plain per-pair terms of ``kernels/mhgsa.py``
(``_poincare_pieces``, ``_poincare_score_from_pieces``,
``_poincare_grad_pieces``) and to ``flash_dq_reference`` and
``flash_dkv_reference``:

- in float64, with exact SFU ops, the algebra is the plain formulas (1e-9
  of each term's largest magnitude);
- in float32, against the float64 plain terms on the same inputs, each
  pair's p and dg and each sum dx2, dy2 is within 1e-5 (mid-ball and close
  pairs);
- assembled as the kernels assemble dq and dk/dv, within the card's
  tolerance for the sweeps, 5e-5 × max(1, max |g|), of the plain sweeps
  (mid-ball);
- at the ball's edge, where every pair clamps at zc = 1 − 1e-5, p within
  1e-5 and dv within 5e-5 of the plain version.

Cases: mid-ball pairs at c ∈ {1, 0.7, 0.05} and head dims 8, 16 and 64;
rows at the ball's edge; close pairs (k = q + 1e-4·noise). Edge and close
rows lie on a grid of 2^-b with 2^2b/c < 2²⁴, where the Gram, the squared
norms and x2 − 2g + y2 are exact in fp32 in any summation order; else
those cancel (close pairs) or artanh amplifies their rounding (the edge)
far beyond any tolerance, for the plain formulas as for the kernels. Even
so dq and dk stay ill-conditioned there (the last test shows the plain
formulas moving by more than the tolerance when one rounding moves), so
the card holds them to finiteness in those cases. Inputs from numpy
seeds.
"""

import math

import numpy as np
import pytest
import torch

from sttode_tpu_torch.kernels import mhgsa as km
from sttode_tpu_torch.nn.attention import to_ball

# one intra-op thread: pytest-xdist runs 6 workers on 8 cores, and
# torch's default of one thread a core each oversubscribes them
torch.set_num_threads(1)

LOG2E = 1.4426950408889634
SFU_REL = 2.0 ** -21      # rcp, rsqrt, ex2: PTX bounds of 1–2 ulp
LG2_ABS = 2.0 ** -22      # lg2.approx: absolute error bound
PAIR_TOL = 1e-5           # fp32 per-pair terms, × each term's max magnitude
GRAD_TOL = 5e-5           # the sweeps' card tolerance, × max(1, max |g|)


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


def sweep_grad(g, x2, y2, lse, delta, dp, c, sfu, c1=None):
    """Model of ``poincare::sweep_grad`` in the inputs' dtype: (p, dg, a, b)
    per pair; lse and delta broadcast over the pair's row. ``c1`` picks the
    c = 1 form (default: c == 1, as the kernels choose at launch)."""
    c1 = (c == 1.0) if c1 is None else c1
    dt = g.dtype
    c_, c2 = torch.tensor(c, dtype=dt), torch.tensor(c * c, dtype=dt)
    sqrt_c = torch.sqrt(c_)
    inv_sqrt_c = 1.0 / sqrt_c
    raw = x2 - 2.0 * g + y2
    m = torch.clamp(raw, min=0.0)
    den = 1.0 - 2.0 * c_ * g + c2 * x2 * y2
    r = sfu("rcp", den + km.DENOM_EPS)
    r2 = r * r
    A = den * r2
    t = m * A + 1e-15
    rho = sfu("rsqrt", t)
    zc = torch.clamp(sqrt_c * (t * rho), max=1.0 - km.ARTANH_EPS)
    om, op = 1.0 - zc, 1.0 + zc
    w = sfu("rcp", torch.clamp(om * op, min=1e-12))
    if c1:
        p = torch.exp(-lse) * (om * om * w)
    else:
        p = sfu("ex2", -inv_sqrt_c * sfu("lg2", op * op * w) - lse * LOG2E)
    dn2 = -(p * (dp - delta)) * (w * rho)
    Bd = m * (km.DENOM_EPS - den) * (r2 * r)
    a = torch.where(raw > 0.0, dn2 * A, 0.0)
    b = dn2 * c2 * Bd
    return p, -2.0 * a - 2.0 * c_ * dn2 * Bd, a, b


def _grid(x, c):
    """x truncated to a grid of 2^-b, 2^2b·max ‖x‖² = 2^2b/c < 2²⁴: every
    product, partial sum and x2 − 2g + y2 of these rows is exact in fp32."""
    s = 2.0 ** math.floor(12 + math.log2(c) / 2)
    return torch.trunc(x * s) / s


def _case(kind, c, Dh, seed, L=48, S=40):
    """(q, k, v, do) of one problem [1, L or S, Dh]: ball points and
    standard normal v and do."""
    rng = np.random.default_rng(seed)

    def arr(*s):
        return torch.from_numpy(rng.standard_normal(s).astype(np.float32))

    scale = 0.5 / (c * Dh) ** 0.5
    if kind == "mid":
        q, k = to_ball(scale * arr(1, L, Dh), c), to_ball(scale * arr(1, S, Dh), c)
    elif kind == "edge":
        # rows at the ball's edge (the ball map's projection to
        # (1 − 1e-3)/√c) in two opposite cones, so that every pair's
        # zc = √c·n clamps at 1 − 1e-5
        axis = torch.zeros(Dh)
        axis[0] = 1.0
        q = to_ball(40.0 * (axis + 0.2 / Dh ** 0.5 * arr(1, L, Dh)), c)
        k = to_ball(40.0 * (-axis + 0.2 / Dh ** 0.5 * arr(1, S, Dh)), c)
        q, k = _grid(q, c), _grid(k, c)
    elif kind == "close":
        q = _grid(to_ball(scale * arr(1, L, Dh), c), c)
        k = _grid(q[:, :S] + 1e-4 * arr(1, S, Dh), c)
    else:
        raise ValueError(kind)
    return q, k, arr(1, S, Dh), arr(1, L, Dh)


def _replay(q, k, v, do, c):
    """The plain sweeps' operands on one problem: the pieces, the forward's
    lse and δ, and do·vᵀ (all in q's dtype)."""
    out, lse = km.flash_geodesic_attention_reference(q, k, v, None,
                                                     "poincare", c)
    delta = torch.sum(do * out, dim=-1)
    return (km._poincare_pieces(q, k, c), lse, delta,
            do @ v.transpose(-1, -2))


def _plain_terms(q, k, v, do, c):
    """The plain per-pair p and dg and the row/column sums dx2, dy2."""
    pieces, lse, delta, dpv = _replay(q, k, v, do, c)
    p = torch.exp(km._poincare_score_from_pieces(pieces[-1], c)
                  - lse[..., None])
    dg, dx2, dy2 = km._poincare_grad_pieces(pieces, p * (dpv - delta[..., None]),
                                            c)
    return p, dg, dx2[..., 0], dy2[..., 0], (lse, delta, dpv)


def _model_terms(q, k, v, do, c, sfu, replay=None, c1=None):
    """The model's p, dg, dx2 = Σ_j (a + b·y2), dy2 = Σ_i (a + b·x2) and
    the sums' scales Σ_j |a + b·y2|, Σ_i |a + b·x2|, on the replay's lse,
    δ and do·vᵀ (default: its own, in q's dtype)."""
    pieces, lse, delta, dpv = replay or _replay(q, k, v, do, c)
    g, x2, y2 = pieces[:3]
    p, dg, a, b = sweep_grad(g, x2, y2, lse[..., None], delta[..., None], dpv,
                             c, sfu, c1)
    ex, ey = a + b * y2, a + b * x2
    return (p, dg, ex.sum(-1), ey.sum(-2)), (ex.abs().sum(-1),
                                             ey.abs().sum(-2))


def _err(a, b, scale=None):
    """max |a − b| over the largest magnitude of b (or of ``scale``)."""
    ref = b if scale is None else scale
    return float((a.double() - b.double()).abs().max()) / max(
        float(ref.double().abs().max()), 1e-30)


def _assemble(p, dg, dx2, dy2, q, k, do):
    """dq, dk, dv as the kernels assemble them."""
    return (dg @ k + 2.0 * dx2[..., None] * q,
            dg.transpose(-1, -2) @ q + 2.0 * dy2[..., None] * k,
            p.transpose(-1, -2) @ do)


def _grad_err(got, want):
    """Each gradient's max abs error over max(1, max |g|)."""
    return [float((g - w).abs().max()) / max(1.0, float(w.abs().max()))
            for g, w in zip(got, want)]


CASES = [dict(kind="mid", c=c, Dh=Dh) for c in (1.0, 0.7, 0.05)
         for Dh in (8, 16, 64)] + \
    [dict(kind=kind, c=c, Dh=Dh) for kind in ("edge", "close")
     for c in (1.0, 0.7, 0.05) for Dh in (8, 64)]


def _id(case):
    return f"{case['kind']}-c{case['c']}-dh{case['Dh']}"


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_sweep_algebra_equals_plain_formulas_in_float64(case):
    """In float64 with exact SFU ops the rewritten algebra (the shared
    reciprocal, the rsqrt form of n and ½/n, p through exp2/log2 and the
    c = 1 form) is the plain formulas: each term within 1e-9 of its
    largest magnitude (float64 rounding, amplified at the ball's edge by
    the cancellation of dg's two terms)."""
    q, k, v, do = (t.double() for t in _case(**case, seed=3))
    want = _plain_terms(q, k, v, do, case["c"])
    for c1 in {False, case["c"] == 1.0}:
        got, _ = _model_terms(q, k, v, do, case["c"], _sfu(False), c1=c1)
        for name, g, w in zip(("p", "dg", "dx2", "dy2"), got, want):
            assert _err(g, w) <= 1e-9, (name, c1)


@pytest.mark.parametrize("perturb", [False, True])
@pytest.mark.parametrize("case", [c for c in CASES if c["kind"] != "edge"],
                         ids=_id)
def test_sweep_epilogue_fp32_per_pair(case, perturb):
    """In float32, with the SFU ops correctly rounded or moved by their
    error bounds, each pair's p and dg is within 1e-5 of its term's largest
    magnitude in the float64 plain version on the same float32 inputs, and
    each sum dx2, dy2 within 1e-5 of its largest sum of magnitudes; the
    replay's lse, δ and do·vᵀ are the float64 plain version's rounded to
    float32, so that only the epilogue differs."""
    c = case["c"]
    q, k, v, do = _case(**case, seed=5)
    want = _plain_terms(*(t.double() for t in (q, k, v, do)), c)
    pieces = _replay(q, k, v, do, c)[0]
    replay = (pieces, *(t.float() for t in want[4]))
    got, scales = _model_terms(q, k, v, do, c, _sfu(perturb), replay=replay)
    for name, g, w, sc in zip(("p", "dg", "dx2", "dy2"), got, want,
                              (None, None, *scales)):
        assert _err(g, w, sc) <= PAIR_TOL, name


@pytest.mark.parametrize("case", [c for c in CASES if c["kind"] == "mid"],
                         ids=_id)
def test_sweep_epilogue_assembled_matches_flash_references(case):
    """The model (SFU ops at their error bounds), assembled as the kernels
    assemble it — dq = Σ_j dg·k_j + 2·dx2·q, dk = Σ_i dg·q_i + 2·dy2·k,
    dv = Σ_i p·do_i — against ``flash_dq_reference`` and
    ``flash_dkv_reference`` in float32, within 5e-5 × max(1, max |g|)."""
    c = case["c"]
    q, k, v, do = _case(**case, seed=7)
    replay = _replay(q, k, v, do, c)
    got = _assemble(*_model_terms(q, k, v, do, c, _sfu(True), replay)[0],
                    q, k, do)
    args = (q, k, v, None, do, replay[1], replay[2], "poincare", c)
    want = (km.flash_dq_reference(*args), *km.flash_dkv_reference(*args))
    assert max(_grad_err(got, want)) <= GRAD_TOL


@pytest.mark.parametrize("case", [c for c in CASES if c["kind"] == "edge"],
                         ids=_id)
def test_sweep_epilogue_at_the_ball_edge(case):
    """Rows at the ball's edge, every pair clamped at zc = 1 − 1e-5: the
    model's p (SFU ops at their error bounds) within 1e-5 relative of the
    plain version's in float32 (both clamp at float32(1 − 1e-5)), dv within
    5e-5 × max(1, max |dv|), and every term finite."""
    c = case["c"]
    q, k, v, do = _case(**case, seed=9)
    replay = _replay(q, k, v, do, c)
    zc = replay[0][-1]
    assert bool(torch.all(zc == np.float32(1.0 - km.ARTANH_EPS)))
    got, _ = _model_terms(q, k, v, do, c, _sfu(True), replay)
    want = _plain_terms(q, k, v, do, c)
    assert _err(got[0], want[0]) <= PAIR_TOL
    assert all(bool(torch.isfinite(t).all()) for t in got)
    dv = _assemble(*got, q, k, do)[2]
    args = (q, k, v, None, do, replay[1], replay[2], "poincare", c)
    assert _grad_err([dv], [km.flash_dkv_reference(*args)[1]])[0] <= GRAD_TOL


@pytest.mark.parametrize("case", [c for c in CASES if c["kind"] != "mid"
                                  and c["Dh"] == 8], ids=_id)
def test_edge_and_close_gradients_are_ill_conditioned_in_fp32(case):
    """Why the card holds dq and dk at the edge and close cases to
    finiteness only: at the recipe's head dim the plain formulas
    themselves, run twice in float32 with one rounding moved, differ by
    more than the sweeps' tolerance of 5e-5 × max(1, max |g|). At the edge, den − c·m =
    (1 − c·x2)(1 − c·y2) ≈ 4e-6 of den is what dg keeps of its two terms,
    so rounding den once less (x2·y2 fused, as a compiler contracts it)
    moves dq; for close pairs dg·k and 2·dx2·q cancel to ~1e-4 of their
    size, so summing dg·k in another order moves dq."""
    c = case["c"]
    q, k, v, do = _case(**case, seed=5)
    pieces, lse, delta, dpv = _replay(q, k, v, do, c)
    args = (q, k, v, None, do, lse, delta, "poincare", c)
    want = km.flash_dq_reference(*args)
    g, x2, y2, m = pieces[:4]
    if case["kind"] == "edge":
        den = (1.0 - 2.0 * c * g.double()
               + (c * c) * x2.double() * y2.double()).float()
        n = torch.sqrt(m * den / ((den + km.DENOM_EPS) ** 2) + 1e-15)
        zc = torch.clamp((c ** 0.5) * n, max=1.0 - km.ARTANH_EPS)
        pieces = (g, x2, y2, m, den, None, n, zc)
    p = torch.exp(km._poincare_score_from_pieces(pieces[-1], c)
                  - lse[..., None])
    dg, dx2, _ = km._poincare_grad_pieces(pieces, p * (dpv - delta[..., None]),
                                          c)
    dgk = (dg.double() @ k.double()).float() if case["kind"] == "close" \
        else dg @ k
    assert _grad_err([dgk + 2.0 * dx2 * q], [want])[0] > GRAD_TOL
