"""The port's Poincaré-ball attention against the JAX package, on the CPU.

``sttode_tpu_torch.manifolds.pmath`` is held function by function to
``sttode_tpu.manifolds.pmath``; the poincaré branches of the geodesic-
attention wrappers (which run their plain versions on the CPU) to JAX's
``fused_geodesic_attention`` and ``flash_geodesic_attention`` with
``metric="poincare"``, whose Pallas kernels run in interpret mode off the
TPU, and to ``jax.grad`` through them; then the attention layer, the
training forward, inference, the CLIs, and the masked whole-S backward
beyond shared memory. The CUDA kernels are held to these plain versions on
the card by ``tests/test_torch_cuda.py``.

Tolerances:
- pmath values 1e-6 (relative 1e-6 where values are large; fp32 with other
  libm implementations), gradients 1e-5 (the clamped artanh's cotangent
  reaches 1/(2·1e-5), so at the ball's edge relative), except the distance
  gradient between two points at the ball's edge: 1e-4 relative, for the
  fp32 cancellation its VJP has there (see the test);
- the fused kernel: forward 1e-5, gradients 5e-5 × max(1, max |g|), the
  mask cotangent too (fp32 in other summation orders, through artanh);
- the flash kernel: forward 2e-5, gradients 1e-4 — the JAX suite's own for
  its flash kernel, whose value-side products are compensated 3-pass bf16
  (~6e-6), amplified by artanh;
- the attention layer against JAX's dense path 1e-5 (gradients 5e-5 ×
  max(1, max |g|)); the training forward and inference, every loss term,
  gradient leaf and forecast 1e-4 (the Euler step multiplies the encoder
  field by 12).
Points are mid-ball (inputs scaled by 0.3–0.5 before the ball map) where
values are compared: near the edge artanh amplifies fp32 rounding up to
~1e4×, and for coincident points the Gram's x2 − 2g + y2 cancels, so those
cases are held to finiteness only, as in the JAX suite.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sttode_tpu.data import preprocess as jprep
from sttode_tpu.data import synthetic as jsyn
from sttode_tpu.kernels import mhgsa as jmhgsa
from sttode_tpu.manifolds import pmath as jp
from sttode_tpu.models import sttode as jm
from sttode_tpu.nn import attention as jattn
from sttode_tpu_torch import bridge
from sttode_tpu_torch.cli import test as cli_test
from sttode_tpu_torch.cli import train as cli_train
from sttode_tpu_torch.data import preprocess as tprep
from sttode_tpu_torch.kernels import mhgsa as tmhgsa
from sttode_tpu_torch.manifolds import pmath as tp
from sttode_tpu_torch.models import sttode as tm
from sttode_tpu_torch.nn import attention as tattn
from sttode_tpu_torch.train import checkpoint as tck

# one intra-op thread: pytest-xdist runs 6 workers on 8 cores, and
# torch's default of one thread a core each oversubscribes them
torch.set_num_threads(1)

FUSED_TOL, FUSED_GRAD_TOL = 1e-5, 5e-5
FLASH_TOL, FLASH_GRAD_TOL = 2e-5, 1e-4
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)


def T(a, grad=False):
    return torch.from_numpy(np.array(a, np.float32)).requires_grad_(grad)


def jrun(fn, *args, **kw):
    with jax.default_matmul_precision("highest"):
        return jax.tree_util.tree_map(np.asarray, fn(*args, **kw))


def _launches():
    return (tmhgsa.fused_geodesic_attention.launches,
            tmhgsa.fused_geodesic_attention_backward.launches,
            tmhgsa.flash_geodesic_attention.launches,
            tmhgsa.flash_geodesic_attention_backward.launches_dq,
            tmhgsa.flash_geodesic_attention_backward.launches_dkv)


# --------------------------------------------------------------------------- #
# manifolds/pmath                                                             #
# --------------------------------------------------------------------------- #

def _points(seed, *shape, scale=0.3):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _ball(x, c=1.0):
    return np.asarray(jp.project(jp.expmap0(jnp.asarray(x), c=c), c=c))


def _edge(axes, c=1.0):
    """Ball points at the projected edge along ±e_a for a in ``axes``, and
    the origin. Edge points on orthogonal axes lie at a distance beyond
    artanh's clamp; the rows have one nonzero, so their squared norms and
    Gram entries are exact in any summation order (off the axes, a pair
    just inside the clamp amplifies fp32 rounding by up to 5e4)."""
    x = np.zeros((2 * len(axes) + 1, 5), np.float32)
    for i, a in enumerate(axes):
        x[2 * i, a], x[2 * i + 1, a] = 100.0, -100.0
    return _ball(x, c)


PMATH_CASES = {
    # name: (args of both, keyword arguments)
    "tanh": (lambda: [_points(1, 4, 5, scale=8.0)], {}),
    "artanh": (lambda: [np.linspace(-1.2, 1.2, 49, dtype=np.float32)], {}),
    "arsinh": (lambda: [_points(2, 4, 5, scale=3.0)], {}),
    "arcosh": (lambda: [np.linspace(0.0, 0.99, 21, dtype=np.float32)], {}),
    "riemannian_gradient": (lambda: [_ball(_points(3, 4, 5))], {}),
    "project": (lambda: [_points(4, 4, 5, scale=2.0)], {"c": 0.7}),
    "lambda_x": (lambda: [_ball(_points(5, 4, 5))], {"c": 0.7}),
    "mobius_add": (lambda: [_ball(_points(6, 4, 5)), _ball(_points(8, 4, 5))],
                   {"c": 0.7}),
    "_safe_norm": (lambda: [_points(9, 4, 5)], {}),
    "dist": (lambda: [_ball(_points(10, 4, 5)), _ball(_points(11, 4, 5))],
             {"c": 1.0}),
    "dist0": (lambda: [_ball(_points(12, 4, 5))], {"c": 2.0}),
    "expmap": (lambda: [_ball(_points(13, 4, 5)), _points(14, 4, 5)],
               {"c": 0.7}),
    "expmap0": (lambda: [_points(15, 4, 5, scale=1.0)], {"c": 0.7}),
    "logmap": (lambda: [_ball(_points(16, 4, 5)), _ball(_points(17, 4, 5))],
               {"c": 1.0}),
    "logmap0": (lambda: [_ball(_points(18, 4, 5))], {"c": 1.0}),
    "mobius_matvec": (lambda: [_points(19, 3, 5), _ball(_points(20, 4, 5))],
                      {"c": 1.0}),
    "mobius_addition_batch": (lambda: [_ball(_points(21, 4, 5)),
                                       _ball(_points(22, 3, 5))], {"c": 0.7}),
    "hyperbolic_softmax": (lambda: [_ball(_points(23, 4, 5)),
                                    _points(24, 3, 5),
                                    _ball(_points(25, 3, 5))], {"c": 1.0}),
    "p2k": (lambda: [_ball(_points(26, 4, 5))], {"c": 1.0}),
    "k2p": (lambda: [_ball(_points(27, 4, 5))], {"c": 1.0}),
    "lorenz_factor": (lambda: [_ball(_points(28, 4, 5))], {"c": 1.0}),
    "poincare_mean": (lambda: [_ball(_points(29, 4, 3, 5))], {"c": 1.0}),
    "dist_matrix": (lambda: [_ball(_points(30, 4, 5)),
                             _ball(_points(31, 3, 5))], {"c": 1.0}),
    "dist_matrix_gram": (lambda: [_ball(_points(32, 2, 4, 5)),
                                  _ball(_points(33, 2, 3, 5))], {"c": 0.7}),
}


@pytest.mark.parametrize("name", sorted(PMATH_CASES))
def test_pmath_values_match_jax(name):
    build, kw = PMATH_CASES[name]
    args = build()
    want = jrun(getattr(jp, name), *[jnp.asarray(a) for a in args], **kw)
    got = getattr(tp, name)(*[T(a) for a in args], **kw).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_pmath_edge_rows_and_auto_select_c():
    """Rows at the projected edge and the origin, through the attention
    path's functions (the distances saturate artanh's clamp: relative)."""
    x = _points(40, 6, 5, scale=40.0)
    x[1] = 0.0
    for c in (0.7, 1.0, 2.0):
        ball = jrun(jp.project, jrun(jp.expmap0, x, c=c), c=c)
        got = tp.project(tp.expmap0(T(x), c=c), c=c).numpy()
        np.testing.assert_allclose(got, ball, rtol=1e-6, atol=1e-6)
        # distances at the clamp and from the origin
        a, b = _edge((0, 1), c), _edge((2, 3), c)
        np.testing.assert_allclose(
            tp.dist_matrix_gram(T(a), T(b), c=c).numpy(),
            jrun(jp.dist_matrix_gram, a, b, c=c), rtol=1e-6, atol=1e-6)
    for d in (2, 5, 8, 64):
        assert tp.auto_select_c(d) == pytest.approx(jp.auto_select_c(d),
                                                    rel=1e-12)


def _grad_pair(jfn, tfn, args, tol=1e-5):
    """Gradients of Σ sin(f(args)) with respect to every argument."""
    def jloss(*a):
        return jnp.sum(jnp.sin(jfn(*a)))

    with jax.default_matmul_precision("highest"):
        want = jax.grad(jloss, argnums=tuple(range(len(args))))(
            *[jnp.asarray(a) for a in args])
    leaves = [T(a, True) for a in args]
    got = torch.autograd.grad(torch.sum(torch.sin(tfn(*leaves))), leaves)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.isfinite(g.numpy()).all()
        np.testing.assert_allclose(g.numpy(), w, rtol=tol, atol=tol)


@pytest.mark.parametrize("c", [0.7, 1.0, 2.0])
def test_pmath_gradients_match_jax(c):
    """artanh and arsinh (through their clamps), riemannian_gradient,
    project∘expmap0 (at the projected edge and the origin) and
    dist_matrix_gram, against jax.grad."""
    z = np.linspace(-1.1, 1.1, 45, dtype=np.float32)   # beyond the clamp
    _grad_pair(jp.artanh, tp.artanh, [z])
    _grad_pair(jp.arsinh, tp.arsinh, [_points(41, 7, scale=3.0)])
    b = _ball(_points(42, 4, 5), c)
    _grad_pair(lambda x: jp.riemannian_gradient(x, c) * x,
               lambda x: tp.riemannian_gradient(x, c) * x, [b])
    x = _points(43, 6, 5, scale=1.0)
    x[0] *= 40.0                          # beyond the projection radius
    x[1] = 0.0
    _grad_pair(lambda u: jp.project(jp.expmap0(u, c=c), c=c),
               lambda u: tp.project(tp.expmap0(u, c=c), c=c), [x])
    _grad_pair(lambda p, q: jp.dist_matrix_gram(p, q, c=c),
               lambda p, q: tp.dist_matrix_gram(p, q, c=c),
               [_ball(_points(44, 2, 5, 8), c), _ball(_points(45, 2, 6, 8),
                                                      c)])
    # at the artanh clamp the cotangent is ~5e4, and with both points at the
    # ball's edge the VJP of n² in x2 is den·(1 − c²·y2²)/(den + ε)³, a
    # ~250× cancellation at c·y2 = 0.998 that each framework's fp32
    # operation order rounds differently (measured 5.5e-5 relative): 1e-4
    # relative here. (Not from the origin: an edge point's distance to it
    # sits just inside the clamp, where 1 − zc² ≈ 2e-3 turns a 1-ulp
    # difference of zc into 6e-5.)
    a, b = _edge((0, 1), c)[:-1], _edge((2, 3, 4), c)[:-1]
    _grad_pair(lambda p: jp.dist_matrix_gram(p, jnp.asarray(b), c=c),
               lambda p: tp.dist_matrix_gram(p, T(b), c=c), [a], tol=1e-4)


# --------------------------------------------------------------------------- #
# the fused (whole-S) kernel's poincaré plain versions                        #
# --------------------------------------------------------------------------- #

def _attn_case(seed, lead, L, S, c, scale=0.5):
    rng = np.random.default_rng(seed)
    qb = _ball(rng.standard_normal((*lead, L, 8)) * scale, c)
    kb = _ball(rng.standard_normal((*lead, S, 8)) * scale, c)
    v = rng.standard_normal((*lead, S, 8)).astype(np.float32)
    w = rng.standard_normal((*lead, L, 8)).astype(np.float32)
    return qb, kb, v, w


def _check_grads(got, want, tol):
    for i, (g, wnt) in enumerate(zip(got, want)):
        g, wnt = np.asarray(g), np.asarray(wnt)
        assert np.isfinite(g).all(), i
        np.testing.assert_allclose(
            g, wnt, rtol=0, atol=tol * max(1.0, float(np.abs(wnt).max())),
            err_msg=f"gradient {i}")


def _fused_both(qb, kb, v, w, mask, c):
    """(out, grads) of Σ out ⊙ w through JAX's Pallas kernel (interpret) and
    the port's wrapper (plain on the CPU), over q, k, v and the mask."""
    n = 3 if mask is None else 4

    def jloss(*a):
        out = jmhgsa.fused_geodesic_attention(
            *a[:3], mask=None if mask is None else a[3], interpret=True,
            metric="poincare", curvature=c)
        return jnp.sum(out * w), out

    args = [qb, kb, v] + ([] if mask is None else [mask])
    (_, jout), jg = jax.value_and_grad(jloss, argnums=tuple(range(n)),
                                       has_aux=True)(
        *[jnp.asarray(a) for a in args])
    leaves = [T(a, True) for a in args]
    out = tmhgsa.fused_geodesic_attention(
        *leaves[:3], mask=None if mask is None else leaves[3],
        metric="poincare", curvature=c)
    tg = torch.autograd.grad((out * T(w)).sum(), leaves)
    return (out.detach().numpy(), [g.numpy() for g in tg]), \
        (np.asarray(jout), [np.asarray(g) for g in jg])


@pytest.mark.parametrize("c", [0.7, 1.0, 2.0])
def test_fused_poincare_matches_jax_interpret(c):
    qb, kb, v, w = _attn_case(1, (2, 2), 9, 13, c, scale=0.5 / c ** 0.5)
    before = _launches()
    (out, grads), (jout, jgrads) = _fused_both(qb, kb, v, w, None, c)
    assert _launches() == before              # plain versions on the CPU
    np.testing.assert_allclose(out, jout, rtol=0, atol=FUSED_TOL)
    _check_grads(grads, jgrads, FUSED_GRAD_TOL)


def test_fused_poincare_masked_and_mask_cotangent():
    """A mask with excluded keys (finfo.min) and finite biases, one row with
    every key excluded: the forward, the q, k, v gradients and dmask."""
    qb, kb, v, w = _attn_case(2, (3,), 8, 12, 1.0)
    rng = np.random.default_rng(3)
    mask = (2.0 * rng.standard_normal((3, 8, 12))).astype(np.float32)
    mask[:, :, 9:] = np.finfo(np.float32).min
    mask[1, 0] = np.finfo(np.float32).min     # an all-excluded row
    (out, grads), (jout, jgrads) = _fused_both(qb, kb, v, w, mask, 1.0)
    np.testing.assert_allclose(out, jout, rtol=0, atol=FUSED_TOL)
    assert np.all(out[1, 0] == 0.0)
    _check_grads(grads, jgrads, FUSED_GRAD_TOL)
    assert np.all(grads[3][1, 0] == 0.0) and np.all(grads[0][1, 0] == 0.0)


def test_fused_poincare_several_jax_q_tiles():
    """L = 300 spans JAX's 128-row poincaré backward q-tiles (the per-tile
    dk contributions add up)."""
    qb, kb, v, w = _attn_case(4, (1,), 300, 20, 0.7, scale=0.3)
    (out, grads), (jout, jgrads) = _fused_both(qb, kb, v, w, None, 0.7)
    np.testing.assert_allclose(out, jout, rtol=0, atol=FUSED_TOL)
    _check_grads(grads, jgrads, FUSED_GRAD_TOL)


@pytest.mark.parametrize("kind", ["fused", "flash"])
def test_identical_qk_gradient_is_finite(kind):
    """q = k puts every diagonal pair at distance ~0, where x2 − 2g + y2
    cancels: the 1e-15 norm guard keeps the gradients finite."""
    qb, _, v, w = _attn_case(5, (1,), 8, 8, 0.7)
    x = T(qb, True)
    fn = tmhgsa.fused_geodesic_attention if kind == "fused" else \
        tmhgsa.flash_geodesic_attention
    out = fn(x, x, T(v), metric="poincare", curvature=0.7)
    (g,) = torch.autograd.grad((out * T(w)).sum(), x)
    assert torch.isfinite(out).all() and torch.isfinite(g).all()


# --------------------------------------------------------------------------- #
# the flash (S-tiled) kernels' poincaré plain versions                        #
# --------------------------------------------------------------------------- #

def _flash_both(qb, kb, v, w, kv, c):
    def jloss(q, k, v_):
        out = jmhgsa.flash_geodesic_attention(
            q, k, v_, kv_valid=None if kv is None else jnp.asarray(kv),
            interpret=True, metric="poincare", curvature=c)
        return jnp.sum(out * w), out

    (_, jout), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                       has_aux=True)(
        jnp.asarray(qb), jnp.asarray(kb), jnp.asarray(v))
    leaves = [T(qb, True), T(kb, True), T(v, True)]
    out = tmhgsa.flash_geodesic_attention(
        *leaves, kv_valid=None if kv is None else T(kv), metric="poincare",
        curvature=c)
    tg = torch.autograd.grad((out * T(w)).sum(), leaves)
    return (out.detach().numpy(), [g.numpy() for g in tg]), \
        (np.asarray(jout), [np.asarray(g) for g in jg])


@pytest.mark.parametrize("L,S,c", [(80, 700, 0.7), (600, 600, 1.0)],
                         ids=["s700_two_jax_key_tiles", "l600_s600"])
def test_flash_poincare_matches_jax_interpret(L, S, c):
    """S = 700: two of JAX's 512-key tiles, ragged (six of the port's 128);
    L = S = 600: several tiles on both axes (the dq k-sweep and the dk/dv
    q-sweep carry dx2 and dy2 across tiles)."""
    qb, kb, v, w = _attn_case(6, (1,), L, S, c, scale=0.3)
    before = _launches()
    (out, grads), (jout, jgrads) = _flash_both(qb, kb, v, w, None, c)
    assert _launches() == before
    np.testing.assert_allclose(out, jout, rtol=0, atol=FLASH_TOL)
    _check_grads(grads, jgrads, FLASH_GRAD_TOL)


def test_flash_poincare_key_validity_and_all_invalid_problem():
    """A random key validity, and one problem with no valid key: its output
    and gradients are exactly 0, as are invalid keys' dk and dv."""
    qb, kb, v, w = _attn_case(7, (3,), 40, 130, 1.0)
    rng = np.random.default_rng(8)
    kv = (rng.random((3, 130)) > 0.3).astype(np.float32)
    kv[:, 0] = 1.0
    kv[2] = 0.0
    (out, grads), (jout, jgrads) = _flash_both(qb, kb, v, w, kv, 1.0)
    np.testing.assert_allclose(out, jout, rtol=0, atol=FLASH_TOL)
    _check_grads(grads, jgrads, FLASH_GRAD_TOL)
    assert np.all(out[2] == 0.0) and all(np.all(g[2] == 0.0) for g in grads)
    dead = kv[0] == 0.0
    assert np.all(grads[1][0][dead] == 0.0) and np.all(grads[2][0][dead] == 0)


def test_flash_poincare_lse_matches_jax_residual():
    qb, kb, v, _ = _attn_case(9, (2,), 30, 520, 0.7, scale=0.3)
    _, res = jmhgsa._flash_fwd(jnp.asarray(qb), jnp.asarray(kb),
                               jnp.asarray(v), None, True, "poincare", 0.7)
    _, lse = tmhgsa.flash_geodesic_attention_reference(
        T(qb), T(kb), T(v), None, "poincare", 0.7)
    np.testing.assert_allclose(lse.numpy(), np.asarray(res[-1])[:, :30, 0],
                               rtol=0, atol=FLASH_TOL)


# --------------------------------------------------------------------------- #
# the maxless-softmax contract and the route                                  #
# --------------------------------------------------------------------------- #

def test_tiny_curvature_is_refused_by_both_wrappers():
    q = torch.randn(1, 8, 8)
    for fn in (tmhgsa.fused_geodesic_attention,
               tmhgsa.flash_geodesic_attention):
        with pytest.raises(ValueError, match="curvature"):
            fn(q, q, q, metric="poincare", curvature=0.005)
        with pytest.raises(ValueError, match="metric"):
            fn(q, q, q, metric="lorentz")
    with pytest.raises(ValueError, match="curvature"):
        tmhgsa.fused_geodesic_attention_backward(
            q, q, q, None, q, metric="poincare", curvature=0.005)


@pytest.mark.parametrize("shape,route", [((1, 512, 64), "flash"),
                                         ((88, 128, 8), "fused"),
                                         ((11, 8, 32, 32 // 4), "fused")])
def test_auto_route_dense_at_tiny_curvature(shape, route):
    """On the card "auto" sends poincaré problems to a kernel at c = 1 (the
    small scene-axis ones to the whole-S kernel, never the packed one) and
    to the plain path below MIN_MAXLESS_CURVATURE, as JAX's route does."""
    def r(**kw):
        flags = dict(has_mask=False, has_kv_valid=False, compat="tpu",
                     fused="auto", need_weights=False, metric="poincare",
                     on_cuda=True)
        return tattn._kernel_route(shape, shape, **{**flags, **kw})

    assert r(curvature=1.0) == route
    assert r(curvature=0.005) is None
    assert r(curvature=0.005, metric="oblique") is not None
    with pytest.raises(ValueError, match="oblique"):
        r(fused="packed")


@pytest.mark.parametrize("compat", ["reference", "tpu"])
@pytest.mark.parametrize("fused", [False, "flash", True])
def test_geodesic_attention_poincare_matches_jax_dense(compat, fused):
    """The attention layer on the dense path, the forced flash route (plain
    versions on the CPU, the ball map applied before them) and the forced
    whole-S route (plain on the CPU) against JAX's dense poincaré path, the
    Q3-swapped square case under reference compat."""
    rng = np.random.default_rng(10)
    q, k, v, w = (rng.standard_normal((2, 3, 9, 8)).astype(np.float32) * s
                  for s in (0.5, 0.5, 1.0, 1.0))

    def jloss(q_, k_, v_):
        out, _ = jattn.geodesic_attention(q_, k_, v_, compat=compat,
                                          fused=False, metric="poincare",
                                          curvature=0.7)
        return jnp.sum(out * w), out

    with jax.default_matmul_precision("highest"):
        (_, jout), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [T(q, True), T(k, True), T(v, True)]
    out, wts = tattn.geodesic_attention(*leaves, compat=compat, fused=fused,
                                        metric="poincare", curvature=0.7,
                                        need_weights=False)
    tg = torch.autograd.grad((out * T(w)).sum(), leaves)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=0, atol=1e-5)
    _check_grads([g.numpy() for g in tg], jg, FUSED_GRAD_TOL)


# --------------------------------------------------------------------------- #
# the model: training forward, inference, CLIs                                #
# --------------------------------------------------------------------------- #

SMALL = dict(hidden_dim=16, num_heads=2, ff_dim=32, zdim=8, sample_k=4,
             past_length=5, future_length=10, attn_metric="poincare")
LOSSES = ("total_loss", "loss_pred", "loss_recover", "loss_kl",
          "loss_diverse")


def _jax_noise(cfg, rng, M) -> tm.TrainNoise:
    """JAX's draws inside sttode_forward(rng): split(rng, 4) → (enc, fenc,
    q, p); each trunk splits its key into (pe, ode) and draws the PE keep-
    mask [M, T, D] with bernoulli(1 − pe_dropout)."""
    D = cfg.hidden_dim
    k_enc, k_fenc, k_q, k_p = jax.random.split(rng, 4)

    def keep(key, T_):
        k_pe, _ = jax.random.split(key)
        return np.asarray(jax.random.bernoulli(k_pe, 1.0 - cfg.pe_dropout,
                                               (M, T_, D)))

    eps_q = jax.random.normal(k_q, (M, cfg.zdim))
    eps_p = jax.random.normal(k_p, (M * cfg.sample_k, cfg.zdim))
    return tm.TrainNoise(*(torch.from_numpy(np.array(a)) for a in (
        keep(k_enc, cfg.past_length), keep(k_fenc, cfg.future_length),
        eps_q, eps_p)))


def _scenes(B, N, seed, training, **kw):
    scenes = jsyn.make_social_scenes(B, agents_range=(N, N), obs_len=5,
                                     pred_len=10, seed=seed)
    obs = np.stack([s["obs"] for s in scenes])
    pred = np.stack([s["pred"] for s in scenes])
    valid = np.ones((B, N), np.float32)
    for name, mod in (("j", jprep), ("t", tprep)):
        yield mod.prepare_scene_group(obs, pred, valid, training=training,
                                      rng=np.random.default_rng(4)
                                      if training else None)[0]


@pytest.mark.parametrize("attn_impl", ["auto", "flash"])
def test_sttode_forward_poincare_matches_jax(attn_impl):
    """The stage-1 training forward and backward with the poincaré metric
    (reference compat, scene axis; "flash" runs the flash plain versions on
    [3 agents × 2 heads, 24 scenes, 8] under the Q3 swap, JAX its flash
    kernel in interpret mode) against JAX's with the same bridged weights
    and injected noise: every loss term and every gradient leaf."""
    jcfg = jm.STTODEConfig(attn_impl=attn_impl, min_clip=0.0, curvature=0.7,
                           **SMALL).validate()
    tcfg = tm.STTODEConfig(**jcfg._asdict()).validate()
    jb, tb = _scenes(24, 3, 2, True)
    jparams = jm.sttode_init(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.tree_map(
        lambda t: t.requires_grad_(),
        bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams)))
    rng = jax.random.PRNGKey(3)

    def jloss(p):
        out = jm.sttode_forward(p, jcfg, jb, rng, train=True)
        return out.total_loss, out

    with jax.default_matmul_precision("highest"):
        (_, jout), jgrads = jax.jit(jax.value_and_grad(jloss,
                                                       has_aux=True))(jparams)
    before = _launches()
    out = tm.sttode_forward(tparams, tcfg, tb,
                            noise=_jax_noise(jcfg, rng, 24 * 3))
    out.total_loss.backward()
    assert _launches() == before
    for name in LOSSES:
        np.testing.assert_allclose(float(getattr(out, name).detach()),
                                   float(getattr(jout, name)), **MODEL_TOL,
                                   err_msg=name)
    want = [np.asarray(g) for g in jax.tree_util.tree_leaves(jgrads)]
    got = [t.grad.numpy() for t in bridge.tree_leaves(tparams)]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, **MODEL_TOL,
                                   err_msg=f"gradient leaf {i}")


@pytest.mark.parametrize("kw", [dict(), dict(compat="tpu",
                                             attn_axis="agent")],
                         ids=["reference_scene", "tpu_agent"])
def test_sttode_inference_poincare_matches_jax(kw):
    jcfg = jm.STTODEConfig(attn_impl="dense", select_impl="xla",
                           **SMALL, **kw).validate()
    tcfg = tm.STTODEConfig(**jcfg._asdict()).validate()
    jb, tb = _scenes(3, 4, 1, False)
    jparams = jm.sttode_init(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams))
    rng = jax.random.PRNGKey(42)
    want = jrun(jm.sttode_inference, jparams, jcfg, jb, rng)
    _, k_p = jax.random.split(rng)
    M = jb.batch_size * jb.agent_num
    z = np.array(jax.random.normal(k_p, (M * jcfg.sample_k, jcfg.zdim)))
    got = tm.sttode_inference(tparams, tcfg._replace(attn_impl="auto",
                                                     select_impl="auto"),
                              tb, z=torch.from_numpy(z))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **MODEL_TOL)


def test_cli_train_and_test_poincare(tmp_path, capsys):
    """``cli.train --attn_metric poincare --device cpu`` trains one epoch
    and writes a checkpoint whose config says poincaré at the given
    curvature; a resume from it trains the next epoch as poincaré;
    ``cli.test`` evaluates it as such and prints a finite table."""
    rng = np.random.default_rng(0)
    d = tmp_path / "data" / "nba"
    d.mkdir(parents=True)
    for name, n in (("train.npy", 40), ("test.npy", 20)):
        start = rng.uniform([0.0, 0.0], [94.0, 50.0], size=(n, 1, 11, 2))
        walk = rng.normal(0.0, 1.0, size=(n, 15, 11, 2)).cumsum(axis=1)
        np.save(d / name, (start + walk).astype(np.float32))
    args = ["--dataset", "nba", "--data_root", str(tmp_path / "data"),
            "--ckpt_dir", str(tmp_path / "ck"), "--device", "cpu",
            "--hidden_dim", "16", "--zdim", "8", "--sample_k", "4",
            "--log_every", "0", "--attn_metric", "poincare", "--curvature",
            "0.7", "--model_save_epoch", "1"]
    run = cli_train.main(args + ["--num_epochs", "1"])
    ((epoch, _, means),) = run.history
    assert epoch == 0 and np.isfinite(list(means.values())).all()
    cdir = os.path.join(tmp_path, "ck", "nba")
    _, _, _, cfg = tck.load_checkpoint(tck.checkpoint_path(cdir, 1))
    assert (cfg.attn_metric, cfg.curvature) == ("poincare", 0.7)
    resumed = cli_train.main(args + ["--num_epochs", "2",
                                     "--epoch_continue", "1"])
    ((epoch, _, means),) = resumed.history
    assert epoch == 1 and np.isfinite(list(means.values())).all()
    assert (resumed.cfg.attn_metric, resumed.cfg.curvature) == ("poincare",
                                                                0.7)
    capsys.readouterr()
    best = cli_test.main(args[:-2] + ["--batch_size", "10"])
    assert best["epoch"] == 2 and best["table"]["scenes"] == 20
    for part in ("ade", "fde"):
        assert np.isfinite(list(best["table"][part].values())).all()


# --------------------------------------------------------------------------- #
# the masked whole-S backward beyond shared memory                            #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("metric", ["oblique", "poincare"])
@pytest.mark.parametrize("S", [1036, 1037, 2048])
def test_masked_whole_s_backward_workspace_boundary(metric, S):
    """A masked scene-axis problem [11 agents, 8 heads, S, 8] stays on the
    whole-S kernels up to S = 2048 (JAX's rule); from L = S = 1037 their
    backward's staging (224·S + 256 bytes at Dh = 8, both metrics) passes
    the 232,448-byte opt-in limit, and the wrapper gives it a device
    workspace instead of refusing it; the forward fits shared memory."""
    fwd, bwd = tmhgsa.whole_s_smem_bytes(S, S, 8, metric)
    assert bwd == 224 * S + 256
    assert fwd == (88 if metric == "poincare" else 84) * S + 128
    assert fwd <= tmhgsa.SMEM_OPTIN_BYTES
    assert (bwd > tmhgsa.SMEM_OPTIN_BYTES) == (S >= 1037)
    shape = (11, 8, S, 8)
    route = tattn._kernel_route(shape, shape, has_mask=True,
                                has_kv_valid=False, compat="tpu",
                                fused="auto", need_weights=False,
                                metric=metric, on_cuda=True)
    assert route == "fused"
    maskless = tattn._kernel_route(shape, shape, has_mask=False,
                                   has_kv_valid=False, compat="tpu",
                                   fused="auto", need_weights=False,
                                   metric=metric, on_cuda=True)
    assert maskless == ("fused" if S <= 1036 else "flash")


@pytest.mark.parametrize("metric", ["oblique", "poincare"])
def test_masked_backward_beyond_shared_memory_matches_jax(metric):
    """The masked backward's plain version at L = 16, S = 1100 (a shape
    whose whole-S staging needs the workspace mode on the card when L = S)
    against jax.grad through JAX's masked fused kernel (interpret mode):
    q, k, v and the mask cotangent."""
    c = 1.0
    qb, kb, v, w = _attn_case(11, (1,), 16, 1100, c, scale=0.3)
    if metric == "oblique":
        rng = np.random.default_rng(12)
        qb, kb = (rng.standard_normal(x.shape).astype(np.float32)
                  for x in (qb, kb))
    rng = np.random.default_rng(13)
    mask = np.where(rng.random((1, 16, 1100)) < 0.2,
                    np.finfo(np.float32).min,
                    rng.standard_normal((1, 16, 1100))).astype(np.float32)

    def jloss(*a):
        out = jmhgsa.fused_geodesic_attention(
            *a[:3], mask=a[3], interpret=True, metric=metric, curvature=c)
        return jnp.sum(out * w)

    jg = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *[jnp.asarray(a) for a in (qb, kb, v, mask)])
    leaves = [T(a, True) for a in (qb, kb, v, mask)]
    out = tmhgsa.fused_geodesic_attention(*leaves[:3], mask=leaves[3],
                                          metric=metric, curvature=c)
    tg = torch.autograd.grad((out * T(w)).sum(), leaves)
    _check_grads([g.numpy() for g in tg], jg, FUSED_GRAD_TOL)
