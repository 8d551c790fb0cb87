"""The port's Poincaré-ball layers (``nn.hyperbolic``) and δ-hyperbolicity
(``utils.delta``) against the JAX package on the CPU.

The layers run on seeded parameters in JAX's structure, carried across by
``bridge``, and the same numpy-seeded inputs: the outputs, and the
gradients of Σ w·out with respect to every input and parameter leaf, fp32
within 1e-5 × max(1, |reference|)
(the Möbius maps' artanh and divisions amplify rounding near the ball's
edge, so the ball points sit at norm ≤ 0.9 there), float64 within 1e-9 at
the ball's edge (norm 1 − 1e-3, where ``project`` clips). δ-hyperbolicity
gets the same distance matrices and the same numpy ``Generator`` (so the
same subsample indices): float64 δ within 1e-12, and the port's row blocks
forced small so that several are taken.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sttode_tpu.nn import hyperbolic as jh
from sttode_tpu.utils import delta as jdelta
from sttode_tpu_torch import bridge
from sttode_tpu_torch.nn import hyperbolic as th
from sttode_tpu_torch.utils import delta as tdelta

# one intra-op thread: pytest-xdist runs 6 workers on 8 cores, and
# torch's default of one thread a core each oversubscribes them
torch.set_num_threads(1)


def _ball(rng, shape, norm_max=0.9, dtype=np.float32):
    x = rng.standard_normal(shape)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    return (x * rng.uniform(0.05, norm_max, (*shape[:-1], 1))).astype(dtype)


def _check(jfn, tfn, args, *, f64=False, tol=1e-5):
    """jfn(*args) against tfn(*port args) for args given as numpy trees:
    values, and the gradients of Σ w·out with respect to every leaf."""
    with jax.enable_x64(f64), jax.default_matmul_precision("highest"):
        jargs = jax.tree_util.tree_map(jnp.asarray, args)
        w = np.random.default_rng(11).standard_normal(
            jax.eval_shape(jfn, *jargs).shape)

        def value_and_grads(w, *a):
            out, vjp = jax.vjp(jfn, *a)
            return out, vjp(w.astype(out.dtype))

        # one compiled program a case: JAX's eager dispatch of the Möbius
        # maps' many small ops costs more than compiling them once
        jout, jgrads = jax.jit(value_and_grads)(w, *jargs)
    dtype = torch.float64 if f64 else torch.float32
    targs = bridge.tree_map(
        lambda a: torch.tensor(np.asarray(a), dtype=dtype,
                               requires_grad=True), list(args))
    tout = tfn(*targs)
    assert tout.dtype == dtype and tuple(tout.shape) == np.shape(jout)
    want = np.asarray(jout)
    np.testing.assert_allclose(tout.detach().numpy(), want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))
    (tout * torch.tensor(w, dtype=dtype)).sum().backward()
    got = bridge.tree_leaves(targs)
    for i, (t, g) in enumerate(zip(got, jax.tree_util.tree_leaves(jgrads))):
        g = np.asarray(g)
        np.testing.assert_allclose(
            t.grad.numpy(), g, rtol=0, atol=tol * max(1.0, np.abs(g).max()),
            err_msg=f"gradient leaf {i}")


def _jparams(init, *a, **kw):
    """Seeded numpy leaves U(±0.3) in the structure of JAX's init (from
    ``jax.eval_shape``: JAX's random ops run eagerly are slow here)."""
    rng = np.random.default_rng(4)
    return jax.tree_util.tree_map(
        lambda s: rng.uniform(-0.3, 0.3, s.shape).astype(np.float32),
        jax.eval_shape(lambda k: init(k, *a, **kw), jax.random.PRNGKey(4)))


C = [1.0, 0.7]


@pytest.mark.parametrize("c", C)
def test_hyperbolic_mlr_matches_jax(rng, c):
    p = _jparams(jh.hyperbolic_mlr_init, 8, 5)
    x = _ball(rng, (12, 8), 0.9 / np.sqrt(c))
    _check(lambda p, x: jh.hyperbolic_mlr(p, x, c=c),
           lambda p, x: th.hyperbolic_mlr(p, x, c=c), (p, x))


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("c", C)
def test_hyp_linear_matches_jax(rng, bias, c):
    p = _jparams(jh.hyp_linear_init, 8, 6, bias=bias)
    x = _ball(rng, (3, 10, 8), 0.9 / np.sqrt(c))
    _check(lambda p, x: jh.hyp_linear(p, x, c=c),
           lambda p, x: th.hyp_linear(p, x, c=c), (p, x))


def test_concat_poincare_and_distance_match_jax(rng):
    p = _jparams(jh.concat_poincare_init, 6, 4, 5)
    x1, x2 = _ball(rng, (7, 6)), _ball(rng, (7, 4))
    _check(jh.concat_poincare, th.concat_poincare, (p, x1, x2))
    y1, y2 = _ball(rng, (2, 7, 5)), _ball(rng, (2, 7, 5))
    _check(lambda a, b: jh.hyperbolic_distance(a, b, c=0.7),
           lambda a, b: th.hyperbolic_distance(a, b, c=0.7), (y1, y2))


TO_POINCARE = [(clip, riem, xp) for clip in (None, 1.0)
               for riem in (True, False) for xp in (False, True)]


@pytest.mark.parametrize("clip_r,riemannian,xp", TO_POINCARE)
def test_to_poincare_matches_jax(rng, clip_r, riemannian, xp):
    """Forward and backward, the Riemannian rescale and a base point
    included (the rescale changes only the backward)."""
    x = (rng.standard_normal((6, 8)) * 0.8).astype(np.float32)
    base = (rng.standard_normal(8) * 0.3).astype(np.float32)
    kw = dict(c=0.7, clip_r=clip_r, riemannian=riemannian)
    if xp:
        _check(lambda x, b: jh.to_poincare(x, xp=b, **kw),
               lambda x, b: th.to_poincare(x, xp=b, **kw), (x, base))
    else:
        _check(lambda x: jh.to_poincare(x, **kw),
               lambda x: th.to_poincare(x, **kw), (x,))


@pytest.mark.parametrize("xp", [False, True])
def test_from_poincare_matches_jax(rng, xp):
    y = _ball(rng, (6, 8))
    base = (rng.standard_normal(8) * 0.3).astype(np.float32)
    if xp:
        _check(lambda y, b: jh.from_poincare(y, xp=b),
               lambda y, b: th.from_poincare(y, xp=b), (y, base))
    else:
        _check(jh.from_poincare, th.from_poincare, (y,))


@pytest.mark.parametrize("fn", ["to_poincare", "from_poincare",
                                "hyperbolic_distance", "hyp_linear"])
def test_layers_at_the_balls_edge_match_jax_in_float64(rng, fn):
    """Points at norm 1 − 1e-3 (``project``'s radius) and features whose
    expmap0 lands beyond it, in float64."""
    edge = _ball(rng, (5, 8), 1.0, np.float64)
    edge /= np.linalg.norm(edge, axis=-1, keepdims=True) / (1 - 1e-3)
    if fn == "to_poincare":
        args = (rng.standard_normal((5, 8)) * 4.0,)
        j, t = (lambda x: jh.to_poincare(x, clip_r=3.0),
                lambda x: th.to_poincare(x, clip_r=3.0))
    elif fn == "from_poincare":
        args = (edge,)
        j, t = jh.from_poincare, th.from_poincare
    elif fn == "hyperbolic_distance":
        args = (edge, _ball(rng, (5, 8), 0.9, np.float64))
        j, t = jh.hyperbolic_distance, th.hyperbolic_distance
    else:
        args = (jax.tree_util.tree_map(
            lambda a: a.astype(np.float64), _jparams(jh.hyp_linear_init,
                                                     8, 8)), edge)
        j, t = jh.hyp_linear, th.hyp_linear
    _check(j, t, args, f64=True, tol=1e-9)


@pytest.mark.parametrize("init,args,kw", [
    ("hyperbolic_mlr_init", (8, 5), {}),
    ("hyp_linear_init", (8, 6), {}),
    ("hyp_linear_init", (8, 6), {"bias": False}),
    ("concat_poincare_init", (6, 4, 5), {}),
])
def test_inits_match_jax_s_structure_and_bounds(init, args, kw):
    """The same tree, shapes and dtype as JAX's init, and each leaf drawn
    from nn.Linear's U(±1/√fan_in), as JAX's: inside the bound and
    reaching past half of it. fan_in is a weight's input width (rows of
    ``w``, columns of the MLR's [n_classes, ball_dim] leaves, the layer's
    for a bias)."""
    want = jax.tree_util.tree_map(np.asarray, getattr(jh, init)(
        jax.random.PRNGKey(4), *args, **kw))
    got = getattr(th, init)(torch.Generator().manual_seed(0), *args, **kw)
    wl = jax.tree_util.tree_leaves_with_path(want)
    gl = bridge.tree_leaves_with_path(got)
    assert [jax.tree_util.keystr(p) for p, _ in wl] == \
        ["".join(f"['{k}']" for k in p) for p, _ in gl]
    for (_, w), (path, g) in zip(wl, gl):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        fan_in = {"w": g.shape[0], "b": args[0]}.get(path[-1], g.shape[-1])
        bound = 1 / np.sqrt(fan_in)
        for leaf in (np.abs(w), g.abs().numpy()):
            assert 0.5 * bound < leaf.max() <= bound


# --------------------------------------------------------------------------- #
# δ-hyperbolicity                                                             #
# --------------------------------------------------------------------------- #

def _cloud(rng, n, d=6):
    return rng.standard_normal((n, d))


@pytest.mark.parametrize("block", [None, 1, 37])
def test_delta_hyp_matches_jax(rng, monkeypatch, block):
    """The exact δ on a distance matrix (a tree metric's δ is 0), in the
    port's row blocks of every size."""
    if block is not None:
        n = 60
        monkeypatch.setattr(tdelta, "BLOCK_ELEMS", block * n * n)
    pts = _cloud(rng, 60)
    d = np.linalg.norm(pts[:, None] - pts[None], axis=-1)
    got = tdelta.delta_hyp(torch.from_numpy(d))
    want = jdelta.delta_hyp(d)
    assert got > 0 and abs(got - want) <= 1e-12 * max(1.0, want)
    path = np.abs(np.arange(8.0)[:, None] - np.arange(8.0)[None])
    assert tdelta.delta_hyp(torch.from_numpy(path)) == \
        jdelta.delta_hyp(path) == 0.0


@pytest.mark.parametrize("n,batch_size", [(90, 40), (30, 1500)])
def test_batched_delta_hyp_matches_jax(rng, monkeypatch, n, batch_size):
    """The same subsample indices from the same numpy Generator state (a
    subsample larger than the set takes it all); float64."""
    monkeypatch.setattr(tdelta, "BLOCK_ELEMS", 7 * n * n)
    X = _cloud(rng, n)
    want = jdelta.batched_delta_hyp(X, n_tries=3, batch_size=batch_size,
                                    rng=np.random.default_rng(5))
    got = tdelta.batched_delta_hyp(torch.from_numpy(X), n_tries=3,
                                   batch_size=batch_size,
                                   rng=np.random.default_rng(5))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)


def test_batched_delta_hyp_draws_what_jax_draws(rng):
    X = _cloud(rng, 50)
    r_j, r_t = np.random.default_rng(9), np.random.default_rng(9)
    jdelta.batched_delta_hyp(X, n_tries=2, batch_size=20, rng=r_j)
    tdelta.batched_delta_hyp(torch.from_numpy(X), n_tries=2, batch_size=20,
                             rng=r_t)
    assert r_j.bit_generator.state == r_t.bit_generator.state


def test_features_delta_matches_jax(rng):
    """Features of several batches through a feature function (a fixed
    tanh projection), subsampled with the same indices; float32 features
    as a model gives them: δ and the diameter within 1e-6 relative."""
    W = rng.standard_normal((5, 7)).astype(np.float32)
    batches = [rng.standard_normal((n, 5)).astype(np.float32)
               for n in (30, 25, 40)]
    want = jdelta.features_delta(batches, lambda b: np.tanh(b @ W),
                                 sample=60, rng=np.random.default_rng(2))
    Wt = torch.from_numpy(W)
    got = tdelta.features_delta([torch.from_numpy(b) for b in batches],
                                lambda b: torch.tanh(b @ Wt), sample=60,
                                rng=np.random.default_rng(2))
    np.testing.assert_allclose(got, want, rtol=1e-6)
