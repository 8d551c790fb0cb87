"""The port's manifolds and Riemannian SGD against the JAX package on the CPU.

- The oblique manifold's Riemannian ops and the Euclidean manifold, values
  and gradients on the same numpy-seeded inputs: fp32 within 1e-6 (values)
  and 1e-5 (gradients), with the small-norm branches of ``expmap`` and
  ``logmap`` taken; float64 within 1e-10 near antipodes, where acos' and
  the normalization amplify rounding.
- ``riemannian_sgd``: JAX's convergence and prefix-mask cases (the port
  within 1e-5 of JAX after 50 steps, 1e-7 after one), a callable mask;
  three steps of ``make_train_step(..., optimizer=riemannian_sgd(...))``
  against JAX's ``make_train_step(cfg, riemannian_sgd(...))`` on the NBA
  shape at narrow width with the same batches and JAX's draws injected:
  every parameter leaf within 1e-5 × its largest magnitude (the port
  writes the retracted point, JAX lands on p + (retr − p); gradients agree
  to ~1e-6), and every leaf's displacement within 1e-2 of its largest
  entry (at lr 5e-5 the retraction's and the tangent projection's own
  effects are second order there; the cases above hold them). At lr 1e-4
  the three steps amplify fp32 rounding past 1e-5 × max: JAX against
  itself from starts perturbed by rounding's size drifts as far as the
  port does (a test below holds that); and ``scan_steps=3`` equal bit for
  bit to three single steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sttode_tpu.data import preprocess as jprep
from sttode_tpu.manifolds import euclidean as jeuc
from sttode_tpu.manifolds import oblique as jobl
from sttode_tpu.models import sttode as jm
from sttode_tpu.train import loop as jloop
from sttode_tpu.train import riemannian as jriem
from sttode_tpu_torch import bridge
from sttode_tpu_torch import manifolds as tman
from sttode_tpu_torch.data import preprocess as tprep
from sttode_tpu_torch.manifolds import euclidean as teuc
from sttode_tpu_torch.manifolds import oblique as tobl
from sttode_tpu_torch.models import sttode as tm
from sttode_tpu_torch.train import loop as tloop
from sttode_tpu_torch.train import riemannian as triem

# one intra-op thread: pytest-xdist runs 6 workers on 8 cores, and
# torch's default of one thread a core each oversubscribes them
torch.set_num_threads(1)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t)


def _points(rng, shape, dtype):
    x = rng.standard_normal(shape)
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(dtype)


def _inputs(dtype, antipodal=False):
    """x, y points [3, 4, 8] on the spheres and u [3, 4, 8]: in the first
    row of u the norm is below EPS (the retraction branch of ``expmap``),
    and y's first row sits 1e-6 from x's (``logmap``'s small branch); with
    ``antipodal`` y is within 1e-3 of −x."""
    rng = np.random.default_rng(7)
    x = _points(rng, (3, 4, 8), dtype)
    u = (0.7 * rng.standard_normal((3, 4, 8))).astype(dtype)
    u[0] *= 1e-6
    if antipodal:
        y = -x + 1e-3 * rng.standard_normal(x.shape)
        y = (y / np.linalg.norm(y, axis=-1, keepdims=True)).astype(dtype)
    else:
        y = _points(rng, (3, 4, 8), dtype)
        y[0] = x[0] + 1e-6 * rng.standard_normal((4, 8))
    return x, u, y


# (name, f(module, is_jax, x, u, y)): JAX's inner takes an unused base point
OBLIQUE = {
    "proj": lambda m, j, x, u, y: m.proj(u),
    "proj_tan": lambda m, j, x, u, y: m.proj_tan(u, x),
    "inner_self": lambda m, j, x, u, y: m.inner(x, u) if j else m.inner(u),
    "inner": lambda m, j, x, u, y: m.inner(x, u, y) if j else m.inner(u, y),
    "dist": lambda m, j, x, u, y: m.dist(x, y),
    "dist_point": lambda m, j, x, u, y: m.dist_point(x, y),
    "expmap": lambda m, j, x, u, y: m.expmap(m.proj_tan(u, x), x),
    "logmap": lambda m, j, x, u, y: m.logmap(y, x),
    "retr": lambda m, j, x, u, y: m.retr(u, x),
    "retr_transp": lambda m, j, x, u, y: m.retr_transp(u, x, y),
    "ptransp": lambda m, j, x, u, y: m.ptransp(u, x, y),
    "egrad2rgrad": lambda m, j, x, u, y: m.egrad2rgrad(u, x),
}
EUCLIDEAN = {
    "proj": lambda m, j, x, u, y: m.proj(u),
    "proj_tan": lambda m, j, x, u, y: m.proj_tan(u, x),
    "inner_self": lambda m, j, x, u, y: m.inner(x, u) if j else m.inner(u),
    "inner": lambda m, j, x, u, y: m.inner(x, u, y) if j else m.inner(u, y),
    "dist": lambda m, j, x, u, y: m.dist(x, y),
    "dist_point": lambda m, j, x, u, y: m.dist_point(x, y),
    "expmap": lambda m, j, x, u, y: m.expmap(u, x),
    "logmap": lambda m, j, x, u, y: m.logmap(y, x),
    "retr": lambda m, j, x, u, y: m.retr(u, x),
    "ptransp": lambda m, j, x, u, y: m.ptransp(u, x, y),
    "egrad2rgrad": lambda m, j, x, u, y: m.egrad2rgrad(u, x),
    "mobius_add": lambda m, j, x, u, y: m.mobius_add(x, y),
    "mobius_matvec": lambda m, j, x, u, y: m.mobius_matvec(u[0, :3], x),
}
CASES = [("oblique", n, "float32") for n in OBLIQUE] + \
    [("euclidean", n, "float32") for n in EUCLIDEAN] + \
    [("oblique", n, "float64") for n in ("dist_point", "expmap", "logmap")]


def _weights(out, rng):
    return [rng.standard_normal(o.shape) for o in out]


@pytest.mark.parametrize("manifold,name,dtype", CASES,
                         ids=["-".join(c) for c in CASES])
def test_manifold_op_matches_jax(manifold, name, dtype):
    """Values and the gradient of Σ w·out with respect to x, u and y."""
    f64 = dtype == "float64"
    jm_, tm_, table = (jobl, tobl, OBLIQUE) if manifold == "oblique" else \
        (jeuc, teuc, EUCLIDEAN)
    fn = table[name]
    x, u, y = _inputs(np.float64 if f64 else np.float32, antipodal=f64)
    val_tol, grad_tol = (1e-10, 1e-9) if f64 else (1e-6, 1e-5)

    def as_tuple(o):
        return o if isinstance(o, tuple) else (o,)

    with jax.enable_x64(f64), jax.default_matmul_precision("highest"):
        jargs = [jnp.asarray(a) for a in (x, u, y)]

        def jvalue(*args):
            return as_tuple(fn(jm_, True, *args))

        w = _weights(jax.eval_shape(jvalue, *jargs),
                     np.random.default_rng(3))

        def value_and_grads(w, *args):
            out, vjp = jax.vjp(jvalue, *args)
            return out, vjp(tuple(wi.astype(o.dtype) for wi, o in
                                  zip(w, out)))

        # one compiled program a case: cheaper than JAX's eager dispatch
        jout, jgrads = jax.jit(value_and_grads)(tuple(w), *jargs)
    targs = [torch.tensor(a, requires_grad=True) for a in (x, u, y)]
    tout = as_tuple(fn(tm_, False, *targs))
    for a, b in zip(tout, jout):
        assert a.dtype == (torch.float64 if f64 else torch.float32)
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=0,
                                   atol=val_tol)
    sum((o * torch.tensor(wi, dtype=o.dtype)).sum()
        for o, wi in zip(tout, w)).backward()
    for t, g in zip(targs, jgrads):
        got = np.zeros_like(x) if t.grad is None else t.grad.numpy()
        np.testing.assert_allclose(got, np.asarray(g), rtol=0,
                                   atol=grad_tol * max(1.0,
                                                       np.abs(g).max()))


@pytest.mark.parametrize("cls", ["Oblique", "Euclidean"])
def test_namespaces_and_exports_match_jax(cls):
    import sttode_tpu.manifolds as jmanifolds

    assert tman.__all__ == jmanifolds.__all__
    jcls, tcls = getattr(jmanifolds, cls), getattr(tman, cls)
    public = {k for k in vars(jcls) if not k.startswith("_")}
    assert public == {k for k in vars(tcls) if not k.startswith("_")}
    module = tobl if cls == "Oblique" else teuc
    assert tcls.name == jcls.name
    for k in public - {"name"}:
        assert getattr(tcls, k) is getattr(module, k), k


def test_oblique_eps_table_is_jax_s():
    assert {str(k).replace("torch.", ""): v for k, v in tobl.EPS.items()} \
        == {str(k): v for k, v in jobl.EPS.items()}


# --------------------------------------------------------------------------- #
# riemannian_sgd                                                              #
# --------------------------------------------------------------------------- #

def _port_tree(jtree):
    return bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jtree))


def _sgd_steps(params, lr, mask, grad_fn, steps):
    """``steps`` updates of ``riemannian_sgd(lr, flat_mask(mask, params))``
    over the tree's leaves, the gradients from ``grad_fn(leaves)``."""
    leaves = [t.clone().requires_grad_() for t in bridge.tree_leaves(params)]
    opt = triem.riemannian_sgd(lr, triem.flat_mask(mask, params))(leaves)
    for _ in range(steps):
        for t, g in zip(leaves, grad_fn(leaves)):
            t.grad = g
        opt.step()
    return [t.detach() for t in leaves]


def test_riemannian_sgd_stays_on_manifold_and_converges_as_jax(rng):
    """JAX's case (tests/test_riemannian_misc.py): 50 steps towards target
    directions, the sphere leaf on the manifold, the flat leaf by SGD."""
    jparams = {"sphere": jnp.asarray(rng.standard_normal((5, 8)),
                                     jnp.float32),
               "flat": jnp.asarray(rng.standard_normal(3), jnp.float32)}
    mask = {"sphere": True, "flat": False}
    target = rng.standard_normal((5, 8)).astype(np.float32)
    t_dir = np.array(jobl.proj(jnp.asarray(target)))
    tparams = triem.project_to_manifold(_port_tree(jparams), mask)
    jparams = jriem.project_to_manifold(jparams, mask)
    np.testing.assert_allclose(tparams["sphere"].numpy(),
                               np.asarray(jparams["sphere"]), atol=1e-7)

    opt = jriem.riemannian_sgd(0.1, mask)
    state = opt.init(jparams)

    def loss(p):
        return -jnp.sum(p["sphere"] * t_dir) + jnp.sum(p["flat"] ** 2)

    @jax.jit
    def step(p, state):
        updates, state = opt.update(jax.grad(loss)(p), state, p)
        return optax.apply_updates(p, updates), state

    for _ in range(50):
        jparams, state = step(jparams, state)

    # leaves in tree_leaves order: flat, sphere
    flat, sphere = _sgd_steps(
        tparams, 0.1, mask,
        lambda ls: [2.0 * ls[0].detach(), -torch.from_numpy(t_dir)], 50)
    np.testing.assert_allclose(np.linalg.norm(sphere.numpy(), axis=-1), 1.0,
                               atol=1e-5)
    assert np.all(np.sum(sphere.numpy() * t_dir, axis=-1) > 0.99)
    np.testing.assert_allclose(sphere.numpy(), np.asarray(jparams["sphere"]),
                               atol=1e-5)
    np.testing.assert_allclose(flat.numpy(), np.asarray(jparams["flat"]),
                               atol=1e-6)


@pytest.mark.parametrize("form", ["prefix", "callable"])
def test_riemannian_sgd_prefix_and_callable_masks_match_jax(rng, form):
    """JAX's prefix-mask case (tests/test_review_fixes.py): a mask leaf
    covers a whole subtree; the same mask as a callable on the params."""
    jparams = {"enc": {"w": jnp.asarray(rng.standard_normal((4, 3)),
                                        jnp.float32),
                       "b": jnp.asarray(rng.standard_normal((4, 3)),
                                        jnp.float32)},
               "head": {"w": jnp.asarray(rng.standard_normal((2, 3)),
                                         jnp.float32)}}
    prefix = {"enc": True, "head": False}
    mask = prefix if form == "prefix" else (lambda p: prefix)
    tparams = triem.project_to_manifold(_port_tree(jparams), mask)
    jparams = jriem.project_to_manifold(jparams, mask)
    assert triem.flat_mask(mask, tparams) == [True, True, False]
    opt = jriem.riemannian_sgd(1e-2, manifold_mask=mask)
    grads = jax.tree_util.tree_map(jnp.ones_like, jparams)
    updates, _ = opt.update(grads, opt.init(jparams), jparams)
    want = jax.tree_util.tree_leaves(optax.apply_updates(jparams, updates))
    got = _sgd_steps(tparams, 1e-2, mask,
                     lambda ls: [torch.ones_like(t) for t in ls], 1)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-7)
    np.testing.assert_allclose(np.linalg.norm(got[0].numpy(), axis=-1), 1.0,
                               atol=1e-5)
    # a leaf-by-leaf mask in the parameters' order, without the tree
    leaves = [t.clone().requires_grad_() for t in bridge.tree_leaves(tparams)]
    opt_flat = triem.riemannian_sgd(1e-2, [True, True, False])(leaves)
    for t in leaves:
        t.grad = torch.ones_like(t)
    opt_flat.step()
    assert all(torch.equal(a.detach(), b) for a, b in zip(leaves, got))


def test_riemannian_mask_must_match_the_tree():
    params = {"a": torch.zeros(2, 3), "b": [torch.zeros(3), torch.zeros(3)]}
    with pytest.raises(ValueError, match="mask keys"):
        triem.flat_mask({"a": True}, params)
    with pytest.raises(ValueError, match="mask sequence"):
        triem.flat_mask({"a": True, "b": [True]}, params)
    for flags in ([], {"a": True}):
        with pytest.raises(ValueError, match="one mask flag"):
            triem.RiemannianSGD([torch.zeros(2)], lr=0.1,
                                manifold_mask=flags)
    assert triem.flat_mask({"a": False, "b": [True, False]}, params) == \
        [False, True, False]


SMALL = dict(hidden_dim=16, num_heads=2, ff_dim=32, zdim=8, sample_k=4,
             past_length=5, future_length=10, attn_impl="dense",
             select_impl="xla", min_clip=0.0)
B_SCENES = 16
LR = 5e-5


def _jax_noise(cfg, key, M) -> tm.TrainNoise:
    """JAX's draws inside sttode_forward(key): split(key, 4) → (enc, fenc,
    q, p); each trunk splits its key into (pe, ode) and draws the PE keep-
    mask [M, T, D] with bernoulli(1 − pe_dropout)."""
    k_enc, k_fenc, k_q, k_p = jax.random.split(key, 4)

    def keep(k, T):
        k_pe, _ = jax.random.split(k)
        return np.asarray(jax.random.bernoulli(
            k_pe, 1.0 - cfg.pe_dropout, (M, T, cfg.hidden_dim)))

    return tm.TrainNoise(*(torch.from_numpy(np.array(a)) for a in (
        keep(k_enc, cfg.past_length), keep(k_fenc, cfg.future_length),
        jax.random.normal(k_q, (M, cfg.zdim)),
        jax.random.normal(k_p, (M * cfg.sample_k, cfg.zdim)))))


def _nba_data(seed):
    rng = np.random.default_rng(seed)
    start = rng.uniform([0.0, 0.0], [94.0, 50.0], size=(B_SCENES, 11, 1, 2))
    steps = rng.normal(0.0, 1.0, size=(B_SCENES, 11, 15, 2)).cumsum(axis=2)
    traj = (start + steps).astype(np.float32)
    return {"past_traj": traj[:, :, :5], "future_traj": traj[:, :, 5:],
            "seq": "nba"}


def _in_proj(path) -> bool:
    return path[-1] == "in_proj_w"


def _jax_mask(p):
    return jax.tree_util.tree_map_with_path(
        lambda path, _: getattr(path[-1], "name", None) == "in_proj_w", p)


def _jax_steps(jcfg, starts, data, keys, lr):
    """JAX's parameter leaves after ``riemannian_sgd(lr)`` steps, one a
    batch, from each numpy tree of ``starts`` (one compiled step)."""
    opt = jriem.riemannian_sgd(lr, _jax_mask)
    out = []
    with jax.default_matmul_precision("highest"):
        step = jloop.make_train_step(jcfg, opt, donate=False)
        for p0 in starts:
            jparams = jax.tree_util.tree_map(jnp.asarray, p0)
            state = opt.init(jparams)
            for d, k in zip(data, keys):
                jparams, state, _ = step(jparams, state,
                                         jprep.prepare_nba_batch(d), k)
            out.append([np.asarray(a)
                        for a in jax.tree_util.tree_leaves(jparams)])
    return out


@pytest.fixture(scope="module")
def nba_case():
    """The config, JAX's initial parameters, three batches, JAX's step
    keys and JAX's parameters after three riemannian_sgd steps (the
    encoder layers' in_proj_w on the oblique manifold)."""
    jcfg = jm.STTODEConfig(**SMALL).validate()
    # the port's seeded init in JAX's tree (the same leaf order): JAX's
    # own init runs its random ops eagerly, ~8 s on this CPU
    shapes = jax.eval_shape(lambda k: jm.sttode_init(k, jcfg),
                            jax.random.PRNGKey(0))
    init = bridge.tree_leaves(tm.sttode_init(0, tm.STTODEConfig(**SMALL)))
    p0 = jax.tree_util.tree_map(np.asarray, jriem.project_to_manifold(
        jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(shapes),
            [jnp.asarray(t.numpy()) for t in init]), _jax_mask))
    data = [_nba_data(s) for s in range(3)]
    keys = list(jax.random.split(jax.random.PRNGKey(5), 3))
    return jcfg, p0, data, keys, _jax_steps(jcfg, [p0], data, keys, LR)[0]


def _port_steps(jcfg, p0, data, keys, scan_steps=1, lr=LR):
    tcfg = tm.STTODEConfig(**jcfg._asdict()).validate()
    mask = lambda p: bridge.tree_map_with_path(  # noqa: E731
        lambda path, _: _in_proj(path), p)
    params = triem.project_to_manifold(bridge.params_from_jax(p0), mask)
    step = tloop.make_train_step(tcfg, lr, device="cpu",
                                 scan_steps=scan_steps,
                                 optimizer=triem.riemannian_sgd(
                                     lr, triem.flat_mask(mask, params)))
    params, opt = step.init(params)
    assert isinstance(opt, triem.RiemannianSGD)
    assert sum(opt.on_manifold.values()) == 2 * tcfg.nlayer
    batches = [tprep.prepare_nba_batch(d) for d in data]
    noises = [_jax_noise(jcfg, k, B_SCENES * 11) for k in keys]
    if scan_steps == 1:
        for b, n in zip(batches, noises):
            step(params, opt, b, noise=n)
    else:
        step(params, opt, tloop.stack_batches(batches),
             noise=tloop.stack_noise(noises))
    return params


def test_make_train_step_with_riemannian_sgd_matches_jax(nba_case):
    """Every leaf within 1e-5 × its largest magnitude of JAX's, and every
    leaf's displacement over the three steps (at this lr at least 36 ulp of
    the leaf's largest entry) within 1e-2 of its largest entry plus the
    fp32 rounding of the leaf (2 ulp of its largest), so a leaf that the
    optimizer skipped or moved by the wrong rule fails; the marked rows
    unit-norm."""
    jcfg, p0, data, keys, want = nba_case
    params = _port_steps(jcfg, p0, data, keys)
    got = bridge.tree_leaves(params)
    paths = [p for p, _ in bridge.tree_leaves_with_path(params)]
    assert len(got) == len(want)
    marked = 0
    for path, g, w, w0 in zip(paths, got, want, jax.tree_util.tree_leaves(
            p0)):
        g = g.detach().numpy()
        scale = max(np.abs(w).max(), 1e-30)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * scale,
                                   err_msg=str(path))
        d_got, d_want = g - np.asarray(w0), w - np.asarray(w0)
        d_max = np.abs(d_want).max()
        d_tol = 1e-2 * d_max + 2 * np.spacing(np.float32(scale))
        assert d_max > 2 * d_tol, f"{path} barely moves in JAX"
        np.testing.assert_allclose(d_got, d_want, rtol=0, atol=d_tol,
                                   err_msg=f"{path} displacement")
        if _in_proj(path):
            np.testing.assert_allclose(np.linalg.norm(g, axis=-1), 1.0,
                                       atol=1e-5)
            marked += 1
    assert marked == 2 * jcfg.nlayer


def test_riemannian_scan_steps_equal_single_steps(nba_case):
    jcfg, p0, data, keys, _ = nba_case
    single = _port_steps(jcfg, p0, data, keys)
    scanned = _port_steps(jcfg, p0, data, keys, scan_steps=3)
    assert all(torch.equal(a, b) for a, b in zip(
        bridge.tree_leaves(single), bridge.tree_leaves(scanned)))


def test_riemannian_drift_at_lr_1e4_is_fp32_rounding(nba_case):
    """Why the parity test runs at lr 5e-5: at 1e-4 the three steps
    amplify fp32 rounding past 1e-5 × a leaf's largest magnitude. JAX
    against itself from starts perturbed by ±6e-8 relative (rounding's
    size; four draws) drifts past that bound in the median, and the
    port's drift from JAX lies within JAX's own."""
    jcfg, p0, data, keys, _ = nba_case
    lr = 1e-4
    starts = [p0]
    for seed in range(4):
        sign = np.random.default_rng(seed)
        starts.append(jax.tree_util.tree_map(
            lambda a: (a * (1 + 6e-8 * sign.choice([-1, 1], a.shape)))
            .astype(np.float32), p0))
    want, *perturbed = _jax_steps(jcfg, starts, data, keys, lr)

    def drift(xs):
        return max(np.abs(x - w).max() / np.abs(w).max()
                   for x, w in zip(xs, want))

    own = [drift(xs) for xs in perturbed]
    got = [t.detach().numpy() for t in bridge.tree_leaves(
        _port_steps(jcfg, p0, data, keys, lr=lr))]
    assert np.median(own) > 1e-5
    assert drift(got) <= max(own)
