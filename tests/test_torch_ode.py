"""The port's ODE solvers (``sttode_tpu_torch/ode/solvers.py``) against the
JAX package's ``odeint`` / ``odeint_adjoint`` on the CPU.

Tolerances. Solutions of the toy problems: 1e-6 relative, and 1e-6 of
the solution's largest magnitude near zero crossings, with identical
attempted and accepted step counts (the float32 time arithmetic makes the
same accept decisions) except where ``FLIPS`` names a flip.
Direct scan-form and adjoint gradients: 1e-4 relative to JAX's; the
analytic values within JAX's own test tolerances. The full-width encoder
field (one layer at d 64, 8 heads, ff 1024, JAX's PRNGKey(0) weights,
[32, 11, 1, 64] input, ts = [0, 12]): identical counts at the three
tolerance pairs of ``scripts/dopri5_accounting.py`` and the solution within
1e-5 of its largest magnitude (that magnitude is ~56, where one float32 ulp
is 3.8e-6; the two frameworks' RHS differ by float32 rounding, 2e-7 of the
field's size, and 428 evaluations carry it).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sttode_tpu.nn import LayerConfig as JLayerConfig
from sttode_tpu.nn import encoder_stack_init
from sttode_tpu.nn.transformer import encoder_stack as j_encoder_stack
from sttode_tpu.ode import odeint as jodeint
from sttode_tpu.ode import odeint_adjoint as jodeint_adjoint
from sttode_tpu_torch import bridge
from sttode_tpu_torch.nn import transformer as ttr
from sttode_tpu_torch.ode import matmul_precision, odeint, odeint_adjoint

# one intra-op thread: pytest-xdist runs 6 workers on 8 cores, and
# torch's default of one thread a core each oversubscribes them
torch.set_num_threads(1)

F32 = np.float32


def T(x):
    return torch.from_numpy(np.asarray(x, F32))


# toy problems: (name, jax rhs, torch rhs, y0, ts, rtol, atol)
TOYS = {
    "exp_decay": (lambda t, y: -y, lambda t, y: -y, [1.0],
                  [0.0, 0.5, 1.0, 2.0], 1e-6, 1e-8),
    "harmonic": (lambda t, y: jnp.stack([y[1], -y[0]]),
                 lambda t, y: torch.stack([y[1], -y[0]]), [1.0, 0.0],
                 np.linspace(0.0, 2 * np.pi, 5), 1e-6, 1e-8),
    "backward_time": (lambda t, y: -y, lambda t, y: -y, [1.0], [1.0, 0.0],
                      1e-6, 1e-8),
    "stiffish": (lambda t, y: -50.0 * (y - jnp.cos(t)),
                 lambda t, y: -50.0 * (y - torch.cos(t)), [0.0], [0.0, 1.0],
                 1e-7, 1e-9),
    "sin_t": (lambda t, y: jnp.sin(t) * y, lambda t, y: torch.sin(t) * y,
              [1.0, 2.0, 3.0], [0.0, 3.0, 5.0], 1e-6, 1e-8),
}


# Where the frameworks' accept decisions flip: at rtol 1e-6 the harmonic
# oscillator's error estimate sits at float32's rounding floor, and XLA's
# rounding (which changes with its optimization level: 44/40 at the default,
# 43/40 at the suite's level 0) and PyTorch's decide differently in
# interval 1 ([π/2, π]): JAX 11 attempted / 10 accepted, the port 9 / 9.
# Both counts are named here; the solutions still agree.
FLIPS = {"harmonic": ((41, 39), (43, 40))}   # (port, JAX at level 0)


def _counts(stats):
    return int(stats["attempted_steps"]), int(stats["accepted_steps"]), \
        int(stats["rhs_evals"]), bool(stats["budget_exhausted"])


@pytest.mark.parametrize("budget", [None, 128])
@pytest.mark.parametrize("toy", sorted(TOYS))
def test_dopri5_toys_match_jax(toy, budget):
    fj, ft, y0, ts, rtol, atol = TOYS[toy]
    ysj, stj = jodeint(fj, jnp.asarray(y0, F32), jnp.asarray(ts, F32),
                       method="dopri5", rtol=rtol, atol=atol,
                       return_stats=True, scan_budget=budget)
    yst, stt = odeint(ft, T(y0), T(ts), method="dopri5", rtol=rtol,
                      atol=atol, return_stats=True, scan_budget=budget)
    ysj = np.asarray(ysj)
    np.testing.assert_allclose(yst.numpy(), ysj, rtol=1e-6,
                               atol=1e-6 * np.abs(ysj).max())
    assert not stt["budget_exhausted"] and not bool(stj["budget_exhausted"])
    if toy in FLIPS:
        assert (_counts(stt)[:2], _counts(stj)[:2]) == FLIPS[toy]
    else:
        assert _counts(stt) == _counts(stj)


def test_dopri5_toys_analytic():
    """The JAX suite's closed forms hold for the port as well."""
    ys = odeint(lambda t, y: -y, T([1.0]), T([0.0, 0.5, 1.0, 2.0]),
                method="dopri5", rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(ys[:, 0].numpy(),
                               np.exp(-np.array([0.0, 0.5, 1.0, 2.0])),
                               atol=1e-5)
    ys = odeint(lambda t, y: -y, T([1.0]), T([1.0, 0.0]), method="dopri5",
                rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(float(ys[1, 0]), np.e, rtol=1e-4)
    y_ad = odeint(TOYS["stiffish"][1], T([0.0]), T([0.0, 1.0]),
                  method="dopri5")
    y_rk = odeint(TOYS["stiffish"][1], T([0.0]),
                  torch.linspace(0, 1, 2001), method="rk4")
    np.testing.assert_allclose(float(y_ad[1, 0]), float(y_rk[-1, 0]),
                               atol=1e-4)


def test_dopri5_counts_scale_with_tolerance():
    f = lambda t, y: -y    # noqa: E731
    ts = T([0.0, 5.0])
    _, tight = odeint(f, torch.ones(()), ts, method="dopri5", rtol=1e-7,
                      atol=1e-9, return_stats=True)
    ys, loose = odeint(f, torch.ones(()), ts, method="dopri5", rtol=1e-3,
                       atol=1e-6, return_stats=True)
    assert tight["attempted_steps"] > loose["attempted_steps"] >= 1
    assert tight["rhs_evals"] == 2 + 6 * tight["attempted_steps"]
    _, fixed = odeint(f, torch.ones(()), torch.linspace(0.0, 5.0, 9),
                      method="rk4", return_stats=True)
    assert (fixed["rhs_evals"], fixed["accepted_steps"]) == (32, 8)


def test_while_and_scan_forms_equal():
    _, ft, y0, ts, rtol, atol = TOYS["sin_t"]
    ys_w, st_w = odeint(ft, T(y0), T(ts), method="dopri5", rtol=rtol,
                        atol=atol, return_stats=True)
    ys_s, st_s = odeint(ft, T(y0), T(ts), method="dopri5", rtol=rtol,
                        atol=atol, return_stats=True, scan_budget=64)
    np.testing.assert_array_equal(ys_s.numpy(), ys_w.numpy())
    assert st_s["attempted_steps"] == st_w["attempted_steps"]
    assert st_s["accepted_steps"] == st_w["accepted_steps"]
    assert st_s["rhs_evals"] == 1 + 2 + 6 * 64 * 2


@pytest.mark.parametrize("budget", [3, None])
def test_budget_exhaustion_flagged_and_warned(budget):
    kw = dict(scan_budget=3) if budget else dict(max_steps=3)
    ysj, stj = jodeint(lambda t, y: -y, jnp.ones(()), jnp.array([0.0, 5.0]),
                       method="dopri5", return_stats=True, **kw)
    with pytest.warns(RuntimeWarning, match="exhausted"):
        ys, st = odeint(lambda t, y: -y, torch.ones(()), T([0.0, 5.0]),
                        method="dopri5", return_stats=True, **kw)
    assert st["budget_exhausted"] and bool(stj["budget_exhausted"])
    assert _counts(st) == _counts(stj)
    # truncated mid-interval (its h follows a rounding-floor error estimate,
    # so the truncation point is not compared)
    assert 0.5 < float(ys[1]) < 1.0 and abs(float(ys[1]) - np.exp(-5)) > 0.1


def test_pytree_state_and_args():
    y0 = {"b": torch.zeros(4), "a": torch.ones(2, 3)}

    def f(t, y, p):
        return {"a": -p["k"] * y["a"], "b": torch.ones_like(y["b"])}

    ys = odeint(f, y0, torch.linspace(0, 1, 51), {"k": torch.tensor(1.0)},
                method="rk4")
    np.testing.assert_allclose(ys["a"][-1].numpy(),
                               np.exp(-1.0) * np.ones((2, 3)), atol=1e-5)
    ys, st = odeint(f, y0, T([0.0, 1.0]), {"k": torch.tensor(1.0)},
                    method="dopri5", return_stats=True)
    np.testing.assert_allclose(ys["b"][-1].numpy(), np.ones(4), atol=1e-6)
    assert set(ys) == {"a", "b"} and st["accepted_steps"] > 0


# --------------------------------------------------------------------------- #
# gradients                                                                   #
# --------------------------------------------------------------------------- #

def _grad(loss, *xs):
    xs = [x.clone().requires_grad_() for x in xs]
    loss(*xs).backward()
    return [x.grad for x in xs]


@pytest.mark.parametrize("case", ["decay", "sin_t"])
def test_scan_form_direct_grads_match_jax(case):
    """Reverse mode through the scan form, h on the graph: JAX's
    scan-form gradient, in the parameter and in y0."""
    if case == "decay":
        fj = lambda t, y, a: -a * y            # noqa: E731
        ft = fj
        ts, y0, a0 = [0.0, 2.0], [1.0], 0.7
    else:
        fj = lambda t, y, a: a * jnp.sin(t) * y    # noqa: E731
        ft = lambda t, y, a: a * torch.sin(t) * y  # noqa: E731
        ts, y0, a0 = [0.0, 3.0, 5.0], [1.0, 2.0], 0.9

    def jloss(y, a):
        ys = jodeint(fj, y, jnp.asarray(ts, F32), a, method="dopri5",
                     rtol=1e-6, atol=1e-8, scan_budget=64)
        return jnp.sum(ys[1:] ** 2)

    def tloss(y, a):
        ys = odeint(ft, y, T(ts), a, method="dopri5", rtol=1e-6, atol=1e-8,
                    scan_budget=64)
        return torch.sum(ys[1:] ** 2)

    gj = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(y0, F32), jnp.float32(a0))
    gt = _grad(tloss, T(y0), torch.tensor(a0))
    for a, b in zip(gt, gj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4)
    if case == "decay":
        # d(e^{-2a})²/da = -4 e^{-4a}
        np.testing.assert_allclose(float(gt[1]), -4 * np.exp(-4 * a0),
                                   rtol=1e-4)


def test_adjoint_grads_match_jax_and_analytic():
    """y0 and a parameter tree (JAX's TestAdjoint cases), against JAX's
    adjoint and the closed forms."""
    params = {"w": 0.5, "b": 0.2}

    def jf(t, y, p):
        return -(p["w"] + p["b"]) * y

    def tf(t, y, p):
        return -(p["w"] + p["b"]) * y

    ts = [0.0, 0.5, 1.0]

    def jloss(y, p):
        ys = jodeint_adjoint(jf, y, jnp.asarray(ts, F32), p,
                             method="dopri5", rtol=1e-7, atol=1e-9)
        return jnp.sum(ys[1:, 0])

    gj = jax.grad(jloss, argnums=(0, 1))(
        jnp.ones((1,), F32), {k: jnp.float32(v) for k, v in params.items()})
    y = torch.ones(1, requires_grad=True)
    p = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    ys = odeint_adjoint(tf, y, T(ts), p, method="dopri5", rtol=1e-7,
                        atol=1e-9)
    torch.sum(ys[1:, 0]).backward()
    np.testing.assert_allclose(y.grad.numpy(), np.asarray(gj[0]), rtol=1e-4)
    for k in params:
        np.testing.assert_allclose(float(p[k].grad), float(gj[1][k]),
                                   rtol=1e-4)
        # d/dk (e^{-0.35} + e^{-0.7}) with k = w + b = 0.7
        np.testing.assert_allclose(
            float(p[k].grad), -0.5 * np.exp(-0.35) - np.exp(-0.7), atol=1e-4)
    np.testing.assert_allclose(float(y.grad), np.exp(-0.35) + np.exp(-0.7),
                               atol=1e-4)


@pytest.mark.parametrize("budget", [None, 64])
def test_adjoint_matches_direct_and_jax(budget):
    """The adjoint's gradient equals the scan form's direct one (JAX's
    test_direct_grads_through_scan / test_adjoint_scan_budget) and JAX's
    adjoint, while and scan forms; rk4's adjoint equals rk4 direct."""
    f = lambda t, y, a: -a * y    # noqa: E731

    def jloss(a):
        return jodeint_adjoint(f, jnp.ones(()), jnp.array([0.0, 2.0]), a,
                               method="dopri5", rtol=1e-6, atol=1e-8,
                               scan_budget=budget)[-1]

    (ga,) = _grad(lambda a: odeint_adjoint(
        f, torch.ones(()), T([0.0, 2.0]), a, method="dopri5", rtol=1e-6,
        atol=1e-8, scan_budget=budget)[-1], torch.tensor(0.7))
    (gs,) = _grad(lambda a: odeint(
        f, torch.ones(()), T([0.0, 2.0]), a, method="dopri5", rtol=1e-6,
        atol=1e-8, scan_budget=64)[-1], torch.tensor(0.7))
    np.testing.assert_allclose(
        float(ga), float(jax.grad(jloss)(jnp.float32(0.7))), rtol=1e-4)
    np.testing.assert_allclose(float(ga), float(gs), rtol=1e-3)
    np.testing.assert_allclose(float(gs), -2.0 * np.exp(-1.4), rtol=1e-4)
    ts = torch.linspace(0.0, 1.0, 41)
    (g_adj,) = _grad(lambda a: odeint_adjoint(f, torch.ones(1), ts, a,
                                              method="rk4")[-1, 0],
                     torch.tensor(1.0))
    (g_dir,) = _grad(lambda a: odeint(f, torch.ones(1), ts, a,
                                      method="rk4")[-1, 0],
                     torch.tensor(1.0))
    np.testing.assert_allclose(float(g_adj), float(g_dir), atol=1e-3)


def test_while_form_refuses_autograd():
    a = torch.tensor(0.7, requires_grad=True)
    with pytest.raises(ValueError, match="ode_scan_budget.*ode_adjoint"):
        odeint(lambda t, y, a: -a * y, torch.ones(()), T([0.0, 1.0]), a,
               method="dopri5")
    with torch.no_grad():
        odeint(lambda t, y, a: -a * y, torch.ones(()), T([0.0, 1.0]), a,
               method="dopri5")
    # no input that takes a gradient: allowed
    odeint(lambda t, y: -y, torch.ones(()), T([0.0, 1.0]), method="dopri5")


def test_checkpoint_matches_plain():
    f = lambda t, y, k: -k * y    # noqa: E731
    ts = torch.linspace(0.0, 1.0, 21)
    grads, vals = [], []
    for ckpt in (False, True):
        k = torch.tensor(1.0, requires_grad=True)
        ys = odeint(f, torch.ones(1), ts, k, method="rk4", checkpoint=ckpt)
        ys[-1, 0].backward()
        grads.append(float(k.grad))
        vals.append(ys.detach().numpy())
    np.testing.assert_array_equal(vals[0], vals[1])
    np.testing.assert_allclose(grads[0], grads[1], atol=1e-6)
    np.testing.assert_allclose(grads[0], -np.exp(-1.0), atol=1e-4)


def _flags():
    return (torch.get_float32_matmul_precision(),
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


def test_precision_scope_sets_and_restores():
    before = _flags()
    try:
        torch.set_float32_matmul_precision("high")
        torch.backends.cudnn.allow_tf32 = True
        outer = _flags()
        with matmul_precision("float32"):
            assert _flags() == ("highest", False, False)
        assert _flags() == outer
        with matmul_precision("bfloat16"):
            assert torch.get_float32_matmul_precision() == "medium"
        with matmul_precision("inherit"):
            assert _flags() == outer
        with pytest.raises(RuntimeError, match="inside"):
            with matmul_precision("float32"):
                raise RuntimeError("inside")
        assert _flags() == outer
        with pytest.raises(ValueError, match="matmul_precision"):
            with matmul_precision("fp8"):
                pass
        # adaptive solves pin float32 inside the RHS by default, fixed-grid
        # ones inherit; both restore
        seen = []

        def f(t, y):
            seen.append(_flags())
            return -y
        odeint(f, torch.ones(()), T([0.0, 1.0]), method="dopri5")
        assert set(seen) == {("highest", False, False)}
        seen.clear()
        odeint(f, torch.ones(()), T([0.0, 1.0]), method="rk4")
        assert set(seen) == {outer}
        seen.clear()
        odeint(f, torch.ones(()), T([0.0, 1.0]), method="dopri5",
               matmul_precision="inherit")
        assert set(seen) == {outer}
        assert _flags() == outer
    finally:
        torch.set_float32_matmul_precision(before[0])
        torch.backends.cuda.matmul.allow_tf32 = before[1]
        torch.backends.cudnn.allow_tf32 = before[2]


# --------------------------------------------------------------------------- #
# the full-width encoder field                                                #
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def full_width():
    cfg = JLayerConfig(d_model=64, num_heads=8, ff_dim=1024)
    params = encoder_stack_init(jax.random.PRNGKey(0), cfg, 1)
    x = np.random.default_rng(0).standard_normal((32, 11, 1, 64)) \
        .astype(F32)
    tparams = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                            params))
    return cfg, params, x, tparams


@pytest.mark.parametrize("rtol,atol,counts", [
    (1e-7, 1e-9, (71, 71, 428)), (1e-5, 1e-7, (16, 16, 98)),
    (1e-3, 1e-6, (7, 7, 44))])
def test_full_width_accounting_matches_jax(full_width, rtol, atol, counts):
    """``scripts/dopri5_accounting.py``'s setup: the port's attempted /
    accepted steps and RHS evaluations equal JAX's."""
    cfg, params, x, tparams = full_width
    tcfg = ttr.LayerConfig(d_model=64, num_heads=8, ff_dim=1024)
    ysj, stj = jodeint(lambda t, y, p: j_encoder_stack(p, y, cfg),
                       jnp.asarray(x), jnp.linspace(0.0, 12.0, 2), params,
                       method="dopri5", rtol=rtol, atol=atol,
                       return_stats=True)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        yst, stt = odeint(lambda t, y, p: ttr.encoder_stack(p, y, tcfg),
                          T(x), torch.linspace(0.0, 12.0, 2), tparams,
                          method="dopri5", rtol=rtol, atol=atol,
                          return_stats=True)
    assert _counts(stj)[:3] == counts
    assert _counts(stt) == _counts(stj)
    ysj = np.asarray(ysj)
    np.testing.assert_allclose(yst.numpy(), ysj, rtol=0,
                               atol=1e-5 * np.abs(ysj).max())
