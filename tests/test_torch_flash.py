"""The port's S-tiled (flash) geodesic attention against the JAX package, on
the CPU.

On the CPU the wrapper ``kernels.mhgsa.flash_geodesic_attention`` runs its
plain versions (the forward with its per-row lse, and the two backward
sweeps' formula through the port's ``torch.autograd.Function``); they are
held against JAX's ``flash_geodesic_attention``, whose Pallas kernels run in
interpret mode off the TPU, and against ``jax.grad`` through it; then
against the port's own dense path. The training forward with
``attn_impl="flash"`` is held against JAX's with the same bridged weights
and injected noise, and the CLI runs a step on that route. The CUDA kernels
are held against these plain versions on the card by
``tests/test_torch_cuda.py``.

Tolerances: against JAX, forward 3e-5 and gradients 5e-5 × max(1, max |g|),
the JAX suite's own for its flash kernel, whose Gram is a compensated 3-pass
bf16 product (error ~6e-6, amplified by acos' up to ~70 at the clip);
against the port's dense path, 1e-5 (both fp32, other summation orders);
the training forward, every loss term and every gradient leaf within 1e-4
(the Euler step multiplies the encoder field by 12).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sttode_tpu.data import preprocess as jprep
from sttode_tpu.data import synthetic as jsyn
from sttode_tpu.kernels import mhgsa as jmhgsa
from sttode_tpu.models import sttode as jm
from sttode_tpu.nn import attention as jattn
from sttode_tpu_torch import bridge
from sttode_tpu_torch.cli import train as cli_train
from sttode_tpu_torch.data import preprocess as tprep
from sttode_tpu_torch.kernels import flash_geodesic_attention
from sttode_tpu_torch.kernels import mhgsa as tmhgsa
from sttode_tpu_torch.models import sttode as tm
from sttode_tpu_torch.nn import attention as tattn

# one intra-op thread: pytest-xdist runs 6 workers on 8 cores, and
# torch's default of one thread a core each oversubscribes them
torch.set_num_threads(1)

JAX_TOL = 3e-5
GRAD_TOL = 5e-5
DENSE_TOL = 1e-5

# (name, lead, L, S, Dh, validity)
CASES = [
    ("small", (2, 2), 10, 14, 8, None),
    # S = 1100 spans JAX's 3 key tiles of 512 and the port's 9 of 128, both
    # ragged; L = 300 spans 2 query tiles of 256 (3 of 128); Dh = 5 pads
    ("ragged_multi_tile", (1,), 300, 1100, 5, None),
    # keys ≥ 100 invalid: JAX's second tile and the port's last four are
    # entirely invalid
    ("kv_valid_invalid_tile", (1,), 12, 520, 8, "tail"),
    # random validity, and one problem with no valid key at all
    ("kv_valid_all_invalid_problem", (3,), 40, 130, 8, "random"),
]


def T(a, grad=False):
    return torch.from_numpy(np.array(a, np.float32)).requires_grad_(grad)


def _case(seed, lead, L, S, Dh, validity):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((*lead, L, Dh)).astype(np.float32)
    k = rng.standard_normal((*lead, S, Dh)).astype(np.float32)
    v = rng.standard_normal((*lead, S, Dh)).astype(np.float32)
    w = rng.standard_normal((*lead, L, Dh)).astype(np.float32)
    kv = None
    if validity == "tail":
        kv = np.ones((*lead, S), np.float32)
        kv[..., 100:] = 0.0
    elif validity == "random":
        kv = (rng.random((*lead, S)) > 0.3).astype(np.float32)
        kv[..., 0] = 1.0
        kv[-1] = 0.0                      # the last problem has no valid key
    return q, k, v, w, kv


def _jax_flash(q, k, v, kv):
    return np.asarray(jmhgsa.flash_geodesic_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        kv_valid=None if kv is None else jnp.asarray(kv), interpret=True))


def _jax_flash_grads(q, k, v, w, kv):
    def loss(q, k, v):
        out = jmhgsa.flash_geodesic_attention(
            q, k, v, kv_valid=None if kv is None else jnp.asarray(kv),
            interpret=True)
        return jnp.sum(out * w)

    g = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v))
    return [np.asarray(x) for x in g]


def _port_flash(q, k, v, w, kv):
    """(out, [dq, dk, dv]) through the public wrapper and autograd."""
    leaves = [T(q, True), T(k, True), T(v, True)]
    out = flash_geodesic_attention(*leaves,
                                   kv_valid=None if kv is None else T(kv))
    grads = torch.autograd.grad((out * T(w)).sum(), leaves)
    return out.detach().numpy(), [g.numpy() for g in grads]


def _launches():
    return (tmhgsa.flash_geodesic_attention.launches,
            tmhgsa.flash_geodesic_attention_backward.launches_dq,
            tmhgsa.flash_geodesic_attention_backward.launches_dkv)


def _assert_grads(got, want, tol):
    for name, g, wnt in zip(("dq", "dk", "dv"), got, want):
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(
            g, wnt, rtol=0, atol=tol * max(1.0, float(np.abs(wnt).max())),
            err_msg=name)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_flash_matches_jax_interpret(case):
    """Forward, per-row lse and the q, k, v gradients of the port's plain
    versions against JAX's Pallas flash kernel (interpret mode)."""
    _, lead, L, S, Dh, validity = case
    q, k, v, w, kv = _case(1, lead, L, S, Dh, validity)
    before = _launches()
    out, grads = _port_flash(q, k, v, w, kv)
    assert _launches() == before              # plain versions on the CPU
    np.testing.assert_allclose(out, _jax_flash(q, k, v, kv), rtol=0,
                               atol=JAX_TOL)
    _assert_grads(grads, _jax_flash_grads(q, k, v, w, kv), GRAD_TOL)
    # the lse the backward replays from, against the JAX residual
    B = int(np.prod(lead))
    flat = [jnp.asarray(x.reshape(B, -1, Dh)) for x in (q, k, v)]
    jval = None if kv is None else jnp.asarray(kv.reshape(B, S))
    _, res = jmhgsa._flash_fwd(*flat, jval, True)
    _, lse = tmhgsa.flash_geodesic_attention_reference(
        *(T(x.reshape(B, -1, Dh)) for x in (q, k, v)),
        None if kv is None else T(kv.reshape(B, S)))
    np.testing.assert_allclose(lse.numpy(), np.asarray(res[-1])[:, :L, 0],
                               rtol=0, atol=JAX_TOL)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_flash_matches_the_dense_path(case):
    """The same against the port's dense path (max-subtracted softmax over
    the dense scores, the validity as an additive mask, autograd)."""
    _, lead, L, S, Dh, validity = case
    q, k, v, w, kv = _case(2, lead, L, S, Dh, validity)
    out, grads = _port_flash(q, k, v, w, kv)
    leaves = [T(q, True), T(k, True), T(v, True)]
    want, _ = tattn.geodesic_attention(
        *leaves, kv_valid=None if kv is None else T(kv), compat="tpu",
        fused=False)
    if kv is not None and not kv.any(axis=-1).all():
        # the dense softmax of a row with no valid key is uniform over the
        # keys; the kernel's contract is 0 there (JAX's too): hold the rows
        # that have a key
        live = torch.from_numpy(kv.any(axis=-1))
        want = want * live[..., None, None]
    wgrads = torch.autograd.grad((want * T(w)).sum(), leaves)
    np.testing.assert_allclose(out, want.detach().numpy(), rtol=0,
                               atol=DENSE_TOL)
    _assert_grads(grads, [g.numpy() for g in wgrads], DENSE_TOL)


def test_all_invalid_problem_is_exactly_zero():
    """A problem whose every key is invalid outputs exactly 0 and gets
    exactly zero gradients (the floored denominator, no NaN)."""
    q, k, v, w, kv = _case(3, (3,), 40, 130, 8, "random")
    out, grads = _port_flash(q, k, v, w, kv)
    assert np.isfinite(out).all() and np.all(out[-1] == 0.0)
    for g in grads:
        assert np.isfinite(g).all() and np.all(g[-1] == 0.0)
    # invalid keys get exactly zero dk and dv
    dead = kv[0] == 0.0
    assert np.all(grads[1][0][dead] == 0.0) and np.all(grads[2][0][dead] == 0)


def test_identical_qk_gradient_is_finite_and_matches_jax():
    """q = k puts the Gram diagonal at 1, outside the clip: the gate zeros
    those terms instead of turning them into NaN."""
    q, _, v, w, _ = _case(4, (2,), 12, 12, 8, None)

    def jloss(x):
        return jnp.sum(jmhgsa.flash_geodesic_attention(
            x, x, jnp.asarray(v), interpret=True) * w)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(q)))
    tq = T(q, True)
    out = flash_geodesic_attention(tq, tq, T(v))
    got = torch.autograd.grad((out * T(w)).sum(), tq)[0].numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=GRAD_TOL * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("compat,kv", [("reference", False), ("tpu", True)])
def test_geodesic_attention_flash_route_matches_jax(compat, kv):
    """``geodesic_attention(fused="flash")``: the Q3-swapped square case
    under reference compat, and a key validity (axes inserted before S)
    under compat "tpu", forward and gradients against JAX's flash route."""
    rng = np.random.default_rng(5)
    q, k, v, w = (rng.standard_normal((3, 2, 150, 8)).astype(np.float32)
                  for _ in range(4))
    valid = None
    if kv:
        valid = (rng.random((3, 150)) > 0.25).astype(np.float32)
        valid[:, 0] = 1.0

    def jloss(q, k, v):
        out, _ = jattn.geodesic_attention(
            q, k, v, compat=compat, fused="flash",
            kv_valid=None if valid is None else jnp.asarray(valid))
        return jnp.sum(out * w), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [T(q, True), T(k, True), T(v, True)]
    before = _launches()
    out, wts = tattn.geodesic_attention(
        *leaves, compat=compat, fused="flash",
        kv_valid=None if valid is None else T(valid))
    grads = torch.autograd.grad((out * T(w)).sum(), leaves)
    assert wts is None and _launches() == before
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=0, atol=JAX_TOL)
    _assert_grads([g.numpy() for g in grads],
                  [np.asarray(g) for g in jgrads], GRAD_TOL)


def test_flash_refuses_additive_masks_and_poincare():
    q = torch.randn(2, 3, 16, 8)
    with pytest.raises(ValueError, match="key-validity"):
        tattn.geodesic_attention(q, q, q, mask=torch.zeros(2, 3, 16, 16),
                                 compat="tpu", fused="flash")
    # under the Q3 swap a key validity is an additive mask: refused as well
    with pytest.raises(ValueError, match="Q3"):
        tattn.geodesic_attention(q, q, q, kv_valid=torch.ones(2, 16),
                                 compat="reference", fused="flash")
    # poincaré is ported; below the maxless softmax's curvature it is
    # refused, as by JAX's kernel
    with pytest.raises(ValueError, match="curvature"):
        flash_geodesic_attention(q, q, q, metric="poincare", curvature=0.005)


@pytest.mark.parametrize("B", [1036, 1037, 2048, 2049, 2304])
def test_route_sends_scene_batches_beyond_the_whole_s_fit_to_flash(B):
    """The scene-axis problem of B scenes, [11 agents, 8 heads, B, 8], on
    the card: maskless it goes to flash from B = 1037, where the whole-S
    backward kernel's 224·B + 256 bytes pass the 232,448-byte opt-in limit;
    with an additive mask it keeps JAX's rule (whole-S up to 2048, plain
    beyond). The shared-memory formulas are the kernels' launch checks."""
    fwd, bwd = tmhgsa.whole_s_smem_bytes(B, B, 8)
    assert (fwd, bwd) == (84 * B + 128, 224 * B + 256)
    shape = (11, 8, B, 8)

    def route(**kw):
        flags = dict(has_mask=False, has_kv_valid=False, compat="reference",
                     fused="auto", need_weights=False, metric="oblique",
                     on_cuda=True)
        return tattn._kernel_route(shape, shape, **{**flags, **kw})

    assert route() == ("fused" if B <= 1036 else "flash")
    assert route(has_mask=True) == ("fused" if B <= 2048 else None)
    # under the Q3 swap a key validity is a mask
    assert route(has_kv_valid=True) == route(has_mask=True)
    assert route(has_kv_valid=True, compat="tpu") == route()
    assert route(on_cuda=False) is None
    assert route(fused="flash", on_cuda=False) == "flash"


# --------------------------------------------------------------------------- #
# the training forward and the CLI on the flash route                        #
# --------------------------------------------------------------------------- #

SMALL = dict(hidden_dim=16, num_heads=2, ff_dim=32, zdim=8, sample_k=4,
             past_length=5, future_length=10)
N_SCENES, N_AGENTS = 24, 3
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


def test_sttode_forward_on_the_flash_route_matches_jax(monkeypatch):
    """The stage-1 training forward and backward with ``attn_impl="flash"``
    (reference compat, scene axis: both trunks run the Q3-swapped flash
    problems [3 agents, 2 heads, 24 scenes, 8]) against JAX's flash route
    with the same bridged weights and injected noise."""
    jcfg = jm.STTODEConfig(attn_impl="flash", min_clip=0.0,
                           **SMALL).validate()
    tcfg = tm.STTODEConfig(**jcfg._asdict()).validate()
    scenes = jsyn.make_social_scenes(N_SCENES,
                                     agents_range=(N_AGENTS, N_AGENTS),
                                     obs_len=5, pred_len=10, seed=2)
    obs = np.stack([s["obs"] for s in scenes])
    pred = np.stack([s["pred"] for s in scenes])
    valid = np.ones((N_SCENES, N_AGENTS), np.float32)
    jb, _ = jprep.prepare_scene_group(obs, pred, valid, training=True,
                                      rng=np.random.default_rng(4))
    tb, _ = tprep.prepare_scene_group(obs, pred, valid, training=True,
                                      rng=np.random.default_rng(4))
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
    calls = []
    real = tmhgsa.flash_geodesic_attention_reference
    monkeypatch.setattr(tmhgsa, "flash_geodesic_attention_reference",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    before = _launches()
    out = tm.sttode_forward(tparams, tcfg, tb, noise=_jax_noise(
        jcfg, rng, N_SCENES * N_AGENTS))
    out.total_loss.backward()
    assert calls == [(N_AGENTS * 2, N_SCENES, 8)] * 2   # both trunks
    assert _launches() == before
    for name in LOSSES:
        np.testing.assert_allclose(float(getattr(out, name).detach()),
                                   float(getattr(jout, name)), rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    want = [np.asarray(g) for g in jax.tree_util.tree_leaves(jgrads)]
    got = [t.grad.numpy() for t in bridge.tree_leaves(tparams)]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4,
                                   err_msg=f"gradient leaf {i}")


def test_cli_train_takes_a_step_on_the_flash_route(tmp_path, monkeypatch):
    """``cli.train --device cpu --attn_impl flash`` takes one step on a tiny
    NBA file through the flash plain versions. ``--batch_size`` needs
    nothing of its own: it sizes the scene batch (here 40 of 50 scenes, one
    step) exactly as the JAX CLI's does, and the route follows the shapes."""
    rng = np.random.default_rng(0)
    d = tmp_path / "data" / "nba"
    d.mkdir(parents=True)
    for name, n in (("train.npy", 50), ("test.npy", 4)):
        start = rng.uniform([0.0, 0.0], [94.0, 50.0], size=(n, 1, 11, 2))
        walk = rng.normal(0.0, 1.0, size=(n, 15, 11, 2)).cumsum(axis=1)
        np.save(d / name, (start + walk).astype(np.float32))
    calls = []
    real = tmhgsa.flash_geodesic_attention_reference
    monkeypatch.setattr(tmhgsa, "flash_geodesic_attention_reference",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    run = cli_train.main([
        "--dataset", "nba", "--data_root", str(tmp_path / "data"),
        "--ckpt_dir", str(tmp_path / "ck"), "--device", "cpu",
        "--hidden_dim", "16", "--zdim", "8", "--sample_k", "4",
        "--log_every", "0", "--num_epochs", "1", "--attn_impl", "flash",
        "--batch_size", "40"])
    assert run.cfg.attn_impl == "flash"
    assert calls == [(11 * 8, 40, 2)] * 2    # 11 agents × 8 heads, B = 40
    ((epoch, _, means),) = run.history
    assert epoch == 0 and np.isfinite(list(means.values())).all()
    assert all(int(s["step"]) == 1
               for s in run.opt.state_dict()["state"].values())
