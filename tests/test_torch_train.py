"""The port's stage-1 training step against the JAX package, on the CPU.

The JAX side runs ``sttode_forward`` under ``jax.value_and_grad`` (jitted,
"highest" matmul precision) with ``attn_impl="dense"``; the port gets the
same weights through ``bridge`` and JAX's own random draws, recomputed from
the key split of ``sttode_forward`` and ``_encode_trunk`` and injected as
``TrainNoise``: the two positional-encoding dropout keep-masks and the
posterior and prior latent noise. ``min_clip=0`` in most cases, so that the
KL term (floored at 2 by default, quirk Q5) carries a gradient.

Tolerances. fp32: every loss term and every gradient leaf within 1e-4 abs/rel
(the Euler step multiplies the encoder field by 12; measured ≤ 2e-5 on the
losses, ≤ 4e-6 on the gradients). The bf16 recipe (``select_dtype`` and
``decode_dtype`` "bfloat16"): losses within 4e-3 relative, 2⁻⁸ (measured
up to 1e-3), and the whole gradient tree within 3e-2 relative L2 (measured
8e-3): bf16 storage keeps 8 bits of mantissa in every decode activation, and XLA on the CPU
keeps some intermediates of a fused bf16 expression in fp32 where PyTorch
rounds after every operation. Adam: one update within 1e-6 of
``optax.adam``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sttode_tpu.data import preprocess as jprep
from sttode_tpu.data import synthetic as jsyn
from sttode_tpu.models import sttode as jm
from sttode_tpu_torch import bridge
from sttode_tpu_torch.data import preprocess as tprep
from sttode_tpu_torch.kernels import mhgsa as tmhgsa
from sttode_tpu_torch.kernels import select_decode as tsd
from sttode_tpu_torch.models import sttode as tm
from sttode_tpu_torch.train import loop as tloop

# one intra-op thread: pytest-xdist runs 6 workers on 8 cores, and
# torch's default of one thread a core each oversubscribes them
torch.set_num_threads(1)

SMALL = dict(hidden_dim=16, num_heads=2, ff_dim=32, zdim=8, sample_k=4,
             past_length=5, future_length=10)
B, N = 3, 4
LOSSES = ("total_loss", "loss_pred", "loss_recover", "loss_kl",
          "loss_diverse")
CASES = {
    "xla_sparse": dict(select_impl="xla", min_clip=0.0),
    "fused_sparse": dict(select_impl="fused", min_clip=0.0),
    "xla_dense": dict(select_impl="xla", diverse_grad="dense", min_clip=0.0),
    "auto_sparse": dict(select_impl="auto", min_clip=0.0),
    "kl_floor_default": dict(select_impl="xla"),
    "vae_only": dict(select_impl="xla", min_clip=0.0,
                     loss_terms=("pred", "recover", "kl")),
}


def _batches(cfg):
    scenes = jsyn.make_social_scenes(B, agents_range=(N, N),
                                     obs_len=cfg.past_length,
                                     pred_len=cfg.future_length, seed=1)
    obs = np.stack([s["obs"] for s in scenes])
    pred = np.stack([s["pred"] for s in scenes])
    valid = np.ones((B, N), np.float32)
    valid[2, 3] = 0.0                      # one padded agent
    jb, _ = jprep.prepare_scene_group(obs, pred, valid, training=True,
                                      rng=np.random.default_rng(3))
    tb, _ = tprep.prepare_scene_group(obs, pred, valid, training=True,
                                      rng=np.random.default_rng(3))
    return jb, tb


def _jax_noise(cfg, rng) -> tm.TrainNoise:
    """JAX's draws inside sttode_forward(rng): split(rng, 4) → (enc, fenc,
    q, p); each trunk splits its key into (pe, ode) and draws the PE keep-
    mask [M, T, D] with bernoulli(1 − pe_dropout)."""
    M, D = B * N, cfg.hidden_dim
    k_enc, k_fenc, k_q, k_p = jax.random.split(rng, 4)

    def keep(key, T):
        k_pe, _ = jax.random.split(key)
        return np.asarray(jax.random.bernoulli(k_pe, 1.0 - cfg.pe_dropout,
                                               (M, T, D)))

    eps_q = jax.random.normal(k_q, (M, cfg.zdim))
    eps_p = jax.random.normal(k_p, (M * cfg.sample_k, cfg.zdim))
    return tm.TrainNoise(*(torch.from_numpy(np.array(a)) for a in (
        keep(k_enc, cfg.past_length), keep(k_fenc, cfg.future_length),
        eps_q, eps_p)))


def _run_both(kw):
    jcfg = jm.STTODEConfig(attn_impl="dense", **SMALL, **kw).validate()
    tcfg = tm.STTODEConfig(**jcfg._asdict()).validate()
    jparams = jm.sttode_init(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.tree_map(
        lambda t: t.requires_grad_(),
        bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams)))
    jb, tb = _batches(jcfg)
    rng = jax.random.PRNGKey(7)

    def jloss(p):
        out = jm.sttode_forward(p, jcfg, jb, rng, train=True)
        return out.total_loss, out

    with jax.default_matmul_precision("highest"):
        (_, jout), jgrads = jax.jit(jax.value_and_grad(jloss,
                                                       has_aux=True))(jparams)
    out = tm.sttode_forward(tparams, tcfg, tb, noise=_jax_noise(jcfg, rng))
    out.total_loss.backward()
    want = [np.asarray(g) for g in jax.tree_util.tree_leaves(jgrads)]
    got = [t.grad.numpy() for t in bridge.tree_leaves(tparams)]
    return jcfg, jout, out, want, got, tb


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_and_grads_match_jax_fp32(case):
    jcfg, jout, out, want, got, _ = _run_both(CASES[case])
    for name in LOSSES:
        np.testing.assert_allclose(float(getattr(out, name)),
                                   float(getattr(jout, name)),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    np.testing.assert_allclose(out.pred_traj.detach().numpy(),
                               np.asarray(jout.pred_traj), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(out.past_feature.detach().numpy(),
                               np.asarray(jout.past_feature), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(out.qz.mu.detach().numpy(),
                               np.asarray(jout.qz.mu), rtol=1e-4, atol=1e-4)
    if jcfg.select_impl == "fused" and jcfg.diverse_grad == "sparse":
        assert np.isnan(out.diverse_pred.numpy()).all()
    else:
        np.testing.assert_allclose(out.diverse_pred.numpy(),
                                   np.asarray(jout.diverse_pred), rtol=1e-4,
                                   atol=1e-4)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4,
                                   err_msg=f"gradient leaf {i}")
    if "kl" in jcfg.loss_terms and jcfg.min_clip == 0.0:
        assert float(out.loss_kl) < 2.0    # the term is live, not floored


def test_pe_tables_receive_gradients():
    """Every leaf trains, the positional tables included: JAX slices them
    differentiably (its optimizer updates rows 0..T-1)."""
    _, _, _, want, got, _ = _run_both(CASES["xla_sparse"])
    pe = [i for i, g in enumerate(got) if g.shape == (200, 16)]
    assert len(pe) == 2
    for i in pe:
        assert np.abs(got[i][:5]).max() > 0
        assert np.all(got[i][10:] == 0) and np.all(want[i][10:] == 0)


def test_bf16_recipe_matches_jax():
    """The bf16 recipe on the selection kernel's route ("fused": the
    kernel's plain version here, JAX's Pallas kernel in interpret mode)."""
    _, jout, out, want, got, _ = _run_both(dict(
        select_impl="fused", select_dtype="bfloat16",
        decode_dtype="bfloat16", min_clip=0.0))
    for name in LOSSES:
        np.testing.assert_allclose(float(getattr(out, name)),
                                   float(getattr(jout, name)), rtol=4e-3,
                                   err_msg=name)
    num = sum(float(np.sum((g - w) ** 2)) for g, w in zip(got, want))
    den = sum(float(np.sum(w ** 2)) for w in want)
    assert (num / den) ** 0.5 < 3e-2
    assert all(np.isfinite(g).all() for g in got)


def test_bf16_plain_selection_matches_jax_up_to_near_ties():
    """The plain route's bf16 selection ("xla": the whole K-decode in bf16)
    rounds where each framework's ops round, so its distances agree with
    JAX's only to bf16 resolution and a winner may flip where two samples
    are that close; every flip must be such a near-tie."""
    _, jout, out, _, _, tb = _run_both(dict(
        select_impl="xla", select_dtype="bfloat16", decode_dtype="bfloat16",
        min_clip=0.0))
    fut = tb.future.numpy()[:, None]
    jdist = np.sum((fut - np.asarray(jout.diverse_pred)) ** 2, axis=(-1, -2))
    tdist = np.sum((fut - out.diverse_pred.numpy()) ** 2, axis=(-1, -2))
    # a few bf16 steps (2⁻⁸ each) through the decode: measured 8.3e-3
    np.testing.assert_allclose(tdist, jdist, rtol=2e-2)
    rows = np.arange(len(jdist))
    t_win, j_win = tdist.argmin(1), jdist.argmin(1)
    gap = np.abs(jdist[rows, t_win] - jdist[rows, j_win])
    assert np.all((t_win == j_win) | (gap <= 4e-2 * jdist[rows, j_win]))
    for name in ("loss_kl", "loss_pred", "loss_recover"):
        np.testing.assert_allclose(float(getattr(out, name)),
                                   float(getattr(jout, name)), rtol=4e-3,
                                   err_msg=name)
    assert np.isfinite(float(out.loss_diverse))


def test_adam_update_matches_optax():
    rng = np.random.default_rng(0)
    cfg = tm.STTODEConfig(**SMALL)
    params = bridge.params_to_numpy(tm.sttode_init(0, cfg))
    grads = jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), params)
    opt = optax.adam(1e-4)
    jp = params
    state = opt.init(jp)
    for _ in range(3):
        updates, state = opt.update(grads, state, jp)
        jp = optax.apply_updates(jp, updates)
    step = tloop.make_train_step(cfg, 1e-4, device="cpu")
    tp, adam = step.init(bridge.params_from_jax(params))
    for _ in range(3):
        for t, g in zip(bridge.tree_leaves(tp), jax.tree_util.tree_leaves(
                bridge.params_from_jax(grads))):
            t.grad = g.clone()
        adam.step()
    for a, b in zip(jax.tree_util.tree_leaves(jp),
                    bridge.tree_leaves(bridge.params_to_numpy(tp))):
        np.testing.assert_allclose(b, np.asarray(a), rtol=0, atol=1e-6)


def test_train_step_on_cpu_trains_every_leaf_and_launches_nothing():
    cfg = tm.STTODEConfig(**SMALL, select_impl="fused", min_clip=0.0)
    step = tloop.make_train_step(cfg, 1e-3, device="cpu")
    params0 = tm.sttode_init(1, cfg)
    params, opt_state = step.init(params0)
    _, tb = _batches(cfg)
    gen = torch.Generator().manual_seed(0)
    before = (tmhgsa.fused_geodesic_attention.launches,
              tmhgsa.fused_geodesic_attention_backward.launches,
              tsd.select_decode.launches)
    params, opt_state, m1 = step(params, opt_state, tb, gen)
    assert set(m1) == {"total", "pred", "recover", "kl", "diverse"}
    assert all(bool(torch.isfinite(v)) for v in m1.values())
    assert (tmhgsa.fused_geodesic_attention.launches,
            tmhgsa.fused_geodesic_attention_backward.launches,
            tsd.select_decode.launches) == before
    moved = [not torch.equal(a.detach(), b) for a, b in zip(
        bridge.tree_leaves(params), bridge.tree_leaves(params0))]
    # Adam moves every leaf whose gradient is not identically zero; the
    # positional tables move in their first T rows
    assert sum(moved) == len(moved)
    params, opt_state, means = tloop.train_epoch(
        step, params, opt_state, [(tb, None)] * 3, gen, log_every=2,
        log_fn=lambda msg: None)
    assert set(means) == set(m1) and all(np.isfinite(list(means.values())))


def test_train_step_runs_on_the_card_by_default():
    cfg = tm.STTODEConfig(**SMALL)
    if torch.cuda.is_available():
        assert tloop.make_train_step(cfg, 1e-4).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tloop.make_train_step(cfg, 1e-4)


def test_bridge_leaves_follow_jax_order():
    cfg = jm.STTODEConfig(**SMALL)
    jparams = jm.sttode_init(jax.random.PRNGKey(0), cfg)
    tparams = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                            jparams))
    for a, b in zip(jax.tree_util.tree_leaves(jparams),
                    bridge.tree_leaves(tparams)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    back = bridge.params_to_numpy(tparams)
    for a, b in zip(jax.tree_util.tree_leaves(jparams),
                    bridge.tree_leaves(back)):
        assert isinstance(b, np.ndarray)
        np.testing.assert_array_equal(np.asarray(a), b)


def test_dropout_and_kl_pieces():
    from sttode_tpu.nn import core as jcore
    from sttode_tpu.utils.distributions import DiagNormal as JDiag
    from sttode_tpu_torch.nn import core as tcore
    from sttode_tpu_torch.utils.distributions import DiagNormal as TDiag

    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 5, 6)).astype(np.float32)
    key = jax.random.PRNGKey(2)
    want = np.asarray(jcore.dropout(key, jnp.asarray(x), 0.1, False))
    keep = torch.from_numpy(np.array(jax.random.bernoulli(key, 0.9,
                                                          x.shape)))
    got = tcore.dropout(torch.from_numpy(x), 0.1, keep_mask=keep).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    drawn = tcore.dropout(torch.ones(4000), 0.1,
                          generator=torch.Generator().manual_seed(0))
    vals = np.unique(drawn.numpy())
    np.testing.assert_allclose(vals, [0.0, 1 / 0.9], rtol=1e-6)
    assert 0.05 < float((drawn == 0).float().mean()) < 0.15
    mu, lv = (rng.standard_normal((4, 3)).astype(np.float32) for _ in "ab")
    pmu, plv = (rng.standard_normal((4, 3)).astype(np.float32) for _ in "ab")
    np.testing.assert_allclose(
        TDiag(torch.from_numpy(mu), torch.from_numpy(lv)).kl(
            TDiag(torch.from_numpy(pmu), torch.from_numpy(plv))).numpy(),
        np.asarray(JDiag(jnp.asarray(mu), jnp.asarray(lv)).kl(
            JDiag(jnp.asarray(pmu), jnp.asarray(plv)))),
        rtol=1e-5, atol=1e-6)
