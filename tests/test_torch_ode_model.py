"""The model options that ride on the ODE encoder — dopri5 (scan-budget and
adjoint gradients), ``learn_prior`` and encoder-layer dropout — against the
JAX package on the CPU, at a small width (hidden 16, 4 heads, ff 32, K 2, as
``tests/test_ode.py``'s model case).

The JAX side runs ``sttode_forward`` under ``jax.value_and_grad`` (jitted,
"highest" matmul precision, ``attn_impl="dense"``); the port gets the same
weights through ``bridge`` and JAX's own random draws as ``TrainNoise``: the
positional-encoding masks, the latent noise and, under ``dropout > 0``, the
encoder layers' keep-masks, recomputed from JAX's key splits
(``sttode_forward`` → ``_encode_trunk`` → ``encoder_stack`` →
``encoder_layer``). Tolerance: every loss term within 1e-4 (abs and rel),
every gradient leaf within 1e-4 of that leaf's largest magnitude.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sttode_tpu.data import preprocess as jprep
from sttode_tpu.data import synthetic as jsyn
from sttode_tpu.models import sampler as js
from sttode_tpu.models import sttode as jm
from sttode_tpu_torch import bridge
from sttode_tpu_torch.data import preprocess as tprep
from sttode_tpu_torch.models import sampler as ts
from sttode_tpu_torch.models import sttode as tm
from sttode_tpu_torch.nn import attention as tattn
from sttode_tpu_torch.nn.transformer import LayerDropMasks
from sttode_tpu_torch.train import loop as tloop

# one intra-op thread: pytest-xdist runs 6 workers on 8 cores, and
# torch's default of one thread a core each oversubscribes them
torch.set_num_threads(1)

SMALL = dict(hidden_dim=16, num_heads=4, ff_dim=32, zdim=8, sample_k=2,
             past_length=5, future_length=10, select_impl="xla",
             min_clip=0.0, attn_impl="dense")
B, N = 3, 4
LOSSES = ("total_loss", "loss_pred", "loss_recover", "loss_kl",
          "loss_diverse")
CASES = {
    # dopri5 in float64 (see test_forward_and_grads_match_jax)
    "dopri5_scan_budget_f64": dict(ode_method="dopri5", ode_rtol=1e-3,
                                   ode_atol=1e-6, ode_scan_budget=12),
    "dopri5_adjoint_f64": dict(ode_method="dopri5", ode_rtol=1e-4,
                               ode_atol=1e-6, ode_adjoint=True),
    "learn_prior": dict(learn_prior=True),
    "dropout": dict(dropout=0.1),
}


def _batches():
    scenes = jsyn.make_social_scenes(B, agents_range=(N, N), obs_len=5,
                                     pred_len=10, seed=1)
    obs = np.stack([s["obs"] for s in scenes])
    pred = np.stack([s["pred"] for s in scenes])
    valid = np.ones((B, N), np.float32)
    valid[2, 3] = 0.0                      # one padded agent
    jb, _ = jprep.prepare_scene_group(obs, pred, valid, training=True,
                                      rng=np.random.default_rng(3))
    tb, _ = tprep.prepare_scene_group(obs, pred, valid, training=True,
                                      rng=np.random.default_rng(3))
    return jb, tb


def _bern(key, keep, shape):
    return torch.from_numpy(np.array(jax.random.bernoulli(key, keep, shape)))


def _jax_noise(cfg, rng) -> tm.TrainNoise:
    """JAX's draws inside sttode_forward(rng): split(rng, 4) → (enc, fenc,
    q, p); each trunk splits its key into (pe, ode), the PE keep-mask
    [M, T, D] from pe, and under dropout one key per layer from
    split(ode, nlayer), split 4 ways into the masks of the attention
    weights [N, H, L, L], the attention residual [L, N, 1, D], the FFN
    hidden layer [L, N, 1, ff] and the FFN residual (the scene axis:
    L = B scenes)."""
    M, D = B * N, cfg.hidden_dim
    k_enc, k_fenc, k_q, k_p = jax.random.split(rng, 4)

    def trunk(key, T):
        k_pe, k_ode = jax.random.split(key)
        pe = _bern(k_pe, 1.0 - cfg.pe_dropout, (M, T, D))
        if cfg.dropout <= 0.0:
            return pe, None
        keep = 1.0 - cfg.dropout
        layers = []
        for k in jax.random.split(k_ode, max(cfg.nlayer, 1)):
            k_attn, k_d1, k_ffn, k_d2 = jax.random.split(k, 4)
            layers.append(LayerDropMasks(
                _bern(k_attn, keep, (N, cfg.num_heads, B, B)),
                _bern(k_d1, keep, (B, N, 1, D)),
                _bern(k_ffn, keep, (B, N, 1, cfg.ff_dim)),
                _bern(k_d2, keep, (B, N, 1, D))))
        return pe, layers

    pe_past, enc_past = trunk(k_enc, cfg.past_length)
    pe_fut, enc_fut = trunk(k_fenc, cfg.future_length)
    eps_q = torch.from_numpy(np.array(jax.random.normal(k_q, (M, cfg.zdim))))
    eps_p = torch.from_numpy(np.array(jax.random.normal(
        k_p, (M * cfg.sample_k, cfg.zdim))))
    return tm.TrainNoise(pe_past, pe_fut, eps_q, eps_p, enc_past, enc_fut)


def _models(**kw):
    jcfg = jm.STTODEConfig(**SMALL, **kw).validate()
    tcfg = tm.STTODEConfig(**jcfg._asdict()).validate()
    jparams = jm.sttode_init(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                            jparams))
    return jcfg, tcfg, jparams, tparams


def _run_both(kw, f64=False):
    """JAX's and the port's forward and gradient on the same weights,
    batch and draws; with ``f64`` both in float64 (JAX in x64 mode)."""
    jcfg, tcfg, jparams, tparams = _models(**kw)
    jb, tb = _batches()
    rng = jax.random.PRNGKey(7)
    dt = torch.float64 if f64 else torch.float32
    tparams = bridge.tree_map(lambda t: t.to(dt).requires_grad_(), tparams)
    if f64:
        tb = dataclasses.replace(tb, **{f: getattr(tb, f).double() for f in (
            "past", "past_vel", "future", "future_vel", "valid")})

    def jloss(p):
        out = jm.sttode_forward(p, jcfg, jb, rng, train=True)
        return out.total_loss, out

    with jax.enable_x64(f64), jax.default_matmul_precision("highest"):
        # in x64 mode JAX draws its latent noise in float64
        noise = _jax_noise(jcfg, rng)
        if f64:
            jparams, jb = jax.tree_util.tree_map(
                lambda a: jnp.asarray(a, jnp.float64), (jparams, jb))
        (_, jout), jgrads = jax.jit(jax.value_and_grad(
            jloss, has_aux=True))(jparams)
    out = tm.sttode_forward(tparams, tcfg, tb, noise=noise)
    out.total_loss.backward()
    want = [np.asarray(g) for g in jax.tree_util.tree_leaves(jgrads)]
    got = [t.grad for t in bridge.tree_leaves(tparams)]
    return jcfg, jout, out, want, got


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_and_grads_match_jax(case):
    """learn_prior and dropout in float32; the dopri5 gradients in float64
    in both frameworks (JAX in x64 mode). In float32 the forward solves
    agree, but both dopri5 gradients differentiate a controller whose
    error ratio float32 rounding sets where the embedded pair cancels (to
    ~2e-5 of the stage values, which the frameworks round differently by
    3e-7): the scan form's gradient through h then agreed to 1.2e-4 of a
    leaf's largest magnitude, and the adjoint's backward solve, which
    starts from the Hairer step with such ratios, picked other step sizes,
    leaving the two adjoint gradients within the adjoint's truncation
    error only. Float64 removes that floor and leaves the algorithms to
    compare."""
    jcfg, jout, out, want, got = _run_both(CASES[case],
                                           f64=case.endswith("_f64"))
    for name in LOSSES:
        np.testing.assert_allclose(float(getattr(out, name).detach()),
                                   float(getattr(jout, name)), rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    np.testing.assert_allclose(out.past_feature.detach().numpy(),
                               np.asarray(jout.past_feature), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(out.pz.mu.detach().numpy(),
                               np.asarray(jout.pz.mu), rtol=1e-4, atol=1e-4)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g is not None, f"gradient leaf {i} has no gradient"
        np.testing.assert_allclose(
            g.numpy(), w, rtol=0, atol=1e-4 * max(np.abs(w).max(), 1e-30),
            err_msg=f"gradient leaf {i}")
    if case == "learn_prior":
        # pz_layer is a trained leaf: the KL reaches it
        assert len(want) == len(jax.tree_util.tree_leaves(
            jm.sttode_init(jax.random.PRNGKey(0), jcfg._replace(
                learn_prior=False)))) + 2
        assert float(torch.abs(out.pz.mu.detach()).max()) > 0


def test_dropout_changes_the_step_and_draws_once_per_solve():
    """Dropout is live (the injected masks move the loss off the
    deterministic one), masks drawn from a generator are reproducible, and
    a dopri5 solve sees one set of masks in every RHS evaluation."""
    _, tcfg, _, tparams = _models(dropout=0.1)
    _, tb = _batches()
    det = tm.sttode_forward(tparams, tcfg._replace(dropout=0.0), tb,
                            generator=torch.Generator().manual_seed(0))
    a = tm.sttode_forward(tparams, tcfg, tb,
                          generator=torch.Generator().manual_seed(0))
    b = tm.sttode_forward(tparams, tcfg, tb,
                          generator=torch.Generator().manual_seed(0))
    assert float(a.total_loss) == float(b.total_loss)
    assert float(a.total_loss) != float(det.total_loss)
    from sttode_tpu_torch.nn import transformer as ttr
    seen = []
    real = ttr.encoder_layer

    def spy(p, src, cfg, **kw):
        seen.append(kw["drop"])
        return real(p, src, cfg, **kw)
    cfg5 = tcfg._replace(ode_method="dopri5", ode_rtol=1e-3, ode_atol=1e-6,
                         ode_scan_budget=16)
    ttr.encoder_layer = spy
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("error", RuntimeWarning)   # no exhaustion
            tm.sttode_forward(tparams, cfg5, tb,
                              generator=torch.Generator().manual_seed(0))
    finally:
        ttr.encoder_layer = real
    # two trunks, one set of masks each, reused by every evaluation
    assert len(seen) == 2 * (1 + 1 + 6 * 16)
    assert len({id(d) for d in seen}) == 2 and all(d is not None
                                                  for d in seen)


def test_dropout_route_rule_matches_jax():
    """Active dropout sends "auto" to the plain path; a forced kernel
    raises JAX's ValueError."""
    q = torch.randn(2, 4, 8, 8)
    keep = torch.rand(2, 4, 8, 8) > 0.1
    for fused, route in ((True, "fused"), ("packed", "packed"),
                         ("flash", "flash")):
        with pytest.raises(ValueError, match=f"attn_impl='{route}' does not "
                                             "implement attention dropout"):
            tattn.geodesic_attention(q, q, q, fused=fused, dropout_rate=0.1,
                                     dropout_mask=keep)
    assert tattn._kernel_route((2, 4, 8, 8), (2, 4, 8, 8), has_mask=False,
                               has_kv_valid=False, compat="tpu",
                               fused="auto", need_weights=False,
                               metric="oblique", on_cuda=True,
                               dropout_active=True) is None
    out, w = tattn.geodesic_attention(q, q, q, compat="tpu",
                                      dropout_rate=0.1, dropout_mask=keep)
    plain, w0 = tattn.geodesic_attention(q, q, q, compat="tpu")
    torch.testing.assert_close(w, torch.where(keep, w0 / 0.9, 0.0))
    torch.testing.assert_close(out, w @ q)
    _, tcfg, _, tparams = _models(dropout=0.1)
    _, tb = _batches()
    with pytest.raises(ValueError, match="does not implement attention "
                                         "dropout"):
        tm.sttode_forward(tparams, tcfg._replace(attn_impl="packed"), tb)


def test_inference_and_sampler_with_learn_prior_match_jax():
    """The learned prior reaches best-of-K inference (z = mu + ε·sigma)
    and the stage-2 sampler's vae_dist, with pz_layer frozen there."""
    jcfg, tcfg, jparams, tparams = _models(learn_prior=True)
    jb, tb = _batches()
    rng = jax.random.PRNGKey(5)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda p, b: jm.sttode_inference(p, jcfg, b, rng))(
            jparams, jb)
    _, k_p = jax.random.split(rng)
    eps = torch.from_numpy(np.array(jax.random.normal(
        k_p, (B * N * jcfg.sample_k, jcfg.zdim))))
    got = tm.sttode_inference(tparams, tcfg, tb, z=eps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)

    jscfg = js.SamplerConfig(nk=2, nz=8, qnet_mlp=(32, 16))
    jsp = js.sampler_init(jax.random.PRNGKey(1), jscfg, pred_model_dim=16,
                          past_feature_dim=32)
    with jax.default_matmul_precision("highest"):
        jout = jax.jit(lambda sp, net, b: js.sampler_forward(
            sp, net, jscfg, jcfg, b, jax.random.PRNGKey(3), mean=True))(
                jsp, jparams, jb)
    tsp = bridge.tree_map(lambda t: t.requires_grad_(), bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jsp)))
    net = bridge.tree_map(lambda t: t.requires_grad_(), tparams)
    out = ts.sampler_forward(tsp, net, ts.SamplerConfig(**jscfg._asdict()),
                             tcfg, tb)
    for f in ("mu", "logvar"):
        np.testing.assert_allclose(getattr(out.vae_dist, f).detach().numpy(),
                                   np.asarray(getattr(jout.vae_dist, f)),
                                   rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out.dec_motion.detach().numpy(),
                               np.asarray(jout.dec_motion), rtol=1e-4,
                               atol=1e-4)
    total, _ = ts.sampler_loss(out, ts.SamplerConfig(**jscfg._asdict()), tb)
    total.backward()
    assert all(t.grad is None for t in bridge.tree_leaves(net))
    assert tsp["linear"]["w"].grad is not None


def test_dopri5_sampler_and_predictor_run_the_while_form():
    """The frozen net's encoder and the server run without gradients, so a
    dopri5 model serves (and feeds the sampler) on the while form."""
    from sttode_tpu_torch.serving import Predictor
    _, tcfg, _, tparams = _models(ode_method="dopri5", ode_rtol=1e-3,
                                  ode_atol=1e-6, learn_prior=True)
    _, tb = _batches()
    scfg = ts.SamplerConfig(nk=2, nz=8, qnet_mlp=(32, 16))
    tsp = bridge.tree_map(lambda t: t.requires_grad_(),
                          ts.sampler_init(0, scfg, 16, 32))
    net = bridge.tree_map(lambda t: t.requires_grad_(), tparams)
    total, _ = ts.sampler_loss(ts.sampler_forward(tsp, net, scfg, tcfg, tb),
                               scfg, tb)
    total.backward()
    assert np.isfinite(float(total.detach()))
    scenes = [s["obs"] for s in jsyn.make_social_scenes(
        3, agents_range=(2, 5), obs_len=5, pred_len=10, seed=4)]
    pred = Predictor(tparams, tcfg, device="cpu")
    out = pred.predict_many(scenes, seed=1)
    assert [o.shape for o in out] == [(2, len(s), 10, 2) for s in scenes]
    assert all(np.isfinite(o).all() for o in out)
    # with the standard prior the same noise gives other samples
    plain = Predictor(tparams, tcfg._replace(learn_prior=False),
                      device="cpu").predict_many(scenes, seed=1)
    assert not np.allclose(out[0], plain[0])


def test_adjoint_train_step_trains_every_leaf_and_checkpoint_round_trips(
        tmp_path):
    from sttode_tpu_torch.train import checkpoint as tck
    cfg = tm.STTODEConfig(**{**SMALL, "attn_impl": "auto"}, learn_prior=True,
                          ode_method="dopri5", ode_adjoint=True,
                          ode_rtol=1e-4, ode_atol=1e-6)
    step = tloop.make_train_step(cfg, 1e-3, device="cpu")
    params0 = tm.sttode_init(1, cfg)
    assert set(params0["pz_layer"]) == {"w", "b"}
    params, opt = step.init(params0)
    _, tb = _batches()
    params, opt, metrics = step(params, opt, tb,
                                torch.Generator().manual_seed(0))
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    moved = [not torch.equal(a.detach(), b) for a, b in zip(
        bridge.tree_leaves(params), bridge.tree_leaves(params0))]
    assert all(moved)
    path = tck.save_checkpoint(str(tmp_path), 1, params, opt, cfg)
    p2, opt_state, epoch, cfg2 = tck.load_checkpoint(path)
    assert cfg2 == cfg and epoch == 1
    for a, b in zip(bridge.tree_leaves(params), bridge.tree_leaves(p2)):
        torch.testing.assert_close(a.detach(), b, rtol=0, atol=0)
    torch.testing.assert_close(p2["pz_layer"]["w"],
                               params["pz_layer"]["w"].detach())
    # the port's init draws pz_layer after every other leaf
    base = tm.sttode_init(1, cfg._replace(learn_prior=False))
    for a, b in zip(bridge.tree_leaves({k: v for k, v in params0.items()
                                        if k != "pz_layer"}),
                    bridge.tree_leaves(base)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_cli_trainvae_and_dopri5_cli(tmp_path):
    """``cli.trainvae`` appends the VAE-only loss terms; ``cli.train``
    trains a dopri5 adjoint model with learn_prior and ``cli.test``
    evaluates its checkpoint (NBA files, ``--device cpu``)."""
    from sttode_tpu_torch.cli import test as cli_test
    from sttode_tpu_torch.cli import train as cli_train
    from sttode_tpu_torch.cli import trainvae as cli_trainvae
    root = tmp_path / "data" / "nba"
    root.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for fname, n in (("train.npy", 40), ("test.npy", 20)):
        walk = rng.normal(0.0, 1.0, size=(n, 15, 11, 2)).cumsum(1)
        np.save(root / fname, (walk + 40.0).astype(np.float32))
    flags = ["--dataset", "nba", "--data_root", str(tmp_path / "data"),
             "--device", "cpu", "--hidden_dim", "16", "--zdim", "8",
             "--sample_k", "2", "--log_every", "0", "--num_epochs", "1",
             "--model_save_epoch", "1", "--batch_size", "8"]
    run = cli_trainvae.main(flags + ["--ckpt_dir", str(tmp_path / "vae")])
    assert run.cfg.loss_terms == ("pred", "recover", "kl")
    assert np.isfinite(run.history[0][2]["total"])
    assert run.history[0][2]["diverse"] == 0.0
    ode = ["--ode_method", "dopri5", "--ode_adjoint", "--ode_rtol", "1e-3",
           "--ode_atol", "1e-6", "--learn_prior"]
    run = cli_train.main(flags + ode + ["--ckpt_dir", str(tmp_path / "ck")])
    assert (run.cfg.ode_method, run.cfg.ode_adjoint, run.cfg.ode_rtol,
            run.cfg.learn_prior) == ("dopri5", True, 1e-3, True)
    assert np.isfinite(run.history[0][2]["total"])
    best = cli_test.main(flags + ["--ckpt_dir", str(tmp_path / "ck")])
    assert np.isfinite(list(best["table"]["ade"].values())).all()
