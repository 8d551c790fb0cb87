"""The port's stage 2, the DLow diversity sampler, on the CPU, held to the JAX
package.

The JAX side runs its own functions (jitted where the JAX package jits
them, "highest" matmul precision) with the weights carried to the port by
``bridge.params_from_jax``; where its attention reaches a Pallas kernel
(``attn_impl="packed"`` on the scene axis, "fused" on the agent axis) the
kernel runs in interpret mode, as JAX runs it off the TPU, and the port
runs the kernel's plain version. JAX's ε draw is injected as ``eps``.

Narrow widths: hidden 16, 2 heads, ff 32, zdim 8, nk 5, ``qnet_mlp``
(32, 16). Tolerances (PERF.md §2): forward quantities and losses 1e-4
abs/rel; every sampler gradient leaf within 1e-4 × max(1, the leaf's
largest magnitude); bf16 decode storage, losses within 4e-3 relative (the
stage-1 rule, 2⁻⁸); three Adam steps under the lambda schedule, every
parameter within 1e-5; evaluation and serving 1e-4.
"""

import os

import jax
import numpy as np
import pytest
import torch

from sttode_tpu.cli import common as jcommon
from sttode_tpu.cli import test_sampler as jtest_sampler
from sttode_tpu.cli import trainsampler as jtrainsampler
from sttode_tpu.data import batching as jbatching
from sttode_tpu.data import synthetic as jsyn
from sttode_tpu.models import sampler as js
from sttode_tpu.models import sttode as jm
from sttode_tpu.serving import Predictor as JPredictor
from sttode_tpu.train import loop as jloop
from sttode_tpu.train import schedulers as jsched
from sttode_tpu.utils.distributions import DiagNormal as JDiagNormal
from sttode_tpu_torch import bridge
from sttode_tpu_torch.cli import common
from sttode_tpu_torch.cli import test_sampler as cli_test_sampler
from sttode_tpu_torch.cli import train as cli_train
from sttode_tpu_torch.cli import trainsampler as cli_trainsampler
from sttode_tpu_torch.data import batching as tbatching
from sttode_tpu_torch.data import preprocess as tprep
from sttode_tpu_torch.data import synthetic as tsyn
from sttode_tpu_torch.kernels import mhgsa as tmhgsa
from sttode_tpu_torch.kernels import packed_mhgsa as tpacked
from sttode_tpu_torch.kernels import select_decode as tsd
from sttode_tpu_torch.models import sampler as ts
from sttode_tpu_torch.models import sttode as tm
from sttode_tpu_torch.serving import Predictor
from sttode_tpu_torch.train import checkpoint as tck
from sttode_tpu_torch.train import loop as tloop
from sttode_tpu_torch.train import schedulers as tsched
from sttode_tpu_torch.utils.distributions import DiagNormal

# one intra-op thread: pytest-xdist runs 6 workers on 8 cores, and
# torch's default of one thread a core each oversubscribes them
torch.set_num_threads(1)

SMALL = dict(hidden_dim=16, num_heads=2, ff_dim=32, zdim=8, sample_k=5)
SCFG = dict(nk=5, nz=8, qnet_mlp=(32, 16))
TOL = dict(rtol=1e-4, atol=1e-4)
RECIPES = {
    # reference compat, scene axis, one scene (5 real agents of 8): the
    # packed route
    "reference_packed": (dict(attn_impl="packed"), 1, (5, 5)),
    # compat "tpu", agent axis, 3 scenes of 3-7 agents in bucket 8: the
    # fused route with key masks
    "tpu_agent_fused": (dict(attn_impl="fused", compat="tpu",
                             attn_axis="agent"), 3, (3, 7)),
    # the poincaré metric on the agent axis (the whole-S poincaré forward)
    "poincare_agent": (dict(attn_impl="fused", compat="tpu",
                            attn_axis="agent", attn_metric="poincare",
                            curvature=0.7), 3, (3, 7)),
}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _models(scfg_kw=None, **kw):
    """(JAX cfg, port cfg, JAX sampler cfg, port sampler cfg, JAX net, port
    net, JAX sampler params, port sampler params): the port's weights are
    JAX's, carried by the bridge."""
    jcfg = jm.STTODEConfig(**{**SMALL, **kw}).validate()
    tcfg = tm.STTODEConfig(**jcfg._asdict()).validate()
    jscfg = js.SamplerConfig(**{**SCFG, **(scfg_kw or {})})
    tscfg = ts.SamplerConfig(**jscfg._asdict())
    jnet = jm.sttode_init(jax.random.PRNGKey(0), jcfg)
    jsp = js.sampler_init(jax.random.PRNGKey(1), jscfg,
                          pred_model_dim=jcfg.hidden_dim,
                          past_feature_dim=2 * jcfg.hidden_dim)
    return (jcfg, tcfg, jscfg, tscfg, jnet,
            bridge.params_from_jax(_np_tree(jnet)), jsp,
            bridge.params_from_jax(_np_tree(jsp)))


def _recipe_batches(recipe):
    """The same training batch of ``scene_batches`` for both packages, with
    padded agents."""
    _, spb, agents = RECIPES[recipe]
    scenes = jsyn.make_social_scenes(spb, agents_range=agents, seed=12)
    (jb, _), = jbatching.scene_batches(scenes, training=True, rng=np.random
                                       .default_rng(1), scenes_per_batch=spb)
    (tb, _), = tbatching.scene_batches(scenes, training=True, rng=np.random
                                       .default_rng(1), scenes_per_batch=spb)
    assert tb.agent_num == 8 and float(tb.valid.min()) == 0.0
    return jb, tb


def _setup(recipe, scfg_kw=None, **kw):
    models = _models(scfg_kw, **{**RECIPES[recipe][0], **kw})
    return (*models, *_recipe_batches(recipe))


def _jax_eps(jscfg, rng, M):
    """JAX's ε inside sampler_forward(rng): split(rng, 3)[1], one [1, nz]
    draw under share_eps, else [M, nz]."""
    _, k_eps, _ = jax.random.split(rng, 3)
    shape = (1, jscfg.nz) if jscfg.share_eps else (M, jscfg.nz)
    return torch.from_numpy(np.array(jax.random.normal(k_eps, shape)))


def _assert_output_matches(out, jout):
    for name in ("dec_motion", "recon_motion"):
        np.testing.assert_allclose(getattr(out, name).detach().numpy(),
                                   np.asarray(getattr(jout, name)), **TOL,
                                   err_msg=name)
    for name in ("sampler_dist", "vae_dist"):
        for f in ("mu", "logvar"):
            np.testing.assert_allclose(
                getattr(getattr(out, name), f).detach().numpy(),
                np.asarray(getattr(getattr(jout, name), f)), **TOL,
                err_msg=f"{name}.{f}")


def _packed_calls(monkeypatch):
    calls = []
    real = tpacked.packed_geodesic_attention_reference
    monkeypatch.setattr(tpacked, "packed_geodesic_attention_reference",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    return calls


def _launches():
    return (tmhgsa.fused_geodesic_attention.launches,
            tmhgsa.fused_geodesic_attention_backward.launches,
            tpacked.packed_geodesic_attention.launches,
            tpacked.packed_geodesic_attention_backward.launches,
            tsd.select_decode.launches)


# --------------------------------------------------------------------------- #
# init and forward                                                            #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("qnet_mlp", [(32, 16), (512, 256), (24,)])
def test_sampler_init_tree_matches_jax(qnet_mlp):
    """Keys, leaf order and leaf shapes of ``sampler_init`` equal JAX's (the
    JAX tree is dicts and lists: the bridge carries it leaf for leaf, in
    JAX's [in, out] layouts); the initializers' distributions: N(0, 0.01²)
    MLP weights, zero MLP biases, U(±1/√fan_in) dense layers."""
    scfg = SCFG | dict(qnet_mlp=qnet_mlp)
    jsp = js.sampler_init(jax.random.PRNGKey(0), js.SamplerConfig(**scfg),
                          pred_model_dim=16, past_feature_dim=32)
    tsp = ts.sampler_init(0, ts.SamplerConfig(**scfg), pred_model_dim=16,
                          past_feature_dim=32)
    assert jax.tree_util.tree_structure(tsp) == \
        jax.tree_util.tree_structure(_np_tree(jsp))
    for a, b in zip(bridge.tree_leaves(tsp), jax.tree_util.tree_leaves(jsp)):
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32
    bridged = bridge.params_from_jax(_np_tree(jsp))
    for a, b in zip(bridge.tree_leaves(bridged),
                    jax.tree_util.tree_leaves(jsp)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for layer in tsp["q_mlp"]["layers"]:
        assert float(layer["w"].abs().max()) < 0.06
        assert not layer["b"].any()
    for name, fan_in in (("linear", 32), ("q_A", qnet_mlp[-1]),
                         ("q_c", 5 * 8)):
        assert float(tsp[name]["w"].abs().max()) <= fan_in ** -0.5


@pytest.mark.parametrize("recipe", list(RECIPES))
def test_forward_mean_matches_jax(recipe, monkeypatch):
    """``sampler_forward`` at mean=True (the default deterministic path):
    dec_motion, recon_motion and both distributions, on each recipe's
    route."""
    jcfg, tcfg, jscfg, tscfg, jnet, tnet, jsp, tsp, jb, tb = _setup(recipe)
    with jax.default_matmul_precision("highest"):
        jout = jax.jit(lambda sp, net, b: js.sampler_forward(
            sp, net, jscfg, jcfg, b, jax.random.PRNGKey(3), mean=True))(
                jsp, jnet, jb)
    calls = _packed_calls(monkeypatch)
    before = _launches()
    out = ts.sampler_forward(tsp, tnet, tscfg, tcfg, tb)
    assert _launches() == before
    # the scene axis ran the packed formula on [8 agents, 2 heads, 1 scene,
    # 8]; the agent axis the masked whole-S route
    assert calls == ([(8, 2, 1, 8)] if recipe == "reference_packed" else [])
    M = tb.batch_size * tb.agent_num
    assert out.dec_motion.shape == (M, 5, 12, 2)
    assert out.sampler_dist.mu.shape == out.vae_dist.mu.shape == (M * 5, 8)
    _assert_output_matches(out, jout)


@pytest.mark.parametrize("share_eps", [True, False])
@pytest.mark.parametrize("recipe", ["reference_packed", "tpu_agent_fused"])
def test_forward_with_injected_eps_matches_jax(recipe, share_eps):
    """mean=False: z = A·ε + b with JAX's ε injected, one [1, nz] draw
    shared by every row, or each agent's [nz] draw shared by its K rows
    (a repeat, not a tile)."""
    jcfg, tcfg, jscfg, tscfg, jnet, tnet, jsp, tsp, jb, tb = _setup(
        recipe, dict(share_eps=share_eps))
    rng = jax.random.PRNGKey(7)
    with jax.default_matmul_precision("highest"):
        jout = jax.jit(lambda sp, net, b: js.sampler_forward(
            sp, net, jscfg, jcfg, b, rng, mean=False))(jsp, jnet, jb)
    M = tb.batch_size * tb.agent_num
    out = ts.sampler_forward(tsp, tnet, tscfg, tcfg, tb, mean=False,
                             eps=_jax_eps(jscfg, rng, M))
    _assert_output_matches(out, jout)
    with pytest.raises(ValueError, match="eps must be"):
        ts.sampler_forward(tsp, tnet, tscfg, tcfg, tb, mean=False,
                           eps=torch.zeros(M + 1, 8))


def test_forward_draws_eps_from_the_generator():
    """With no ``eps`` the draw comes from ``generator``: the same seed
    gives the same decode, another seed another; the mean path draws
    nothing."""
    _, tcfg, _, tscfg, _, tnet, _, tsp, _, tb = _setup("tpu_agent_fused")

    def run(seed, **kw):
        return ts.sampler_forward(
            tsp, tnet, tscfg, tcfg, tb,
            generator=torch.Generator().manual_seed(seed), **kw).dec_motion

    a, b, c = run(0, mean=False), run(0, mean=False), run(1, mean=False)
    assert torch.equal(a, b) and not torch.allclose(a, c)
    assert torch.equal(run(0), run(1))


# --------------------------------------------------------------------------- #
# losses                                                                      #
# --------------------------------------------------------------------------- #

def _dists(rng, rows, Z):
    arr = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    mu, logvar = arr(rows, Z), 0.5 * arr(rows, Z) - 1.0
    prior_mu, prior_lv = np.zeros((rows, Z), np.float32), \
        np.zeros((rows, Z), np.float32)
    return mu, logvar, prior_mu, prior_lv


@pytest.mark.parametrize("min_clip", [0.0, 1e6], ids=["above", "at_floor"])
@pytest.mark.parametrize("masked", [False, True])
def test_sampler_kld_matches_jax(masked, min_clip):
    """KL(sampler ‖ prior), its floor and its gradient (zero at the floor),
    with and without a validity (the denominator counts the real agents)."""
    rng = np.random.default_rng(3)
    M, K, Z = 6, 5, 8
    mu, lv, pmu, plv = _dists(rng, M * K, Z)
    valid = np.array([1, 1, 0, 1, 0, 1], np.float32) if masked else None

    def jf(mu_, lv_):
        return js.sampler_kld(JDiagNormal(mu_, lv_), JDiagNormal(pmu, plv),
                              M, min_clip, 0.1, valid)

    jw, juw = jf(mu, lv)
    jg = jax.grad(lambda m, l: jf(m, l)[0], argnums=(0, 1))(mu, lv)
    tmu, tlv = (torch.from_numpy(a).requires_grad_() for a in (mu, lv))
    w, uw = ts.sampler_kld(
        DiagNormal(tmu, tlv), DiagNormal(*map(torch.from_numpy, (pmu, plv))),
        M, min_clip, 0.1, None if valid is None else torch.from_numpy(valid))
    w.backward()
    np.testing.assert_allclose(float(w.detach()), float(jw), **TOL)
    np.testing.assert_allclose(float(uw.detach()), float(juw), **TOL)
    for g, want in zip((tmu.grad, tlv.grad), jg):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), **TOL)
    if min_clip > 0:
        assert float(uw.detach()) == min_clip and not tmu.grad.any()


@pytest.mark.parametrize("masked", [False, True])
def test_sampler_diversity_matches_jax(masked):
    """The per-agent repulsion (÷ K·(K − 1), summed over agents ÷ their
    count) and its gradient, with and without a validity; and the grouping
    is per agent: permuting the agents leaves it unchanged, mixing samples
    across agents does not."""
    rng = np.random.default_rng(5)
    M, K = 6, 5
    dec = rng.standard_normal((M, K, 12, 2)).astype(np.float32) * 0.3
    valid = np.array([1, 0, 1, 1, 1, 0], np.float32) if masked else None

    def jf(d):
        return js.sampler_diversity(d, M, 3.0, 2.0, valid)

    jw, juw = jf(dec)
    jg = jax.grad(lambda d: jf(d)[0])(dec)
    t = torch.from_numpy(dec).requires_grad_()
    tv = None if valid is None else torch.from_numpy(valid)
    w, uw = ts.sampler_diversity(t, M, 3.0, 2.0, tv)
    w.backward()
    np.testing.assert_allclose(float(w.detach()), float(jw), **TOL)
    np.testing.assert_allclose(float(uw.detach()), float(juw), **TOL)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), **TOL)
    perm = torch.tensor([2, 0, 3, 1, 5, 4])
    w_perm, _ = ts.sampler_diversity(
        t.detach()[perm], M, 3.0, 2.0, None if tv is None else tv[perm])
    np.testing.assert_allclose(float(w_perm), float(w.detach()), rtol=1e-6)
    mixed = t.detach().transpose(0, 1).reshape(M, K, 12, 2)   # K-major
    assert abs(float(ts.sampler_diversity(mixed, M, 3.0, 2.0, tv)[0])
               - float(w.detach())) > 1e-3


# --------------------------------------------------------------------------- #
# gradients                                                                   #
# --------------------------------------------------------------------------- #

def _jax_loss_and_grads(jcfg, jscfg, jnet, jsp, jb, rng):
    def loss_fn(sp):
        out = js.sampler_forward(sp, jnet, jscfg, jcfg, jb, rng)
        return js.sampler_loss(out, jscfg, jb)

    with jax.default_matmul_precision("highest"):
        return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jsp)


@pytest.mark.parametrize("recipe", list(RECIPES))
def test_loss_and_sampler_gradients_match_jax(recipe, monkeypatch):
    """``sampler_loss`` and the gradient of every sampler leaf against
    ``jax.value_and_grad`` on each recipe's route; the net is frozen: with
    its leaves trainable no net leaf receives a gradient, and no attention
    backward runs (the packed formula runs once, for the encoder's
    forward)."""
    jcfg, tcfg, jscfg, tscfg, jnet, tnet, jsp, tsp, jb, tb = _setup(recipe)
    (jtotal, jparts), jgrads = _jax_loss_and_grads(
        jcfg, jscfg, jnet, jsp, jb, jax.random.PRNGKey(3))
    for t in bridge.tree_leaves(tnet):
        t.requires_grad_()
    leaves = [t.requires_grad_() for t in bridge.tree_leaves(tsp)]
    calls = _packed_calls(monkeypatch)
    before = _launches()
    out = ts.sampler_forward(tsp, tnet, tscfg, tcfg, tb)
    total, parts = ts.sampler_loss(out, tscfg, tb)
    total.backward()
    assert _launches() == before
    assert len(calls) == (1 if recipe == "reference_packed" else 0)
    np.testing.assert_allclose(float(total.detach()), float(jtotal), **TOL)
    assert set(parts) == {"kld", "diverse"}
    for k in parts:
        np.testing.assert_allclose(float(parts[k].detach()),
                                   float(jparts[k]), **TOL, err_msg=k)
    # the KL is above its floor here: every term carries a gradient
    assert float(parts["kld"].detach()) > tscfg.kld_min_clamp
    assert all(t.grad is None for t in bridge.tree_leaves(tnet))
    want = jax.tree_util.tree_leaves(jgrads)
    assert len(leaves) == len(want)
    for i, (t, w) in enumerate(zip(leaves, want)):
        w = np.asarray(w)
        # q_c feeds only the reconstruction decode, which no loss term
        # reads: autograd leaves its gradient unset, JAX's is 0
        g = np.zeros_like(w) if t.grad is None else t.grad.numpy()
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * scale,
                                   err_msg=f"gradient leaf {i}")
    assert tsp["q_c"]["w"].grad is None
    assert not np.asarray(jgrads["q_c"]["w"]).any()


def test_bf16_decode_losses_match_jax():
    """decode_dtype="bfloat16": both decodes in bf16 storage, the losses
    within 4e-3 relative of JAX's (bf16 keeps 8 bits of mantissa in every
    decode activation)."""
    jcfg, tcfg, jscfg, tscfg, jnet, tnet, jsp, tsp, jb, tb = _setup(
        "tpu_agent_fused", decode_dtype="bfloat16")
    (jtotal, jparts), _ = _jax_loss_and_grads(jcfg, jscfg, jnet, jsp, jb,
                                              jax.random.PRNGKey(3))
    out = ts.sampler_forward(tsp, tnet, tscfg, tcfg, tb)
    assert out.dec_motion.dtype == torch.float32
    total, parts = ts.sampler_loss(out, tscfg, tb)
    np.testing.assert_allclose(float(total), float(jtotal), rtol=4e-3)
    for k in parts:
        np.testing.assert_allclose(float(parts[k]), float(jparts[k]),
                                   rtol=4e-3, err_msg=k)


# --------------------------------------------------------------------------- #
# training: lambda-LR, the step, checkpoints                                  #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("fix,total", [(5, 10), (0, 3), (2, 2), (12, 4)])
def test_lambda_lr_matches_jax(fix, total):
    want = jsched.lambda_lr(1e-4, fix, total)
    got = tsched.lambda_lr(1e-4, fix, total)
    for epoch in range(13):
        assert got(epoch) == want(epoch), epoch


def test_sampler_train_steps_match_optax_under_lambda_lr():
    """Three stage-2 steps, one an epoch, under lambda_lr(1e-3, 0, 3) set
    before each with ``set_lr``, against JAX's step with
    ``adam_with_schedule``: the metrics within 1e-4, every sampler
    parameter within 1e-5 after each step; the net is untouched."""
    jcfg, tcfg, jscfg, tscfg, jnet, tnet, jsp, tsp, jb, tb = _setup(
        "tpu_agent_fused")
    schedule_j = jsched.lambda_lr(1e-3, 0, 3)
    schedule_t = tsched.lambda_lr(1e-3, 0, 3)
    opt = jsched.adam_with_schedule(schedule_j)
    jstate = opt.init(jsp)
    jstep = jloop.make_sampler_train_step(jcfg, jscfg, opt, donate=False)
    step = tloop.make_sampler_train_step(tcfg, tscfg, 1.0, tnet,
                                         device="cpu")
    assert isinstance(step, tloop.SamplerTrainStep)
    net_before = [t.clone() for t in bridge.tree_leaves(step.net_params)]
    params, adam = step.init(tsp)
    assert len(adam.param_groups[0]["params"]) == len(
        jax.tree_util.tree_leaves(jsp))
    for epoch in range(3):
        jstate = jsched.set_lr(jstate, schedule_j(epoch))
        with jax.default_matmul_precision("highest"):
            jsp, jstate, jm_ = jstep(jsp, jnet, jstate, jb,
                                     jax.random.PRNGKey(epoch))
        tsched.set_lr(adam, schedule_t(epoch))
        params, adam, metrics = step(params, adam, tb)
        assert set(metrics) == {"total", "kld", "diverse"}
        for k, v in metrics.items():
            assert v.dim() == 0 and not v.requires_grad
            np.testing.assert_allclose(float(v), float(jm_[k]), **TOL,
                                       err_msg=k)
        for i, (a, b) in enumerate(zip(bridge.tree_leaves(params),
                                       jax.tree_util.tree_leaves(jsp))):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       rtol=0, atol=1e-5,
                                       err_msg=f"epoch {epoch} leaf {i}")
    assert [g["lr"] for g in adam.param_groups] == [schedule_t(2)]
    for a, b in zip(bridge.tree_leaves(step.net_params), net_before):
        assert torch.equal(a, b) and a.grad is None


def test_sampler_train_step_on_cpu_and_default_device():
    """On the CPU the step launches no kernel and train_epoch drives it;
    without ``device`` it runs on the card, and raises without one."""
    _, tcfg, _, tscfg, _, tnet, _, tsp, _, tb = _setup("reference_packed")
    step = tloop.make_sampler_train_step(tcfg, tscfg, 1e-3, tnet,
                                         device="cpu")
    params, opt = step.init(tsp)
    before = _launches()
    params, opt, means = tloop.train_epoch(
        step, params, opt, [(tb, None)] * 3, torch.Generator(),
        log_every=2, log_fn=lambda msg: None)
    assert _launches() == before
    assert set(means) == {"total", "kld", "diverse"}
    assert np.isfinite(list(means.values())).all()
    if torch.cuda.is_available():
        assert tloop.make_sampler_train_step(tcfg, tscfg, 1e-4,
                                             tnet).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tloop.make_sampler_train_step(tcfg, tscfg, 1e-4, tnet)


def test_sampler_checkpoint_round_trips(tmp_path):
    """A SamplerConfig checkpoint under <ckpt_dir>/sampler/ keeps the
    parameters, the Adam state, the epoch and the config; the JSON type tag
    picks the config class; an unknown tag raises."""
    _, tcfg, _, tscfg, _, tnet, _, tsp, _, tb = _setup("tpu_agent_fused")
    step = tloop.make_sampler_train_step(tcfg, tscfg, 1e-3, tnet,
                                         device="cpu")
    params, opt = step.init(tsp)
    params, opt, _ = step(params, opt, tb)
    sdir = str(tmp_path / "eth" / "sampler")
    path = tck.save_checkpoint(sdir, 4, params, opt, tscfg)
    assert path == os.path.join(sdir, "model_0004.pt")
    p2, state, epoch, cfg2 = tck.load_checkpoint(path)
    assert epoch == 4 and cfg2 == tscfg
    assert isinstance(cfg2, ts.SamplerConfig)
    assert isinstance(cfg2.qnet_mlp, tuple)
    for a, b in zip(bridge.tree_leaves(p2), bridge.tree_leaves(params)):
        assert torch.equal(a, b.detach())
    want = opt.state_dict()
    assert state["param_groups"] == want["param_groups"]
    for k, s in want["state"].items():
        for name, v in s.items():
            assert torch.equal(state["state"][k][name], v)
    assert tck._config_from_json(tck._config_to_json(tcfg)) == tcfg
    with pytest.raises(ValueError, match="unknown checkpoint config type"):
        tck._config_from_json('{"type": "Other", "nk": 3}')


# --------------------------------------------------------------------------- #
# evaluation and serving                                                      #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("recipe", ["reference_scene", "tpu_agent"])
def test_eval_sampler_device_reduction_matches_host_and_jax(recipe):
    kw = dict(attn_impl="dense") if recipe == "reference_scene" else \
        dict(attn_impl="dense", compat="tpu", attn_axis="agent")
    jcfg, tcfg, jscfg, tscfg, jnet, tnet, jsp, tsp = _models(**kw)
    scenes = jsyn.make_social_scenes(6, agents_range=(2, 11), seed=8)
    dev = cli_test_sampler.eval_sampler(tsp, tnet, tscfg, tcfg, scenes)
    host = cli_test_sampler.eval_sampler(tsp, tnet, tscfg, tcfg, scenes,
                                         device_reduce=False)
    np.testing.assert_allclose(dev, host, rtol=1e-5)
    with jax.default_matmul_precision("highest"):
        want = jtest_sampler.eval_sampler(jsp, jnet, jscfg, jcfg, scenes,
                                          jax.random.PRNGKey(3))
    np.testing.assert_allclose(dev, want, **TOL)
    assert cli_test_sampler.eval_sampler(tsp, tnet, tscfg, tcfg, []) == \
        (0.0, 0.0)


def test_eval_sampler_nba_batches_device_matches_host():
    """NBA's (past, future) arrays are evaluated in batches of
    ``nba_batches`` (JAX's scene batching does not take them)."""
    _, tcfg, _, tscfg, _, tnet, _, tsp = _models(past_length=5,
                                                 future_length=10)
    rng = np.random.default_rng(2)
    past = rng.normal(size=(10, 11, 5, 2)).astype(np.float32).cumsum(2)
    fut = past[:, :, -1:] + rng.normal(size=(10, 11, 10, 2)).astype(
        np.float32).cumsum(2)
    dev = cli_test_sampler.eval_sampler(tsp, tnet, tscfg, tcfg, (past, fut),
                                        nba_batch_size=4)
    host = cli_test_sampler.eval_sampler(tsp, tnet, tscfg, tcfg, (past, fut),
                                         nba_batch_size=4,
                                         device_reduce=False)
    np.testing.assert_allclose(dev, host, rtol=1e-5)
    assert np.isfinite(dev).all() and dev[0] > 0


@pytest.mark.parametrize("axis", ["scene", "agent"])
def test_predictor_with_sampler_matches_jax(axis):
    """``Predictor(sampler_params=…)`` against JAX's Predictor on the same
    scenes: nk forecasts [nk, N, T_f, 2] in absolute coordinates, within
    1e-4; the seed changes nothing (mean=True)."""
    kw = dict(attn_impl="dense") if axis == "scene" else \
        dict(attn_impl="dense", compat="tpu", attn_axis="agent")
    jcfg, tcfg, jscfg, tscfg, jnet, tnet, jsp, tsp = _models(**kw)
    scenes = [s["obs"] for s in jsyn.make_social_scenes(
        5, agents_range=(2, 10), seed=4)]
    with jax.default_matmul_precision("highest"):
        want = JPredictor(jnet, jcfg, sampler_params=jsp,
                          sampler_cfg=jscfg).predict_many(scenes, seed=0)
    pred = Predictor(tnet, tcfg, device="cpu", sampler_params=tsp,
                     sampler_cfg=tscfg)
    assert pred.sample_k == 5
    got = pred.predict_many(scenes, seed=0)
    again = pred.predict_many(scenes, seed=9)
    for g, a, w, s in zip(got, again, want, scenes):
        assert g.shape == w.shape == (5, len(s), 12, 2)
        np.testing.assert_allclose(g, w, **TOL)
        np.testing.assert_array_equal(g, a)


def test_predictor_with_sampler_equals_sampler_forward():
    """On the scene axis each scene is its own problem: the served forecasts
    are a direct sampler_forward(mean=True) of each scene alone, plus its
    origin."""
    _, tcfg, _, tscfg, _, tnet, _, tsp = _models()
    scenes = [s["obs"] for s in tsyn.make_social_scenes(
        3, agents_range=(4, 4), seed=6)]
    # bucket 4: reference compat drops the padding's mask (Q2), so a padded
    # scene would differ from the scene alone
    got = Predictor(tnet, tcfg, device="cpu", buckets=(4,),
                    sampler_params=tsp, sampler_cfg=tscfg).predict_many(scenes)
    for s, g in zip(scenes, got):
        batch, origs = tprep.prepare_scene_group(
            s[None], np.zeros((1, 4, 12, 2), np.float32),
            np.ones((1, 4), np.float32), training=False)
        want = ts.sampler_forward(tsp, tnet, tscfg, tcfg, batch).dec_motion
        want = want.transpose(0, 1).numpy() + origs[0][None, None, None]
        np.testing.assert_allclose(g, want, rtol=1e-5, atol=1e-5)


def test_predictor_sampler_errors_match_jax():
    jcfg, tcfg, jscfg, tscfg, jnet, tnet, jsp, tsp = _models()
    bad_j = js.SamplerConfig(nk=5, nz=9)
    bad_t = ts.SamplerConfig(nk=5, nz=9)
    cases = [
        (dict(sampler_params=jsp), dict(sampler_params=tsp)),
        (dict(sampler_cfg=jscfg), dict(sampler_cfg=tscfg)),
        (dict(sampler_params=jsp, sampler_cfg=bad_j),
         dict(sampler_params=tsp, sampler_cfg=bad_t)),
        (dict(sampler_params=jsp, sampler_cfg=jscfg, sample_k=6),
         dict(sampler_params=tsp, sampler_cfg=tscfg, sample_k=6)),
    ]
    for jkw, tkw in cases:
        with pytest.raises(ValueError) as je:
            JPredictor(jnet, jcfg, **jkw)
        with pytest.raises(ValueError) as te:
            Predictor(tnet, tcfg, device="cpu", **tkw)
        assert str(te.value) == str(je.value)
    assert Predictor(tnet, tcfg, device="cpu", sampler_params=tsp,
                     sampler_cfg=tscfg, sample_k=5).sample_k == 5


# --------------------------------------------------------------------------- #
# the CLIs                                                                    #
# --------------------------------------------------------------------------- #

def _cli_args(tmp_path, dataset, *extra):
    return ["--dataset", dataset, "--data_root", str(tmp_path / "data"),
            "--ckpt_dir", str(tmp_path / "ck"), "--device", "cpu",
            "--hidden_dim", "16", "--zdim", "8", "--sample_k", "4",
            "--log_every", "0", "--model_save_epoch", "1", *extra]


SAMPLER_FLAGS = ["--nz", "8", "--qnet_mlp", "32", "16", "--fix_epochs", "0"]


def _write_data(root, dataset):
    """A few scenes a split: synthetic ETH-style CSVs (6 scenes a split) or
    NBA files of 32 train and 16 test scenes (two steps and one evaluation
    batch at --batch_size 16)."""
    if dataset == "eth":
        for split, seed in (("train", 0), ("test", 1)):
            tsyn.write_eth_style_csvs(str(root / "eth" / split), n_files=1,
                                      frames_per_file=25, agents=4,
                                      seed=seed)
        return
    rng = np.random.default_rng(0)
    d = root / "nba"
    d.mkdir(parents=True)
    for name, n in (("train.npy", 32), ("test.npy", 16)):
        start = rng.uniform([0.0, 0.0], [94.0, 50.0], size=(n, 1, 11, 2))
        steps = rng.normal(0.0, 1.0, size=(n, 15, 11, 2)).cumsum(axis=1)
        np.save(d / name, (start + steps).astype(np.float32))


@pytest.mark.parametrize("dataset", ["eth", "nba"])
def test_cli_trainsampler_trains_resumes_and_test_sampler_sweeps(
        tmp_path, capsys, dataset):
    """Stage 1 for two epochs, then ``cli.trainsampler`` for one epoch on
    the frozen newest net and a resumed second (lambda decay from epoch 0:
    the resumed epoch at 2/3 of the rate), then ``cli.test_sampler
    --sweep 2`` over 2 nets × 2 samplers, all with ``--device cpu``."""
    _write_data(tmp_path / "data", dataset)
    args = _cli_args(tmp_path, dataset, *(["--batch_size", "16"]
                                          if dataset == "nba" else []))
    cli_train.main(args + ["--num_epochs", "2"])
    run = cli_trainsampler.main(args + SAMPLER_FLAGS + ["--num_epochs", "1"])
    sdir = str(tmp_path / "ck" / dataset / "sampler")
    assert tck.checkpoint_epochs(sdir) == [1]
    assert run.start_epoch == 0 and run.cfg.zdim == 8
    assert run.scfg == common.sampler_config(
        cli_trainsampler.add_sampler_args(common.base_parser("x"))
        .parse_args(args + SAMPLER_FLAGS))
    _, state, _, scfg = tck.load_checkpoint(tck.checkpoint_path(sdir, 1))
    steps = {int(s["step"]) for s in state["state"].values()}
    assert scfg == run.scfg and len(steps) == 1 and steps.pop() > 0
    resumed = cli_trainsampler.main(args + SAMPLER_FLAGS +
                                    ["--num_epochs", "2"])
    assert resumed.start_epoch == 1 and len(resumed.history) == 1
    assert [lr for _, lr, _ in run.history + resumed.history] == [
        1e-4, pytest.approx(1e-4 * 2 / 3)]
    for r in (run, resumed):
        assert np.isfinite(list(r.history[0][2].values())).all()
        assert set(r.history[0][2]) == {"total", "kld", "diverse"}
    capsys.readouterr()
    best = cli_test_sampler.main(args + SAMPLER_FLAGS + ["--sweep", "2"])
    out = capsys.readouterr().out
    for ve in (1, 2):
        for se in (1, 2):
            assert f"vae {ve} × sampler {se}: ADE" in out
    assert "best: ADE" in out and np.isfinite([best["ade"], best["fde"]]).all()
    assert best["ade"] > 0 and best["fde"] > 0
    assert best["vae"] in (1, 2) and best["sampler"] in (1, 2)


def test_cli_sampler_parsers_match_jax_and_refuse(tmp_path):
    """The stage-2 flags and their defaults equal JAX's (the port adds
    ``--device``), so does ``sampler_config`` for every dataset; the CLIs
    exit on --nz ≠ the net's zdim with JAX's message and on missing
    checkpoints, and take --scan_steps and --async_ckpt."""
    tparser = cli_trainsampler.add_sampler_args(common.base_parser("x"))
    jparser = jtrainsampler.add_sampler_args(jcommon.base_parser("x"))
    targs, jargs = vars(tparser.parse_args([])), vars(jparser.parse_args([]))
    assert targs.pop("device") == "cuda"
    assert targs == jargs
    for argv in (["--dataset", d] for d in ("eth", "hotel", "univ", "zara1",
                                            "zara2", "sdd", "nba")):
        argv += ["--nz", "16", "--qnet_mlp", "8", "--no_share_eps",
                 "--kld_weight", "0.5"]
        assert common.sampler_config(tparser.parse_args(argv))._asdict() == \
            jcommon.sampler_config(jparser.parse_args(argv))._asdict()
    _write_data(tmp_path / "data", "eth")
    args = _cli_args(tmp_path, "eth")
    with pytest.raises(SystemExit, match="no stage-1 checkpoint"):
        cli_trainsampler.main(args + SAMPLER_FLAGS)
    with pytest.raises(SystemExit, match="need checkpoints"):
        cli_test_sampler.main(args + SAMPLER_FLAGS)
    cli_train.main(args + ["--num_epochs", "1"])
    with pytest.raises(SystemExit, match=r"--nz 32 must equal the frozen "
                                         r"net's zdim 8 .*pass --nz 8"):
        cli_trainsampler.main(args + ["--num_epochs", "1"])
    # --scan_steps and --async_ckpt are ported (tests/test_torch_scan.py)
    run = cli_trainsampler.main(args + SAMPLER_FLAGS + [
        "--num_epochs", "1", "--scan_steps", "2", "--async_ckpt"])
    assert len(run.history) == 1
    assert tck.checkpoint_epochs(str(tmp_path / "ck" / "eth" /
                                     "sampler")) == [1]
