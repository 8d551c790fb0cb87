"""The port's model (inference slice) against the JAX package, on the CPU.

The JAX side runs ``attn_impl="dense"``, ``select_impl="xla"`` at "highest"
matmul precision; the port gets the same weights through ``bridge`` and the
same latents: inference's only random draw is z, which the test recomputes
from JAX's key split and injects into the port. Tolerance 1e-4 abs/rel: the
Euler step multiplies the encoder field by 12, and the decoder sums over
512-wide layers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sttode_tpu.data import batching as jbatching
from sttode_tpu.data import preprocess as jprep
from sttode_tpu.data import synthetic as jsyn
from sttode_tpu.models import sttode as jm
from sttode_tpu_torch import bridge
from sttode_tpu_torch.data import batching as tbatching
from sttode_tpu_torch.data import preprocess as tprep
from sttode_tpu_torch.data import synthetic as tsyn
from sttode_tpu_torch.kernels import mhgsa as tmhgsa
from sttode_tpu_torch.kernels import select_decode as tsd
from sttode_tpu_torch.models import sttode as tm

# one intra-op thread: pytest-xdist runs 6 workers on 8 cores, and
# torch's default of one thread a core each oversubscribes them
torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
SMALL = dict(hidden_dim=16, num_heads=2, ff_dim=32, zdim=8, sample_k=4)
CASES = {
    # (i) reference compat, scene axis, B = 3 scenes × N = 4 agents
    "reference_scene": (dict(SMALL), 3, (4, 4)),
    # (ii) corrected compat, agent axis, scenes padded to 6 agents
    "tpu_agent": (dict(SMALL, compat="tpu", attn_axis="agent",
                       past_length=5, future_length=10), 3, (3, 6)),
}


def _scene_group(cfg, B, agents_range, seed):
    scenes = jsyn.make_social_scenes(B, agents_range=agents_range,
                                     obs_len=cfg.past_length,
                                     pred_len=cfg.future_length, seed=seed)
    N = max(agents_range[1], max(len(s["obs"]) for s in scenes))
    obs = np.zeros((B, N, cfg.past_length, 2), np.float32)
    pred = np.zeros((B, N, cfg.future_length, 2), np.float32)
    valid = np.zeros((B, N), np.float32)
    for j, s in enumerate(scenes):
        n = len(s["obs"])
        obs[j, :n], pred[j, :n], valid[j, :n] = s["obs"], s["pred"], 1.0
    return obs, pred, valid


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    kw, B, agents = CASES[request.param]
    jcfg = jm.STTODEConfig(attn_impl="dense", select_impl="xla",
                           **kw).validate()
    tcfg = tm.STTODEConfig(**jcfg._asdict()).validate()
    jparams = jm.sttode_init(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams))
    obs, pred, valid = _scene_group(jcfg, B, agents, seed=1)
    jb, _ = jprep.prepare_scene_group(obs, pred, valid, training=False)
    tb, _ = tprep.prepare_scene_group(obs, pred, valid, training=False)
    if request.param == "tpu_agent":
        assert valid.min() == 0.0          # a padded agent is present
    return jcfg, tcfg, jparams, tparams, jb, tb


def _jrun(fn, *args, **kw):
    with jax.default_matmul_precision("highest"):
        return jax.tree_util.tree_map(np.asarray, fn(*args, **kw))


def test_sttode_inference_matches_jax(case):
    jcfg, tcfg, jparams, tparams, jb, tb = case
    rng = jax.random.PRNGKey(42)
    want = _jrun(jm.sttode_inference, jparams, jcfg, jb, rng)
    M = jb.batch_size * jb.agent_num
    _, k_p = jax.random.split(rng)
    z = np.array(jax.random.normal(k_p, (M * jcfg.sample_k, jcfg.zdim)))
    got = tm.sttode_inference(tparams, tcfg, tb, z=torch.from_numpy(z))
    assert got.shape == want.shape == (jcfg.sample_k, M,
                                       jcfg.future_length, 2)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_encoder_and_decoder_pieces_match_jax(case):
    jcfg, tcfg, jparams, tparams, jb, tb = case
    pf_want = _jrun(jm.encode_past, jparams, jcfg, jb,
                    rng=jax.random.PRNGKey(0), train=False)
    pf = tm.encode_past(tparams, tcfg, tb)
    np.testing.assert_allclose(pf.numpy(), pf_want, **TOL)
    s0_want = _jrun(jm.decode_block0_state, jparams, jnp.asarray(jb.past))
    np.testing.assert_allclose(
        tm.decode_block0_state(tparams, tb.past).numpy(), s0_want, **TOL)
    M, K = pf_want.shape[0], 2
    z = np.random.default_rng(3).standard_normal(
        (M * K, jcfg.zdim)).astype(np.float32)
    pfk = np.repeat(pf_want, K, axis=0)
    want = _jrun(jm.decode, jparams, jcfg, pfk, z, jb.past,
                 jb.past[:, -1:], K)
    got = tm.decode(tparams, tcfg, torch.from_numpy(pfk), torch.from_numpy(z),
                    tb.past, tb.cur_location, K)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, **TOL)
    pz = tm.prior(tparams, tcfg, pf)
    assert pz.mu.shape == (M, jcfg.zdim) and float(pz.logvar.abs().max()) == 0
    eps = torch.randn(M, jcfg.zdim)
    torch.testing.assert_close(pz.rsample(noise=eps), eps, rtol=0, atol=0)


def test_cpu_routes_are_plain_and_launch_nothing(case):
    """On the CPU every route setting runs the plain path: the kernel
    counters stay 0 and the results equal the plain ones exactly."""
    _, tcfg, _, tparams, _, tb = case
    M = tb.batch_size * tb.agent_num
    z = torch.randn(M * tcfg.sample_k, tcfg.zdim,
                    generator=torch.Generator().manual_seed(0))
    before = (tmhgsa.fused_geodesic_attention.launches,
              tsd.select_decode.launches)
    outs = [tm.sttode_inference(tparams, tcfg._replace(attn_impl=a,
                                                       select_impl=s), tb, z=z)
            for a, s in (("dense", "xla"), ("auto", "auto"),
                         ("fused", "fused"))]
    assert (tmhgsa.fused_geodesic_attention.launches,
            tsd.select_decode.launches) == before
    for o in outs[1:]:
        torch.testing.assert_close(o, outs[0], rtol=0, atol=0)


def test_agent_axis_padding_does_not_leak():
    """Under the agent axis, what a padded agent slot holds never reaches a
    real agent's forecast (the key mask excludes it)."""
    kw, B, agents = CASES["tpu_agent"]
    tcfg = tm.STTODEConfig(**kw).validate()
    tparams = tm.sttode_init(3, tcfg)
    obs, pred, valid = _scene_group(tcfg, B, agents, seed=2)
    tb, _ = tprep.prepare_scene_group(obs, pred, valid, training=False)
    real = tb.valid.bool()
    assert not bool(real.all())
    z = torch.randn(real.numel() * tcfg.sample_k, tcfg.zdim,
                    generator=torch.Generator().manual_seed(1))
    junk = dataclasses.replace(
        tb, past=torch.where(real[:, None, None], tb.past, 55.0),
        past_vel=torch.where(real[:, None, None], tb.past_vel, -7.0))
    a = tm.sttode_inference(tparams, tcfg, tb, z=z)[:, real]
    b = tm.sttode_inference(tparams, tcfg, junk, z=z)[:, real]
    torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_sttode_init_tree_matches_jax_structure():
    jcfg = jm.STTODEConfig(**SMALL)
    jshapes = jax.tree_util.tree_map(
        lambda a: tuple(a.shape), jm.sttode_init(jax.random.PRNGKey(0), jcfg))
    tparams = tm.sttode_init(0, tm.STTODEConfig(**SMALL))
    tshapes = bridge.tree_map(lambda t: tuple(t.shape), tparams)
    assert bridge.tree_map(lambda s: s, jshapes) == tshapes


def test_bridge_rejects_unknown_namedtuples():
    from typing import NamedTuple

    class Unknown(NamedTuple):
        a: np.ndarray

    with pytest.raises(TypeError, match="no port counterpart"):
        bridge.params_from_jax({"x": Unknown(np.zeros(2))})


@pytest.mark.parametrize("field,value", [
    ("attn_impl", "ulysses"), ("attn_impl", "ring"),
    ("ode_method", "dopri5"), ("ode_adjoint", True), ("learn_prior", True),
    ("compute_dtype", "bfloat16"), ("dropout", 0.1), ("num_decompose", 3)])
def test_config_refuses_unported_settings(field, value):
    # the adaptive and adjoint ODE encoder, learn_prior and encoder-layer
    # dropout are ported (held to JAX in test_torch_ode_model.py), and so are
    # the ring and ulysses (test_torch_parallel.py)
    if field in ("attn_impl", "ode_method", "ode_adjoint", "learn_prior",
                 "dropout"):
        assert tm.STTODEConfig(**{field: value}).validate()._asdict()[
            field] == value
        return
    with pytest.raises(NotImplementedError):
        tm.STTODEConfig(**{field: value}).validate()
    # num_decompose != 2 runs on the plain decode
    if field == "num_decompose":
        tm.STTODEConfig(num_decompose=3, select_impl="xla").validate()


@pytest.mark.parametrize("field,value", [
    ("attn_metric", "euclidean"), ("curvature", 0.0), ("curvature", -1.0)])
def test_config_refuses_bad_metric_and_curvature(field, value):
    """JAX's asserts on the metric and the curvature, as ValueErrors; the
    poincaré metric itself is ported."""
    with pytest.raises(ValueError, match=field):
        tm.STTODEConfig(**{field: value}).validate()
    tm.STTODEConfig(attn_metric="poincare", curvature=0.005).validate()


def test_config_fields_mirror_jax():
    assert tm.STTODEConfig._fields == jm.STTODEConfig._fields
    diff = {f for f in tm.STTODEConfig._fields
            if getattr(tm.STTODEConfig(), f) != getattr(jm.STTODEConfig(), f)}
    assert diff == {"select_impl"}         # the port's default route: kernel


def test_data_helpers_match_jax():
    js = jsyn.make_social_scenes(4, agents_range=(2, 7), seed=9)
    ts = tsyn.make_social_scenes(4, agents_range=(2, 7), seed=9)
    for a, b in zip(js, ts):
        np.testing.assert_array_equal(a["obs"], b["obs"])
        np.testing.assert_array_equal(a["pred"], b["pred"])
    for n in (1, 8, 9, 100, 128, 129, 300):
        assert tbatching.bucket_for(n) == jbatching.bucket_for(n)
    obs, pred, valid = _scene_group(jm.STTODEConfig(), 3, (2, 5), seed=4)
    rng_a, rng_b = np.random.default_rng(0), np.random.default_rng(0)
    for training, r in ((False, None), (True, (rng_a, rng_b))):
        jb, jo = jprep.prepare_scene_group(obs, pred, valid, training=training,
                                           rng=None if r is None else r[0])
        tb, to = tprep.prepare_scene_group(obs, pred, valid, training=training,
                                           rng=None if r is None else r[1])
        np.testing.assert_array_equal(to, jo)
        for f in ("past", "past_vel", "future", "future_vel", "valid"):
            np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                          getattr(jb, f))
        assert (tb.batch_size, tb.agent_num) == (jb.batch_size, jb.agent_num)
