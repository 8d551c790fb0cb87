"""The port's layers against the JAX package's, on the CPU.

Same numpy-seeded inputs and the same weights (carried by
``sttode_tpu_torch.bridge``) go through each JAX function and its port; the
JAX side runs at "highest" matmul precision (JAX's CPU default truncates
matmul operands to bf16). Tolerance 1e-5 abs/rel: fp32 with different
summation orders, through at most one encoder layer scaled by the ODE time.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sttode_tpu.manifolds import oblique as joblique
from sttode_tpu.nn import attention as jattn
from sttode_tpu.nn import core as jcore
from sttode_tpu.nn import embed as jembed
from sttode_tpu.nn import ode_block as jode
from sttode_tpu.nn import recurrent as jrec
from sttode_tpu.nn import transformer as jtr
from sttode_tpu_torch.bridge import params_from_jax
from sttode_tpu_torch.manifolds import oblique as toblique
from sttode_tpu_torch.nn import attention as tattn
from sttode_tpu_torch.nn import core as tcore
from sttode_tpu_torch.nn import embed as tembed
from sttode_tpu_torch.nn import ode_block as tode
from sttode_tpu_torch.nn import recurrent as trec
from sttode_tpu_torch.nn import transformer as ttr

# one intra-op thread: pytest-xdist runs 6 workers on 8 cores, and
# torch's default of one thread a core each oversubscribes them
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def T(a):
    return torch.from_numpy(np.array(a, np.float32))


def bridged(p):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, p))


def jrun(fn, *args, **kw):
    with jax.default_matmul_precision("highest"):
        out = fn(*args, **kw)
    return jax.tree_util.tree_map(np.asarray, out)


def randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_oblique_proj_and_dist(rng):
    u, v = randn(rng, 3, 5, 4), randn(rng, 3, 6, 4)
    u[0, 0] = 0.0                       # zero row: the norm floor
    un, vn = jrun(joblique.proj, u), jrun(joblique.proj, v)
    np.testing.assert_allclose(toblique.proj(T(u)).numpy(), un, **TOL)
    np.testing.assert_allclose(toblique.dist(T(un), T(vn)).numpy(),
                               jrun(joblique.dist, un, vn), **TOL)
    # self-distance sits on the clip: acos(1 - 1e-4)
    d = toblique.dist(T(un[1:]), T(un[1:])).numpy()
    np.testing.assert_allclose(np.diagonal(d, axis1=-2, axis2=-1),
                               np.arccos(np.float32(1 - 1e-4)), rtol=1e-4)


def test_core_dense_mlp_layer_norm(rng):
    key = jax.random.PRNGKey(0)
    x = randn(rng, 4, 7, 12)
    mlp = jcore.mlp_init(key, 12, [16, 8], 3)
    np.testing.assert_allclose(tcore.mlp(bridged(mlp), T(x)).numpy(),
                               jrun(jcore.mlp, mlp, x), **TOL)
    mlp2 = jcore.mlp_init_normal001(key, 12, [5])
    np.testing.assert_allclose(
        tcore.mlp(bridged(mlp2), T(x), activate_final=True).numpy(),
        jrun(jcore.mlp, mlp2, x, activate_final=True), **TOL)
    ln = {"scale": randn(rng, 12), "bias": randn(rng, 12)}
    np.testing.assert_allclose(tcore.layer_norm(bridged(ln), T(x)).numpy(),
                               jrun(jcore.layer_norm, ln, x), **TOL)


def test_initializer_distributions():
    """Port init draws the JAX package's distributions (values differ)."""
    g = torch.Generator().manual_seed(0)
    w = tcore.xavier_uniform(g, 64, 192)
    bound = np.sqrt(6.0 / 256)
    assert float(w.abs().max()) <= bound
    assert abs(float(w.std()) - bound / np.sqrt(3)) < 0.01
    assert abs(float(tcore.kaiming_normal(g, 32, 288).std())
               - np.sqrt(2 / 32)) < 0.02
    assert abs(float(tcore.normal_001(g, 128, 64).std()) - 0.01) < 0.001
    assert float(tcore.torch_linear_weight(g, 16, 40).abs().max()) <= 0.25


def test_positional_agent_encoding(rng):
    p = jembed.positional_agent_encoding_init(jax.random.PRNGKey(1), 8)
    x = randn(rng, 5, 6, 8)
    np.testing.assert_array_equal(tembed.positional_encoding_table(200, 8)
                                  .numpy(), np.asarray(p["pe"]))
    np.testing.assert_allclose(
        tembed.positional_agent_encoding(bridged(p), T(x)).numpy(),
        jrun(jembed.positional_agent_encoding, p, x, deterministic=True),
        **TOL)


def test_gru_and_conv1d(rng):
    g = jrec.gru_init(jax.random.PRNGKey(2), 6, 10)
    g = g._replace(b_ih=randn(rng, 30), b_hh=randn(rng, 30))
    xs = randn(rng, 4, 5, 6)
    want_ys, want_h = jrun(jrec.gru, g, xs)
    ys, h = trec.gru(bridged(g), T(xs))
    np.testing.assert_allclose(ys.numpy(), want_ys, **TOL)
    np.testing.assert_allclose(h.numpy(), want_h, **TOL)
    c = jrec.conv1d_init(jax.random.PRNGKey(3), 2, 32, 3)
    c = c._replace(b=randn(rng, 32))
    x = randn(rng, 4, 8, 2)
    np.testing.assert_allclose(trec.conv1d(bridged(c), T(x)).numpy(),
                               jrun(jrec.conv1d, c, x, padding=1), **TOL)


@pytest.mark.parametrize("compat", ["reference", "tpu"])
@pytest.mark.parametrize("L,S", [(6, 6), (5, 7)])
def test_geodesic_scores_and_attention(rng, compat, L, S):
    q, k, v = randn(rng, 2, 3, L, 4), randn(rng, 2, 3, S, 4), \
        randn(rng, 2, 3, S, 4)
    np.testing.assert_allclose(
        tattn.geodesic_scores(T(q), T(k), compat=compat).numpy(),
        jrun(jattn.geodesic_scores, q, k, compat=compat), **TOL)
    mask = None if compat == "reference" else \
        np.where(rng.random((2, 1, L, S)) < 0.3,
                 np.finfo(np.float32).min, 0.0).astype(np.float32)
    if mask is not None:
        mask[..., 0] = 0.0               # every row keeps a key
    want_o, want_w = jrun(jattn.geodesic_attention, q, k, v, mask=mask,
                          compat=compat, fused=False)
    o, w = tattn.geodesic_attention(T(q), T(k), T(v),
                                    mask=None if mask is None else T(mask),
                                    compat=compat, fused="auto")
    np.testing.assert_allclose(o.numpy(), want_o, **TOL)
    np.testing.assert_allclose(w.numpy(), want_w, **TOL)


def test_split_merge_heads(rng):
    x = randn(rng, 2, 5, 12)
    h = tattn.split_heads(T(x), 3)
    np.testing.assert_array_equal(h.numpy(), np.asarray(
        jattn.split_heads(jnp.asarray(x), 3)))
    np.testing.assert_array_equal(tattn.merge_heads(h).numpy(), x)


@pytest.mark.parametrize("compat", ["reference", "tpu"])
@pytest.mark.parametrize("self_attn", [True, False])
def test_mhgsa(rng, compat, self_attn):
    p = jattn.mhgsa_init(jax.random.PRNGKey(4), 16)
    p = p._replace(in_proj_b=randn(rng, 48), out_proj_b=randn(rng, 16))
    x = randn(rng, 3, 6, 16)
    kv = x if self_attn else randn(rng, 3, 6, 16)
    mask = None
    if compat == "tpu":
        mask = np.where(rng.random((3, 6, 6)) < 0.3, -1e30,
                        rng.standard_normal((3, 6, 6))).astype(np.float32)
        mask[..., 0] = 0.0
    tx = T(x)
    tkv = tx if self_attn else T(kv)
    jx = jnp.asarray(x)
    jkv = jx if self_attn else jnp.asarray(kv)
    want, want_w = jrun(jattn.mhgsa, p, jx, jkv, jkv, 4, mask=mask,
                        compat=compat, need_weights=True, fused=False)
    got, w = tattn.mhgsa(bridged(p), tx, tkv, tkv, 4,
                         mask=None if mask is None else T(mask),
                         compat=compat, need_weights=True)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(w.numpy(), want_w, **TOL)


@pytest.fixture(scope="module")
def layer_setup():
    lcfg_j = {c: jtr.LayerConfig(d_model=16, num_heads=4, ff_dim=32,
                                 compat=c, attn_impl="dense")
              for c in ("reference", "tpu")}
    p = jtr.encoder_stack_init(jax.random.PRNGKey(5), lcfg_j["tpu"], 2)
    return lcfg_j, p, bridged(p)


def _tokens_and_mask(rng, compat):
    src = randn(rng, 5, 3, 1, 16)            # [L, N, S, D]
    mask = None
    if compat == "tpu":
        mask = np.zeros((3, 5, 5), np.float32)
        mask[1, :, 3:] = np.finfo(np.float32).min   # padded keys of batch 1
    return src, mask


@pytest.mark.parametrize("compat", ["reference", "tpu"])
def test_gated_attention_and_encoder_layer(rng, layer_setup, compat):
    lcfg_j, jp, tp = layer_setup
    src, mask = _tokens_and_mask(rng, compat)
    tmask = None if mask is None else T(mask)
    want, _ = jrun(jtr.gated_attention, jp[0].self_attn, src, src, src, 4,
                   mask=mask, compat=compat, fused=False)
    ts = T(src)
    got, _ = ttr.gated_attention(tp[0].self_attn, ts, ts, ts, 4, mask=tmask,
                                 compat=compat)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    tcfg = ttr.LayerConfig(**lcfg_j[compat]._asdict())
    np.testing.assert_allclose(
        ttr.encoder_layer(tp[0], ts, tcfg, mask=tmask).numpy(),
        jrun(jtr.encoder_layer, jp[0], src, lcfg_j[compat], mask=mask),
        **TOL)
    np.testing.assert_allclose(
        ttr.encoder_stack(tp, ts, tcfg, mask=tmask).numpy(),
        jrun(jtr.encoder_stack, jp, src, lcfg_j[compat], mask=mask), **TOL)


@pytest.mark.parametrize("compat", ["reference", "tpu"])
@pytest.mark.parametrize("method,steps", [("euler", 1), ("rk4", 2),
                                          ("midpoint", 3)])
def test_ode_encoder(rng, layer_setup, compat, method, steps):
    lcfg_j, jp, tp = layer_setup
    src, mask = _tokens_and_mask(rng, compat)
    tcfg = ttr.LayerConfig(**lcfg_j[compat]._asdict())
    want = jrun(jode.ode_encoder, jp[:1], src, lcfg_j[compat], time=12.0,
                method=method, steps=steps, mask=mask)
    got = tode.ode_encoder(tp[:1], T(src), tcfg, time=12.0, method=method,
                           steps=steps, mask=None if mask is None else T(mask))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_unported_routes_raise(rng):
    q = T(randn(rng, 2, 4, 8))
    # the ring and ulysses are ported (tests/test_torch_parallel.py) and
    # need a mesh; a route neither package has is refused
    for route in ("ring", "ulysses"):
        with pytest.raises(ValueError, match=f"'{route}' needs a mesh"):
            tattn.geodesic_attention(q, q, q, fused=route)
    with pytest.raises(NotImplementedError, match="not ported"):
        tattn.geodesic_attention(q, q, q, fused="tree")
    # the poincaré metric is ported (held to JAX in test_torch_poincare.py);
    # a metric neither package has is refused
    # (mid-ball points: near the edge artanh amplifies fp32 rounding ~1e4×)
    x, y = 0.3 * randn(rng, 2, 4, 8), 0.3 * randn(rng, 2, 4, 8)
    np.testing.assert_allclose(
        tattn.geodesic_scores(T(x), T(y), metric="poincare").numpy(),
        jrun(jattn.geodesic_scores, x, y, metric="poincare"), **TOL)
    with pytest.raises(ValueError, match="metric"):
        tattn.geodesic_scores(q, q, metric="euclidean")
    ucfg = ttr.LayerConfig(d_model=8, num_heads=2, ff_dim=16,
                           attn_impl="ulysses")
    with pytest.raises(ValueError, match="'ulysses' needs a mesh"):
        ttr.encoder_layer(ttr.encoder_layer_init(torch.Generator()
                                                 .manual_seed(0), ucfg),
                          T(randn(rng, 2, 2, 1, 8)), ucfg)
    with pytest.raises(NotImplementedError, match="not ported"):
        ttr.encoder_layer(None, T(randn(rng, 2, 2, 1, 8)),
                          ttr.LayerConfig(d_model=8, attn_impl="tree"))
