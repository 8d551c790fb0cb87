"""The decoder side of the port against the JAX package, on the CPU:
``decoder_layer``, ``decoder_stack``, ``ode_decoder`` and ``mhgsa``'s
``bias_kv`` / ``add_zero_attn``.

Same numpy-seeded inputs and the same weights (carried by
``bridge.params_from_jax``) go through each JAX function and its port, at a
small width (d_model 16, 4 heads, ff 32). JAX runs at "highest" matmul
precision; its ``fused`` and ``packed`` routes run their Pallas kernels in
interpret mode, the port's the kernels' plain versions. Gradients are of
Σ out · c for a fixed numpy cotangent c, taken by ``jax.grad`` and by
autograd. Tolerance: outputs and weights 1e-5 (abs and rel), each gradient
leaf (the parameters, tgt and memory) 1e-4 × that leaf's largest
magnitude. Dropout runs with JAX's own keep-masks, recomputed from its key
splits (``decoder_stack`` → one key a layer → ``decoder_layer``'s six).

Shapes: tgt L ≠ L_mem and the square cross-attention L == L_mem, which
under reference compat runs in quirk Q3's swapped orientation; with
``bias_kv`` a square call runs unswapped with S = L + 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sttode_tpu.nn import attention as jattn
from sttode_tpu.nn import ode_block as jode
from sttode_tpu.nn import transformer as jtr
from sttode_tpu_torch import bridge
from sttode_tpu_torch.nn import attention as tattn
from sttode_tpu_torch.nn import ode_block as tode
from sttode_tpu_torch.nn import transformer as ttr

# one intra-op thread: pytest-xdist runs 6 workers on 8 cores, and
# torch's default of one thread a core each oversubscribes them
torch.set_num_threads(1)

D, H, FF = 16, 4, 32
N, S_ = 3, 1
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = 1e-4


def T(a):
    return torch.from_numpy(np.array(a, np.float32))


def randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def bridged(p):
    return bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, p))


def _bern(key, keep, shape):
    return torch.from_numpy(np.array(jax.random.bernoulli(key, keep, shape)))


def _jax_drop(rng_key, n_layers, L, Lm, rate):
    """JAX's decoder keep-masks: split(rng, n_layers), then six keys a
    layer (self weights, residual, cross weights, residual, FFN hidden,
    residual)."""
    keep = 1.0 - rate
    out = []
    for k in jax.random.split(rng_key, n_layers):
        ks = jax.random.split(k, 6)
        out.append(ttr.DecoderDropMasks(
            _bern(ks[0], keep, (N * S_, H, L, L)),
            _bern(ks[1], keep, (L, N, S_, D)),
            _bern(ks[2], keep, (N * S_, H, L, Lm)),
            _bern(ks[3], keep, (L, N, S_, D)),
            _bern(ks[4], keep, (L, N, S_, FF)),
            _bern(ks[5], keep, (L, N, S_, D))))
    return out


def _assert_grads(got: list, want: list, what: str):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g.detach().numpy() - w).max())
        assert err <= GRAD_TOL * scale, \
            f"{what}: leaf {i} differs by {err:.3e} of {scale:.3e}"


def _weights_close(got, want):
    if want is None:
        assert got is None
    else:
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **TOL)


def _run_pair(jfn, tfn, jparams, tgt, mem, cot):
    """(JAX out, aux, grads of (params, tgt, mem)) and the port's, for
    loss Σ out · cot. ``jfn(p, tgt, mem)`` / ``tfn`` return (out, aux)."""
    def jloss(p, x, m):
        out, aux = jfn(p, x, m)
        return jnp.sum(out * cot), (out, aux)

    with jax.default_matmul_precision("highest"):
        (_, (jout, jaux)), jg = jax.value_and_grad(
            jloss, argnums=(0, 1, 2), has_aux=True)(
                jparams, jnp.asarray(tgt), jnp.asarray(mem))
    tp = bridge.tree_map(lambda t: t.requires_grad_(), bridged(jparams))
    tx, tm_ = T(tgt).requires_grad_(), T(mem).requires_grad_()
    out, aux = tfn(tp, tx, tm_)
    (out * T(cot)).sum().backward()
    tg = [t.grad for t in bridge.tree_leaves(tp)] + [tx.grad, tm_.grad]
    want = jax.tree_util.tree_leaves(jg[0]) + [jg[1], jg[2]]
    return (np.asarray(jout), jaux, want), (out, aux, tg)


CASES = [
    # (compat, impl, L, L_mem): dense at L ≠ L_mem and at the square cross
    # (Q3 swapped under reference compat), both compats; the kernel routes
    # (JAX's Pallas interpret against the port's plain versions)
    ("reference", "dense", 6, 4), ("reference", "dense", 5, 5),
    ("tpu", "dense", 6, 4), ("tpu", "dense", 5, 5),
    ("reference", "auto", 6, 4),
    ("reference", "fused", 6, 4), ("reference", "fused", 5, 5),
    ("tpu", "fused", 6, 4),
    ("reference", "packed", 6, 4), ("reference", "packed", 5, 5),
    ("tpu", "packed", 6, 4),
]


def _cfgs(compat, impl, dropout=0.0):
    j = jtr.LayerConfig(d_model=D, num_heads=H, ff_dim=FF, compat=compat,
                        attn_impl=impl, dropout=dropout)
    return j, ttr.LayerConfig(**j._asdict())


def _tokens(seed, L, Lm):
    rng = np.random.default_rng(seed)
    return (randn(rng, L, N, S_, D), randn(rng, Lm, N, S_, D),
            randn(rng, L, N, S_, D))


@pytest.mark.parametrize("compat,impl,L,Lm", CASES)
def test_decoder_layer_matches_jax(compat, impl, L, Lm):
    jcfg, tcfg = _cfgs(compat, impl)
    jp = jtr.decoder_layer_init(jax.random.PRNGKey(3), jcfg)
    tgt, mem, cot = _tokens(L * 10 + Lm, L, Lm)
    (jout, jaux, jg), (out, aux, tg) = _run_pair(
        lambda p, x, m: (lambda r: (r[0], r[1:]))(
            jtr.decoder_layer(p, x, m, jcfg)),
        lambda p, x, m: (lambda r: (r[0], r[1:]))(
            ttr.decoder_layer(p, x, m, tcfg)),
        jp, tgt, mem, cot)
    np.testing.assert_allclose(out.detach().numpy(), jout, **TOL)
    for got_w, want_w in zip(aux, jaux):
        _weights_close(got_w, want_w)
    if impl in ("fused", "packed"):
        assert aux == (None, None)
    else:
        assert aux[0].shape == (N * S_, L, L) and \
            aux[1].shape == (N * S_, L, Lm)
    _assert_grads(tg, jg, f"decoder_layer {compat} {impl} {L}x{Lm}")


@pytest.mark.parametrize("compat,L,Lm", [("reference", 6, 4),
                                         ("reference", 5, 5), ("tpu", 6, 4)])
def test_decoder_stack_matches_jax_with_dropout(compat, L, Lm):
    """Two layers with dropout 0.1 (JAX's keep-masks injected) and without;
    the last layer's weights."""
    for rate in (0.0, 0.1):
        jcfg, tcfg = _cfgs(compat, "dense", rate)
        jp = jtr.decoder_stack_init(jax.random.PRNGKey(4), jcfg, 2)
        tgt, mem, cot = _tokens(7 + L, L, Lm)
        key = jax.random.PRNGKey(11)
        drop = _jax_drop(key, 2, L, Lm, rate) if rate > 0 else None
        (jout, jaux, jg), (out, aux, tg) = _run_pair(
            lambda p, x, m: (lambda r: (r[0], r[1:]))(jtr.decoder_stack(
                p, x, m, jcfg, rng=key, deterministic=rate == 0.0)),
            lambda p, x, m: (lambda r: (r[0], r[1:]))(ttr.decoder_stack(
                p, x, m, tcfg, drop=drop)),
            jp, tgt, mem, cot)
        np.testing.assert_allclose(out.detach().numpy(), jout, **TOL)
        for got_w, want_w in zip(aux, jaux):
            _weights_close(got_w, want_w)
        _assert_grads(tg, jg, f"decoder_stack {compat} {L}x{Lm} p={rate}")


def test_decoder_tpu_masks_match_jax():
    """compat "tpu" forwards the additive tgt and memory masks (reference
    compat drops them, quirk Q2)."""
    jcfg, tcfg = _cfgs("tpu", "dense")
    jp = jtr.decoder_stack_init(jax.random.PRNGKey(5), jcfg, 2)
    L, Lm = 6, 4
    tgt, mem, cot = _tokens(21, L, Lm)
    tmask = np.triu(np.full((L, L), -1e30, np.float32), 1)[None]
    mmask = np.zeros((N * S_, L, Lm), np.float32)
    mmask[1, :, -1] = np.finfo(np.float32).min
    (jout, jaux, jg), (out, aux, tg) = _run_pair(
        lambda p, x, m: (lambda r: (r[0], r[1:]))(jtr.decoder_stack(
            p, x, m, jcfg, tgt_mask=jnp.asarray(tmask),
            memory_mask=jnp.asarray(mmask))),
        lambda p, x, m: (lambda r: (r[0], r[1:]))(ttr.decoder_stack(
            p, x, m, tcfg, tgt_mask=T(tmask), memory_mask=T(mmask))),
        jp, tgt, mem, cot)
    np.testing.assert_allclose(out.detach().numpy(), jout, **TOL)
    for got_w, want_w in zip(aux, jaux):
        _weights_close(got_w, want_w)
    _assert_grads(tg, jg, "decoder_stack tpu masks")


@pytest.mark.parametrize("compat,impl,L,Lm,method,steps", [
    ("reference", "dense", 6, 4, "euler", 1),
    ("reference", "dense", 5, 5, "rk4", 2),
    ("tpu", "dense", 6, 4, "midpoint", 3),
    ("reference", "fused", 6, 4, "euler", 1),
    ("reference", "packed", 5, 5, "euler", 1)])
def test_ode_decoder_matches_jax(compat, impl, L, Lm, method, steps):
    """relu(z(T)) and the weights of one more stack evaluation at z(T)."""
    jcfg, tcfg = _cfgs(compat, impl)
    jp = jtr.decoder_stack_init(jax.random.PRNGKey(6), jcfg, 1)
    tgt, mem, cot = _tokens(31 + L, L, Lm)
    tgt, mem = 0.1 * tgt, 0.1 * mem

    def pick(r):
        return r[0], (r[1]["self"], r[1]["cross"])

    (jout, jaux, jg), (out, aux, tg) = _run_pair(
        lambda p, x, m: pick(jode.ode_decoder(p, x, m, jcfg, time=12.0,
                                              method=method, steps=steps)),
        lambda p, x, m: pick(tode.ode_decoder(p, x, m, tcfg, time=12.0,
                                              method=method, steps=steps)),
        jp, tgt, mem, cot)
    np.testing.assert_allclose(out.detach().numpy(), jout, **TOL)
    for got_w, want_w in zip(aux, jaux):
        _weights_close(got_w, want_w)
    _assert_grads(tg, jg, f"ode_decoder {compat} {impl} {method}")


def test_decoder_refuses_sequence_parallel_routes():
    _, tcfg = _cfgs("reference", "ring")
    jcfg, _ = _cfgs("reference", "dense")
    p = bridged(jtr.decoder_layer_init(jax.random.PRNGKey(0), jcfg))
    x = torch.zeros(4, N, S_, D)
    for impl in ("ring", "ulysses"):
        with pytest.raises(ValueError, match="decoder layers do not support"):
            ttr.decoder_layer(p, x, x, tcfg._replace(attn_impl=impl))


# --------------------------------------------------------------------------- #
# mhgsa with bias_kv / add_zero_attn                                          #
# --------------------------------------------------------------------------- #

def _mhgsa_setup(seed, E=D):
    rng = np.random.default_rng(seed)
    p = jattn.mhgsa_init(jax.random.PRNGKey(seed), E)
    p = p._replace(in_proj_b=0.1 * randn(rng, 3 * E),
                   out_proj_b=0.1 * randn(rng, E))
    bias = (randn(rng, E), randn(rng, E))
    return rng, p, bias


def _mhgsa_pair(p, bias, x, kv, cot, *, self_attn, jkw, tkw, heads=H):
    """JAX's and the port's mhgsa forward, weights and gradients (the
    parameters, bias_k, bias_v, query and key/value)."""
    def jloss(pp, b, q, k):
        k = q if self_attn else k
        out, w = jattn.mhgsa(pp, q, k, k, heads, bias_kv=b, **jkw)
        return jnp.sum(out * cot), (out, w)

    with jax.default_matmul_precision("highest"):
        (_, (jout, jw)), jg = jax.value_and_grad(
            jloss, argnums=(0, 1, 2, 3), has_aux=True)(
                p, None if bias is None else tuple(map(jnp.asarray, bias)),
                jnp.asarray(x), jnp.asarray(kv))
    tp = bridge.tree_map(lambda t: t.requires_grad_(), bridged(p))
    tb = None if bias is None else tuple(T(b).requires_grad_() for b in bias)
    tx, tk = T(x).requires_grad_(), T(kv).requires_grad_()
    out, w = tattn.mhgsa(tp, tx, tx if self_attn else tk,
                         tx if self_attn else tk, heads, bias_kv=tb, **tkw)
    (out * T(cot)).sum().backward()
    got = [t.grad for t in bridge.tree_leaves(tp)] + \
        ([] if tb is None else [b.grad for b in tb]) + [tx.grad] + \
        ([] if self_attn else [tk.grad])
    want = jax.tree_util.tree_leaves(jg[0]) + \
        ([] if bias is None else list(jg[1])) + [jg[2]] + \
        ([] if self_attn else [jg[3]])
    return (np.asarray(jout), jw, want), (out, w, got)


@pytest.mark.parametrize("compat", ["reference", "tpu"])
@pytest.mark.parametrize("self_attn,L,S", [(True, 6, 6), (False, 6, 4),
                                           (False, 5, 5)])
@pytest.mark.parametrize("bias,zero", [(True, False), (False, True),
                                       (True, True)])
@pytest.mark.parametrize("masking", [None, "mask", "kv_valid"])
def test_mhgsa_bias_kv_add_zero_attn_match_jax(compat, self_attn, L, S,
                                               bias, zero, masking):
    """Square and non-square, with an additive mask (it gains a 0 column)
    or a key validity (it gains a valid key), on the plain route."""
    rng, p, bias_kv = _mhgsa_setup(L * 7 + S)
    x = randn(rng, N, L, D)
    kv = x if self_attn else randn(rng, N, S, D)
    cot = randn(rng, N, L, D)
    jkw = dict(compat=compat, need_weights=True, fused=False,
               add_zero_attn=zero)
    tkw = dict(compat=compat, need_weights=True, add_zero_attn=zero)
    if masking == "mask":
        m = np.where(rng.random((N, L, S)) < 0.3, -1e30,
                     rng.standard_normal((N, L, S))).astype(np.float32)
        jkw["mask"], tkw["mask"] = jnp.asarray(m), T(m)
    elif masking == "kv_valid":
        val = np.ones((N, S), np.float32)
        val[1, -2:] = 0.0
        val[2] = 0.0                  # no real key: the appended ones stay
        jkw["kv_valid"], tkw["kv_valid"] = jnp.asarray(val), T(val)
    (jout, jw, jg), (out, w, tg) = _mhgsa_pair(
        p, bias_kv if bias else None, x, kv, cot, self_attn=self_attn,
        jkw=jkw, tkw=tkw)
    s_new = S + int(bias) + int(zero)
    assert w.shape == (N, L, s_new)
    np.testing.assert_allclose(out.detach().numpy(), jout, **TOL)
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(jw), **TOL)
    _assert_grads(tg, jg, f"mhgsa {compat} {L}x{S} bias={bias} zero={zero}")


@pytest.mark.parametrize("route", ["fused", "packed"])
@pytest.mark.parametrize("bias,zero", [(False, False), (True, False),
                                       (False, True), (True, True)])
def test_mhgsa_bias_kv_loses_the_q3_swap(route, bias, zero):
    """A square reference-compat self-attention runs swapped (Q3); with an
    appended position it is S = L + 1 (or + 2) and runs unswapped. JAX's
    forced kernel route (Pallas interpret) against the port's forced
    route, and both against the plain route, which orients the scores by
    the same rule."""
    L = 8
    rng, p, bias_kv = _mhgsa_setup(40 + int(bias) + 2 * int(zero), E=32)
    x = randn(rng, 2, L, 32)
    cot = randn(rng, 2, L, 32)
    kw = dict(compat="reference", add_zero_attn=zero)
    fused = True if route == "fused" else route
    # the packed kernel wants an explicit head axis: fold a batch axis in
    x4 = x[:, None] if route == "packed" else x
    cot4 = cot[:, None] if route == "packed" else cot
    (jout, _, jg), (out, w, tg) = _mhgsa_pair(
        p, bias_kv if bias else None, x4, x4, cot4, self_attn=True,
        jkw=dict(kw, fused=fused), tkw=dict(kw, fused=fused), heads=8)
    assert w is None
    np.testing.assert_allclose(out.detach().numpy(), jout, **TOL)
    _assert_grads(tg, jg, f"mhgsa {route} bias={bias} zero={zero}")
    outs = {}
    for compat in ("reference", "tpu"):
        (dout, _, _), _ = _mhgsa_pair(
            p, bias_kv if bias else None, x4, x4, cot4, self_attn=True,
            jkw=dict(kw, compat=compat, fused=False),
            tkw=dict(kw, compat=compat, fused=False), heads=8)
        outs[compat] = dout
    np.testing.assert_allclose(out.detach().numpy(), outs["reference"],
                               **TOL)
    # the orientation: swapped (≠ compat "tpu") only while square
    appended = bias or zero
    assert np.allclose(outs["reference"], outs["tpu"], rtol=1e-5,
                       atol=1e-5) == appended
