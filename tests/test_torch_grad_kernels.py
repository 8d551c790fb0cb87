"""The port's training-path kernels against the JAX package, on the CPU: the
geodesic-attention backward and the bf16 selection decode.

On the CPU each wrapper runs its plain PyTorch version: the attention
gradient goes through the port's ``torch.autograd.Function``, whose backward
on a CPU tensor is ``fused_geodesic_attention_backward_reference``; it is
held against ``jax.grad`` through the JAX Pallas kernel in interpret mode.
The CUDA kernels are held against these plain versions on the card by
``tests/test_torch_cuda.py``.

Tolerances: attention gradients 5e-5 abs, the JAX package's own tolerance
for its fused backward (tests/test_kernels.py). bf16 selection decode 1e-4
abs/rel: both sides round to bf16 at the same points, so they differ only
where a different fp32 summation order moves a value across a bf16
rounding boundary; that is ten times below the bf16-vs-fp32 difference of
the same decode (~1e-3 on the trajectories, ~1e-2 on the distances), so
the test tells the two storage types apart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sttode_tpu.kernels import mhgsa as jmhgsa
from sttode_tpu.kernels import select_decode as jsd
from sttode_tpu.models import STTODEConfig as JConfig
from sttode_tpu.models import sttode as jm
from sttode_tpu.models import sttode_init as jinit
from sttode_tpu_torch.bridge import params_from_jax
from sttode_tpu_torch.kernels import mhgsa as tmhgsa
from sttode_tpu_torch.kernels import select_decode as tsd

# one intra-op thread: pytest-xdist runs 6 workers on 8 cores, and
# torch's default of one thread a core each oversubscribes them
torch.set_num_threads(1)

GRAD_ATOL = 5e-5


def T(a, grad=False):
    return torch.from_numpy(np.array(a, np.float32)).requires_grad_(grad)


def _attn_case(shape_q, S, mask_kind, seed=0):
    rng = np.random.default_rng(seed)
    *lead, L, Dh = shape_q
    q = rng.standard_normal(shape_q).astype(np.float32)
    k = rng.standard_normal((*lead, S, Dh)).astype(np.float32)
    v = rng.standard_normal((*lead, S, Dh)).astype(np.float32)
    w = rng.standard_normal(shape_q).astype(np.float32)   # output cotangent
    mask = None
    if mask_kind == "finite":
        mask = (3.0 * rng.standard_normal((*lead, L, S)) - 1.0) \
            .astype(np.float32)
    elif mask_kind in ("neg1e30", "finfo_min"):
        sentinel = -1e30 if mask_kind == "neg1e30" else \
            np.finfo(np.float32).min
        mask = np.where(rng.random((*lead, L, S)) < 0.3, sentinel,
                        0.0).astype(np.float32)
        mask[..., 1, 0] = 0.0                   # a row with one live key
        mask[..., 1, 1:] = sentinel
    elif mask_kind == "all_excluded":
        mask = np.zeros((*lead, L, S), np.float32)
        mask[..., 0, :] = np.finfo(np.float32).min
    return q, k, v, w, mask


def _jax_grads(q, k, v, w, mask):
    def loss(q, k, v, m):
        out = jmhgsa.fused_geodesic_attention(q, k, v, mask=m, interpret=True)
        return jnp.sum(out * w)

    argnums = (0, 1, 2) if mask is None else (0, 1, 2, 3)
    with jax.default_matmul_precision("highest"):
        g = jax.grad(loss, argnums=argnums)(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            None if mask is None else jnp.asarray(mask))
    return [np.asarray(x) for x in g]


def _port_grads(q, k, v, w, mask):
    tq, tk, tv = T(q, True), T(k, True), T(v, True)
    tm = None if mask is None else T(mask, True)
    out = tmhgsa.fused_geodesic_attention(tq, tk, tv, mask=tm)
    leaves = [tq, tk, tv] + ([] if tm is None else [tm])
    return [g.numpy() for g in torch.autograd.grad((out * T(w)).sum(),
                                                   leaves)]


@pytest.mark.parametrize("shape_q,S", [((2, 3, 6, 4), 6), ((3, 5, 8), 7),
                                       ((2, 4, 1, 8), 1)])
@pytest.mark.parametrize("mask_kind", [None, "finite", "neg1e30",
                                       "finfo_min", "all_excluded"])
def test_attention_backward_matches_jax_grad(shape_q, S, mask_kind):
    if mask_kind in ("neg1e30", "finfo_min") and shape_q[-2] < 2:
        mask_kind = "all_excluded"
    q, k, v, w, mask = _attn_case(shape_q, S, mask_kind)
    want = _jax_grads(q, k, v, w, mask)
    before = (tmhgsa.fused_geodesic_attention.launches,
              tmhgsa.fused_geodesic_attention_backward.launches)
    got = _port_grads(q, k, v, w, mask)
    assert (tmhgsa.fused_geodesic_attention.launches,
            tmhgsa.fused_geodesic_attention_backward.launches) == before
    for name, g, wnt in zip(("dq", "dk", "dv", "dmask"), got, want):
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, wnt, rtol=0, atol=GRAD_ATOL,
                                   err_msg=name)
    if mask_kind == "all_excluded":
        # an all-excluded row outputs 0, so its query gets no gradient
        assert np.all(got[0][..., 0, :] == 0.0)
        assert np.all(got[3][..., 0, :] == 0.0)


def test_attention_backward_identical_qk_is_finite_and_matches_jax():
    """q = k puts the Gram diagonal at 1, outside the clip: the gate must
    zero those terms, not turn them into NaN."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 5, 8)).astype(np.float32)
    v = rng.standard_normal((2, 5, 8)).astype(np.float32)

    def jloss(x):
        return jnp.sum(jmhgsa.fused_geodesic_attention(x, x, jnp.asarray(v),
                                                       interpret=True))

    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    tx = T(x, True)
    out = tmhgsa.fused_geodesic_attention(tx, tx, T(v))
    got = torch.autograd.grad(out.sum(), tx)[0].numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=GRAD_ATOL)


def test_backward_reference_returns_dmask_only_when_asked():
    q, k, v, w, mask = _attn_case((2, 6, 4), 5, "finite", seed=2)
    m3 = tmhgsa._canonicalize_mask(T(mask))
    args = (T(q), T(k), T(v), m3, T(w))
    *_, dm = tmhgsa.fused_geodesic_attention_backward(*args)
    assert dm is None
    dq, dk, dv, dm = tmhgsa.fused_geodesic_attention_backward(
        *args, need_dmask=True)
    assert dm.shape == (2, 6, 5)
    # the softmax VJP's rows sum to 0
    np.testing.assert_allclose(dm.sum(-1).numpy(), 0.0, atol=1e-6)


@pytest.fixture(scope="module")
def select_setup():
    """Decoder at hidden 16, zdim 8 (the 512/256 MLP, 96 GRU and 32 conv
    widths are fixed by the kernel), M = 13 agents (no tile multiple),
    K = 6, the training horizons 5 / 10."""
    cfg = JConfig(hidden_dim=16, num_heads=2, ff_dim=32, zdim=8,
                  past_length=5, future_length=10).validate()
    params = jinit(jax.random.PRNGKey(0), cfg)
    M, K = 13, 6
    rng = np.random.default_rng(1)
    pf = rng.standard_normal((M, 2 * cfg.hidden_dim)).astype(np.float32)
    z_km = rng.standard_normal((K, M, cfg.zdim)).astype(np.float32)
    past = rng.standard_normal((M, cfg.past_length, 2)).astype(np.float32)
    fut = rng.standard_normal((M, 2 * cfg.future_length)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        state0 = np.asarray(jm.decode_block0_state(params, jnp.asarray(past)))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    return params, tparams, (pf, z_km, state0, past.reshape(M, -1), fut)


@pytest.mark.parametrize("mode", ["traj", "dist"])
def test_bf16_select_decode_plain_matches_jax_kernel(select_setup, mode):
    params, tparams, ops = select_setup
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jsd.select_decode(
            params, *map(jnp.asarray, ops), mode=mode, dtype=jnp.bfloat16,
            interpret=True))
    before = dict(tsd.select_decode.launches_by_dtype)
    got = tsd.select_decode(tparams, *map(T, ops), mode=mode,
                            dtype=torch.bfloat16).numpy()
    assert tsd.select_decode.launches_by_dtype == before     # plain on CPU
    fp32 = tsd.select_decode(tparams, *map(T, ops), mode=mode).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # the test can tell bf16 storage from fp32
    assert np.abs(fp32 - want).max() > 10 * np.abs(got - want).max()
    if mode == "dist":
        g_win, w_win = got.argmin(1), want.argmin(1)
        gap = np.abs(want[np.arange(len(want)), g_win]
                     - want[np.arange(len(want)), w_win])
        assert np.all((g_win == w_win) | (gap <= 1e-4))


def test_bf16_select_weights_round_where_the_tpu_kernel_rounds(select_setup):
    _, tparams, (pf, z_km, *_rest) = select_setup
    w32 = tsd.prep_select_weights(tparams, pf.shape[1], z_km.shape[2], 5, 10)
    w16 = tsd.prep_select_weights(tparams, pf.shape[1], z_km.shape[2], 5, 10,
                                  torch.bfloat16)
    for i, (a, b) in enumerate(zip(w32, w16)):
        if i in tsd._FP32_BIASES:
            assert b.dtype == torch.float32 and torch.equal(a, b)
        elif i in tsd._ROUNDED_BIASES:
            assert b.dtype == torch.float32
            assert torch.equal(b, a.to(torch.bfloat16).to(torch.float32))
        else:
            assert b.dtype == torch.bfloat16 and torch.equal(
                b, a.to(torch.bfloat16))


def test_select_decode_rejects_other_dtypes(select_setup):
    _, tparams, ops = select_setup
    with pytest.raises(ValueError, match="dtype"):
        tsd.select_decode(tparams, *map(T, ops), dtype=torch.float16)
