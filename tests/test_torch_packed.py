"""The port's small-shape key-validity attention against the JAX package, on
the CPU.

On the CPU the wrapper ``kernels.packed_mhgsa.packed_geodesic_attention``
runs its plain versions (forward, and the hand-derived backward through the
port's ``torch.autograd.Function``); they are held against JAX's
``packed_geodesic_attention``, whose Pallas kernel runs in interpret mode
off the TPU, and against ``jax.grad`` through it. The CUDA kernels are held
against these plain versions on the card by ``tests/test_torch_cuda.py``.
The route (``nn.attention._kernel_route``, a pure function of shapes and
flags) is held against the JAX package's ``_kernel_route`` as it decides
inside JAX's ``geodesic_attention``.

Tolerances, as for the whole-S kernel: forward 1e-5 abs/rel (fp32 with
other summation orders); gradients 5e-5 × max(1, max |gradient|) (acos' is
up to ~70 at the clip and amplifies the Gram's rounding).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sttode_tpu.kernels import packed_mhgsa as jpacked
from sttode_tpu.nn import attention as jattn
from sttode_tpu_torch.bridge import params_from_jax
from sttode_tpu_torch.kernels import mhgsa as tmhgsa
from sttode_tpu_torch.kernels import packed_mhgsa as tpacked
from sttode_tpu_torch.nn import attention as tattn

# one intra-op thread: pytest-xdist runs 6 workers on 8 cores, and
# torch's default of one thread a core each oversubscribes them
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = 5e-5

# (B, H, L, S, Dh, masked), the cases of tests/test_packed_kernel.py: the
# NBA-recipe proxy, the agent axis, rectangular, kv_valid at the recipe's
# size, the H·Dh = 128 boundary, odd sizes
CASES = [
    (3, 8, 32, 32, 8, False),
    (2, 8, 11, 11, 8, True),
    (1, 4, 16, 24, 16, False),
    (5, 8, 32, 32, 8, True),
    (2, 16, 8, 8, 8, False),
    (1, 2, 7, 13, 8, True),
]


def T(a, grad=False):
    return torch.from_numpy(np.array(a, np.float32)).requires_grad_(grad)


def _case(seed, B, H, L, S, Dh, masked):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, L, Dh)).astype(np.float32)
    k = rng.standard_normal((B, H, S, Dh)).astype(np.float32)
    v = rng.standard_normal((B, H, S, Dh)).astype(np.float32)
    w = rng.standard_normal((B, H, L, Dh)).astype(np.float32)
    kv = None
    if masked:
        kv = (rng.random((B, S)) > 0.3).astype(np.float32)
        kv[:, 0] = 1.0                    # at least one valid key
    return q, k, v, w, kv


def _jax_packed(q, k, v, kv):
    with jax.default_matmul_precision("highest"):
        return np.asarray(jpacked.packed_geodesic_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            kv_valid=None if kv is None else jnp.asarray(kv)))


def _jax_packed_grads(q, k, v, w, kv):
    def loss(q, k, v):
        out = jpacked.packed_geodesic_attention(
            q, k, v, kv_valid=None if kv is None else jnp.asarray(kv))
        return jnp.sum(out * w)

    with jax.default_matmul_precision("highest"):
        g = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                              jnp.asarray(v))
    return [np.asarray(x) for x in g]


def _port_packed_grads(q, k, v, w, kv):
    leaves = [T(q, True), T(k, True), T(v, True)]
    out = tpacked.packed_geodesic_attention(
        *leaves, kv_valid=None if kv is None else T(kv))
    return [g.numpy() for g in torch.autograd.grad((out * T(w)).sum(),
                                                   leaves)]


def _launches():
    return (tpacked.packed_geodesic_attention.launches,
            tpacked.packed_geodesic_attention_backward.launches)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_packed_forward_matches_jax(case):
    q, k, v, _, kv = _case(1, *case)
    before = _launches()
    got = tpacked.packed_geodesic_attention(
        T(q), T(k), T(v), kv_valid=None if kv is None else T(kv))
    assert _launches() == before              # plain version on the CPU
    np.testing.assert_allclose(got.numpy(), _jax_packed(q, k, v, kv), **TOL)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_packed_grads_match_jax_grad(case):
    q, k, v, w, kv = _case(2, *case)
    want = _jax_packed_grads(q, k, v, w, kv)
    before = _launches()
    got = _port_packed_grads(q, k, v, w, kv)
    assert _launches() == before
    for name, g, wnt in zip(("dq", "dk", "dv"), got, want):
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(
            g, wnt, rtol=0, atol=GRAD_TOL * max(1.0, float(np.abs(wnt).max())),
            err_msg=name)


def test_all_invalid_problem_is_exactly_zero():
    """A problem whose every key is invalid outputs 0 and gets exactly zero
    gradients (the floored denominator, no NaN), in the port as in JAX."""
    q, k, v, w, _ = _case(3, 2, 4, 8, 8, 8, False)
    kv = np.ones((2, 8), np.float32)
    kv[1] = 0.0
    out = tpacked.packed_geodesic_attention(T(q), T(k), T(v), kv_valid=T(kv))
    assert torch.all(out[1] == 0.0) and torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), _jax_packed(q, k, v, kv), **TOL)
    got = _port_packed_grads(q, k, v, w, kv)
    for g in got:
        assert np.isfinite(g).all() and np.all(g[1] == 0.0)
    dq, dk, dv = tpacked.packed_geodesic_attention_backward(
        T(q), T(k), T(v), T(kv), T(w))
    assert all(bool(torch.all(x[1] == 0.0)) for x in (dq, dk, dv))


def test_identical_qk_gradient_is_finite_and_matches_jax():
    """q = k puts the Gram diagonal at 1, outside the clip: the gate zeros
    those terms instead of turning them into NaN."""
    q, _, v, w, _ = _case(4, 2, 4, 12, 12, 8, False)

    def jloss(x):
        return jnp.sum(jpacked.packed_geodesic_attention(
            x, x, jnp.asarray(v)) * w)

    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.grad(jloss)(jnp.asarray(q)))
    tq = T(q, True)
    out = tpacked.packed_geodesic_attention(tq, tq, T(v))
    got = torch.autograd.grad((out * T(w)).sum(), tq)[0].numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=GRAD_TOL * max(1.0, np.abs(want).max()))


def test_packed_rejects_wide_heads_and_additive_masks():
    q = torch.zeros(1, 32, 8, 8)                   # H·Dh = 256 > 128
    with pytest.raises(ValueError, match="128"):
        tpacked.packed_geodesic_attention(q, q, q)
    q = torch.randn(1, 4, 8, 8)
    with pytest.raises(ValueError, match="key-validity"):
        tattn.geodesic_attention(q, q, q, mask=torch.zeros(1, 1, 8, 8),
                                 compat="tpu", fused="packed")
    # under the Q3 swap a key validity is an additive mask: refused as well
    with pytest.raises(ValueError, match="Q3"):
        tattn.geodesic_attention(q, q, q, kv_valid=torch.ones(1, 8),
                                 compat="reference", fused="packed")


# --------------------------------------------------------------------------- #
# routing                                                                     #
# --------------------------------------------------------------------------- #

ROUTE_SHAPES = [
    ((2, 8, 32, 8), (2, 8, 32, 8)),      # the NBA recipe's problems
    ((11, 8, 128, 8), (11, 8, 128, 8)),  # the bench recipe: L·S > 32²
    ((88, 8, 1, 8), (88, 8, 1, 8)),      # single-scene serving, L = S = 1
    ((2, 16, 8, 8), (2, 16, 8, 8)),      # H·Dh = 128
    ((2, 17, 8, 8), (2, 17, 8, 8)),      # H·Dh = 136
    ((3, 4, 256, 8), (3, 4, 256, 8)),    # L·S = 2¹⁶: JAX's whole-S kernel
    ((3, 32, 8), (3, 32, 8)),            # no head axis
    ((2, 4, 4, 16), (2, 4, 256, 16)),    # rectangular, L·S = 32²
    ((2, 4, 8, 16), (2, 4, 256, 16)),    # rectangular, L·S = 2·32²
    ((1, 2, 7, 8), (1, 2, 13, 8)),       # odd rectangular
    ((11, 8, 1152, 8), (11, 8, 1152, 8)),  # B = 1152: port flash, JAX fused
    ((11, 8, 2304, 8), (11, 8, 2304, 8)),  # B = 2304: both flash
]


class _RouteSeen(Exception):
    pass


def _jax_route(monkeypatch, q_shape, k_shape, *, mask, kv, compat, fused,
               need_weights):
    """The route JAX's geodesic_attention picks on a TPU (its VMEM guard
    lifted), recorded from inside the call, which then stops: nothing of
    the attention itself is computed (the shapes reach L = S = 2304). The
    additive mask is a zero row broadcast over the query rows."""
    seen = []
    real = jattn._kernel_route

    def spy(*args, **kw):
        with monkeypatch.context() as m:
            m.setattr(jax, "default_backend", lambda: "tpu")
            m.setattr(jpacked, "packed_vmem_fit", lambda *a: True)
            seen.append(real(*args, **kw))
        raise _RouteSeen

    monkeypatch.setattr(jattn, "_kernel_route", spy)
    q = jnp.zeros(q_shape) + 0.5
    k = jnp.zeros(k_shape) + 0.25
    lead = q_shape[:-3] if len(q_shape) >= 4 else q_shape[:-2]
    with pytest.raises(_RouteSeen):
        jattn.geodesic_attention(
            q, k, k, mask=jnp.zeros((*q_shape[:-2], 1, k_shape[-2])) if mask
            else None, kv_valid=jnp.ones((*lead, k_shape[-2])) if kv
            else None, compat=compat, fused=fused,
            need_weights=need_weights)
    monkeypatch.setattr(jattn, "_kernel_route", real)
    (route,) = seen
    return route


@pytest.mark.parametrize("q_shape,k_shape", ROUTE_SHAPES, ids=str)
def test_route_matches_jax_predicate(monkeypatch, q_shape, k_shape):
    """On the card "auto" picks the packed kernel exactly where the JAX
    predicate does (minus its TPU VMEM guard), the flash kernel wherever JAX
    does (S > 2048, maskless) and the whole-S kernel everywhere else JAX
    would run a kernel or XLA — with one H100 deviation: a maskless problem
    that the whole-S kernels would refuse for shared memory goes to flash
    (at Dh = 8 their backward refuses L = S > 1036, where JAX runs its fused
    kernel up to S = 2048). Forced routes and the plain route agree with
    JAX's; in both compat modes, with and without an additive mask or a key
    validity. On the CPU only a forced "packed" or "flash" leaves the plain
    path."""
    L, S, Dh = q_shape[-2], k_shape[-2], q_shape[-1]
    fits = max(tmhgsa.whole_s_smem_bytes(L, S, Dh)) <= tmhgsa.SMEM_OPTIN_BYTES
    for compat in ("reference", "tpu"):
        for mask in (False, True):
            for kv in (False, True):
                for fused in ("auto", True, "packed", "flash", False):
                    for need_weights in ((False, True) if fused == "auto"
                                         else (False,)):
                        flags = dict(compat=compat, fused=fused,
                                     need_weights=need_weights)
                        jr = _jax_route(monkeypatch, q_shape, k_shape,
                                        mask=mask, kv=kv, **flags)
                        route = {on: tattn._kernel_route(
                            q_shape, k_shape, has_mask=mask, has_kv_valid=kv,
                            metric="oblique", on_cuda=on, **flags)
                            for on in (True, False)}
                        what = (compat, mask, kv, fused, need_weights, jr)
                        maskless = not mask and not (
                            kv and compat == "reference" and L == S)
                        if fused == "auto" and not need_weights:
                            if jr in ("packed", "flash"):
                                want = jr
                            elif jr is None and S > 2048:
                                want = None    # masked beyond S = 2048
                            else:
                                want = ("flash" if maskless and not fits
                                        else "fused")
                            assert route[True] == want, what
                        else:
                            assert route[True] == jr, what
                        assert route[False] == (
                            fused if fused in ("packed", "flash")
                            else None), what


@pytest.mark.parametrize("compat", ["tpu", "reference"])
def test_mhgsa_packed_route_matches_jax(compat):
    """``mhgsa(..., fused="packed")`` at full head layout (E = 64, 8 heads
    of 8) against JAX's: with a key validity under compat "tpu"; the Q3
    swapped square case (no validity) under reference compat."""
    rng = np.random.default_rng(5)
    params = jattn.mhgsa_init(jax.random.PRNGKey(0), 64)
    params = params._replace(
        in_proj_b=rng.standard_normal(192).astype(np.float32),
        out_proj_b=rng.standard_normal(64).astype(np.float32))
    x = rng.standard_normal((3, 12, 64)).astype(np.float32)
    kv = None
    if compat == "tpu":
        kv = np.ones((3, 12), np.float32)
        kv[:, -3:] = 0.0
        kv[2] = 0.0                       # a scene with no valid key
    with jax.default_matmul_precision("highest"):
        jx = jnp.asarray(x)
        want, _ = jattn.mhgsa(params, jx, jx, jx, 8, compat=compat,
                              kv_valid=None if kv is None else jnp.asarray(kv),
                              fused="packed")
        dense, _ = jattn.mhgsa(params, jx, jx, jx, 8, compat=compat,
                               kv_valid=None if kv is None
                               else jnp.asarray(kv), fused=False)
    tx = T(x)
    before = _launches()
    got, w = tattn.mhgsa(params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                params)),
                         tx, tx, tx, 8, compat=compat,
                         kv_valid=None if kv is None else T(kv),
                         fused="packed")
    assert w is None and _launches() == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if compat == "reference":
        np.testing.assert_allclose(got.numpy(), np.asarray(dense), **TOL)


@pytest.mark.parametrize("compat", ["tpu", "reference"])
def test_kv_valid_on_the_plain_route_matches_jax(compat):
    """A key validity on the plain route becomes JAX's additive mask, under
    the Q3 swap as well."""
    rng = np.random.default_rng(6)
    q, k, v = (rng.standard_normal((2, 3, 6, 4)).astype(np.float32)
               for _ in range(3))
    kv = (rng.random((2, 6)) > 0.4).astype(np.float32)
    kv[:, 0] = 1.0
    with jax.default_matmul_precision("highest"):
        want, want_w = jattn.geodesic_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            kv_valid=jnp.asarray(kv), compat=compat, fused=False)
    got, w = tattn.geodesic_attention(T(q), T(k), T(v), kv_valid=T(kv),
                                      compat=compat, fused=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(w.numpy(), np.asarray(want_w), **TOL)
