"""Head dims above 128 and masked problems beyond shared memory, against the
JAX package, on the CPU.

The route (``nn.attention._kernel_route``, a pure function of shapes and
flags) keeps every masked problem up to S = 2048 on the whole-S kernel, as
JAX keeps it on its fused kernel, whatever the head dim: beyond shared
memory the card's forward streams the keys (``csrc/stream_fwd.cuh``) and the
backward stages in a device workspace. A maskless problem whose whole-S fit
fails goes to flash, which now takes any head dim, as JAX's padded flash
does. On the CPU the flash wrapper runs its plain versions; they are held
against JAX's Pallas flash kernel in interpret mode at Dh = 256 (JAX pads
the head dim to a multiple of 128), both metrics, forward and gradients.
The kernels themselves are held against these plain versions on the card by
``tests/test_torch_cuda.py``.

Tolerances: those of the port's flash tests against JAX — oblique forward
3e-5 and gradients 5e-5 × max(1, max |g|) (JAX's compensated 3-pass bf16
Gram); poincaré 2e-5 and 1e-4 × max(1, max |g|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sttode_tpu.kernels import mhgsa as jmhgsa
from sttode_tpu.manifolds import pmath as jp
from sttode_tpu_torch.kernels import mhgsa as tmhgsa
from sttode_tpu_torch.nn import attention as tattn

# one intra-op thread: pytest-xdist runs 6 workers on 8 cores, and
# torch's default of one thread a core each oversubscribes them
torch.set_num_threads(1)

TOL = {"oblique": (3e-5, 5e-5), "poincare": (2e-5, 1e-4)}


def _route(shape_q, shape_k, **kw):
    flags = dict(has_mask=False, has_kv_valid=False, compat="tpu",
                 fused="auto", need_weights=False, metric="oblique",
                 on_cuda=True)
    return tattn._kernel_route(shape_q, shape_k, **{**flags, **kw})


@pytest.mark.parametrize("metric", ["oblique", "poincare"])
@pytest.mark.parametrize("S", [436, 1569, 2048])
def test_route_keeps_masked_problems_beyond_the_fit_on_the_whole_s_kernel(
        metric, S):
    """Masked [8, S, 64] problems up to S = 2048 go to the whole-S kernel
    ("fused"), as in JAX, although their keys and values pass the block's
    shared memory (oblique from S = 436 at Dh = 64): the forward streams
    them. Beyond 2048 a mask goes to the plain path, as in JAX."""
    fwd, _ = tmhgsa.whole_s_smem_bytes(S, S, 64, metric)
    assert fwd > tmhgsa.SMEM_OPTIN_BYTES
    shape = (8, S, 64)
    assert _route(shape, shape, has_mask=True, metric=metric) == "fused"
    big = (8, 2049, 64)
    assert _route(big, big, has_mask=True, metric=metric) is None


@pytest.mark.parametrize("metric", ["oblique", "poincare"])
@pytest.mark.parametrize("L", [32, 54, 300])
def test_route_sends_wide_maskless_problems_to_flash(metric, L):
    """Maskless Dh = 256 problems whose whole-S fit fails (from L = S = 54)
    go to flash, which takes any head dim; the small ones stay whole-S."""
    shape = (4, L, 256)
    fits = max(tmhgsa.whole_s_smem_bytes(L, L, 256, metric)) <= \
        tmhgsa.SMEM_OPTIN_BYTES
    assert fits == (L < 54)
    assert _route(shape, shape, metric=metric) == ("fused" if fits
                                                   else "flash")


def _inputs(seed, metric, lead, L, S, Dh, c=1.0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((*lead, L, Dh)).astype(np.float32)
    k = rng.standard_normal((*lead, S, Dh)).astype(np.float32)
    if metric == "poincare":   # mid-ball points, rows of norm ~0.5
        q, k = (np.array(jp.project(jp.expmap0(
            jnp.asarray(x * (0.5 / Dh ** 0.5)), c=c), c=c), np.float32)
                for x in (q, k))
    v = rng.standard_normal((*lead, S, Dh)).astype(np.float32)
    w = rng.standard_normal((*lead, L, Dh)).astype(np.float32)
    kv = (rng.random((*lead, S)) > 0.3).astype(np.float32)
    kv[..., 0] = 1.0
    return q, k, v, w, kv


@pytest.mark.parametrize("metric", ["oblique", "poincare"])
def test_flash_dh256_matches_jax_interpret(metric):
    """The flash plain versions at Dh = 256 (forward, lse-replaying sweeps
    through the port's autograd Function) against JAX's Pallas flash kernel
    in interpret mode and ``jax.grad`` through it, with a ragged key
    validity."""
    c = 1.0
    q, k, v, w, kv = _inputs(256, metric, (2,), 10, 14, 256, c)
    kw = dict(metric=metric, curvature=c)

    def jloss(q_, k_, v_):
        out = jmhgsa.flash_geodesic_attention(
            q_, k_, v_, kv_valid=jnp.asarray(kv), interpret=True, **kw)
        return jnp.sum(out * w), out

    (_, jout), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                       has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    before = tmhgsa.flash_geodesic_attention.launches
    out = tmhgsa.flash_geodesic_attention(*leaves,
                                          kv_valid=torch.from_numpy(kv), **kw)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(), leaves)
    assert tmhgsa.flash_geodesic_attention.launches == before   # plain
    tol, gtol = TOL[metric]
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=0, atol=tol)
    for name, g, want in zip(("dq", "dk", "dv"), grads, jg):
        want = np.asarray(want)
        assert np.isfinite(g.numpy()).all(), name
        np.testing.assert_allclose(
            g.numpy(), want, rtol=0,
            atol=gtol * max(1.0, float(np.abs(want).max())), err_msg=name)
