"""The port's two kernels against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version, which is held against
the JAX kernel run in Pallas interpret mode on the same numpy inputs. The
CUDA kernels themselves are held against the plain versions on the card by
``tests/test_torch_cuda.py``.

Tolerances: attention 1e-5 abs/rel (fp32, true acos vs the TPU kernel's
polynomial at ≤ 2e-8); selection decode 1e-4 (fp32 through a 1024-wide
first layer, a 5-8 step GRU and two MLP heads: sums of ~10³ terms
reassociate differently in each implementation).
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
from sttode_tpu_torch.kernels import _build
from sttode_tpu_torch.kernels import mhgsa as tmhgsa
from sttode_tpu_torch.kernels import select_decode as tsd
from sttode_tpu_torch.models import sttode as tm

def T(a):
    return torch.from_numpy(np.array(a, np.float32))


def _attn_inputs(shape_q, S, mask_kind, seed=0):
    rng = np.random.default_rng(seed)
    *lead, L, Dh = shape_q
    q = rng.standard_normal(shape_q).astype(np.float32)
    k = rng.standard_normal((*lead, S, Dh)).astype(np.float32)
    v = rng.standard_normal((*lead, S, Dh)).astype(np.float32)
    mask = None
    if mask_kind == "finite":
        mask = (3.0 * rng.standard_normal((*lead, L, S)) + 2.0).astype(np.float32)
    elif mask_kind in ("neg1e30", "finfo_min"):
        sentinel = -1e30 if mask_kind == "neg1e30" else np.finfo(np.float32).min
        mask = np.where(rng.random((*lead, L, S)) < 0.3, sentinel,
                        0.0).astype(np.float32)
        if L >= 2:
            mask[..., 0, :] = sentinel          # an all-excluded row
            mask[..., 1, 0] = 0.0               # a row with one live key
            mask[..., 1, 1:] = sentinel
    return q, k, v, mask


@pytest.mark.parametrize("shape_q,S", [((2, 3, 6, 4), 6), ((3, 5, 8), 7),
                                       ((2, 4, 1, 8), 1)])
@pytest.mark.parametrize("mask_kind", [None, "finite", "neg1e30", "finfo_min"])
def test_attention_plain_matches_jax_kernel(shape_q, S, mask_kind):
    q, k, v, mask = _attn_inputs(shape_q, S, mask_kind)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jmhgsa.fused_geodesic_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            mask=None if mask is None else jnp.asarray(mask), interpret=True))
    before = tmhgsa.fused_geodesic_attention.launches
    got = tmhgsa.fused_geodesic_attention(
        T(q), T(k), T(v), mask=None if mask is None else T(mask)).numpy()
    assert tmhgsa.fused_geodesic_attention.launches == before   # plain on CPU
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if mask_kind in ("neg1e30", "finfo_min") and shape_q[-2] >= 2:
        assert np.all(got[..., 0, :] == 0.0)   # all-excluded row outputs 0


def test_canonicalize_mask_matches_jax():
    rng = np.random.default_rng(3)
    m = (10 * rng.standard_normal((4, 5, 6))).astype(np.float32)
    m[0, 0] = np.finfo(np.float32).min
    m[1, 2, :3] = -1e30
    m[2, 1, 2] = 80.0
    want = np.asarray(jmhgsa._canonicalize_mask(jnp.asarray(m)))
    got = tmhgsa._canonicalize_mask(T(m)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def select_setup():
    """Small decoder (hidden 8, zdim 4; the 512/256 MLP, 96 GRU and 32 conv
    widths are fixed by the kernel), M = 13 agents (no tile multiple), K = 3."""
    cfg = JConfig(hidden_dim=8, num_heads=2, ff_dim=16, zdim=4,
                  past_length=5, future_length=6).validate()
    params = jinit(jax.random.PRNGKey(0), cfg)
    M, K = 13, 3
    rng = np.random.default_rng(1)
    pf = rng.standard_normal((M, 2 * cfg.hidden_dim)).astype(np.float32)
    z_km = rng.standard_normal((K, M, cfg.zdim)).astype(np.float32)
    past = rng.standard_normal((M, cfg.past_length, 2)).astype(np.float32)
    fut_rel = rng.standard_normal((M, 2 * cfg.future_length)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        state0 = np.asarray(jm.decode_block0_state(params, jnp.asarray(past)))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    return cfg, params, tparams, (pf, z_km, state0, past.reshape(M, -1),
                                  fut_rel)


@pytest.mark.parametrize("mode", ["traj", "dist"])
def test_select_decode_plain_matches_jax_kernel(select_setup, mode):
    cfg, params, tparams, ops = select_setup
    pf, z_km, state0, xt, fut = ops
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jsd.select_decode(
            params, *map(jnp.asarray, ops), mode=mode, dtype=jnp.float32,
            interpret=True))
    before = tsd.select_decode.launches
    got = tsd.select_decode(tparams, *map(T, ops), mode=mode).numpy()
    assert tsd.select_decode.launches == before
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_select_decode_traj_matches_model_decode(select_setup):
    """The plain version equals the port's model decode (different code:
    repeat-free broadcasting vs the repeated decode)."""
    cfg, _, tparams, (pf, z_km, state0, xt, _) = select_setup
    K, M, Z = z_km.shape
    pcfg = tm.STTODEConfig(**cfg._asdict())
    past = T(xt).reshape(M, -1, 2)
    rel = tsd.select_decode(tparams, T(pf), T(z_km), T(state0), T(xt),
                            mode="traj")
    out, _ = tm.decode(tparams, pcfg, T(pf).repeat_interleave(K, 0),
                       T(z_km).transpose(0, 1).reshape(M * K, Z), past,
                       torch.zeros(M, 1, 2), K)
    np.testing.assert_allclose(
        rel.reshape(K, M, -1, 2).numpy(),
        out.reshape(M, K, -1, 2).transpose(0, 1).numpy(), rtol=1e-5, atol=1e-5)


def test_select_decode_rejects_bad_operands(select_setup):
    _, _, tparams, (pf, z_km, state0, xt, fut) = select_setup
    with pytest.raises(ValueError, match="mode"):
        tsd.select_decode(tparams, T(pf), T(z_km), T(state0), T(xt),
                          T(fut), mode="both")
    with pytest.raises(ValueError, match="future_rel_flat"):
        tsd.select_decode(tparams, T(pf), T(z_km), T(state0), T(xt),
                          mode="dist")
    with pytest.raises(ValueError, match="shapes"):
        tsd.select_decode(tparams, T(pf[:-1]), T(z_km), T(state0), T(xt),
                          mode="traj")


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    """A missing compiler is an error, never a silent plain-version run."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert not list(tmp_path.glob("*.so"))
