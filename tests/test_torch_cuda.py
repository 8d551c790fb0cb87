"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (Hopper: the kernels are built for
sm_90a) and nvcc, and skips without one. The file imports neither JAX nor
the JAX package, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances as in tests/test_torch_kernels.py: attention 1e-5, selection
decode and the model 1e-4 (fp32 with different summation orders).
"""

import numpy as np
import pytest
import torch

from sttode_tpu_torch.bridge import to_device
from sttode_tpu_torch.data.preprocess import prepare_scene_group
from sttode_tpu_torch.data.synthetic import make_social_scenes
from sttode_tpu_torch.kernels import mhgsa as tmhgsa
from sttode_tpu_torch.kernels import select_decode as tsd
from sttode_tpu_torch.models import sttode as tm
from sttode_tpu_torch.serving import Predictor


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _attn_inputs(shape_q, S, mask_kind, seed):
    rng = np.random.default_rng(seed)
    *lead, L, Dh = shape_q
    arr = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    q, k, v = arr(*shape_q), arr(*lead, S, Dh), arr(*lead, S, Dh)
    mask = None
    if mask_kind == "finite":
        mask = 3.0 * arr(*lead, L, S) + 2.0
    elif mask_kind == "finfo_min":
        mask = torch.where(torch.from_numpy(rng.random((*lead, L, S))) < 0.3,
                           torch.finfo(torch.float32).min, 0.0)
        mask[..., 0, :] = torch.finfo(torch.float32).min   # all excluded
    return q, k, v, mask


@pytest.mark.cuda
@pytest.mark.parametrize("shape_q,S,mask_kind", [
    ((11, 8, 32, 8), 32, None),           # scene axis, reference compat
    ((64, 8, 8, 8), 8, "finfo_min"),      # agent axis with padded keys
    ((3, 5, 40, 16), 70, "finite"),
    ((2, 2, 6, 64), 300, "finfo_min")])
def test_attention_kernel_matches_plain(cuda_device, shape_q, S, mask_kind):
    q, k, v, mask = _attn_inputs(shape_q, S, mask_kind, seed=4)
    want = tmhgsa.fused_geodesic_attention(q, k, v, mask=mask)
    before = tmhgsa.fused_geodesic_attention.launches
    got = tmhgsa.fused_geodesic_attention(
        q.to(cuda_device), k.to(cuda_device), v.to(cuda_device),
        mask=None if mask is None else mask.to(cuda_device))
    torch.cuda.synchronize()
    assert tmhgsa.fused_geodesic_attention.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    if mask_kind == "finfo_min":
        assert torch.all(got[..., 0, :] == 0)


@pytest.mark.cuda
def test_attention_kernel_refuses_grad_and_oversized_keys(cuda_device):
    q = torch.randn(2, 4, 8, device=cuda_device, requires_grad=True)
    with pytest.raises(NotImplementedError, match="forward-only"):
        tmhgsa.fused_geodesic_attention(q, q, q)
    q = torch.randn(1, 8, 64, device=cuda_device)
    kv = torch.randn(1, 100_000, 64, device=cuda_device)
    with pytest.raises(RuntimeError, match="CUDA error"):
        tmhgsa.fused_geodesic_attention(q, kv, kv)


@pytest.fixture(scope="module")
def decoder():
    cfg = tm.STTODEConfig(past_length=5, future_length=10).validate()
    return cfg, tm.sttode_init(0, cfg)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["traj", "dist"])
@pytest.mark.parametrize("M,K", [(37, 5), (16, 1)])
def test_select_decode_kernel_matches_plain(cuda_device, decoder, mode, M, K):
    cfg, params = decoder
    rng = np.random.default_rng(M * K)
    arr = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    past = arr(M, cfg.past_length, 2)
    ops = [arr(M, 2 * cfg.hidden_dim), arr(K, M, cfg.zdim),
           tm.decode_block0_state(params, past), past.reshape(M, -1),
           arr(M, 2 * cfg.future_length)]
    want = tsd.select_decode(params, *ops, mode=mode)
    before = tsd.select_decode.launches
    got = tsd.select_decode(to_device(params, cuda_device),
                            *[o.to(cuda_device) for o in ops], mode=mode)
    torch.cuda.synchronize()
    assert tsd.select_decode.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)
    leaf = ops[0].to(cuda_device).requires_grad_()
    with pytest.raises(NotImplementedError, match="forward-only"):
        tsd.select_decode(to_device(params, cuda_device), leaf,
                          *[o.to(cuda_device) for o in ops[1:]], mode=mode)


def _sweep(n, seed, draw):
    rng = np.random.default_rng(seed)
    return [draw(rng) for _ in range(n)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", _sweep(16, 11, lambda r: dict(
    lead=tuple(int(x) for x in r.integers(1, 6, size=int(r.integers(1, 3)))),
    L=int(r.integers(1, 70)), S=int(r.integers(1, 70)),
    Dh=int(r.choice([1, 3, 5, 8, 13, 32, 33, 64])),
    mask=str(r.choice(["none", "finite", "finfo_min"])))))
def test_attention_kernel_randomized_sweep(cuda_device, case):
    """Random shapes (odd head dims, L ≠ S, one leading dim or two) and mask
    kinds against the plain version."""
    rng = np.random.default_rng(case["L"] * 131 + case["S"])
    lead, L, S, Dh = case["lead"], case["L"], case["S"], case["Dh"]
    arr = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    q, k, v = arr(*lead, L, Dh), arr(*lead, S, Dh), arr(*lead, S, Dh)
    mask = None
    if case["mask"] == "finite":
        mask = 20 * arr(*lead, L, S)
    elif case["mask"] == "finfo_min":
        mask = torch.where(torch.from_numpy(rng.random((*lead, 1, S))) < 0.4,
                           torch.finfo(torch.float32).min, 0.0)
    want = tmhgsa.fused_geodesic_attention(q, k, v, mask=mask)
    got = tmhgsa.fused_geodesic_attention(
        q.to(cuda_device), k.to(cuda_device), v.to(cuda_device),
        mask=None if mask is None else mask.to(cuda_device))
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("case", _sweep(8, 12, lambda r: dict(
    hidden=int(r.choice([2, 6, 10, 64])), zdim=int(r.choice([1, 3, 8, 32])),
    t_past=int(r.integers(1, 10)), t_fut=int(r.integers(1, 14)),
    M=int(r.integers(1, 70)), K=int(r.integers(1, 7)))))
@pytest.mark.parametrize("mode", ["traj", "dist"])
def test_select_decode_kernel_randomized_sweep(cuda_device, case, mode):
    """Random decoder widths (pf and z widths not multiples of 4), horizons,
    agent counts (not multiples of the 16-row tile) and sample counts."""
    cfg = tm.STTODEConfig(hidden_dim=case["hidden"], num_heads=1,
                          zdim=case["zdim"], past_length=case["t_past"],
                          future_length=case["t_fut"])
    params = tm.sttode_init(case["M"], cfg)
    M, K = case["M"], case["K"]
    rng = np.random.default_rng(M * 7 + K)
    arr = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    past = arr(M, cfg.past_length, 2)
    ops = [arr(M, 2 * cfg.hidden_dim), arr(K, M, cfg.zdim),
           tm.decode_block0_state(params, past), past.reshape(M, -1),
           arr(M, 2 * cfg.future_length)]
    want = tsd.select_decode(params, *ops, mode=mode)
    got = tsd.select_decode(to_device(params, cuda_device),
                            *[o.to(cuda_device) for o in ops], mode=mode)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["agent", "reference"])
def test_inference_kernel_route_matches_plain_route(cuda_device, kind):
    if kind == "agent":
        cfg = tm.STTODEConfig(compat="tpu", attn_axis="agent", sample_k=6)
        n_agents = (3, 8)
    else:
        cfg = tm.STTODEConfig(past_length=5, future_length=10, sample_k=6)
        n_agents = (6, 6)
    cfg = cfg.validate()
    params = to_device(tm.sttode_init(1, cfg), cuda_device)
    scenes = make_social_scenes(5, agents_range=n_agents,
                                obs_len=cfg.past_length,
                                pred_len=cfg.future_length, seed=2)
    N = max(len(s["obs"]) for s in scenes)
    obs = np.zeros((5, N, cfg.past_length, 2), np.float32)
    valid = np.zeros((5, N), np.float32)
    for j, s in enumerate(scenes):
        obs[j, :len(s["obs"])] = s["obs"]
        valid[j, :len(s["obs"])] = 1.0
    batch, _ = prepare_scene_group(
        obs, np.zeros((5, N, cfg.future_length, 2), np.float32), valid,
        training=False)
    batch = batch.to(cuda_device)
    z = torch.randn(5 * N * cfg.sample_k, cfg.zdim, device=cuda_device)
    counts = (tmhgsa.fused_geodesic_attention.launches,
              tsd.select_decode.launches)
    with torch.inference_mode():
        got = tm.sttode_inference(params, cfg, batch, z=z)
        plain_cfg = cfg._replace(attn_impl="dense", select_impl="xla")
        want = tm.sttode_inference(params, plain_cfg, batch, z=z)
    torch.cuda.synchronize()
    assert tmhgsa.fused_geodesic_attention.launches > counts[0]
    assert tsd.select_decode.launches == counts[1] + 1
    assert got.shape == (cfg.sample_k, 5 * N, cfg.future_length, 2)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_predictor_on_card_is_deterministic(cuda_device):
    """The card's Predictor answers every scene with finite samples of the
    right shape, and the same (seed, scenes) gives the same samples."""
    cfg = tm.STTODEConfig(compat="tpu", attn_axis="agent", sample_k=4)
    params = tm.sttode_init(3, cfg)
    scenes = [s["obs"] for s in make_social_scenes(6, agents_range=(2, 9),
                                                   seed=5)]
    pred = Predictor(params, cfg, device=cuda_device, max_group=4)
    out = pred.predict_many(scenes, seed=7)
    again = pred.predict_many(scenes, seed=7)
    for a, b, s in zip(out, again, scenes):
        assert a.shape == (4, len(s), cfg.future_length, 2)
        assert np.isfinite(a).all()
        np.testing.assert_array_equal(a, b)
