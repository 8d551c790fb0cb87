"""The port's Predictor on the CPU: shapes, coordinates, the determinism
contract per attention axis, and equality with a direct ``sttode_inference``
call."""

import numpy as np
import pytest
import torch

from sttode_tpu_torch.data.preprocess import prepare_scene_group
from sttode_tpu_torch.data.synthetic import make_social_scenes
from sttode_tpu_torch.models import sttode as tm
from sttode_tpu_torch.serving import Predictor, _digest, _generator

# one intra-op thread: pytest-xdist runs 6 workers on 8 cores, and
# torch's default of one thread a core each oversubscribes them
torch.set_num_threads(1)

SMALL = dict(hidden_dim=16, num_heads=2, ff_dim=32, zdim=8, sample_k=4)


@pytest.fixture(scope="module")
def scenes():
    return [s["obs"] for s in make_social_scenes(5, agents_range=(2, 10),
                                                 seed=4)]


@pytest.fixture(scope="module", params=["scene", "agent"])
def predictor(request):
    kw = dict(SMALL) if request.param == "scene" else \
        dict(SMALL, compat="tpu", attn_axis="agent")
    cfg = tm.STTODEConfig(**kw)
    return Predictor(tm.sttode_init(0, cfg), cfg, device="cpu", max_group=3)


def test_output_shapes_and_absolute_coordinates(predictor, scenes):
    out = predictor.predict_many(scenes, seed=1)
    for o, s in zip(out, scenes):
        assert o.shape == (4, len(s), predictor.cfg.future_length, 2)
        assert np.isfinite(o).all()
        # absolute coordinates: forecasts start near the last observation
        # (random weights: a loose bound, far below the scene scale of ~10)
        gap = np.linalg.norm(o[:, :, 0] - s[None, :, -1], axis=-1)
        scene_scale = np.abs(s).max()
        assert np.median(gap) < scene_scale
    single = predictor.predict(scenes[0], seed=1)
    assert single.shape == out[0].shape


def test_rejects_malformed_scenes(predictor, scenes):
    with pytest.raises(ValueError, match="obs\\[None\\]"):
        predictor.predict(scenes[0][0])
    with pytest.raises(ValueError, match="expected"):
        predictor.predict(scenes[0][:, :3])


def test_same_call_same_samples(predictor, scenes):
    a = predictor.predict_many(scenes, seed=3)
    b = predictor.predict_many(scenes, seed=3)
    c = predictor.predict_many(scenes, seed=4)
    for x, y, w in zip(a, b, c):
        np.testing.assert_array_equal(x, y)
        assert not np.allclose(x, w)


def test_scene_axis_isolation_is_per_scene():
    """Scene axis: the same (seed, scene) gives the same samples whatever
    else shares the call (up to float reassociation)."""
    cfg = tm.STTODEConfig(**SMALL)
    pred = Predictor(tm.sttode_init(1, cfg), cfg, device="cpu")
    sc = [s["obs"] for s in make_social_scenes(6, agents_range=(5, 8),
                                               seed=6)]
    together = pred.predict_many(sc, seed=2)
    for i in (0, 3, 5):
        alone = pred.predict(sc[i], seed=2)
        np.testing.assert_allclose(together[i], alone, rtol=1e-5, atol=1e-5)
    partial = pred.predict_many(sc[2:5], seed=2)
    np.testing.assert_allclose(partial[1], together[3], rtol=1e-5, atol=1e-5)


def test_agent_axis_contract_is_per_group():
    """Agent axis: a group shares one draw, so a scene's samples depend on
    its group; the same (seed, group) reproduces them."""
    cfg = tm.STTODEConfig(**SMALL, compat="tpu", attn_axis="agent")
    pred = Predictor(tm.sttode_init(1, cfg), cfg, device="cpu", max_group=8)
    sc = [s["obs"] for s in make_social_scenes(3, agents_range=(5, 8),
                                               seed=6)]
    together = pred.predict_many(sc, seed=2)
    np.testing.assert_array_equal(pred.predict_many(sc, seed=2)[1],
                                  together[1])
    assert not np.allclose(pred.predict(sc[1], seed=2), together[1])


@pytest.mark.parametrize("axis", ["scene", "agent"])
def test_predictor_equals_direct_inference(axis, scenes):
    kw = dict(SMALL) if axis == "scene" else \
        dict(SMALL, compat="tpu", attn_axis="agent")
    cfg = tm.STTODEConfig(**kw)
    params = tm.sttode_init(2, cfg)
    pred = Predictor(params, cfg, device="cpu", buckets=(16,),
                     max_group=8)
    got = pred.predict_many(scenes, seed=5)
    K, B, N = cfg.sample_k, len(scenes), 16
    obs = np.zeros((B, N, cfg.past_length, 2), np.float32)
    valid = np.zeros((B, N), np.float32)
    for j, s in enumerate(scenes):
        obs[j, :len(s)], valid[j, :len(s)] = s, 1.0
    batch, origs = prepare_scene_group(
        obs, np.zeros((B, N, cfg.future_length, 2), np.float32), valid,
        training=False)
    cpu = torch.device("cpu")
    if axis == "scene":
        z = torch.cat([torch.randn((N * K, cfg.zdim),
                                   generator=_generator(5, _digest(s), cpu))
                       for s in scenes])
    else:
        digest = 0
        for s in scenes:
            digest ^= _digest(s)
        z = torch.randn((B * N * K, cfg.zdim),
                        generator=_generator(5, digest, cpu))
    with torch.inference_mode():
        direct = tm.sttode_inference(params, cfg, batch, z=z,
                                     isolate_scenes=axis == "scene")
    direct = direct.reshape(K, B, N, cfg.future_length, 2).numpy()
    for j, s in enumerate(scenes):
        np.testing.assert_allclose(
            got[j], direct[:, j, :len(s)] + origs[j][None, None, None],
            rtol=1e-6, atol=1e-6)


def test_isolation_equals_separate_batch_size_one_calls():
    """isolate_scenes=True is exactly B separate batch_size=1 inferences."""
    cfg = tm.STTODEConfig(**SMALL)
    params = tm.sttode_init(4, cfg)
    sc = [s["obs"] for s in make_social_scenes(3, agents_range=(4, 4),
                                               seed=8)]
    obs = np.stack(sc)
    valid = np.ones(obs.shape[:2], np.float32)
    zeros = np.zeros((3, 4, cfg.future_length, 2), np.float32)
    batch, _ = prepare_scene_group(obs, zeros, valid, training=False)
    z = torch.randn(3 * 4 * cfg.sample_k, cfg.zdim,
                    generator=torch.Generator().manual_seed(0))
    together = tm.sttode_inference(params, cfg, batch, z=z,
                                   isolate_scenes=True)
    for j in range(3):
        b1, _ = prepare_scene_group(obs[j:j + 1], zeros[j:j + 1],
                                    valid[j:j + 1], training=False)
        rows = slice(j * 4 * cfg.sample_k, (j + 1) * 4 * cfg.sample_k)
        alone = tm.sttode_inference(params, cfg, b1, z=z[rows])
        torch.testing.assert_close(together[:, j * 4:(j + 1) * 4], alone,
                                   rtol=1e-5, atol=1e-5)


def test_default_device_is_the_card():
    """Without ``device`` the Predictor serves on CUDA, and refuses to fall
    back to the CPU when there is no card."""
    cfg = tm.STTODEConfig(**SMALL)
    params = tm.sttode_init(0, cfg)
    if torch.cuda.is_available():
        assert Predictor(params, cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Predictor(params, cfg)


def test_warmup_runs(predictor):
    predictor.warmup([3, 12], scenes_per=2)
