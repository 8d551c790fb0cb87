"""The port's ETH-UCY and SDD path on the CPU, held to the JAX package.

The data path is numpy in both packages and must equal JAX's bit for bit:
the synthetic scenes and CSVs, ``load_eth_ucy`` (the port's numpy loop and
its own build of the C++ windowing engine, against JAX's numpy loop),
``load_sdd``, ``rotate_2d``, ``prepare_scene``, ``stack_scenes``,
``scene_batches`` (the same numpy rng draws in the same order) and
``compiled_shape_count``. JAX's preparation keeps some rotated arrays in
float64 that its model reads as float32: they are compared after that cast.

The model side is held to PERF.md §2's tolerances, 1e-4 abs/rel: the
best-of-K metrics and ``evaluate_scenes`` (device reduction against the
host-numpy oracle, and against JAX's metrics on the same predictions),
``sttode_inference`` at an ETH bucket with padded agents (JAX's latents
injected as ``z``), and one ETH training step on each recipe's route:
reference compat on the packed route (JAX's packed Pallas kernel in
interpret mode) and compat "tpu" on the agent axis on the fused route
(JAX's ``_fused_fwd``/``_fused_bwd`` in interpret mode), JAX's random draws
injected as ``TrainNoise``. Then the prefetch thread and the CLIs end to
end with ``--device cpu``. Narrow widths (hidden 16) keep the file fast.
"""

import os
import pickle
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from sttode_tpu.data import batching as jbatching
from sttode_tpu.data import eth_ucy as jeth
from sttode_tpu.data import preprocess as jprep
from sttode_tpu.data import sdd as jsdd
from sttode_tpu.data import synthetic as jsyn
from sttode_tpu.models import sttode as jm
from sttode_tpu.utils import metrics as jmetrics
from sttode_tpu_torch import bridge
from sttode_tpu_torch.cli import common
from sttode_tpu_torch.cli import test as cli_test
from sttode_tpu_torch.cli import train as cli_train
from sttode_tpu_torch.data import batching as tbatching
from sttode_tpu_torch.data import eth_ucy as teth
from sttode_tpu_torch.data import prefetch as tprefetch
from sttode_tpu_torch.data import preprocess as tprep
from sttode_tpu_torch.data import sdd as tsdd
from sttode_tpu_torch.data import synthetic as tsyn
from sttode_tpu_torch.evaluation import _best_of_k_sums, evaluate_scenes
from sttode_tpu_torch.kernels import packed_mhgsa as tpacked
from sttode_tpu_torch.models import sttode as tm
from sttode_tpu_torch.native import binding
from sttode_tpu_torch.train import checkpoint as tck
from sttode_tpu_torch.train import loop as tloop
from sttode_tpu_torch.utils import metrics as tmetrics

# one intra-op thread: pytest-xdist runs 6 workers on 8 cores, and
# torch's default of one thread a core each oversubscribes them
torch.set_num_threads(1)

SMALL = dict(hidden_dim=16, num_heads=2, ff_dim=32, zdim=8, sample_k=4)
TOL = dict(rtol=1e-4, atol=1e-4)
BATCH_FIELDS = ("past", "past_vel", "future", "future_vel", "valid")
LOSSES = ("total_loss", "loss_pred", "loss_recover", "loss_kl",
          "loss_diverse")


def _assert_scenes_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for key in a:
            if isinstance(b[key], np.ndarray):
                assert a[key].dtype == b[key].dtype, key
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)
            else:
                assert a[key] == b[key], key


def _assert_batch_equal(tb, jb):
    for f in BATCH_FIELDS:
        got = getattr(tb, f)
        assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(getattr(jb, f), np.float32), err_msg=f)
    assert (tb.batch_size, tb.agent_num) == (jb.batch_size, jb.agent_num)


def _odd_file(path):
    """Rows that test the coverage rule: ped 1 covers every frame on a
    straight line (kept, linear), ped 2 a curve (kept), ped 3 has a
    duplicated row in frame 30 and no row in frame 40 (the right count, a
    shifted trajectory: rejected in the windows that hold them), ped 4
    misses frame 100 (in every window), rows out of frame order."""
    rows = []
    for f in range(26):
        t = f * 10.0
        rows.append([t, 1.0, 0.5 * f, -0.25 * f])
        rows.append([t, 2.0, np.sin(0.3 * f) * 3.0, 0.1 * f * f])
        if f != 4:
            rows.append([t, 3.0, 1.0 + 0.2 * f, 2.0])
        if f == 3:
            rows.append([t, 3.0, 1.7, 2.1])
        if f != 10:
            rows.append([t, 4.0, -1.0 - 0.3 * f, 0.7 * np.cos(f)])
    rows = np.asarray(rows)[::-1]
    np.savetxt(path, rows, delimiter=",")


# --------------------------------------------------------------------------- #
# synthetic data                                                              #
# --------------------------------------------------------------------------- #

def test_make_social_scenes_matches_jax_dict_for_dict():
    for kw in (dict(seed=0), dict(agents_range=(2, 9), obs_len=5,
                                  pred_len=10, seed=7)):
        _assert_scenes_equal(tsyn.make_social_scenes(5, **kw),
                             jsyn.make_social_scenes(5, **kw))


def test_write_eth_style_csvs_matches_jax(tmp_path):
    kw = dict(n_files=2, frames_per_file=30, agents=4, seed=5)
    tsyn.write_eth_style_csvs(str(tmp_path / "t"), **kw)
    jsyn.write_eth_style_csvs(str(tmp_path / "j"), **kw)
    names = sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "t")) == names == [
        "synthetic_0.csv", "synthetic_1.csv"]
    for n in names:
        assert (tmp_path / "t" / n).read_bytes() == \
            (tmp_path / "j" / n).read_bytes()


# --------------------------------------------------------------------------- #
# loaders                                                                     #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("backend", ["python", "native", "auto"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_load_eth_ucy_matches_jax_bit_for_bit(tmp_path, seed, backend):
    tsyn.write_eth_style_csvs(str(tmp_path), n_files=2, frames_per_file=36,
                              agents=5 + seed, seed=seed)
    _odd_file(tmp_path / "odd.csv")
    os.makedirs(tmp_path / "a_directory")          # skipped: not a file
    kw = dict(skip=1 + seed % 2, traj_scale=(1.0, 2.0, 0.5)[seed])
    want = jeth.load_eth_ucy(str(tmp_path), backend="python", **kw)
    got = teth.load_eth_ucy(str(tmp_path), backend=backend, **kw)
    _assert_scenes_equal(got, want)
    odd = [s for s in got if s["seq_name"] == "odd.csv"]
    # ped 3 only in the windows past frame 40 (from frame 50: start 5,
    # obs boundary 130), ped 4 in none
    assert odd and all((3.0 in s["ped_ids"]) == (s["frame"] >= 130.0)
                       and 4.0 not in s["ped_ids"] for s in odd)
    assert all(s["non_linear"][0] == 0.0 for s in odd)   # ped 1: a line
    assert {len(s["ped_ids"]) for s in odd} == {2, 3}


@pytest.mark.parametrize("backend", ["python", "native"])
def test_min_ped_is_strict(tmp_path, backend):
    rows = np.asarray([[f * 10.0, 1.0, f * 1.0, 0.0] for f in range(25)]
                      + [[f * 10.0, 2.0, 0.0, f * 0.5] for f in range(5)])
    np.savetxt(tmp_path / "one.csv", rows, delimiter=",")
    for min_ped, n_scenes in ((1, 0), (0, 6)):
        got = teth.load_eth_ucy(str(tmp_path), min_ped=min_ped,
                                backend=backend)
        want = jeth.load_eth_ucy(str(tmp_path), min_ped=min_ped,
                                 backend="python")
        assert len(got) == n_scenes
        _assert_scenes_equal(got, want)


def test_windowing_helpers_match_jax(tmp_path):
    _odd_file(tmp_path / "odd.csv")
    rows = teth.read_trajectory_csv(str(tmp_path / "odd.csv"))
    np.testing.assert_array_equal(
        rows, jeth.read_trajectory_csv(str(tmp_path / "odd.csv")))
    rng = np.random.default_rng(3)
    for xy in (rng.normal(size=(20, 2)), np.linspace(0, 1, 40).reshape(20, 2)):
        for thr in (0.0, 0.002, 10.0):
            assert teth.poly_fit_nonlinear(xy, 12, thr) == \
                jeth.poly_fit_nonlinear(xy, 12, thr)
    _assert_scenes_equal(
        binding.window_file(rows, obs_len=5, pred_len=7, min_ped=0),
        [dict(s, seq_name="") for s in jeth._file_scenes(
            rows, 5, 7, 1, 0.002, 0, 1.0, "odd.csv")])
    assert binding.window_file(rows[:30]) == []
    with pytest.raises(ValueError, match=r"\[R, 4\]"):
        binding.window_file(rows[:, :3])


def test_native_engine_is_the_ports_own_build(tmp_path, monkeypatch):
    """Importing the port builds nothing; the port builds its own copy of
    the C++ source into its _build directory and loads that library, never
    the JAX package's; a failed build raises with the compiler's output (no
    quiet numpy fallback); an unknown backend is refused."""
    port = os.path.dirname(os.path.dirname(os.path.abspath(
        tprep.__file__)))
    assert binding.SOURCE == binding.library_path().parents[1] / "native" \
        / "windowing.cpp"
    assert str(binding.library_path()).startswith(
        os.path.join(port, "_build") + os.sep)
    tsyn.write_eth_style_csvs(str(tmp_path / "eth"), n_files=1,
                              frames_per_file=25, agents=3)
    code = ("from sttode_tpu_torch.native import binding\n"
            "from sttode_tpu_torch.kernels import _build\n"
            "import sttode_tpu_torch, sttode_tpu_torch.data, "
            "sttode_tpu_torch.cli.train, sttode_tpu_torch.cli.test\n"
            "assert binding._lib is None and _build._lib is None\n"
            "from sttode_tpu_torch.data import load_eth_ucy\n"
            "assert len(load_eth_ucy('eth')) == 6\n"
            "maps = open('/proc/self/maps').read()\n"
            "assert str(binding.library_path()) in maps\n"
            "assert 'libwindowing.so' not in maps\n")
    env = dict(os.environ, PYTHONPATH=os.path.dirname(port))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=str(tmp_path))

    broken = tmp_path / "windowing.cpp"
    broken.write_text("int ws_count( {\n")
    monkeypatch.setattr(binding, "SOURCE", broken)
    monkeypatch.setattr(binding, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(binding, "_lib", None)
    with pytest.raises(RuntimeError, match=r"g\+\+ failed(.|\n)*error"):
        teth.load_eth_ucy(str(tmp_path / "eth"), backend="auto")
    assert not list((tmp_path / "_build").glob("*.so"))
    with pytest.raises(ValueError, match="backend"):
        teth.load_eth_ucy(str(tmp_path / "eth"), backend="numpy")


@pytest.mark.parametrize("layout", ["reference_N2T", "time_major_NT2"])
def test_load_sdd_matches_jax(tmp_path, layout):
    groups = []
    for s in tsyn.make_social_scenes(4, agents_range=(2, 6), seed=3):
        traj = np.concatenate([s["obs"], s["pred"]], axis=1) * 50.0
        groups.append(np.transpose(traj, (0, 2, 1))
                      if layout == "reference_N2T" else traj)
    d = tmp_path / "sdd"
    d.mkdir()
    with open(d / "test.pkl", "wb") as f:
        pickle.dump(groups, f)
    got, want = tsdd.load_sdd(str(d)), jsdd.load_sdd(str(d))
    _assert_scenes_equal(got, want)
    assert got[0]["obs"].shape[1:] == (8, 2)
    np.testing.assert_allclose(
        np.concatenate([got[1]["obs"], got[1]["pred"]], 1) * 50.0,
        groups[1] if layout == "time_major_NT2"
        else np.transpose(groups[1], (0, 2, 1)), rtol=1e-6)
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        tsdd.load_sdd(str(tmp_path / "empty"))


# --------------------------------------------------------------------------- #
# preparation and batching                                                    #
# --------------------------------------------------------------------------- #

def test_rotate_2d_matches_jax():
    rng = np.random.default_rng(0)
    xy = rng.normal(size=(5, 8, 2)).astype(np.float32)
    origin = xy[:, -1].mean(0)
    for theta in (0.0, 0.7, 3.9):
        for a, b in zip(tprep.rotate_2d(xy, theta, origin),
                        jprep.rotate_2d(xy, theta, origin)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", ["eval", "train_rotated", "train_capped",
                                  "eval_padded", "train_capped_padded"])
def test_prepare_scene_matches_jax(case):
    (scene,) = jsyn.make_social_scenes(1, agents_range=(11, 11), seed=4)
    kw = {"eval": dict(training=False),
          "train_rotated": dict(training=True),
          "train_capped": dict(training=True, max_train_agent=6),
          "eval_padded": dict(training=False, pad_to=16),
          "train_capped_padded": dict(training=True, max_train_agent=6,
                                      pad_to=8)}[case]
    r_t, r_j = np.random.default_rng(9), np.random.default_rng(9)
    tb, to = tprep.prepare_scene(scene, rng=r_t, **kw)
    jb, jo = jprep.prepare_scene(scene, rng=r_j, **kw)
    _assert_batch_equal(tb, jb)
    np.testing.assert_array_equal(to, jo)
    assert r_t.bit_generator.state == r_j.bit_generator.state
    n = kw.get("pad_to") or min(11, kw.get("max_train_agent", 11))
    assert tb.agent_num == n and int(tb.valid.sum()) == min(
        11, kw.get("max_train_agent", 11))


def test_prepare_scene_refuses_what_jax_refuses():
    (scene,) = jsyn.make_social_scenes(1, agents_range=(5, 5), seed=1)
    for mod in (tprep, jprep):
        with pytest.raises(ValueError, match="needs an rng"):
            mod.prepare_scene(scene, training=True)
        with pytest.raises(ValueError, match="pad_to=4"):
            mod.prepare_scene(scene, training=False, pad_to=4)
    tb, _ = tprep.prepare_scene(scene, training=True, rand_rot=False)
    jb, _ = jprep.prepare_scene(scene, training=True, rand_rot=False)
    _assert_batch_equal(tb, jb)


def test_stack_scenes_matches_jax():
    scenes = jsyn.make_social_scenes(3, agents_range=(3, 8), seed=2)
    tbs = [tprep.prepare_scene(s, training=False, pad_to=8)[0]
           for s in scenes]
    jbs = [jprep.prepare_scene(s, training=False, pad_to=8)[0]
           for s in scenes]
    _assert_batch_equal(tprep.stack_scenes(tbs), jprep.stack_scenes(jbs))
    with pytest.raises(ValueError, match="agent_num"):
        tprep.stack_scenes([tbs[0], tprep.prepare_scene(
            scenes[0], training=False, pad_to=16)[0]])


def _batching_scenes():
    # 3-40 agents: buckets 8, 16, 32, 64, and the cap of 12 in training
    return jsyn.make_social_scenes(14, agents_range=(3, 40), seed=6)


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("spb", [1, 4])
def test_scene_batches_match_jax_bit_for_bit(spb, training):
    scenes = _batching_scenes()
    r_t, r_j = np.random.default_rng(11), np.random.default_rng(11)
    kw = dict(training=training, scenes_per_batch=spb, max_train_agent=12)
    got = list(tbatching.scene_batches(scenes, rng=r_t if training else None,
                                       **kw))
    want = list(jbatching.scene_batches(
        scenes, rng=r_j if training else None, **kw))
    assert len(got) == len(want) > 1
    for (tb, to), (jb, jo) in zip(got, want):
        _assert_batch_equal(tb, jb)
        np.testing.assert_array_equal(to, jo)
    # the same draws in the same order: the rng ends in the same state
    assert r_t.bit_generator.state == r_j.bit_generator.state
    sizes = [b.batch_size for b, _ in got]
    assert sum(sizes) == len(scenes) and max(sizes) == spb
    if training:
        assert max(b.agent_num for b, _ in got) == 16   # cap 12 → bucket 16


def test_scene_batches_guards_match_jax():
    scenes = jsyn.make_social_scenes(4, agents_range=(3, 7), seed=1)
    for mod in (tbatching, jbatching):
        with pytest.raises(ValueError, match="compat='reference'"):
            list(mod.scene_batches(scenes, training=False,
                                   scenes_per_batch=2, compat="reference"))
        with pytest.raises(ValueError, match="needs an rng"):
            list(mod.scene_batches(scenes, training=True))
        with pytest.raises(ValueError, match="shuffle=True needs an rng"):
            list(mod.scene_batches(scenes, training=False, shuffle=True))
    # one scene a batch is safe under reference compat
    assert len(list(tbatching.scene_batches(scenes, training=False,
                                            compat="reference"))) == 4


@pytest.mark.parametrize("training", [True, False])
def test_compiled_shape_count_matches_jax(training):
    scenes = _batching_scenes() + jsyn.make_social_scenes(
        2, agents_range=(130, 140), seed=1)
    for cap in (12, 100):
        got = tbatching.compiled_shape_count(scenes, max_train_agent=cap,
                                             training=training)
        assert got == jbatching.compiled_shape_count(
            scenes, max_train_agent=cap, training=training)
    assert (256 in got) != training


# --------------------------------------------------------------------------- #
# metrics and evaluation                                                      #
# --------------------------------------------------------------------------- #

def test_metrics_match_jax():
    rng = np.random.default_rng(2)
    pred = rng.normal(size=(6, 5, 12, 2)).astype(np.float32)
    gt = rng.normal(size=(6, 12, 2)).astype(np.float32)
    valid = np.array([1, 1, 0, 1, 0, 1], np.float32)
    for v in (None, valid):
        assert tmetrics.compute_ade(pred, gt, v) == \
            jmetrics.compute_ade(pred, gt, v)
        assert tmetrics.compute_fde(pred, gt, v) == \
            jmetrics.compute_fde(pred, gt, v)
    np.testing.assert_array_equal(tmetrics.best_sample_indices(pred, gt),
                                  jmetrics.best_sample_indices(pred, gt))
    for thr in (0.5, 1.0, 2.0):
        assert tmetrics.count_miss_samples(pred, gt, thr) == \
            jmetrics.count_miss_samples(pred, gt, thr)
    tm_, jm_ = tmetrics.AverageMeter(), jmetrics.AverageMeter()
    assert tm_.avg == jm_.avg == 0.0
    for val, n in ((1.5, 3), (0.25, 2), (4.0, 1)):
        tm_.update(val, n)
        jm_.update(val, n)
    assert (tm_.avg, tm_.val, tm_.count) == (jm_.avg, jm_.val, jm_.count)
    tm_.reset()
    assert (tm_.sum, tm_.count) == (0.0, 0)


def _eval_model(**kw):
    jcfg = jm.STTODEConfig(attn_impl="dense", select_impl="xla", **SMALL,
                           **kw).validate()
    tcfg = tm.STTODEConfig(**jcfg._asdict()).validate()
    jparams = jm.sttode_init(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams))
    return jcfg, tcfg, jparams, tparams


def test_evaluate_scenes_device_reduction_equals_host_oracle():
    _, tcfg, _, tparams = _eval_model(compat="tpu", attn_axis="agent")
    scenes = tsyn.make_social_scenes(7, agents_range=(3, 12), seed=8)

    def run(device_reduce, spb=1):
        return evaluate_scenes(tparams, tcfg, scenes,
                               torch.Generator().manual_seed(4), sample_k=4,
                               scenes_per_batch=spb,
                               device_reduce=device_reduce)

    for spb in (1, 3):
        dev, host = run(True, spb), run(False, spb)
        assert dev["agents"] == host["agents"] == sum(
            len(s["obs"]) for s in scenes)
        for key in ("ade", "fde", "miss_rate"):
            np.testing.assert_allclose(dev[key], host[key], rtol=1e-5,
                                       err_msg=key)
    assert evaluate_scenes(tparams, tcfg, [], sample_k=4) == {
        "ade": 0.0, "fde": 0.0, "miss_rate": 0.0, "agents": 0}


@pytest.mark.parametrize("recipe", ["reference_scene", "tpu_agent"])
def test_inference_and_reduction_at_an_eth_bucket_match_jax(recipe):
    """The port's sttode_inference on one ETH batch with padded agents
    (5 and 7 real of 8), JAX's latents injected as z, against JAX's; then
    the device reduction of evaluate_scenes on those predictions against
    JAX's metrics."""
    kw = {} if recipe == "reference_scene" else dict(compat="tpu",
                                                     attn_axis="agent")
    jcfg, tcfg, jparams, tparams = _eval_model(**kw)
    scenes = jsyn.make_social_scenes(2, agents_range=(5, 7), seed=3)
    spb = 1 if recipe == "reference_scene" else 2
    (jb, _), *_ = jbatching.scene_batches(scenes, training=False,
                                          scenes_per_batch=spb)
    (tb, _), *_ = tbatching.scene_batches(scenes, training=False,
                                          scenes_per_batch=spb)
    assert tb.agent_num == 8 and float(tb.valid.min()) == 0.0
    rng = jax.random.PRNGKey(5)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jm.sttode_inference(jparams, jcfg, jb, rng))
    M, K = tb.batch_size * tb.agent_num, jcfg.sample_k
    z = np.array(jax.random.normal(jax.random.split(rng)[1],
                                   (M * K, jcfg.zdim)))
    got = tm.sttode_inference(tparams, tcfg, tb, z=torch.from_numpy(z))
    assert got.shape == want.shape == (K, M, 12, 2)
    np.testing.assert_allclose(got.numpy(), want, **TOL)

    sums = _best_of_k_sums(got, tb.future, tb.valid, 1.0).numpy()
    real = tb.valid.numpy() > 0
    pred_nk = np.transpose(want, (1, 0, 2, 3))[real]
    gt = np.asarray(jb.future)[real]
    n = int(real.sum())
    np.testing.assert_allclose(sums[0] / n, jmetrics.compute_ade(pred_nk, gt),
                               **TOL)
    np.testing.assert_allclose(sums[1] / n, jmetrics.compute_fde(pred_nk, gt),
                               **TOL)
    assert sums[2] == jmetrics.count_miss_samples(pred_nk, gt, 1.0)
    assert sums[3] == n


# --------------------------------------------------------------------------- #
# one ETH training step against JAX                                           #
# --------------------------------------------------------------------------- #

def _jax_noise(cfg, rng, M) -> tm.TrainNoise:
    """JAX's draws inside sttode_forward(rng): split(rng, 4) → (enc, fenc,
    q, p); each trunk splits its key into (pe, ode) and draws the PE keep-
    mask [M, T, D] with bernoulli(1 − pe_dropout)."""
    D = cfg.hidden_dim
    k_enc, k_fenc, k_q, k_p = jax.random.split(rng, 4)

    def keep(key, T):
        k_pe, _ = jax.random.split(key)
        return np.asarray(jax.random.bernoulli(k_pe, 1.0 - cfg.pe_dropout,
                                               (M, T, D)))

    eps_q = jax.random.normal(k_q, (M, cfg.zdim))
    eps_p = jax.random.normal(k_p, (M * cfg.sample_k, cfg.zdim))
    return tm.TrainNoise(*(torch.from_numpy(np.array(a)) for a in (
        keep(k_enc, cfg.past_length), keep(k_fenc, cfg.future_length),
        eps_q, eps_p)))


@pytest.mark.parametrize("recipe", ["reference_packed", "tpu_agent_fused"])
def test_eth_training_step_matches_jax(recipe, monkeypatch):
    """One step of each ETH recipe on a batch of scene_batches with padded
    agents: reference compat, one scene of 5 agents in bucket 8 on the
    packed route; compat "tpu", agent axis, 4 scenes of 3-7 agents in bucket
    8 on the fused route (key masks for the padding)."""
    if recipe == "reference_packed":
        kw, spb, agents = dict(attn_impl="packed"), 1, (5, 5)
    else:
        kw, spb, agents = dict(attn_impl="fused", compat="tpu",
                               attn_axis="agent"), 4, (3, 7)
    jcfg = jm.STTODEConfig(min_clip=0.0, **SMALL, **kw).validate()
    tcfg = tm.STTODEConfig(**jcfg._asdict()).validate()
    scenes = jsyn.make_social_scenes(spb, agents_range=agents, seed=12)
    (jb, _), = jbatching.scene_batches(scenes, training=True, rng=np.random
                                       .default_rng(1), scenes_per_batch=spb)
    (tb, _), = tbatching.scene_batches(scenes, training=True, rng=np.random
                                       .default_rng(1), scenes_per_batch=spb)
    assert tb.agent_num == 8 and float(tb.valid.min()) == 0.0
    jparams = jm.sttode_init(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.tree_map(
        lambda t: t.requires_grad_(),
        bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams)))
    rng = jax.random.PRNGKey(3)

    def jloss(p):
        out = jm.sttode_forward(p, jcfg, jb, rng, train=True)
        return out.total_loss, out

    with jax.default_matmul_precision("highest"):
        (_, jout), jgrads = jax.jit(jax.value_and_grad(jloss,
                                                       has_aux=True))(jparams)
    calls = []
    real = tpacked.packed_geodesic_attention_reference
    monkeypatch.setattr(tpacked, "packed_geodesic_attention_reference",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    M = tb.batch_size * tb.agent_num
    out = tm.sttode_forward(tparams, tcfg, tb, noise=_jax_noise(jcfg, rng, M))
    out.total_loss.backward()
    # reference: both trunks ran the packed formula on [8 agents, 2 heads,
    # one scene, 8]; the agent axis runs the masked whole-S route
    assert calls == ([(8, 2, 1, 8)] * 2 if recipe == "reference_packed"
                     else [])
    for name in LOSSES:
        np.testing.assert_allclose(float(getattr(out, name).detach()),
                                   float(getattr(jout, name)), **TOL,
                                   err_msg=name)
    want = [np.asarray(g) for g in jax.tree_util.tree_leaves(jgrads)]
    got = [t.grad.numpy() for t in bridge.tree_leaves(tparams)]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, **TOL, err_msg=f"gradient leaf {i}")


# --------------------------------------------------------------------------- #
# prefetch                                                                    #
# --------------------------------------------------------------------------- #

def test_prefetch_keeps_order_and_moves_tensors():
    scenes = tsyn.make_social_scenes(9, agents_range=(3, 12), seed=5)
    want = list(tbatching.scene_batches(scenes, training=False))
    got = list(tprefetch.prefetch(iter(want), size=2, device="cpu"))
    assert len(got) == len(want)
    for (gb, go), (wb, wo) in zip(got, want):
        assert go is wo                      # numpy aux kept as it is
        for f in BATCH_FIELDS:
            assert torch.equal(getattr(gb, f), getattr(wb, f))
    seen = []
    out = list(tprefetch.prefetch(range(7), size=1,
                                  device_put=lambda x: seen.append(x) or -x))
    assert out == [0, -1, -2, -3, -4, -5, -6] and seen == list(range(7))
    moved = tprefetch.tree_to((torch.ones(2), [np.zeros(1), 3, None]),
                              lambda t: t * 2)
    assert torch.equal(moved[0], torch.full((2,), 2.0))
    assert moved[1][1:] == [3, None]


def test_prefetch_reraises_the_producers_exception():
    def batches():
        yield 1
        yield 2
        raise KeyError("bad scene")

    it = tprefetch.prefetch(batches(), size=2)
    assert next(it) == 1 and next(it) == 2
    with pytest.raises(KeyError, match="bad scene"):
        next(it)


def test_prefetch_close_releases_the_producer():
    produced, done = [], threading.Event()

    def batches():
        try:
            for i in range(1000):
                produced.append(i)
                yield i
        finally:
            done.set()

    it = tprefetch.prefetch(batches(), size=2)
    assert next(it) == 0
    it.close()                  # the consumer stops early
    assert done.wait(5.0), "the producer thread was not released"
    assert len(produced) <= 5
    n = len(produced)
    time.sleep(0.3)
    assert len(produced) == n


def test_train_epoch_with_and_without_prefetch_gives_the_same_losses():
    cfg = tm.STTODEConfig(compat="tpu", attn_axis="agent", **SMALL)
    scenes = tsyn.make_social_scenes(10, agents_range=(3, 12), seed=2)
    means = []
    for depth in (2, 0):
        step = tloop.make_train_step(cfg, 1e-3, device="cpu")
        params, opt = step.init(tm.sttode_init(1, cfg))
        _, _, m = tloop.train_epoch(
            step, params, opt, tbatching.scene_batches(
                scenes, training=True, rng=np.random.default_rng(3),
                scenes_per_batch=2),
            torch.Generator().manual_seed(6), prefetch_depth=depth)
        means.append(m)
    assert means[0] == means[1] and np.isfinite(list(means[0].values())).all()


# --------------------------------------------------------------------------- #
# the CLIs                                                                    #
# --------------------------------------------------------------------------- #

def _eth_data(root, frames=30, agents=5):
    for split, seed in (("train", 0), ("test", 1)):
        tsyn.write_eth_style_csvs(str(root / "eth" / split), n_files=1,
                                  frames_per_file=frames, agents=agents,
                                  seed=seed)


def _cli_args(tmp_path, dataset="eth", *extra):
    return ["--dataset", dataset, "--data_root", str(tmp_path / "data"),
            "--ckpt_dir", str(tmp_path / "ck"), "--device", "cpu",
            "--hidden_dim", "16", "--zdim", "8", "--sample_k", "4",
            "--log_every", "0", "--model_save_epoch", "1", *extra]


@pytest.mark.parametrize("recipe", ["reference", "agent_axis"])
def test_cli_eth_trains_resumes_and_evaluates(tmp_path, capsys, recipe):
    _eth_data(tmp_path / "data")
    extra = [] if recipe == "reference" else [
        "--compat", "tpu", "--attn_axis", "agent", "--scenes_per_batch", "4"]
    args = _cli_args(tmp_path, "eth", *extra)
    run = cli_train.main(args + ["--num_epochs", "1"])
    n_scenes = len(teth.load_eth_ucy(str(tmp_path / "data" / "eth" /
                                         "train")))
    steps = n_scenes if recipe == "reference" else -(-n_scenes // 4)
    cdir = str(tmp_path / "ck" / "eth")
    assert tck.checkpoint_epochs(cdir) == [1]
    _, state, _, cfg = tck.load_checkpoint(tck.checkpoint_path(cdir, 1))
    assert cfg == run.cfg and cfg.past_length == 8 and cfg.future_length == 12
    assert all(int(s["step"]) == steps for s in state["state"].values())
    resumed = cli_train.main(args + ["--num_epochs", "2",
                                     "--epoch_continue", "1"])
    assert resumed.start_epoch == 1 and len(resumed.history) == 1
    assert all(int(s["step"]) == 2 * steps
               for s in resumed.opt.state_dict()["state"].values())
    for r in (run, resumed):
        assert np.isfinite(list(r.history[0][2].values())).all()
    capsys.readouterr()
    best = cli_test.main(args)
    out = capsys.readouterr().out
    assert "epoch 1: ADE" in out and "epoch 2: ADE" in out
    assert "FDE" in out and "miss" in out and "agents)" in out
    assert best["epoch"] in (1, 2) and np.isfinite([best["ade"],
                                                    best["fde"]]).all()


def test_cli_sdd_evaluates_an_eth_checkpoint(tmp_path, capsys):
    _eth_data(tmp_path / "data")
    cli_train.main(_cli_args(tmp_path, "eth", "--num_epochs", "1"))
    sdd = tmp_path / "data" / "sdd" / "test"
    sdd.mkdir(parents=True)
    groups = [np.transpose(np.concatenate([s["obs"], s["pred"]], 1) * 50.0,
                           (0, 2, 1))
              for s in tsyn.make_social_scenes(5, agents_range=(2, 9),
                                               seed=4)]
    with open(sdd / "test_sdd.pkl", "wb") as f:
        pickle.dump(groups, f)
    (tmp_path / "ck" / "sdd").mkdir()
    os.link(tmp_path / "ck" / "eth" / "model_0001.pt",
            tmp_path / "ck" / "sdd" / "model_0001.pt")
    capsys.readouterr()
    best = cli_test.main(_cli_args(tmp_path, "sdd"))
    out = capsys.readouterr().out
    n = sum(len(g) for g in groups)
    assert f"({n} agents)" in out and best["epoch"] == 1
    assert np.isfinite([best["ade"], best["fde"]]).all()
    scenes = common.load_scenes(common.base_parser("x").parse_args(
        ["--dataset", "sdd", "--data_root", str(tmp_path / "data")]), "test")
    _assert_scenes_equal(scenes, jsdd.load_sdd(str(sdd)))


def test_cli_dataset_defaults_match_jax(tmp_path):
    from sttode_tpu.cli import common as jcommon
    _eth_data(tmp_path / "data", frames=25)
    for argv in (["--dataset", "eth"], ["--dataset", "eth",
                                        "--max_train_agent", "50"],
                 ["--dataset", "hotel"], ["--dataset", "sdd"]):
        a = common.base_parser("x").parse_args(argv)
        j = jcommon.base_parser("x").parse_args(argv)
        assert common.effective_max_train_agent(a) == \
            jcommon.effective_max_train_agent(j)
    a = common.base_parser("x").parse_args(
        ["--dataset", "eth", "--data_root", str(tmp_path / "data")])
    assert common.effective_max_train_agent(a) == 32
    for split in ("train", "test"):
        _assert_scenes_equal(common.load_scenes(a, split), jeth.load_eth_ucy(
            str(tmp_path / "data" / "eth" / split), backend="python"))
    with pytest.raises(ValueError, match="compat='reference'"):
        cli_train.main(_cli_args(tmp_path, "eth", "--scenes_per_batch", "2",
                                 "--num_epochs", "1"))
