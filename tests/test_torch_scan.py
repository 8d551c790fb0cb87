"""The port's multi-step training dispatch (``scan_steps``) and background
checkpoints against the JAX package, on the CPU.

On the CPU a step built with ``scan_steps`` = S runs the stacked batch's S
steps one after another (the card replays them as one CUDA graph: the
card tests and ``chip_smoke.py`` phase 18). JAX runs them in one
``lax.scan``, with the per-step keys ``split(key, S)``; the port gets each
step's draws recomputed from those keys and injected (``stack_noise``).

Tolerances. Losses: 1e-4 abs/rel, as every fp32 training test here (the
Euler step multiplies the encoder field by 12). Adam moments: 1e-4
relative to each leaf's largest magnitude (they hold the gradients, held
to 1e-4 in tests/test_torch_train.py). Parameters after S Adam steps at lr
1e-4: Adam's update m̂ / (√v̂ + ε) takes the sign of a gradient that sits
at its rounding floor, so there the two sides may step apart by up to
2 · lr a step; each entry is held within 2 · S · lr, at most 1e-4 of the
entries beyond 2e-6, and each leaf's update within 2e-2 in relative L2
(measured: 37 of 924,684 entries beyond 2e-6, at most 1.7e-4, the worst
leaf's update 8.7e-3 in relative L2). Stage 2 as
tests/test_torch_sampler.py: 1e-4 on the metrics, 1e-5 on the parameters.
``train_epoch``'s bookkeeping (chunk order, sizes, means, log lines) is
exact: both sides get a recording step that returns numbers of the batch.
"""

import dataclasses
import os
import threading
import time
import warnings

import jax
import numpy as np
import optax
import pytest
import torch

from sttode_tpu.data import preprocess as jprep
from sttode_tpu.data import synthetic as jsyn
from sttode_tpu.models import sttode as jm
from sttode_tpu.train import loop as jloop
from sttode_tpu_torch import bridge
from sttode_tpu_torch.cli import common
from sttode_tpu_torch.cli import train as cli_train
from sttode_tpu_torch.cli import trainsampler as cli_trainsampler
from sttode_tpu_torch.data import preprocess as tprep
from sttode_tpu_torch.models import sttode as tm
from sttode_tpu_torch.train import checkpoint as tck
from sttode_tpu_torch.train import loop as tloop
from tests.test_torch_cli import _nba_file
from tests.test_torch_sampler import (SAMPLER_FLAGS, _jax_eps, _np_tree,
                                      _setup, _write_data)
from tests.test_torch_sampler import _cli_args as _sampler_cli_args
from tests.test_torch_train import B, N, SMALL, _jax_noise

# one intra-op thread: pytest-xdist runs 6 workers on 8 cores, and
# torch's default of one thread a core each oversubscribes them
torch.set_num_threads(1)

S = 3
LR = 1e-4


def _scene_batches(cfg, seeds):
    """One B × N training batch per seed (one padded agent each), for both
    packages."""
    jbs, tbs = [], []
    for seed in seeds:
        scenes = jsyn.make_social_scenes(B, agents_range=(N, N),
                                         obs_len=cfg.past_length,
                                         pred_len=cfg.future_length,
                                         seed=seed)
        obs = np.stack([s["obs"] for s in scenes])
        pred = np.stack([s["pred"] for s in scenes])
        valid = np.ones((B, N), np.float32)
        valid[seed % B, N - 1] = 0.0
        jb, _ = jprep.prepare_scene_group(obs, pred, valid, training=True,
                                          rng=np.random.default_rng(seed))
        tb, _ = tprep.prepare_scene_group(obs, pred, valid, training=True,
                                          rng=np.random.default_rng(seed))
        jbs.append(jb)
        tbs.append(tb)
    return jbs, tbs


def _assert_moments(opt, leaves_p, mu, nu):
    for i, (p, m, v) in enumerate(zip(leaves_p, mu, nu)):
        st = opt.state.get(p)
        if not st:
            # a leaf no step reached: torch keeps no state, optax zeros
            assert p.grad is None and not np.any(np.asarray(m)), i
            continue
        for name, got, want in (("exp_avg", st["exp_avg"], m),
                                ("exp_avg_sq", st["exp_avg_sq"], v)):
            want = np.asarray(want)
            scale = max(float(np.abs(want).max()), 1e-30)
            err = float(np.abs(got.numpy() - want).max()) / scale
            assert err <= 1e-4, (name, i, err)


@pytest.mark.parametrize("kw", [
    dict(select_impl="xla", min_clip=0.0),
    dict(select_impl="fused", min_clip=0.0)], ids=["xla", "fused"])
def test_scan_train_step_matches_jax(kw):
    """make_train_step(scan_steps=3) against JAX's scanned step: every
    per-step loss term, the final parameters and both Adam moments."""
    jcfg = jm.STTODEConfig(attn_impl="dense", **SMALL, **kw).validate()
    tcfg = tm.STTODEConfig(**jcfg._asdict()).validate()
    jparams = jm.sttode_init(jax.random.PRNGKey(0), jcfg)
    jbs, tbs = _scene_batches(jcfg, range(S))
    key = jax.random.PRNGKey(11)
    opt = optax.adam(LR)
    jstep = jloop.make_train_step(jcfg, opt, scan_steps=S, donate=False)
    with jax.default_matmul_precision("highest"):
        jp, jstate, jmetrics = jstep(jparams, opt.init(jparams),
                                     jloop.stack_batches(jbs), key)
    noise = tloop.stack_noise([_jax_noise(jcfg, k)
                               for k in jax.random.split(key, S)])
    step = tloop.make_train_step(tcfg, LR, device="cpu", scan_steps=S)
    assert step.mode == "eager" and step.scan_steps == S
    params, adam = step.init(bridge.params_from_jax(_np_tree(jparams)))
    stacked = tloop.stack_batches(tbs)
    params, adam, metrics = step(params, adam, stacked, noise=noise)
    assert set(metrics) == set(jmetrics)
    for k, v in metrics.items():
        assert v.shape == (S,) and not v.requires_grad
        np.testing.assert_allclose(v.numpy(), np.asarray(jmetrics[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    leaves = bridge.tree_leaves(params)
    _assert_moments(adam, leaves, jax.tree_util.tree_leaves(jstate[0].mu),
                    jax.tree_util.tree_leaves(jstate[0].nu))
    off = 0
    for i, (a, b, p0) in enumerate(zip(
            leaves, jax.tree_util.tree_leaves(jp),
            jax.tree_util.tree_leaves(jparams))):
        a, b, p0 = a.detach().numpy(), np.asarray(b), np.asarray(p0)
        diff = np.abs(a - b)
        assert diff.max() <= 2 * S * LR, f"leaf {i}"
        want = np.linalg.norm(b - p0)
        assert np.linalg.norm((a - p0) - (b - p0)) <= 2e-2 * want + 1e-6, \
            f"leaf {i}"
        off += int((diff > 2e-6).sum())
    assert off <= 1e-4 * sum(t.numel() for t in leaves)
    assert all(int(adam.state[p]["step"]) == S for p in leaves)


def _np_dict(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def test_scan_sampler_train_step_matches_jax():
    """make_sampler_train_step(scan_steps=3) against JAX's scanned stage-2
    step, ε sampled (``train_w_mean=False``) and injected from JAX's
    per-step keys: the stacked metrics, the sampler's parameters and
    moments; the frozen net is untouched."""
    (jcfg, tcfg, jscfg, tscfg, jnet, tnet, jsp, tsp, jb,
     tb) = _setup("tpu_agent_fused", scfg_kw=dict(train_w_mean=False))
    opt = optax.adam(1e-3)
    jstep = jloop.make_sampler_train_step(jcfg, jscfg, opt, donate=False,
                                          scan_steps=S)
    key = jax.random.PRNGKey(4)
    with jax.default_matmul_precision("highest"):
        jsp2, jstate, jmetrics = jstep(jsp, jnet, opt.init(jsp),
                                       jloop.stack_batches([jb] * S), key)
    M = tb.batch_size * tb.agent_num
    eps = tloop.stack_noise([_jax_eps(jscfg, k, M)
                             for k in jax.random.split(key, S)])
    step = tloop.make_sampler_train_step(tcfg, tscfg, 1e-3, tnet,
                                         device="cpu", scan_steps=S)
    net_before = [t.clone() for t in bridge.tree_leaves(step.net_params)]
    params, adam = step.init(tsp)
    params, adam, metrics = step(params, adam, tloop.stack_batches([tb] * S),
                                 noise=eps)
    for k, v in _np_dict(jmetrics).items():
        np.testing.assert_allclose(metrics[k].numpy(), v, rtol=1e-4,
                                   atol=1e-4, err_msg=k)
    leaves = bridge.tree_leaves(params)
    for i, (a, b) in enumerate(zip(leaves, jax.tree_util.tree_leaves(jsp2))):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=0, atol=1e-5, err_msg=f"leaf {i}")
    _assert_moments(adam, leaves, jax.tree_util.tree_leaves(jstate[0].mu),
                    jax.tree_util.tree_leaves(jstate[0].nu))
    for a, b in zip(bridge.tree_leaves(step.net_params), net_before):
        assert torch.equal(a, b) and a.grad is None


class _Recorder:
    """A step for ``train_epoch`` that records each call's chunk and
    returns per-step numbers of its batches: both packages' loops get one,
    so their bookkeeping is compared exactly."""

    device = torch.device("cpu")

    def __init__(self, scan_steps, xp):
        self.scan_steps, self.xp, self.calls = scan_steps, xp, []
        self.checks = 0

    def check_budget(self):
        self.checks += 1

    def __call__(self, params, opt_state, batch, key):
        past = batch.past
        self.calls.append((batch.batch_size, batch.agent_num,
                           tuple(past.shape)))
        flat = past.reshape(past.shape[0], -1) if self.scan_steps > 1 \
            else past.reshape(1, -1)
        first = flat[:, 0]
        out = {"total": first, "agents": first * 0 + batch.agent_num}
        if self.scan_steps <= 1:
            out = {k: v[0] for k, v in out.items()}
        return params, opt_state, out


def _bucket_stream():
    """An interleaved two-bucket stream (agent buckets 3 and 5) whose
    buckets leave tails: 7 batches of one, 5 of the other."""
    rng = np.random.default_rng(0)
    kinds = [3, 5, 3, 3, 5, 3, 5, 5, 3, 3, 5, 3]
    pairs = []
    for n in kinds:
        arrs = [rng.standard_normal((2 * n, T, 2)).astype(np.float32)
                for T in (8, 8, 12, 12)]
        valid = np.ones(2 * n, np.float32)
        jb = jm.Batch(*(jax.numpy.asarray(a) for a in arrs),
                      jax.numpy.asarray(valid), batch_size=2, agent_num=n)
        tb = tm.Batch(*(torch.from_numpy(a) for a in arrs),
                      torch.from_numpy(valid), batch_size=2, agent_num=n)
        pairs.append((jb, tb))
    return pairs


@pytest.mark.parametrize("scan_steps", [1, 3])
def test_train_epoch_chunks_like_jax(scan_steps):
    """The same sequence of chunk signatures and sizes, the same means and
    the same log lines as JAX's train_epoch, over an interleaved two-bucket
    stream with tails."""
    pairs = _bucket_stream()
    jrec, trec = _Recorder(scan_steps, "jax"), _Recorder(scan_steps, "torch")
    jlogs, tlogs = [], []
    _, _, jmeans = jloop.train_epoch(
        jrec, None, None, [(jb, None) for jb, _ in pairs],
        jax.random.PRNGKey(0), log_every=4, log_fn=jlogs.append,
        prefetch_depth=0, scan_steps=scan_steps)
    _, _, tmeans = tloop.train_epoch(
        trec, None, None, [(tb, None) for _, tb in pairs], None,
        log_every=4, log_fn=tlogs.append, prefetch_depth=2)
    assert trec.calls == jrec.calls
    if scan_steps == 3:
        assert [c[2][0] for c in trec.calls] == [3, 3, 3, 2, 1]
    assert tlogs == jlogs and tlogs
    assert tmeans.keys() == jmeans.keys()
    for k in tmeans:
        np.testing.assert_allclose(tmeans[k], jmeans[k], rtol=1e-6,
                                   err_msg=k)


def test_train_epoch_takes_scan_steps_from_the_step_and_checks_its_budget():
    """``train_epoch`` chunks as the step's ``scan_steps`` says and asks the
    step to check its captured solves' budget at each log line and at the
    end."""
    pairs = _bucket_stream()
    logs = []
    rec = _Recorder(3, "torch")
    tloop.train_epoch(rec, None, None, [(tb, None) for _, tb in pairs], None,
                      log_every=4, log_fn=logs.append, prefetch_depth=0)
    assert [c[2][0] for c in rec.calls] == [3, 3, 3, 2, 1]
    assert len(logs) == 2 and rec.checks == len(logs) + 1
    one = _Recorder(1, "torch")
    tloop.train_epoch(one, None, None, [(tb, None) for _, tb in pairs], None,
                      prefetch_depth=0)
    assert len(one.calls) == len(pairs) and one.checks == 1


def _decay(t, y):
    return -50.0 * y


def test_scan_form_under_capture_flags_exhaustion_on_the_device(monkeypatch):
    """Inside a CUDA graph capture the scan form reads nothing: it ORs
    whether its budget ran out into the capture's device flag and returns
    it as a tensor, without warning (the capture is mimicked on the CPU);
    outside one it warns, as before."""
    from sttode_tpu_torch.ode import exhaustion_flag, odeint, solvers
    y0, ts = torch.ones(3), torch.tensor([0.0, 1.0])
    kw = dict(method="dopri5", rtol=1e-6, atol=1e-9, return_stats=True)
    with pytest.warns(RuntimeWarning, match="scan_budget=2 exhausted"):
        _, stats = odeint(_decay, y0, ts, scan_budget=2, **kw)
    assert stats["budget_exhausted"] is True
    monkeypatch.setattr(solvers, "_capturing", lambda t: True)
    flag = torch.zeros((), dtype=torch.bool)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with exhaustion_flag(flag):
            _, enough = odeint(_decay, y0, ts, scan_budget=200, **kw)
            assert not bool(flag)
            _, short = odeint(_decay, y0, ts, scan_budget=2, **kw)
            odeint(_decay, y0, ts, scan_budget=200, **kw)
        odeint(_decay, y0, ts, scan_budget=2, **kw)    # no flag: not ORed
    assert bool(flag) and solvers._EXHAUSTED is None
    assert not bool(enough["budget_exhausted"])
    assert bool(short["budget_exhausted"])
    assert short["attempted_steps"] is None


def test_step_warns_once_of_a_budget_exhausted_in_a_replay():
    """``check_budget`` reads the graphs' exhaustion flags, warns if one is
    set and clears them, so the next check is silent; a config without
    dopri5 reads nothing."""
    import types
    cfg = tm.STTODEConfig(**SMALL, ode_method="dopri5", ode_scan_budget=7,
                          ode_rtol=1e-3, ode_atol=1e-6)
    step = tloop.make_train_step(cfg, LR, device="cpu")
    flags = [torch.tensor(False), torch.tensor(True)]
    step.graphs = {i: types.SimpleNamespace(exhausted=f)
                   for i, f in enumerate(flags)}
    with pytest.warns(RuntimeWarning, match="scan_budget=7 exhausted"):
        step.check_budget()
    assert not any(bool(f) for f in flags)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        step.check_budget()
        euler = tloop.make_train_step(tm.STTODEConfig(**SMALL), LR,
                                      device="cpu")
        euler.graphs = {0: types.SimpleNamespace(exhausted=None)}
        euler.check_budget()


def test_a_replays_in_place_writes_reach_the_packed_weight_cache():
    """A replay writes the parameters without dispatching an operation, so
    their versions stay; ``graph.mark_changed`` (called after each replay)
    moves them, and kernel B's packed-weight cache then packs the written
    weights (mimicked on the CPU with a write through ``.data``)."""
    from sttode_tpu_torch.kernels import select_decode as ks
    from sttode_tpu_torch.train import graph as tgraph
    cfg = tm.STTODEConfig(hidden_dim=6, num_heads=1, zdim=3, past_length=4,
                          future_length=5)
    src = ks._select_sources(tm.sttode_init(4, cfg), 12, 3, 4, 5)
    a = ks._packed_weights(src, torch.float32, 12, 3)
    src[2].data.add_(1.0)                  # no version moves
    assert ks._packed_weights(src, torch.float32, 12, 3) is a
    tgraph.mark_changed(src)
    b = ks._packed_weights(src, torch.float32, 12, 3)
    assert b is not a
    np.testing.assert_array_equal(
        ks.unpack_select_weight(b[2], 512, 256).numpy(), src[2].numpy())


def test_stack_batches_matches_jax_and_asserts_static_shape():
    jcfg = jm.STTODEConfig(**SMALL).validate()
    jbs, tbs = _scene_batches(jcfg, (1, 2))
    js, ts_ = jloop.stack_batches(jbs), tloop.stack_batches(tbs)
    for f in ("past", "past_vel", "future", "future_vel", "valid"):
        np.testing.assert_array_equal(getattr(ts_, f).numpy(),
                                      np.asarray(getattr(js, f)))
    assert (ts_.batch_size, ts_.agent_num) == (js.batch_size, js.agent_num)
    other = dataclasses.replace(tbs[1], batch_size=B + 1)
    with pytest.raises(AssertionError, match="static shape"):
        tloop.stack_batches([tbs[0], other])
    jother = dataclasses.replace(jbs[1], batch_size=B + 1)
    with pytest.raises(AssertionError, match="static shape"):
        jloop.stack_batches([jbs[0], jother])
    with pytest.raises(AssertionError):
        tloop.stack_batches([])
    step = tloop.make_train_step(tm.STTODEConfig(**SMALL), LR, device="cpu",
                                 scan_steps=2)
    params, adam = step.init(tm.sttode_init(0, step.cfg))
    with pytest.raises(ValueError, match="stacked batch"):
        step(params, adam, tbs[0])
    with pytest.raises(ValueError, match="scan_steps"):
        tloop.make_train_step(step.cfg, LR, device="cpu", scan_steps=0)


def test_scan_step_equals_single_steps_and_tails():
    """A stacked call equals the same steps one a call from the same
    generator state, and one step object serves a full chunk and a tail."""
    cfg = tm.STTODEConfig(**SMALL, select_impl="fused").validate()
    _, tbs = _scene_batches(cfg, range(5))
    single = tloop.make_train_step(cfg, 1e-3, device="cpu")
    scan = tloop.make_train_step(cfg, 1e-3, device="cpu", scan_steps=3)
    p1, o1 = single.init(tm.sttode_init(2, cfg))
    p2, o2 = scan.init(tm.sttode_init(2, cfg))
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    want = [single(p1, o1, b, g1)[2]["total"] for b in tbs]
    got = [scan(p2, o2, tloop.stack_batches(tbs[:3]), g2)[2]["total"],
           scan(p2, o2, tloop.stack_batches(tbs[3:]), g2)[2]["total"]]
    assert [g.shape for g in got] == [(3,), (2,)]
    assert torch.equal(torch.cat(got), torch.stack(want))
    for a, b in zip(bridge.tree_leaves(p1), bridge.tree_leaves(p2)):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------- #
# the CLIs                                                                    #
# --------------------------------------------------------------------------- #

def _cli_args(tmp_path, *extra):
    return ["--dataset", "nba", "--data_root", str(tmp_path / "data"),
            "--ckpt_dir", str(tmp_path / "ck"), "--device", "cpu",
            "--hidden_dim", "16", "--zdim", "8", "--sample_k", "4",
            "--log_every", "0", "--batch_size", "8", *extra]


def test_cli_train_scan_steps_resumes_across_scan_steps(tmp_path, capsys):
    """``--scan_steps 2`` trains (not refused), its checkpoint resumes with
    ``--scan_steps 1`` and the other way round: the epoch, the schedule's
    learning rate and the Adam step counts continue."""
    _nba_file(tmp_path / "data", n_train=40)      # 5 steps an epoch
    args = _cli_args(tmp_path, "--model_save_epoch", "1", "--decay_step", "1")
    run = cli_train.main(args + ["--num_epochs", "1", "--scan_steps", "2"])
    assert "train step: eager, 2 step(s) a call" in capsys.readouterr().out
    assert np.isfinite(list(run.history[0][2].values())).all()
    cdir = str(tmp_path / "ck" / "nba")
    _, state, _, _ = tck.load_checkpoint(tck.checkpoint_path(cdir, 1))
    assert all(int(s["step"]) == 5 for s in state["state"].values())
    assert all(g["lr"] == 1e-4 for g in state["param_groups"])
    run = cli_train.main(args + ["--num_epochs", "2", "--epoch_continue", "1",
                                 "--scan_steps", "1"])
    assert run.start_epoch == 1 and run.history[0][1] == 5e-5
    assert all(int(s["step"]) == 10
               for s in run.opt.state_dict()["state"].values())
    run = cli_train.main(args + ["--num_epochs", "3", "--epoch_continue", "2",
                                 "--scan_steps", "3", "--async_ckpt"])
    assert all(int(s["step"]) == 15
               for s in run.opt.state_dict()["state"].values())
    assert tck.checkpoint_epochs(cdir) == [1, 2, 3]
    _, state3, epoch3, _ = tck.load_checkpoint(tck.checkpoint_path(cdir, 3))
    assert epoch3 == 3 and all(int(s["step"]) == 15
                               for s in state3["state"].values())


def test_cli_trainsampler_scan_steps_and_async_ckpt(tmp_path, capsys):
    _write_data(tmp_path / "data", "nba")
    args = _sampler_cli_args(tmp_path, "nba", "--batch_size", "8")
    cli_train.main(args + ["--num_epochs", "1"])
    run = cli_trainsampler.main(args + SAMPLER_FLAGS + [
        "--num_epochs", "2", "--scan_steps", "2", "--async_ckpt",
        "--keep_last_ckpts", "1"])
    assert "sampler step: eager, 2 step(s) a call" in capsys.readouterr().out
    assert len(run.history) == 2
    assert all(np.isfinite(list(h[2].values())).all() for h in run.history)
    sdir = str(tmp_path / "ck" / "nba" / "sampler")
    assert tck.checkpoint_epochs(sdir) == [2]
    _, state, epoch, _ = tck.load_checkpoint(tck.latest_checkpoint(sdir))
    assert epoch == 2 and all(int(s["step"]) == 8
                              for s in state["state"].values())


def test_scan_and_async_flags_are_ported():
    """Both flags parse with JAX's defaults and help, and no CLI refuses
    them: since ``--distributed`` is ported too, the CLIs have no list of
    refused flags and no helper that refuses one."""
    a = common.base_parser("x").parse_args(["--scan_steps", "4",
                                            "--async_ckpt"])
    assert (a.scan_steps, a.async_ckpt) == (4, True)
    assert not hasattr(common, "UNPORTED_FLAGS")
    assert not hasattr(common, "refuse_unported")


# --------------------------------------------------------------------------- #
# background checkpoints                                                      #
# --------------------------------------------------------------------------- #

def _small_state():
    cfg = tm.STTODEConfig(**SMALL, attn_impl="packed",
                          loss_terms=("pred", "kl")).validate()
    step = tloop.make_train_step(cfg, 1e-3, device="cpu")
    params, opt = step.init(tm.sttode_init(0, cfg))
    for t in bridge.tree_leaves(params):
        t.grad = torch.randn_like(t)
    opt.step()
    return cfg, step, params, opt


@pytest.fixture
def slow_save(monkeypatch):
    """``torch.save`` held until the test releases it."""
    release, started = threading.Event(), threading.Event()
    real = torch.save

    def save(obj, f, *a, **kw):
        started.set()
        assert release.wait(10)
        return real(obj, f, *a, **kw)

    monkeypatch.setattr(torch, "save", save)
    yield started, release
    release.set()
    tck.wait_for_saves()


def test_background_save_is_whole_or_absent_and_prunes_after_commit(
        tmp_path, slow_save):
    started, release = slow_save
    cfg, _, params, opt = _small_state()
    d = str(tmp_path)
    for e in (1, 2):
        release.set()
        tck.save_checkpoint(d, e, params, opt, cfg)
    release.clear()
    started.clear()
    path = tck.save_checkpoint(d, 3, params, opt, cfg, keep_last=1,
                               background=True)
    assert started.wait(10)
    # the write is in flight: no file under the final name, the temporary
    # one not listed, nothing pruned yet
    assert not os.path.exists(path)
    assert tck.checkpoint_epochs(d) == [1, 2]
    # the state was snapshotted: changing it now changes nothing saved
    with torch.no_grad():
        for t in bridge.tree_leaves(params):
            t.add_(1.0)
    release.set()
    tck.wait_for_saves()
    assert tck.checkpoint_epochs(d) == [3]
    assert not [f for f in os.listdir(d) if ".tmp." in f]
    p3, _, epoch, _ = tck.load_checkpoint(path)
    assert epoch == 3
    for a, b in zip(bridge.tree_leaves(p3), bridge.tree_leaves(params)):
        assert torch.equal(a + 1.0, b.detach())


def test_load_checkpoint_waits_for_a_background_save(tmp_path, slow_save):
    started, release = slow_save
    cfg, step, params, opt = _small_state()
    path = tck.save_checkpoint(str(tmp_path), 4, params, opt, cfg,
                               background=True)
    assert started.wait(10)
    threading.Timer(0.2, release.set).start()
    t0 = time.perf_counter()
    p4, state, epoch, cfg4 = tck.load_checkpoint(path)
    assert time.perf_counter() - t0 >= 0.15
    assert epoch == 4 and cfg4 == cfg
    _, opt4 = step.init(p4, state)
    assert opt4.state_dict()["param_groups"] == opt.state_dict()[
        "param_groups"]


def test_background_save_error_is_raised_by_the_wait(tmp_path, monkeypatch):
    cfg, _, params, opt = _small_state()

    def fail(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", fail)
    tck.save_checkpoint(str(tmp_path), 1, params, opt, cfg, background=True)
    with pytest.raises(OSError, match="disk full"):
        tck.flush_saves()
    tck.wait_for_saves()          # raised once
    assert tck.checkpoint_epochs(str(tmp_path)) == []


def test_capturable_form_keeps_a_loaded_state_as_it_is():
    """A graph step's Adam form (``_make_capturable``, device-agnostic): the
    rate becomes a 0-dim tensor that ``set_lr`` fills in place, a loaded
    state keeps its entries, and a leaf with no state (one no step
    reaches, as a stage-2 leaf may be) gets no entry, so a checkpoint of
    it equals the eager run's."""
    from sttode_tpu_torch.train.loop import _make_capturable
    from sttode_tpu_torch.train.schedulers import set_lr
    a = torch.zeros(3, requires_grad=True)
    b = torch.zeros(2, requires_grad=True)
    opt = torch.optim.Adam([a, b], lr=1e-3)
    a.grad = torch.ones(3)
    opt.step()
    again = torch.optim.Adam([a, b], lr=1e-3)
    again.load_state_dict(opt.state_dict())
    _make_capturable(again, torch.device("cpu"))
    lr = again.param_groups[0]["lr"]
    assert isinstance(lr, torch.Tensor) and lr.dim() == 0
    assert float(lr) == np.float32(1e-3)
    set_lr(again, 5e-4)
    assert again.param_groups[0]["lr"] is lr
    assert float(lr) == np.float32(5e-4)
    assert list(again.state_dict()["state"]) == [0]
    assert int(again.state[a]["step"]) == 1 and b not in again.state
