"""The port's training options against the JAX package, on the CPU: the
plateau and annealing schedules, logging, flat parameter views, the
gradient guards and guarded Adam, the divergence supervisor, tracing,
timing and the parameter table, the plotters, and the CLI flags that use
them (``--supervise``, ``--profile_dir``, ``--save_plots``).

Host-side classes (schedulers, ``Supervisor``'s decisions, ``Logger``) are
held to JAX's exactly; ``guarded_adam`` to optax's chain within 1e-6 after
5 steps; the plotters by the line data of the figures they draw; the CLIs
by the files they write, ``cli.test --save_plots`` by as many PNGs as the
JAX CLI writes on the same files.
"""

import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.flatten_util import ravel_pytree

from sttode_tpu.cli import test as jcli_test
from sttode_tpu.cli import train as jcli_train
from sttode_tpu.models import STTODEConfig as JConfig
from sttode_tpu.models import sttode as jm
from sttode_tpu.train import guards as jguards
from sttode_tpu.train import schedulers as jsched
from sttode_tpu.train.supervisor import Supervisor as JSupervisor
from sttode_tpu.utils import flat_params as jflat
from sttode_tpu.utils import logging as jlog
from sttode_tpu.utils import profiling as jprof
from sttode_tpu.utils import visualize as jviz
from sttode_tpu_torch import bridge
from sttode_tpu_torch.cli import test as cli_test
from sttode_tpu_torch.cli import train as cli_train
from sttode_tpu_torch.cli import trainvae as cli_trainvae
from sttode_tpu_torch.data import synthetic as tsyn
from sttode_tpu_torch.models import sttode as tm
from sttode_tpu_torch.train import checkpoint as tck
from sttode_tpu_torch.train import guards as tguards
from sttode_tpu_torch.train import loop as tloop
from sttode_tpu_torch.train import schedulers as tsched
from sttode_tpu_torch.train.supervisor import Supervisor
from sttode_tpu_torch.utils import flat_params as tflat
from sttode_tpu_torch.utils import logging as tlog
from sttode_tpu_torch.utils import profiling as tprof
from sttode_tpu_torch.utils import visualize as tviz
from tests.test_torch_cli import _nba_file

# one intra-op thread: pytest-xdist runs 6 workers on 8 cores, and
# torch's default of one thread a core each oversubscribes them
torch.set_num_threads(1)

SMALL = dict(hidden_dim=16, num_heads=4, ff_dim=32, zdim=8, sample_k=2,
             past_length=5, future_length=10)


def _full_params():
    """The JAX model's parameter tree (numpy leaves) and its bridge."""
    jp = jax.tree_util.tree_map(np.asarray, jm.sttode_init(
        jax.random.PRNGKey(0), jm.STTODEConfig(**SMALL)))
    return jp, bridge.params_from_jax(jp)


# --------------------------------------------------------------------------- #
# schedulers, logging                                                         #
# --------------------------------------------------------------------------- #

def test_reduce_on_plateau_and_annealer_match_jax():
    rng = np.random.default_rng(0)
    metrics = np.concatenate([np.linspace(2.0, 1.0, 6),
                              1.0 + 1e-6 * rng.random(30),
                              np.linspace(0.9, 0.5, 5), np.full(20, 0.5)])
    for kw in (dict(), dict(factor=0.1, patience=2, threshold=1e-3,
                            min_lr=1e-5)):
        j, t = jsched.ReduceOnPlateau(1e-3, **kw), \
            tsched.ReduceOnPlateau(1e-3, **kw)
        seq_j = [j.step(float(m)) for m in metrics]
        seq_t = [t.step(float(m)) for m in metrics]
        assert seq_t == seq_j and len(set(seq_t)) > 1
        assert (t.best, t.bad_epochs) == (j.best, j.bad_epochs)
    j, t = jsched.ExpParamAnnealer(1.0, 0.1, 0.9), \
        tsched.ExpParamAnnealer(1.0, 0.1, 0.9)
    vals = []
    for _ in range(12):
        vals.append((t.val, j.val))
        t.step()
        j.step()
    assert all(a == b for a, b in vals) and vals[0][0] == 1.0


def test_logger_and_print_log_lines_match_jax(tmp_path, capsys):
    stamp = re.compile(r"^\[\d{4}-\d\d-\d\d \d\d:\d\d:\d\d\] ")
    lines = {}
    for name, mod in (("j", jlog), ("t", tlog)):
        path = tmp_path / name / "log.txt"
        log = mod.Logger(str(path))
        log("hello")
        mod.print_log("nba", 3, 100, 7, 20, "total: 1.2345", log=log)
        log.close()
        out = capsys.readouterr().out.splitlines()
        lines[name] = (out, path.read_text().splitlines())
    for out, file_lines in (lines["t"],):
        assert out == file_lines and all(stamp.match(x) for x in out)
    strip = [[stamp.sub("", x) for x in part] for part in lines["t"]]
    assert strip == [[stamp.sub("", x) for x in part] for part in lines["j"]]
    assert strip[0][1] == ("nba | Epo: 03/100, It: 0007/0020, "
                           "total: 1.2345")
    quiet = tlog.Logger(also_stdout=False)
    quiet("nothing printed")
    assert capsys.readouterr().out == ""


# --------------------------------------------------------------------------- #
# flat parameter views                                                        #
# --------------------------------------------------------------------------- #

def test_flat_params_order_matches_ravel_pytree():
    jp, tp = _full_params()
    jflat_vec, _ = ravel_pytree(jp)
    flat, unravel = tflat.get_flat_params(tp)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat_vec))
    back = tflat.set_flat_params(flat * 2.0, unravel)
    for a, b in zip(bridge.tree_leaves(back), bridge.tree_leaves(tp)):
        assert a.shape == b.shape
        torch.testing.assert_close(a, 2.0 * b, rtol=0, atol=0)
    assert type(back["past_encoder"]["ode_layers"][0]).__name__ == \
        "EncoderLayerParams"
    np.testing.assert_array_equal(tflat.get_flat_grad(tp).numpy(),
                                  np.asarray(jflat.get_flat_grad(jp)))
    np.testing.assert_allclose(float(tflat.param_l2(tp)),
                               float(jflat.param_l2(jp)), rtol=1e-6)


# --------------------------------------------------------------------------- #
# guards                                                                      #
# --------------------------------------------------------------------------- #

def _grad_sequence(params, rng):
    """Five gradient trees: plain, one with NaN and ±Inf entries, one of a
    huge norm, one with NaN and a huge norm, plain."""
    def draw(scale=1.0):
        return jax.tree_util.tree_map(
            lambda a: scale * rng.standard_normal(a.shape).astype(
                np.float32), params)

    seq = [draw(), draw(), draw(1e4), draw(1e3), draw()]
    for i in (1, 3):
        leaf = seq[i]["w"]
        leaf[0, 0], leaf[1, 2], leaf[2, 1] = np.nan, np.inf, -np.inf
        seq[i]["b"][1] = np.nan
    return seq


@pytest.mark.parametrize("max_grad_norm", [None, 1.0, 50.0])
def test_guarded_adam_matches_optax_chain(max_grad_norm):
    rng = np.random.default_rng(1)
    params = {"w": rng.standard_normal((4, 5)).astype(np.float32),
              "b": rng.standard_normal(5).astype(np.float32),
              "z": {"v": rng.standard_normal((3,)).astype(np.float32)}}
    grads = _grad_sequence(params, rng)
    opt = jguards.guarded_adam(1e-2, max_grad_norm=max_grad_norm)
    jp, state = params, opt.init(params)
    tp = bridge.tree_map(lambda a: torch.tensor(a).requires_grad_(), params)
    topt = tguards.guarded_adam(1e-2, max_grad_norm=max_grad_norm)(
        bridge.tree_leaves(tp), capturable=False)
    assert isinstance(topt, tguards.GuardedAdam)
    for g in grads:
        updates, state = opt.update(g, state, jp)
        jp = optax.apply_updates(jp, updates)
        for t, a in zip(bridge.tree_leaves(tp), bridge.tree_leaves(g)):
            t.grad = torch.tensor(a)
        topt.step()
        for t in bridge.tree_leaves(tp):
            assert torch.isfinite(t.grad).all()
        if max_grad_norm is not None:
            norm = float(tguards.global_norm([t.grad for t in
                                              bridge.tree_leaves(tp)]))
            assert norm <= max_grad_norm * (1 + 1e-6)
        for a, b in zip(jax.tree_util.tree_leaves(jp),
                        bridge.tree_leaves(tp)):
            np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                       rtol=0, atol=1e-6)


def test_guards_all_finite_global_norm_zero_nan():
    rng = np.random.default_rng(2)
    tree = {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": [rng.standard_normal(5).astype(np.float32)]}
    tt = bridge.tree_map(torch.tensor, tree)
    ok = tguards.all_finite(tt)
    assert ok.dtype == torch.bool and ok.dim() == 0 and bool(ok)
    assert bool(ok) == bool(jguards.all_finite(tree))
    np.testing.assert_allclose(float(tguards.global_norm(tt)),
                               float(jguards.global_norm(tree)), rtol=1e-6)
    for bad in (np.nan, np.inf):
        tree["b"][0][2] = bad
        tt = bridge.tree_map(torch.tensor, tree)
        assert not bool(tguards.all_finite(tt))
        assert bool(jguards.all_finite(tree)) is False
        zeroed = tguards.zero_nan_grads(bridge.tree_leaves(tt))
        assert float(zeroed[1][2]) == 0.0 and all(
            torch.isfinite(z).all() for z in zeroed)


def test_train_step_takes_guarded_adam():
    """``make_train_step(..., optimizer=guarded_adam(...))`` builds its
    optimizer from the factory, eager and with scan_steps; a step with
    finite gradients below the clip equals plain Adam's."""
    cfg = tm.STTODEConfig(**SMALL, select_impl="xla", attn_impl="dense",
                          min_clip=0.0)
    from sttode_tpu_torch.data import preprocess as tprep
    scenes = tsyn.make_social_scenes(2, agents_range=(3, 3), obs_len=5,
                                     pred_len=10, seed=1)
    batch, _ = tprep.prepare_scene_group(
        np.stack([s["obs"] for s in scenes]),
        np.stack([s["pred"] for s in scenes]), np.ones((2, 3), np.float32),
        training=True, rng=np.random.default_rng(3))
    outs = []
    for opt in (None, tguards.guarded_adam(1e-3, max_grad_norm=1e9)):
        step = tloop.make_train_step(cfg, 1e-3, device="cpu", optimizer=opt)
        params, adam = step.init(tm.sttode_init(2, cfg))
        assert type(adam) is (torch.optim.Adam if opt is None
                              else tguards.GuardedAdam)
        _, _, m = step(params, adam, batch, torch.Generator().manual_seed(0))
        outs.append((float(m["total"]), params))
    assert outs[0][0] == outs[1][0]
    for a, b in zip(bridge.tree_leaves(outs[0][1]),
                    bridge.tree_leaves(outs[1][1])):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-7)
    step = tloop.make_train_step(cfg, 1e-3, device="cpu", scan_steps=2,
                                 optimizer=tguards.guarded_adam(1e-3))
    params, adam = step.init(tm.sttode_init(2, cfg))
    _, _, m = step(params, adam, tloop.stack_batches([batch, batch]),
                   torch.Generator().manual_seed(0))
    assert m["total"].shape == (2,) and isinstance(adam,
                                                   tguards.GuardedAdam)


# --------------------------------------------------------------------------- #
# the supervisor                                                              #
# --------------------------------------------------------------------------- #

SEQUENCES = {
    # (losses, Supervisor kwargs): tests/test_supervisor.py's cases
    "healthy": ([1.0 - 0.1 * e for e in range(4)], dict(save_every=2)),
    "nan_rollback": ([1.0, float("nan"), 0.9, 0.8], dict(save_every=1)),
    "explosion": ([1.0, 1.0, 1.0, 100.0, 5.0, 2.0],
                  dict(save_every=1, explosion_factor=10.0)),
    "abort": ([float("inf")], dict()),
    "rollback_budget": ([1.0, float("nan"), float("nan"), 1.0],
                        dict(save_every=1, max_rollbacks=1)),
    "nonpositive_baseline": ([-2.0, -2.0, -2.0, 1e6, -1.5, 4.0, 17.0],
                             dict(save_every=1, explosion_factor=10.0)),
}


def _drive(sup, losses, params, opt):
    """Feed ``losses`` as the epochs' means the way the CLI does (a
    rollback continues at the restored epoch, an abort stops)."""
    trace, epoch, i = [], 0, 0
    while i < len(losses):
        params, opt, new_epoch, action = sup.after_epoch(
            epoch, losses[i], params, opt, log=lambda m: None)
        trace.append((epoch, action, new_epoch, sup.lr_scale))
        i += 1
        if action == "abort":
            break
        epoch = new_epoch if action == "rollback" else epoch + 1
    return trace


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_supervisor_decisions_match_jax(tmp_path, name):
    losses, kw = SEQUENCES[name]
    jparams = {"w": jnp.ones((4, 4))}
    jtrace = _drive(JSupervisor(str(tmp_path / "j"), JConfig(), **kw),
                    losses, jparams, optax.adam(1e-3).init(jparams))
    tparams = {"w": torch.ones(4, 4, requires_grad=True)}
    opt = torch.optim.Adam([tparams["w"]], lr=1e-3)
    tparams["w"].grad = torch.ones(4, 4)
    opt.step()
    sup = Supervisor(str(tmp_path / "t"), tm.STTODEConfig(), **kw)
    ttrace = _drive(sup, losses, tparams, opt)
    assert ttrace == jtrace
    jck = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path / "j")
                 if d.startswith("model_")) if (tmp_path / "j").exists() \
        else []
    assert tck.checkpoint_epochs(str(tmp_path / "t")) == jck
    for loss in (5.0, 100.0, 1e6, -1.5, float("nan")):
        jsup = JSupervisor(str(tmp_path / "jh"), JConfig(), **kw)
        tsup = Supervisor(str(tmp_path / "th"), tm.STTODEConfig(), **kw)
        jsup.history.extend(losses[:3])
        tsup.history.extend(losses[:3])
        assert tsup.healthy(loss) == jsup.healthy(loss)


def test_supervisor_rollback_restores_in_place(tmp_path):
    """A rollback writes the last-good checkpoint's parameters and Adam
    state into the same tensors (a captured step stays bound to them)."""
    torch.manual_seed(0)
    params = {"a": torch.randn(3, 4, requires_grad=True),
              "b": [torch.randn(5, requires_grad=True)]}
    leaves = bridge.tree_leaves(params)
    opt = torch.optim.Adam(leaves, lr=1e-2)

    def step():
        for t in leaves:
            t.grad = torch.randn_like(t)
        opt.step()

    step()
    sup = Supervisor(str(tmp_path), tm.STTODEConfig(), save_every=1)
    assert sup.after_epoch(0, 1.0, params, opt)[3] == "ok"
    good = [t.detach().clone() for t in leaves]
    good_state = {k: v.clone() for k, v in opt.state[leaves[0]].items()}
    ptrs = [t.data_ptr() for t in leaves] + \
        [v.data_ptr() for v in opt.state[leaves[0]].values()]
    step()
    step()
    with torch.no_grad():
        leaves[1][0] = float("nan")
    p, o, epoch, action = sup.after_epoch(1, float("nan"), params, opt)
    assert (action, epoch, sup.lr_scale) == ("rollback", 1, 0.5)
    assert p is params and o is opt
    assert [t.data_ptr() for t in leaves] + \
        [v.data_ptr() for v in opt.state[leaves[0]].values()] == ptrs
    for a, b in zip(leaves, good):
        torch.testing.assert_close(a.detach(), b, rtol=0, atol=0)
    for k, v in opt.state[leaves[0]].items():
        torch.testing.assert_close(v, good_state[k], rtol=0, atol=0)
    other = torch.optim.Adam([torch.zeros(2, requires_grad=True)])
    with pytest.raises(ValueError):
        sup.after_epoch(2, float("nan"), {"x": other.param_groups[0][
            "params"][0]}, other)


# --------------------------------------------------------------------------- #
# profiling                                                                   #
# --------------------------------------------------------------------------- #

def test_param_table_matches_jax():
    jp, tp = _full_params()
    printed = {"j": [], "t": []}
    want = jprof.param_table(jp, print_fn=printed["j"].append)
    got = tprof.param_table(tp, print_fn=printed["t"].append)
    assert got == want and printed["t"] == printed["j"]
    assert any(r["name"] == "past_encoder/ode_layers/0/self_attn/attn/"
               "in_proj_w" for r in got)
    assert printed["t"][-1].split()[-1] == f"{tprof.param_count(tp):,}"


def test_time_fn_and_trace(tmp_path):
    x = torch.randn(64, 64)
    res = tprof.time_fn(torch.matmul, x, x, iters=5)
    assert res["seconds_per_call"] > 0 and res["calls_per_s"] == \
        pytest.approx(1.0 / res["seconds_per_call"])
    with tprof.trace(str(tmp_path / "tr")) as prof:
        torch.matmul(x, x).sum()
    files = os.listdir(tmp_path / "tr")
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    assert os.path.join(str(tmp_path / "tr"), files[0]) == prof.trace_path
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    assert any("matmul" in e.get("name", "") for e in events)


# --------------------------------------------------------------------------- #
# the plotters                                                                #
# --------------------------------------------------------------------------- #

def _lines(fig):
    return [l.get_xydata().tolist() for ax in fig.axes for l in ax.lines]


def test_plotters_draw_what_jax_draws(tmp_path):
    import matplotlib.pyplot as plt
    rng = np.random.default_rng(4)
    obs, gt = rng.standard_normal((3, 8, 2)), rng.standard_normal((3, 12, 2))
    pred_k = rng.standard_normal((3, 4, 12, 2))
    past, fut = 10 * rng.random((11, 5, 2)), 10 * rng.random((11, 10, 2))
    assert tviz.SCENE_PRESETS == jviz.SCENE_PRESETS
    for ds in ("eth", "zara1", "nba"):
        assert tviz.scene_preset(ds) == jviz.scene_preset(ds)
    calls = [
        ("plot_scene", (obs, gt, gt + 0.1), dict(dataset="eth",
                                                 title="t")),
        ("plot_scene", (obs, gt), dict(flip_y=True)),
        ("plot_best_of_k", (obs, gt, pred_k), dict(title="k")),
        ("plot_nba_court", (past, fut, fut + 0.5), dict(title="c")),
    ]
    for i, (name, args, kw) in enumerate(calls):
        jfig = getattr(jviz, name)(*args, **kw)
        tfig = getattr(tviz, name)(*args, **kw)
        assert _lines(tfig) == _lines(jfig), name
        assert tfig.get_size_inches().tolist() == \
            jfig.get_size_inches().tolist()
        plt.close(jfig)
        plt.close(tfig)
        path = tmp_path / f"{i}.png"
        getattr(tviz, name)(*args, save_path=str(path), **kw)
        assert path.stat().st_size > 0


# --------------------------------------------------------------------------- #
# the CLIs                                                                    #
# --------------------------------------------------------------------------- #

def _args(root, dataset, *extra, ckpt="ck"):
    return ["--dataset", dataset, "--data_root", str(root / "data"),
            "--ckpt_dir", str(root / ckpt), "--hidden_dim", "16", "--zdim",
            "8", "--sample_k", "4", "--log_every", "0", "--seed", "1",
            *extra]


def test_cli_train_supervise_and_profile_dir(tmp_path, capsys):
    """``--supervise`` checkpoints on the supervisor's cadence (no regular
    save), ``--profile_dir`` traces epoch 0 only; ``cli.trainvae``
    inherits both; ``--distributed`` without a launcher's environment
    exits, as JAX's CLI does."""
    _nba_file(tmp_path / "data", n_train=40)
    args = _args(tmp_path, "nba", "--device", "cpu", "--supervise",
                 "--model_save_epoch", "2", "--batch_size", "16")
    run = cli_train.main(args + ["--num_epochs", "3", "--profile_dir",
                                 str(tmp_path / "prof")])
    out = capsys.readouterr().out
    assert out.count("profiler trace written to") == 1 and "saved" not in out
    assert [h[0] for h in run.history] == [0, 1, 2]
    assert tck.checkpoint_epochs(str(tmp_path / "ck" / "nba")) == [2]
    files = os.listdir(tmp_path / "prof")
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    with open(tmp_path / "prof" / files[0]) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert any("addmm" in n or "matmul" in n or "mm" == n.split("::")[-1]
               for n in names)
    vae = cli_trainvae.main(_args(tmp_path, "nba", "--device", "cpu",
                                  "--supervise", "--model_save_epoch", "1",
                                  "--batch_size", "16", "--num_epochs", "1",
                                  "--profile_dir", str(tmp_path / "prof2"),
                                  ckpt="ck_vae"))
    assert vae.cfg.loss_terms == ("pred", "recover", "kl")
    assert tck.checkpoint_epochs(str(tmp_path / "ck_vae" / "nba")) == [1]
    assert len(os.listdir(tmp_path / "prof2")) == 1
    with pytest.raises(SystemExit, match="--distributed"):
        cli_train.main(args + ["--distributed"])


def test_cli_train_supervise_rolls_back_a_diverged_epoch(tmp_path, capsys,
                                                         monkeypatch):
    """A NaN epoch mean is rolled back to the last-good checkpoint and run
    again at half the learning rate; the run then finishes."""
    _nba_file(tmp_path / "data", n_train=40)
    real = cli_train.train_epoch
    calls = {"n": 0}

    def flaky(*a, **kw):
        params, opt, means = real(*a, **kw)
        calls["n"] += 1
        if calls["n"] == 2:
            means = dict(means, total=float("nan"))
        return params, opt, means

    monkeypatch.setattr(cli_train, "train_epoch", flaky)
    run = cli_train.main(_args(tmp_path, "nba", "--device", "cpu",
                               "--supervise", "--model_save_epoch", "1",
                               "--batch_size", "16", "--num_epochs", "3",
                               "--lr", "1e-3", "--decay_step", "100"))
    assert "rolled back to epoch 1" in capsys.readouterr().out
    assert [(h[0], h[1]) for h in run.history] == [
        (0, 1e-3), (1, 1e-3), (1, 5e-4), (2, 5e-4)]
    assert tck.checkpoint_epochs(str(tmp_path / "ck" / "nba")) == [1, 2, 3]


@pytest.mark.parametrize("dataset", ["nba", "eth"])
def test_cli_test_save_plots_writes_what_jax_writes(tmp_path, dataset):
    """``cli.test --save_plots``: as many PNGs, under the same names, as
    the JAX CLI writes from its own checkpoints on the same files."""
    if dataset == "nba":
        _nba_file(tmp_path / "data", n_train=16, n_test=6)
        extra = ["--batch_size", "8"]
    else:
        for split, seed in (("train", 0), ("test", 1)):
            tsyn.write_eth_style_csvs(
                str(tmp_path / "data" / "eth" / split), n_files=1,
                frames_per_file=30, agents=4, seed=seed)
        extra = []
    train = ["--num_epochs", "1", "--model_save_epoch", "1"]
    plots = ["--save_plots", None, "--max_plots", "4", "--sweep", "1"]
    written = {}
    for name, tr, te, dev in (("j", jcli_train, jcli_test, []),
                              ("t", cli_train, cli_test,
                               ["--device", "cpu"])):
        args = _args(tmp_path, dataset, *extra, *dev, ckpt=f"ck_{name}")
        tr.main(args + train)
        plots[1] = str(tmp_path / f"plots_{name}")
        best = te.main(args + plots)
        assert np.isfinite(best["ade"]) and "params" not in best
        written[name] = sorted(os.listdir(plots[1]))
    assert written["t"] == written["j"] and len(written["t"]) == (
        4 if dataset == "nba" else min(4, len(written["j"])))
    assert all(n.endswith(".png") for n in written["t"])
