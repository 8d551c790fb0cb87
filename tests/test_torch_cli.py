"""The port's NBA training recipe on the CPU: data, schedule, checkpoints,
the training step at the recipe's shape against the JAX package, the CLIs
and evaluation.

The data helpers are numpy copies and must equal the JAX package's bit for
bit. The NBA-recipe step (B = 32 scenes × 11 agents, 5 / 10 steps,
reference compat, ``attn_impl="packed"``) is held to JAX's ``sttode_forward``
on the same route: JAX runs its packed Pallas kernel in interpret mode, the
port the packed kernel's plain version; JAX's random draws are injected as
``TrainNoise``. Tolerance 1e-4 abs/rel on every loss term and gradient leaf,
as for the other fp32 training tests (the Euler step multiplies the encoder
field by 12). The widths are narrow (hidden 16) so the suite stays fast.
"""

import os
import pickle
import signal

import jax
import numpy as np
import pytest
import torch

from sttode_tpu.data import nba as jnba
from sttode_tpu.data import preprocess as jprep
from sttode_tpu.models import sttode as jm
from sttode_tpu.train import schedulers as jsched
from sttode_tpu.utils import metrics as jmetrics
from sttode_tpu_torch import bridge
from sttode_tpu_torch.cli import common
from sttode_tpu_torch.cli import test as cli_test
from sttode_tpu_torch.cli import train as cli_train
from sttode_tpu_torch.data import nba as tnba
from sttode_tpu_torch.data import preprocess as tprep
from sttode_tpu_torch.data import synthetic as tsyn
from sttode_tpu_torch.evaluation import evaluate_nba
from sttode_tpu_torch.kernels import packed_mhgsa as tpacked
from sttode_tpu_torch.models import sttode as tm
from sttode_tpu_torch.train import checkpoint as tck
from sttode_tpu_torch.train import loop as tloop
from sttode_tpu_torch.train import schedulers as tsched
from sttode_tpu_torch.utils.profiling import param_count

# one intra-op thread: pytest-xdist runs 6 workers on 8 cores, and
# torch's default of one thread a core each oversubscribes them
torch.set_num_threads(1)

SMALL = dict(hidden_dim=16, num_heads=2, ff_dim=32, zdim=8, sample_k=4,
             past_length=5, future_length=10)
LOSSES = ("total_loss", "loss_pred", "loss_recover", "loss_kl",
          "loss_diverse")


def _nba_file(root, n_train=80, n_test=40, seed=0):
    """Synthetic NBA split in the dataset's format: [S, 15, 11, 2] feet."""
    rng = np.random.default_rng(seed)
    d = os.path.join(root, "nba")
    os.makedirs(d, exist_ok=True)
    for name, n in (("train.npy", n_train), ("test.npy", n_test)):
        start = rng.uniform([0.0, 0.0], [94.0, 50.0], size=(n, 1, 11, 2))
        steps = rng.normal(0.0, 1.0, size=(n, 15, 11, 2)).cumsum(axis=1)
        np.save(os.path.join(d, name), (start + steps).astype(np.float32))
    return d


def _cli_args(tmp_path, *extra):
    return ["--dataset", "nba", "--data_root", str(tmp_path / "data"),
            "--ckpt_dir", str(tmp_path / "ck"), "--device", "cpu",
            "--hidden_dim", "16", "--zdim", "8", "--sample_k", "4",
            "--log_every", "0", *extra]


# --------------------------------------------------------------------------- #
# data, schedule, checkpoints                                                 #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("training", [True, False])
def test_nba_data_matches_jax_bit_for_bit(tmp_path, training):
    d = _nba_file(tmp_path / "data", n_train=70, n_test=45)
    want = jnba.load_nba(d, training=training)
    got = tnba.load_nba(d, training=training)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    past, fut = got
    assert past.shape == (len(past), 11, 5, 2) and fut.shape[2] == 10
    jb = list(jnba.nba_batches(*want, 16, rng=np.random.default_rng(4)))
    tb = list(tnba.nba_batches(past, fut, 16, rng=np.random.default_rng(4)))
    assert len(tb) == len(jb) == len(past) // 16        # the last drops
    for a, b in zip(tb, jb):
        np.testing.assert_array_equal(a["past_traj"], b["past_traj"])
        np.testing.assert_array_equal(a["future_traj"], b["future_traj"])
        ja, ta = jprep.prepare_nba_batch(b), tprep.prepare_nba_batch(a)
        for f in ("past", "past_vel", "future", "future_vel", "valid"):
            np.testing.assert_array_equal(getattr(ta, f).numpy(),
                                          getattr(ja, f))
        assert (ta.batch_size, ta.agent_num) == (ja.batch_size, ja.agent_num)
    assert len(list(tnba.nba_batches(past, fut, 16, drop_last=False))) == \
        -(-len(past) // 16)


def test_step_lr_matches_jax_and_sets_every_group():
    want = jsched.step_lr(1e-4, 10, 0.5)
    got = tsched.step_lr(1e-4, 10, 0.5)
    for epoch in range(31):
        assert got(epoch) == want(epoch)
    opt = torch.optim.Adam([{"params": [torch.zeros(2, requires_grad=True)]},
                            {"params": [torch.zeros(3, requires_grad=True)]}],
                           lr=1.0)
    tsched.set_lr(opt, got(25))
    assert [g["lr"] for g in opt.param_groups] == [2.5e-5, 2.5e-5]


def test_checkpoint_round_trips_exactly(tmp_path):
    cfg = tm.STTODEConfig(**SMALL, attn_impl="packed",
                          loss_terms=("pred", "kl")).validate()
    step = tloop.make_train_step(cfg, 1e-3, device="cpu")
    params, opt = step.init(tm.sttode_init(0, cfg))
    for t in bridge.tree_leaves(params):       # a real Adam state
        t.grad = torch.randn_like(t)
    opt.step()
    path = tck.save_checkpoint(str(tmp_path), 3, params, opt, cfg)
    assert path.endswith("model_0003.pt")
    open(os.path.join(tmp_path, "model_0009.pt.tmp.1"), "w").close()
    p2, state, epoch, cfg2 = tck.load_checkpoint(path)
    assert epoch == 3 and cfg2 == cfg
    assert bridge.tree_map(lambda t: 0, p2) == bridge.tree_map(lambda t: 0,
                                                               params)
    for a, b in zip(bridge.tree_leaves(p2), bridge.tree_leaves(params)):
        assert torch.equal(a, b.detach())
    _, opt2 = step.init(p2)
    opt2.load_state_dict(state)
    s1, s2 = opt.state_dict(), opt2.state_dict()
    assert s1["param_groups"] == s2["param_groups"]
    for i, st in s1["state"].items():
        for key, val in st.items():
            assert torch.equal(val, s2["state"][i][key]), (i, key)
    for e in (5, 7):
        tck.save_checkpoint(str(tmp_path), e, params, opt, cfg)
    assert tck.checkpoint_epochs(str(tmp_path)) == [3, 5, 7]
    assert tck.latest_checkpoint(str(tmp_path)).endswith("model_0007.pt")
    tck.save_checkpoint(str(tmp_path), 8, params, opt, cfg, keep_last=2)
    assert tck.checkpoint_epochs(str(tmp_path)) == [7, 8]
    assert tck.latest_checkpoint(str(tmp_path / "none")) is None


def test_param_count_matches_jax():
    params = tm.sttode_init(0, tm.STTODEConfig(**SMALL))
    assert param_count(params) == sum(
        int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(
            jm.sttode_init(jax.random.PRNGKey(0), jm.STTODEConfig(**SMALL))))


# --------------------------------------------------------------------------- #
# the NBA-recipe step against JAX                                            #
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


def test_nba_recipe_step_on_the_packed_route_matches_jax(tmp_path,
                                                         monkeypatch):
    d = _nba_file(tmp_path, n_train=32, n_test=1)
    past, fut = tnba.load_nba(d)
    (data,) = tnba.nba_batches(past, fut, 32)
    jcfg = jm.STTODEConfig(attn_impl="packed", min_clip=0.0,
                           **SMALL).validate()
    tcfg = tm.STTODEConfig(**jcfg._asdict()).validate()
    jparams = jm.sttode_init(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.tree_map(
        lambda t: t.requires_grad_(),
        bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams)))
    jb, tb = jprep.prepare_nba_batch(data), tprep.prepare_nba_batch(data)
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
    before = (tpacked.packed_geodesic_attention.launches,
              tpacked.packed_geodesic_attention_backward.launches)
    out = tm.sttode_forward(tparams, tcfg, tb,
                            noise=_jax_noise(jcfg, rng, 32 * 11))
    out.total_loss.backward()
    # both trunks ran the packed formula on [11 agents, 2 heads, 32, 8]
    assert calls == [(11, 2, 32, 8)] * 2
    assert (tpacked.packed_geodesic_attention.launches,
            tpacked.packed_geodesic_attention_backward.launches) == before
    for name in LOSSES:
        np.testing.assert_allclose(float(getattr(out, name).detach()),
                                   float(getattr(jout, name)), rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    want = [np.asarray(g) for g in jax.tree_util.tree_leaves(jgrads)]
    got = [t.grad.numpy() for t in bridge.tree_leaves(tparams)]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4,
                                   err_msg=f"gradient leaf {i}")


# --------------------------------------------------------------------------- #
# the CLIs and evaluation                                                    #
# --------------------------------------------------------------------------- #

def test_cli_train_trains_saves_and_resumes(tmp_path, capsys):
    _nba_file(tmp_path / "data", n_train=70)
    args = _cli_args(tmp_path, "--model_save_epoch", "1", "--decay_step",
                     "1", "--lr", "1e-3")
    run = cli_train.main(args + ["--num_epochs", "2"])
    out = capsys.readouterr().out
    assert "model parameters:" in out and "saved" in out
    assert run.start_epoch == 0 and [h[:2] for h in run.history] == \
        [(0, 1e-3), (1, 5e-4)]
    assert all(np.isfinite(list(h[2].values())).all() for h in run.history)
    cdir = tmp_path / "ck" / "nba"
    assert tck.checkpoint_epochs(str(cdir)) == [1, 2]
    steps = 70 // 32
    p1, state1, epoch1, cfg1 = tck.load_checkpoint(
        tck.checkpoint_path(str(cdir), 1))
    assert epoch1 == 1 and cfg1 == run.cfg
    assert all(int(s["step"]) == steps for s in state1["state"].values())

    # resume from epoch 1 for one more epoch: the saved epoch, the schedule's
    # learning rate for it, and the Adam moments continue
    resumed = cli_train.main(args + ["--num_epochs", "2",
                                     "--epoch_continue", "1"])
    assert "resumed epoch 1" in capsys.readouterr().out
    assert resumed.start_epoch == 1
    assert [h[:2] for h in resumed.history] == [(1, 5e-4)]
    assert all(int(s["step"]) == 2 * steps
               for s in resumed.opt.state_dict()["state"].values())
    assert all(g["lr"] == 5e-4 for g in resumed.opt.param_groups)
    # --scan_steps is ported (tests/test_torch_scan.py): a stacked call of
    # the epoch's two steps continues the resumed run
    scanned = cli_train.main(args + ["--num_epochs", "3", "--epoch_continue",
                                     "2", "--scan_steps", "4"])
    assert [h[:2] for h in scanned.history] == [(2, 2.5e-4)]
    assert all(int(s["step"]) == 3 * steps
               for s in scanned.opt.state_dict()["state"].values())
    # --supervise is ported (tests/test_torch_train_options.py): the
    # supervisor continues the resumed run and writes its checkpoint
    supervised = cli_train.main(args + ["--num_epochs", "4",
                                        "--epoch_continue", "3",
                                        "--supervise"])
    assert [h[:2] for h in supervised.history] == [(3, 1.25e-4)]
    assert tck.checkpoint_epochs(str(cdir)) == [1, 2, 3, 4]
    # --distributed is ported (tests/test_torch_parallel.py): without a
    # launcher's environment it exits, as JAX's CLI does; the CLI's step has
    # no mesh, as JAX's has none, so the ring and ulysses ask for one
    with pytest.raises(SystemExit, match="--distributed"):
        cli_train.main(args + ["--distributed"])
    with pytest.raises(ValueError, match="needs a mesh"):
        cli_train.main(args + ["--attn_impl", "ring"])
    with pytest.raises(ValueError, match="'ulysses' needs a mesh"):
        cli_train.main(args + ["--attn_impl", "ulysses"])


def test_cli_train_checkpoints_and_stops_on_sigterm(tmp_path, monkeypatch,
                                                     capsys):
    _nba_file(tmp_path / "data", n_train=40)
    real = cli_train.train_epoch

    def epoch_then_term(*a, **kw):
        os.kill(os.getpid(), signal.SIGTERM)
        return real(*a, **kw)

    monkeypatch.setattr(cli_train, "train_epoch", epoch_then_term)
    prev = signal.getsignal(signal.SIGTERM)
    run = cli_train.main(_cli_args(tmp_path, "--num_epochs", "5"))
    assert signal.getsignal(signal.SIGTERM) is prev
    assert len(run.history) == 1
    assert "resume with --epoch_continue 1" in capsys.readouterr().out
    assert tck.checkpoint_epochs(str(tmp_path / "ck" / "nba")) == [1]


def test_cli_test_prints_a_finite_table(tmp_path, capsys):
    _nba_file(tmp_path / "data", n_train=40, n_test=40)
    cli_train.main(_cli_args(tmp_path, "--num_epochs", "2",
                             "--model_save_epoch", "1"))
    capsys.readouterr()
    best = cli_test.main(_cli_args(tmp_path, "--batch_size", "16"))
    out = capsys.readouterr().out
    assert "epoch 1: ADE@1.0s" in out and "epoch 2:" in out and "best" in out
    assert best["epoch"] in (1, 2) and best["table"]["scenes"] == 32
    for part in ("ade", "fde"):
        assert set(best["table"][part]) == {"1.0s", "2.0s", "3.0s", "4.0s"}
        assert np.isfinite(list(best["table"][part].values())).all()
    # --save_plots is ported (tests/test_torch_train_options.py)
    cli_test.main(_cli_args(tmp_path, "--batch_size", "16", "--save_plots",
                            str(tmp_path / "plots"), "--max_plots", "2"))
    assert sorted(os.listdir(tmp_path / "plots")) == [
        "court_0000.png", "court_0001.png"]
    with pytest.raises(SystemExit):
        cli_test.main(_cli_args(tmp_path, "--ckpt_dir",
                                str(tmp_path / "empty")))


def test_evaluate_nba_device_reduction_equals_host_oracle(tmp_path):
    past, fut = tnba.load_nba(_nba_file(tmp_path, n_test=40),
                              training=False)
    cfg = tm.STTODEConfig(**SMALL).validate()
    params = tm.sttode_init(5, cfg)

    def run(device_reduce):
        return evaluate_nba(params, cfg, tnba.nba_batches(past, fut, 16),
                            torch.Generator().manual_seed(9), sample_k=4,
                            traj_scale=2.0, device_reduce=device_reduce)

    dev, host = run(True), run(False)
    assert dev["scenes"] == host["scenes"] == 32
    for part in ("ade", "fde"):
        for h in dev[part]:
            np.testing.assert_allclose(dev[part][h], host[part][h],
                                       rtol=1e-6, err_msg=(part, h))
    with pytest.raises(ValueError, match="NBA protocol"):
        evaluate_nba(params, cfg._replace(future_length=12), [])
    # the 4 s row is the agents' best-of-K ADE / FDE over the whole horizon
    (data,) = tnba.nba_batches(past[:4], fut[:4], 4)
    batch = tprep.prepare_nba_batch(data)
    preds = tm.sttode_inference(params, cfg, batch, sample_k=4,
                                generator=torch.Generator().manual_seed(0))
    pred_nk = np.transpose(preds.numpy(), (1, 0, 2, 3))
    table = evaluate_nba(params, cfg, [data], torch.Generator().manual_seed(
        0), sample_k=4)
    assert table["scenes"] == 4
    for part, metric in (("ade", jmetrics.compute_ade),
                         ("fde", jmetrics.compute_fde)):
        np.testing.assert_allclose(table[part]["4.0s"], metric(
            pred_nk, batch.future.numpy()), rtol=1e-6)


def test_cli_refuses_what_is_not_ported(tmp_path):
    _nba_file(tmp_path / "data")
    # ETH-UCY, SDD and --scenes_per_batch > 1 are ported: they load and run
    # (the recipes themselves: tests/test_torch_eth.py)
    eth = tmp_path / "data" / "eth"
    tsyn.write_eth_style_csvs(str(eth / "train"), n_files=1,
                              frames_per_file=24, agents=3)
    args = common.base_parser("x").parse_args(
        ["--dataset", "eth", "--data_root", str(tmp_path / "data")])
    assert len(common.load_scenes(args, "train")) == 5
    sdd = tmp_path / "data" / "sdd" / "test"
    sdd.mkdir(parents=True)
    with open(sdd / "s.pkl", "wb") as f:
        pickle.dump([np.ones((3, 2, 20), np.float32)], f)
    args = common.base_parser("x").parse_args(
        ["--dataset", "sdd", "--data_root", str(tmp_path / "data")])
    (scene,) = common.load_scenes(args, "test")
    assert scene["obs"].shape == (3, 8, 2) and scene["pred"].shape == \
        (3, 12, 2)
    run = cli_train.main(_cli_args(
        tmp_path, "--dataset", "eth", "--compat", "tpu", "--attn_axis",
        "agent", "--scenes_per_batch", "2", "--num_epochs", "1"))
    assert len(run.history) == 1
    # --async_ckpt is ported: the background save is in place when the run
    # returns (tests/test_torch_scan.py)
    run = cli_train.main(_cli_args(tmp_path, "--async_ckpt", "--num_epochs",
                                   "1", "--model_save_epoch", "1"))
    assert tck.checkpoint_epochs(str(tmp_path / "ck" / "nba")) == [1]
    # learn_prior and dopri5 are ported (test_torch_ode_model.py); training
    # through dopri5's while form has no gradient, as in JAX, and the error
    # names the two forms that have one
    with pytest.raises(ValueError, match="ode_scan_budget.*ode_adjoint"):
        cli_train.main(_cli_args(tmp_path, "--ode_method", "dopri5"))
    # poincaré trains (test_torch_poincare.py); a curvature ≤ 0 is refused
    with pytest.raises(ValueError, match="curvature"):
        cli_train.main(_cli_args(tmp_path, "--attn_metric", "poincare",
                                 "--curvature", "0"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli_train.main(["--dataset", "nba", "--data_root",
                            str(tmp_path / "data")])
    a = common.base_parser("x").parse_args(["--dataset", "nba"])
    assert common.horizons_for("nba") == (5, 10)
    assert common.horizons_for("eth") == (8, 12)
    cfg = common.model_config(a)
    assert (cfg.past_length, cfg.future_length, cfg.compat, cfg.attn_axis,
            cfg.select_impl, a.batch_size, a.device) == \
        (5, 10, "reference", "scene", "xla", 0, "cuda")
