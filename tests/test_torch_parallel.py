"""The port's parallel layer against the JAX package, on the CPU, in
several gloo processes.

Each group of ranks (2, 4, and 2 × 2 data × sequence) is a set of child
processes (``tests/torch_parallel_child.py``, no JAX; one torch thread,
a file rendezvous under the test's temporary directory, a 60 s
collective timeout) that run the cases of a spec file and write their
results; the parent starts every group at once, computes the JAX side
meanwhile on conftest's 8-device CPU mesh, and joins the children within
``JOIN_S`` seconds, killing them after. The inputs are made from seeds
with numpy and JAX's own draws (as ``tests/test_torch_train.py`` makes
them) and handed to the port through ``bridge``.

What is held, and to what:
- ``ring_geodesic_attention`` and ``ulysses_geodesic_attention`` on each
  rank's blocks, assembled, against JAX's on the same mesh shape and
  JAX's ``dense_reference``, both metrics, with a key validity: forward
  within 2e-5, gradients of sum(out²) within 5e-5 × max(1, max |g|);
  ulysses with heads that do not divide raises ValueError;
- ``sttode_forward(mesh=)`` (every loss term, alike on every rank, and
  every gradient leaf summed over the ranks) against JAX's unsharded
  forward within 1e-4 abs/rel: the scene axis at reference compat on the
  routes "auto" (the gathered keys and values, q and v under quirk Q3),
  "packed" (the gathered call on the packed kernel's plain version) and
  "ring", the agent axis at compat "tpu" on "auto" and "ring" (each
  scene's agents split over the ranks); "ulysses" on the scene axis and
  on the agent axis (2 × 8), against JAX's dense forward as JAX's own
  Ulysses tests hold it, and with padded agents whose inputs move no real
  agent's feature (``tests/test_ulysses.py``); a padded batch whose ranks hold
  different counts of real agents, with the KL floor between the global
  mean and rank 0's, so that a per-rank normalizer or clamp differs;
- ``make_train_step(mesh=)`` for 2 steps against JAX's
  ``make_train_step(mesh=make_mesh(dp=8), params_like=)`` (plain SGD on
  both sides, so the parameters compare within 1e-5 after the steps;
  Adam is held to optax in ``test_torch_train.py``): the metrics within
  1e-4, the parameters equal bit for bit on every rank though the ranks
  but 0 start from other values;
- the mesh step with a generator against the single-process step with a
  generator of the same seed (default Adam): the noise is global, so the
  metrics agree within 1e-5;
- ``sttode_inference(mesh=)`` against JAX's ``sttode_inference``;
- ``make_sampler_train_step(mesh=)`` for 2 steps against JAX's on the
  8-device mesh (SGD; ε JAX's own [M, nz] draws, not shared): metrics
  within 1e-5, parameters within 1e-4, on a padded batch whose ranks hold
  different counts of real agents and whose KL floor lies between the
  global mean and rank 0's; the stage-2 mesh step with a generator
  against the single-process step;
- ``scan_steps=2`` under a mesh, both stages, against JAX's scanned mesh
  steps (``tests/test_train.py``'s ``test_dp_scanned_matches_single_device``
  setup; SGD): metrics and parameters within 1e-5, the step "eager" on
  the CPU;
- dopri5 under a mesh at rtol / atol 1e-3 / 1e-6 in its three forms: the
  while form (the stage-2 step's frozen encoder), the scan budget (12)
  and the adjoint (stage-1 steps), each against JAX's mesh step: losses
  within 1e-4, parameters within 1e-4 (the adjoint's summed gradient
  within 1e-4 × max(1, max |g|) of JAX's), equal bit for bit on every
  rank; every solve's attempted and accepted steps and RHS evaluations
  equal on every rank and to the single process, the forward solves' to
  JAX's (recorded from an un-jitted forward);
- ``restore_shardings``: a checkpoint saved at world 2 restored at worlds
  1 and 4 (every rank but 0 reading a copy with other values): the
  parameters and Adam moments equal the saved ones bit for bit on every
  rank, and the next step's metrics equal the saving run's within 1e-5
  (JAX's ``test_save_dp8_restore_dp4``); also onto the 2 × 2 mesh;
- on ``make_mesh(dp=2, sp=2)`` (the 2 × 2 group) against JAX's
  ``make_train_step(mesh=make_mesh(dp=2, sp=2))`` (SGD, 2 steps): the
  stage-1 step on "ring" and "auto" (scene axis, 4 × 3), "ulysses" (scene
  axis, 4 × 4) and "ring" and "ulysses" on the agent axis (2 × 8), the
  stage-2 step and ``scan_steps=2`` on "ulysses": metrics within 1e-4,
  parameters within 1e-5, equal bit for bit on the 4 ranks; ulysses on
  the scene axis with 3 agents over data = 2 raises ValueError, as JAX's
  ``shard_map`` refuses it;
- ``make_mesh``'s shapes and errors, the lifted refusals (the scanned, the
  stage-2 and the dopri5 steps build on a mesh, so does a step on a "seq"
  axis, and ulysses validates) and every refusal left: tensor
  parallelism (``restore_shardings(tp=True)`` too), the ring and ulysses
  with dropout, ulysses without a mesh, with an additive mask or without
  a head axis;
- ``cli.train --distributed`` at world 2 (torchrun's environment, a free
  local port) and without the environment.
"""

import concurrent.futures
import contextlib
import dataclasses
import functools
import os
import socket
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import optax
import pytest
import torch

from sttode_tpu.data import preprocess as jprep
from sttode_tpu.data import synthetic as jsyn
from sttode_tpu.models import sampler as js
from sttode_tpu.models import sttode as jm
from sttode_tpu.nn import ode_block as jode_block
from sttode_tpu.parallel import make_mesh as jmake_mesh
from sttode_tpu.parallel import param_sharding as jparam_sharding
from sttode_tpu.parallel import shard_batch as jshard_batch
from sttode_tpu.parallel.ring_attention import dense_reference as jdense
from sttode_tpu.parallel.ring_attention import \
    ring_geodesic_attention as jring
from sttode_tpu.parallel.ulysses import \
    ulysses_geodesic_attention as julysses
from sttode_tpu.train import make_sampler_train_step as jmake_sampler_step
from sttode_tpu.train import make_train_step as jmake_train_step
from sttode_tpu.train import stack_batches as jstack_batches
from sttode_tpu_torch import bridge
from sttode_tpu_torch.cli import train as cli_train
from sttode_tpu_torch.data import preprocess as tprep
from sttode_tpu_torch.models import sttode as tm

# one intra-op thread: pytest-xdist runs 6 workers on 8 cores, and
# torch's default of one thread a core each oversubscribes them
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(ROOT, "tests", "torch_parallel_child.py")
JOIN_S = 240.0
TOL = dict(rtol=1e-4, atol=1e-4)
SMALL = dict(hidden_dim=16, num_heads=2, ff_dim=32, zdim=8, sample_k=4,
             past_length=5, future_length=10, select_impl="xla")
B, N = 4, 4
LOSSES = ("total_loss", "loss_pred", "loss_recover", "loss_kl",
          "loss_diverse")
MODEL_CASES = {
    # name: (config, port route)
    "scene_auto": (dict(min_clip=0.0), "auto"),
    "scene_packed": (dict(min_clip=0.0), "packed"),
    "scene_ring": (dict(min_clip=0.0), "ring"),
    "agent_auto": (dict(compat="tpu", attn_axis="agent", min_clip=0.0),
                   "auto"),
    "agent_ring": (dict(compat="tpu", attn_axis="agent", min_clip=0.0),
                   "ring"),
    # ulysses: four heads (they divide over 4 ranks); the agent axis on
    # JAX's test shape, 2 scenes × 8 agents
    "scene_ulysses": (dict(min_clip=0.0, num_heads=4), "ulysses"),
    "agent_ulysses": (dict(compat="tpu", attn_axis="agent", min_clip=0.0,
                           num_heads=4), "ulysses", (2, 8)),
}
WORLD4 = ("scene_auto", "scene_ring", "agent_ring", "scene_ulysses")
RING = dict(B=2, L=8, S=16, D=8)
ULYSSES = dict(B=2, H=4, L=8, S=16, D=8)
# the steps on the 2 × 2 mesh: (config, route, scenes × agents)
AGENT = dict(compat="tpu", attn_axis="agent", min_clip=0.0)
DPSP_STEPS = {
    "scene_ring": (dict(min_clip=0.0), "ring", (4, 3)),
    "scene_auto": (dict(min_clip=0.0), "auto", (4, 3)),
    "scene_ulysses": (dict(min_clip=0.0), "ulysses", (4, 4)),
    "agent_ring": (AGENT, "ring", (2, 8)),
    "agent_ulysses": (AGENT, "ulysses", (2, 8)),
}
SCFG = dict(nk=4, nz=SMALL["zdim"], qnet_mlp=(32, 16), train_w_mean=False,
            share_eps=False)
ODE = dict(ode_method="dopri5", ode_rtol=1e-3, ode_atol=1e-6, min_clip=0.0)
ODE_CASES = {
    # form: (the step, config); the while form cannot be differentiated
    # through: the stage-2 step runs it in its frozen encoder
    "while": ("sampler_step", ODE),
    "scan_budget": ("step", dict(ODE, ode_scan_budget=12)),
    "adjoint": ("step", dict(ODE, ode_adjoint=True)),
}
SOLVE_KEYS = ("attempted_steps", "accepted_steps", "rhs_evals")


def _jcfg(**kw):
    return jm.STTODEConfig(attn_impl="dense", **{**SMALL, **kw}).validate()


def _tcfg(jcfg, route):
    return tm.STTODEConfig(**jcfg._replace(attn_impl=route)._asdict()) \
        .validate()._asdict()


def _batches(cfg, seed, valid=None, training=True, shape=(B, N)):
    B, N = shape
    scenes = jsyn.make_social_scenes(B, agents_range=(N, N),
                                     obs_len=cfg.past_length,
                                     pred_len=cfg.future_length, seed=seed)
    obs = np.stack([s["obs"] for s in scenes])
    pred = np.stack([s["pred"] for s in scenes])
    valid = np.ones((B, N), np.float32) if valid is None else valid
    kw = dict(training=training, rng=np.random.default_rng(seed))
    jb, _ = jprep.prepare_scene_group(obs, pred, valid, **kw)
    kw = dict(training=training, rng=np.random.default_rng(seed))
    tb, _ = tprep.prepare_scene_group(obs, pred, valid, **kw)
    return jb, tb


def _jax_noise(cfg, rng, shape=(B, N)) -> tm.TrainNoise:
    """JAX's draws inside sttode_forward(rng), as test_torch_train
    recomputes them: the PE keep-masks and the latent noise."""
    M, D = shape[0] * shape[1], cfg.hidden_dim
    k_enc, k_fenc, k_q, k_p = jax.random.split(rng, 4)

    def keep(key, T):
        k_pe, _ = jax.random.split(key)
        return np.asarray(jax.random.bernoulli(k_pe, 1.0 - cfg.pe_dropout,
                                               (M, T, D)))

    return tm.TrainNoise(*(torch.from_numpy(np.array(a)) for a in (
        keep(k_enc, cfg.past_length), keep(k_fenc, cfg.future_length),
        jax.random.normal(k_q, (M, cfg.zdim)),
        jax.random.normal(k_p, (M * cfg.sample_k, cfg.zdim)))))


def _params(jcfg, seed):
    jp = jm.sttode_init(jax.random.PRNGKey(seed), jcfg)
    return jp, bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jp))


def _jax_value_and_grad(jcfg, jparams, jb, rng):
    def loss(p):
        out = jm.sttode_forward(p, jcfg, jb, rng, train=True)
        return out.total_loss, out

    with jax.default_matmul_precision("highest"):
        (_, out), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            jparams)
    return out, [np.asarray(x) for x in jax.tree_util.tree_leaves(g)]


def _ring_inputs(seed, shape=RING):
    r = np.random.default_rng(seed)
    heads = (shape["H"],) if "H" in shape else ()
    q, k, v = (0.5 * r.standard_normal((shape["B"], *heads, n, shape["D"]))
               .astype(np.float32) for n in (shape["L"], shape["S"],
                                             shape["S"]))
    val = np.ones((shape["B"], shape["S"]), np.float32)
    val[:, -5:] = 0.0
    val[1, :3] = 0.0
    return q, k, v, val


def _model_cases(names, rng_seed=7):
    """The port's spec and JAX's result of each model case."""
    spec, want = {}, {}
    cache = {}
    for name in names:
        kw, route, *shape = MODEL_CASES[name]
        shape = tuple(shape[0]) if shape else (B, N)
        jcfg = _jcfg(**kw)
        key = (tuple(sorted(kw.items())), shape)
        if key not in cache:
            jp, tp = _params(jcfg, 0)
            jb, tb = _batches(jcfg, 1, shape=shape)
            rng = jax.random.PRNGKey(rng_seed)
            cache[key] = (jp, tp, jb, tb, rng, _jax_noise(jcfg, rng, shape))
        jp, tp, jb, tb, rng, noise = cache[key]
        spec[name] = dict(kind="forward", cfg=_tcfg(jcfg, route), params=tp,
                          batch=tb, noise=noise)
        want[name] = (jcfg, jp, jb, rng)
    return spec, want


def _sampler_params(seed):
    jscfg = js.SamplerConfig(**SCFG)
    jsp = js.sampler_init(jax.random.PRNGKey(seed), jscfg,
                          pred_model_dim=SMALL["hidden_dim"],
                          past_feature_dim=2 * SMALL["hidden_dim"])
    return jscfg, jsp, bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jsp))


def _jax_eps(key):
    """JAX's ε inside sampler_forward(key): normal(split(key, 3)[1],
    [M, nz]) (share_eps off)."""
    return torch.from_numpy(np.array(jax.random.normal(
        jax.random.split(key, 3)[1], (B * N, SCFG["nz"]))))


@contextlib.contextmanager
def _jax_solve_log():
    """Inside, JAX's ``ode_encoder`` solves of an un-jitted call on this
    thread record their (attempted steps, accepted steps, RHS
    evaluations); the adjoint's forward solve is odeint's."""
    record = []
    saved = jode_block.odeint, jode_block.odeint_adjoint
    me = threading.get_ident()

    def recorder(own):
        def solve(*args, **kw):
            if threading.get_ident() != me:      # another thread's trace
                return own(*args, **kw)
            ys, st = saved[0](*args, return_stats=True, **kw)
            record.append(tuple(int(st[k]) for k in SOLVE_KEYS))
            return ys
        return solve

    jode_block.odeint, jode_block.odeint_adjoint = map(recorder, saved)
    try:
        yield record
    finally:
        jode_block.odeint, jode_block.odeint_adjoint = saved


def _jax_mesh_steps(make, params, batches, keys, *args):
    """JAX's mesh step (SGD(1e-2)) over ``batches`` (sharded on the
    8-device mesh) → (metrics a call, the final parameters' leaves)."""
    step, mesh, stacked = make
    state = optax.sgd(1e-2).init(params)
    metrics = []
    with jax.default_matmul_precision("highest"):
        for jb_, key in zip(batches, keys):
            params, state, m = step(params, *args, state, jshard_batch(
                jb_, mesh, stacked=stacked), key)
            metrics.append({k_: np.asarray(x).tolist() for k_, x in m.items()})
    return metrics, [np.asarray(x) for x in jax.tree_util.tree_leaves(params)]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _nba_files(root, n_train=32, seed=20):
    """Synthetic NBA files ([S, 15, 11, 2] random walks)."""
    d = os.path.join(root, "data", "nba")
    os.makedirs(d)
    r = np.random.default_rng(seed)
    for fname, n in (("train.npy", n_train), ("test.npy", 16)):
        start = r.uniform([0.0, 0.0], [94.0, 50.0], size=(n, 1, 11, 2))
        walk = r.normal(0.0, 1.0, size=(n, 15, 11, 2)).cumsum(1)
        np.save(os.path.join(d, fname), (start + walk).astype(np.float32))
    return os.path.join(root, "data")


CLI_FLAGS = ["--dataset", "nba", "--device", "cpu", "--hidden_dim", "16",
             "--zdim", "8", "--sample_k", "4", "--batch_size", "16",
             "--num_epochs", "1", "--model_save_epoch", "5",
             "--log_every", "0"]


class _Group:
    """A set of ranks running one spec file."""

    def __init__(self, tmp, name, world, cases):
        self.out = os.path.join(tmp, f"{name}.out.pt")
        spec = os.path.join(tmp, f"{name}.spec.pt")
        torch.save({"rendezvous": os.path.join(tmp, f"{name}.rdv"),
                    "out": self.out, "cases": cases}, spec)
        env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
        self.logs = [os.path.join(tmp, f"{name}.{r}.log")
                     for r in range(world)]
        self.procs = [subprocess.Popen(
            [sys.executable, CHILD, spec, str(r), str(world)],
            stdout=open(log, "w"), stderr=subprocess.STDOUT, env=env)
            for r, log in enumerate(self.logs)]

    def join(self, deadline):
        try:
            for p in self.procs:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        tails = "\n".join(open(log).read()[-3000:] for log in self.logs)
        assert all(p.returncode == 0 for p in self.procs), tails
        return torch.load(self.out, weights_only=False), tails


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("parallel"))
    # ---- the specs (numpy inputs, JAX's weights and draws) --------------
    q, k, v, val = _ring_inputs(3)
    ring = {f"ring_{metric}": dict(
        kind="ring", q=torch.from_numpy(q), k=torch.from_numpy(k),
        v=torch.from_numpy(v), val=torch.from_numpy(val), metric=metric,
        curvature=1.0) for metric in ("oblique", "poincare")}
    uq, uk, uv, uval = _ring_inputs(4, ULYSSES)
    uly = {f"ulysses_{metric}": dict(
        kind="ring", route="ulysses", q=torch.from_numpy(uq),
        k=torch.from_numpy(uk), v=torch.from_numpy(uv),
        val=torch.from_numpy(uval), metric=metric, curvature=1.0)
        for metric in ("oblique", "poincare")}
    model2, want_model = _model_cases(MODEL_CASES)
    # ulysses on the agent axis with two padded agents (JAX's test): the
    # forward against JAX's, and the padded agents' inputs moved
    jcfg_u = _jcfg(**MODEL_CASES["agent_ulysses"][0])
    valid_u = np.ones((2, 8), np.float32)
    valid_u[:, 7] = 0.0
    jp_u, tp_u = _params(jcfg_u, 0)
    jb_u, tb_u = _batches(jcfg_u, 6, valid=valid_u, shape=(2, 8))
    rng_u = jax.random.PRNGKey(8)
    noise_u = _jax_noise(jcfg_u, rng_u, (2, 8))
    moved = tb_u.past.clone()
    moved[7] += 100.0
    moved[15] -= 50.0
    model2["agent_ulysses_padded"] = dict(
        kind="forward", cfg=_tcfg(jcfg_u, "ulysses"), params=tp_u,
        batch=tb_u, noise=noise_u, single=True)
    validity_case = dict(kind="validity", cfg=_tcfg(jcfg_u, "ulysses"),
                         params=tp_u, batch=tb_u, noise=noise_u,
                         moved=dataclasses.replace(tb_u, past=moved))
    # the padded batch: rank 0 of 2 holds 8 real agents, rank 1 holds 3
    valid = np.ones((B, N), np.float32)
    valid[2, 1:] = 0.0
    valid[3, 2:] = 0.0
    jcfg0 = _jcfg(min_clip=0.0)
    jp, tp = _params(jcfg0, 0)
    jb_pad, tb_pad = _batches(jcfg0, 5, valid=valid)
    rng_pad = jax.random.PRNGKey(9)
    jout0, _ = _jax_value_and_grad(jcfg0, jp, jb_pad, rng_pad)
    kl_agent = np.asarray(jax.numpy.sum(jout0.qz.kl(jout0.pz), axis=-1))
    v_flat = valid.reshape(-1)
    mean0 = float((kl_agent * v_flat)[:8].sum() / v_flat[:8].sum())
    mean_all = float((kl_agent * v_flat).sum() / v_flat.sum())
    floor = 0.5 * (mean0 + mean_all)
    jcfg_kl = _jcfg(min_clip=floor)
    model2["kl_floor"] = dict(kind="forward", cfg=_tcfg(jcfg_kl, "auto"),
                              params=tp, batch=tb_pad,
                              noise=_jax_noise(jcfg_kl, rng_pad))
    # two steps of SGD (the JAX side below), and the generator step
    jcfg_s = _jcfg(min_clip=0.0)
    step_batches = [_batches(jcfg_s, s) for s in (11, 12)]
    step_keys = [jax.random.PRNGKey(s) for s in (21, 22)]
    step_case = dict(kind="step", cfg=_tcfg(jcfg_s, "auto"), params=tp,
                     lr=1e-2, optimizer="sgd",
                     batches=[tb for _, tb in step_batches],
                     noises=[_jax_noise(jcfg_s, k_) for k_ in step_keys])
    gen_case = dict(kind="generator_step", cfg=_tcfg(jcfg_s, "auto"),
                    params=tp, lr=1e-3, seed=5,
                    batches=[tb for _, tb in step_batches])
    # inference: JAX's z, recomputed from its key split
    jb_inf, tb_inf = _batches(jcfg0, 13, training=False)
    rng_inf = jax.random.PRNGKey(42)
    z = np.array(jax.random.normal(jax.random.split(rng_inf)[1],
                                   (B * N * jcfg0.sample_k, jcfg0.zdim)))
    odd = _batches(jcfg0, 14)[1]
    odd = dataclasses.replace(odd, batch_size=3, **{
        f: getattr(odd, f)[:3 * N] for f in ("past", "past_vel", "future",
                                             "future_vel", "valid")})
    refusals = dict(kind="refusals", cfg=_tcfg(jcfg0, "auto"), params=tp,
                    batch=tb_pad, odd_batch=odd)

    # stage 2 on the padded batch, its KL floor between the global mean
    # and rank 0's (JAX's sampler forward at the initial parameters)
    jscfg, jsp, tsp = _sampler_params(1)
    s_keys = [jax.random.PRNGKey(s) for s in (31, 32)]
    with jax.default_matmul_precision("highest"):
        sout = js.sampler_forward(jsp, jp, jscfg, jcfg0, jb_pad, s_keys[0])
    skl = np.asarray(sout.sampler_dist.kl(sout.vae_dist)).reshape(
        B * N, -1).sum(1) * v_flat
    s_means = (float(skl[:8].sum() / v_flat[:8].sum()),
               float(skl.sum() / v_flat.sum()))
    jscfg_floor = jscfg._replace(kld_min_clamp=0.5 * sum(s_means))
    jscfg_live = jscfg._replace(kld_min_clamp=0.0)
    stage2 = dict(kind="sampler_step", cfg=_tcfg(jcfg0, "auto"), net=tp,
                  params=tsp, lr=1e-2)
    sampler_case = dict(stage2, scfg=jscfg_floor._asdict(),
                        batches=[tb_pad, tb_pad],
                        noises=[_jax_eps(k_) for k_ in s_keys])
    sampler_gen = dict(stage2, kind="sampler_generator_step", lr=1e-3,
                       seed=5, scfg=jscfg_live._asdict(),
                       batches=[tb for _, tb in step_batches])
    # scan_steps = 2 under the mesh, both stages: JAX's per-step keys
    scan_key = jax.random.PRNGKey(23)
    scan_keys = jax.random.split(scan_key, 2)
    scan1 = dict(step_case, scan_steps=2,
                 noises=[_jax_noise(jcfg_s, k_) for k_ in scan_keys])
    scan2 = dict(stage2, scan_steps=2, scfg=jscfg_live._asdict(),
                 batches=[tb for _, tb in step_batches],
                 noises=[_jax_eps(k_) for k_ in scan_keys])
    # dopri5's three forms, one step each, with the single-process twin
    ode_key = jax.random.PRNGKey(41)
    jb_o, tb_o = step_batches[0]
    ode = {}
    for form, (kind, kw) in ODE_CASES.items():
        cfg_o = _tcfg(_jcfg(**kw), "auto")
        ode[f"ode_{form}"] = dict(
            kind="step", cfg=cfg_o, params=tp, lr=1e-2, optimizer="sgd",
            batches=[tb_o], noises=[_jax_noise(_jcfg(**kw), ode_key)],
            single=True) if kind == "step" else dict(
            stage2, cfg=cfg_o, scfg=jscfg_live._asdict(), batches=[tb_o],
            noises=[_jax_eps(ode_key)], single=True)
    # the adjoint's gradient and backward solves in float64 (JAX in x64
    # mode): in float32 the backward solves' error ratios sit on the
    # rounding floor, where another summation order takes other steps
    # (tests/test_torch_ode_model.py)
    jcfg_a = _jcfg(**ODE_CASES["adjoint"][1])
    with jax.enable_x64(True):
        noise64 = _jax_noise(jcfg_a, ode_key)
    ode["ode_adjoint_f64"] = dict(
        kind="forward", cfg=_tcfg(jcfg_a, "auto"), single=True,
        params=bridge.tree_map(torch.Tensor.double, tp), noise=noise64,
        batch=dataclasses.replace(tb_o, **{
            f: getattr(tb_o, f).double() for f in (
                "past", "past_vel", "future", "future_vel", "valid")}))
    # a checkpoint saved at world 2, restored at worlds 1 and 4
    ck = dict(cfg=_tcfg(jcfg_s, "auto"), lr=1e-3,
              batches=[tb for _, tb in step_batches],
              noises=step_case["noises"], ckpt_dir=os.path.join(tmp, "ck"))
    restore = {w: dict(ck, kind="restore", tmp=os.path.join(tmp, w))
               for w in ("w1", "w4")}
    for d in [r["tmp"] for r in restore.values()]:
        os.makedirs(d)

    def on(mesh, cases):
        return {n: dict(c, mesh=mesh) for n, c in cases.items()}

    # the 2 × 2 mesh: the stage-1 steps, stage 2 and scan_steps = 2 on
    # ulysses, ulysses over 3 agents (refused), a restore
    dpsp_cases, dpsp_jax = {}, {}
    for name, (kw, route, shape) in DPSP_STEPS.items():
        jcfg_d = _jcfg(**kw)
        jp_d, tp_d = _params(jcfg_d, 0)
        bs = [_batches(jcfg_d, s_, shape=shape) for s_ in (11, 12)]
        dpsp_cases[f"step_{name}"] = dict(
            kind="step", cfg=_tcfg(jcfg_d, route), params=tp_d, lr=1e-2,
            optimizer="sgd", batches=[tb for _, tb in bs],
            noises=[_jax_noise(jcfg_d, k_, shape) for k_ in step_keys])
        dpsp_jax[f"step_{name}"] = (jcfg_d._replace(attn_impl=route), jp_d,
                                    [jb_ for jb_, _ in bs])
    jcfg_n3 = _jcfg(min_clip=0.0)
    _, tb_n3 = _batches(jcfg_n3, 15, shape=(4, 3))
    dpsp_cases["ulysses_n3"] = dict(
        kind="forward_raises", cfg=_tcfg(jcfg_n3, "ulysses"), params=tp,
        batch=tb_n3, noise=_jax_noise(jcfg_n3, step_keys[0], (4, 3)))
    dpsp_cases["sampler_step"] = dict(sampler_case,
                                      cfg=_tcfg(jcfg0, "ulysses"))
    dpsp_cases["scan_step"] = dict(scan1, cfg=_tcfg(jcfg_s, "ulysses"))
    restore["dpsp"] = dict(ck, kind="restore", tmp=os.path.join(tmp, "dpsp"))
    os.makedirs(restore["dpsp"]["tmp"])
    dpsp_cases["restore"] = restore["dpsp"]

    w2 = on((2, 1), {"save": dict(ck, kind="save", params=tp),
                     **ring, **uly, **model2, "validity": validity_case,
                     "step": step_case,
                     "sampler_step": sampler_case,
                     "sampler_generator_step": sampler_gen,
                     "scan_step": scan1, "scan_sampler_step": scan2,
                     "generator_step": gen_case,
                     "inference": dict(kind="inference",
                                       cfg=_tcfg(jcfg0, "auto"), params=tp,
                                       batch=tb_inf,
                                       z=torch.from_numpy(z)),
                     "refusals": refusals})
    w4 = on((4, 1), {**ring, **uly, **{n: model2[n] for n in WORLD4},
                     "step": step_case, "sampler_step": sampler_case,
                     "restore": restore["w4"]})
    dpsp = on((2, 2), {**ring, **uly, **dpsp_cases})
    # ---- start every group, and the CLI at world 2 ----------------------
    groups = {"w2": _Group(tmp, "w2", 2, w2), "w4": _Group(tmp, "w4", 4, w4),
              "ode": _Group(tmp, "ode", 2, on((2, 1), ode)),
              "w1": _Group(tmp, "w1", 1, on((1, 1), {
                  "restore": restore["w1"]})),
              "dpsp": _Group(tmp, "dpsp", 4, dpsp)}
    data_root = _nba_files(tmp)
    port = str(_free_port())
    cli_logs = [os.path.join(tmp, f"cli.{r}.log") for r in range(2)]
    cli = [subprocess.Popen(
        [sys.executable, "-m", "sttode_tpu_torch.cli.train", "--distributed",
         "--data_root", data_root, "--ckpt_dir",
         os.path.join(tmp, f"ck{r}")] + CLI_FLAGS,
        stdout=open(log, "w"), stderr=subprocess.STDOUT, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
                 MASTER_ADDR="127.0.0.1", MASTER_PORT=port, RANK=str(r),
                 LOCAL_RANK=str(r), WORLD_SIZE="2"))
        for r, log in enumerate(cli_logs)]
    deadline = time.monotonic() + JOIN_S
    # ---- the JAX side, while the ranks run ------------------------------
    want = {"model": {}}
    for name, (jcfg, jparams, jb, rng) in want_model.items():
        key = (jcfg, id(jparams), id(jb))
        if key not in want["model"]:
            want["model"][key] = _jax_value_and_grad(jcfg, jparams, jb, rng)
        want[name] = want["model"][key]
    want["agent_ulysses_padded"] = _jax_value_and_grad(jcfg_u, jp_u, jb_u,
                                                       rng_u)
    want["kl_floor"] = _jax_value_and_grad(jcfg_kl, jp, jb_pad, rng_pad)
    want["kl_means"] = (mean0, mean_all, floor)
    jmesh = jmake_mesh(dp=8)
    jstep = jmake_train_step(jcfg_s, optax.sgd(1e-2), mesh=jmesh,
                             params_like=jp, donate=False)
    p_, s_ = jax.device_put(jp, jparam_sharding(jp, jmesh)), \
        optax.sgd(1e-2).init(jp)
    metrics = []
    with jax.default_matmul_precision("highest"):
        for (jb_, _), key in zip(step_batches, step_keys):
            p_, s_, m = jstep(p_, s_, jshard_batch(jb_, jmesh), key)
            metrics.append({k_: float(x) for k_, x in m.items()})
    want["step"] = (metrics, [np.asarray(x) for x in
                              jax.tree_util.tree_leaves(p_)])
    with jax.default_matmul_precision("highest"):
        want["inference"] = np.asarray(jm.sttode_inference(
            jp, jcfg0, jb_inf, rng_inf))
        for metric in ("oblique", "poincare"):
            args = [jax.numpy.asarray(a) for a in (q, k, v)]

            def dense(q_, k_, v_):
                return jdense(q_, k_, v_, kv_valid=val, metric=metric)

            grads = jax.grad(lambda *a: jax.numpy.sum(dense(*a) ** 2),
                             argnums=(0, 1, 2))(*args)
            want[f"ring_{metric}"] = {
                "dense": np.asarray(dense(*args)),
                "grads": [np.asarray(g) for g in grads],
                "ring": {
                    mesh: np.asarray(jring(*args, jmake_mesh(
                        dp=mesh[0], sp=mesh[1], tp=1), kv_valid=val,
                        metric=metric))
                    for mesh in ((2, 1), (4, 1), (2, 2))}}
            uargs = [jax.numpy.asarray(a) for a in (uq, uk, uv)]
            Bu, Hu, D_ = ULYSSES["B"], ULYSSES["H"], ULYSSES["D"]

            def dense_heads(q_, k_, v_):
                return jdense(*(x.reshape(Bu * Hu, -1, D_) for x in
                                (q_, k_, v_)),
                              kv_valid=np.repeat(uval, Hu, axis=0),
                              metric=metric).reshape(q_.shape)

            grads = jax.grad(lambda *a: jax.numpy.sum(dense_heads(*a) ** 2),
                             argnums=(0, 1, 2))(*uargs)
            want[f"ulysses_{metric}"] = {
                "dense": np.asarray(dense_heads(*uargs)),
                "grads": [np.asarray(g) for g in grads],
                "ring": {
                    mesh: np.asarray(julysses(*uargs, jmake_mesh(
                        dp=mesh[0], sp=mesh[1], tp=1), kv_valid=uval,
                        metric=metric))
                    for mesh in ((2, 1), (4, 1), (2, 2))}}
    # the mesh steps of stage 2, the scanned steps and dopri5 compile in
    # threads (XLA compiles without the GIL; the precision and x64
    # settings are the thread's); the solve counts come from un-jitted
    # forwards on this thread
    jp_mesh = jax.device_put(jp, jparam_sharding(jp, jmesh))
    sgd = optax.sgd(1e-2)
    stacked = [jstack_batches([jb_ for jb_, _ in step_batches])]

    jmesh22 = jmake_mesh(dp=2, sp=2, tp=1)

    def stage1(jcfg, params, batches, keys, scan_steps=1, mesh=jmesh,
               like=jp):
        return _jax_mesh_steps(
            (jmake_train_step(jcfg, sgd, mesh=mesh, params_like=like,
                              donate=False, scan_steps=scan_steps),
             mesh, scan_steps > 1), params, batches, keys)

    def stage2(jcfg, jscfg_, batches, keys, scan_steps=1, mesh=jmesh):
        return _jax_mesh_steps(
            (jmake_sampler_step(jcfg, jscfg_, sgd, donate=False,
                                scan_steps=scan_steps, mesh=mesh),
             mesh, scan_steps > 1), jsp, batches, keys, jp)

    def on22(jcfg, params, batches, keys, scan_steps=1):
        return stage1(jcfg, jax.device_put(params, jparam_sharding(
            params, jmesh22)), batches, keys, scan_steps, jmesh22, params)

    def adjoint64():
        """The adjoint's mesh step in float64: its metrics, and the
        gradient from its SGD update."""
        with jax.enable_x64(True):
            jp64, jb64 = jax.tree_util.tree_map(
                lambda a: jax.numpy.asarray(a, jax.numpy.float64),
                (jp, jb_o))
            metrics, params = _jax_mesh_steps(
                (jmake_train_step(_jcfg(**ODE_CASES["adjoint"][1]), sgd,
                                  mesh=jmesh, params_like=jp64,
                                  donate=False), jmesh, False),
                jax.device_put(jp64, jparam_sharding(jp64, jmesh)), [jb64],
                [ode_key])
            return metrics, [(np.asarray(a) - b) / 1e-2 for a, b in zip(
                jax.tree_util.tree_leaves(jp64), params)]

    tasks = {
        "sampler_step": lambda: stage2(jcfg0, jscfg_floor, [jb_pad, jb_pad],
                                       s_keys),
        "scan_step": lambda: stage1(jcfg_s, jp_mesh, stacked, [scan_key], 2),
        "scan_sampler_step": lambda: stage2(jcfg0, jscfg_live, stacked,
                                            [scan_key], 2),
        "ode_while": lambda: stage2(_jcfg(**ODE_CASES["while"][1]),
                                    jscfg_live, [jb_o], [ode_key]),
        "ode_scan_budget": lambda: stage1(_jcfg(
            **ODE_CASES["scan_budget"][1]), jp_mesh, [jb_o], [ode_key]),
        "ode_adjoint_f64": adjoint64,
        **{name: functools.partial(on22, jcfg_d, jp_d, jbs, step_keys)
           for name, (jcfg_d, jp_d, jbs) in dpsp_jax.items()},
        "dpsp_sampler_step": lambda: stage2(
            jcfg0._replace(attn_impl="ulysses"), jscfg_floor,
            [jb_pad, jb_pad], s_keys, mesh=jmesh22),
        "dpsp_scan_step": lambda: on22(jcfg_s._replace(attn_impl="ulysses"),
                                       jp, stacked, [scan_key], 2)}
    with concurrent.futures.ThreadPoolExecutor(len(tasks)) as pool:
        futures = {name: pool.submit(fn) for name, fn in tasks.items()}
        solves, losses = {}, {}
        for form, (kind, kw) in ODE_CASES.items():
            jcfg_o = _jcfg(**kw)
            with _jax_solve_log() as solves[form], \
                    jax.default_matmul_precision("highest"):
                if kind == "step":
                    out = jm.sttode_forward(jp, jcfg_o, jb_o, ode_key,
                                            train=True)
                    losses[form] = {k: float(getattr(out, name)) for k, name
                                    in zip(("total", "pred", "recover",
                                            "kl", "diverse"), LOSSES)}
                else:
                    js.sampler_forward(jsp, jp, jscfg_live, jcfg_o, jb_o,
                                       ode_key)
        with jax.enable_x64(True), jax.default_matmul_precision("highest"), \
                _jax_solve_log() as solves64:
            jp64, jb64 = jax.tree_util.tree_map(
                lambda a: jax.numpy.asarray(a, jax.numpy.float64),
                (jp, jb_o))
            jm.sttode_forward(jp64, _jcfg(**ODE_CASES["adjoint"][1]), jb64,
                              ode_key, train=True)
        done = {name: f.result() for name, f in futures.items()}
    want["sampler_step"] = done["sampler_step"]
    want["sampler_means"] = (*s_means, jscfg_floor.kld_min_clamp)
    want["scan_step"] = done["scan_step"]
    want["scan_sampler_step"] = done["scan_sampler_step"]
    want["dpsp"] = {name: done[name] for name in dpsp_jax}
    want["dpsp"]["sampler_step"] = done["dpsp_sampler_step"]
    want["dpsp"]["scan_step"] = done["dpsp_scan_step"]
    for form in ("while", "scan_budget"):
        want[f"ode_{form}"] = (*done[f"ode_{form}"], solves[form])
    # the float32 adjoint step's losses: JAX's float32 forward's
    want["ode_adjoint"] = ([losses["adjoint"]], None, solves["adjoint"])
    want["ode_adjoint_f64"] = (*done["ode_adjoint_f64"], solves64)
    # ---- join -----------------------------------------------------------
    got = {name: g.join(deadline) for name, g in groups.items()}
    try:
        for p in cli:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in cli:
            if p.poll() is None:
                p.kill()
                p.wait()
    got["cli"] = ([p.returncode for p in cli],
                  [open(log).read() for log in cli_logs])
    return got, want


def _assert_grads(got, want, what):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, **TOL,
                                   err_msg=f"{what}: gradient leaf {i}")


@pytest.mark.parametrize("group,mesh", [("w2", (2, 1)), ("w4", (4, 1)),
                                        ("dpsp", (2, 2))])
@pytest.mark.parametrize("metric", ["oblique", "poincare"])
def test_ring_matches_jax_ring_and_dense(runs, group, mesh, metric):
    got, want = runs
    res, w = got[group][0][f"ring_{metric}"], want[f"ring_{metric}"]
    np.testing.assert_allclose(res["out"], w["ring"][mesh], atol=2e-5)
    np.testing.assert_allclose(res["out"], w["dense"], atol=2e-5)
    for name, g, wg in zip(("dq", "dk", "dv"), (res["dq"], res["dk"],
                                                res["dv"]), w["grads"]):
        tol = 5e-5 * max(1.0, float(np.abs(wg).max()))
        np.testing.assert_allclose(g, wg, atol=tol, err_msg=name)


@pytest.mark.parametrize("group,mesh", [("w2", (2, 1)), ("w4", (4, 1)),
                                        ("dpsp", (2, 2))])
@pytest.mark.parametrize("metric", ["oblique", "poincare"])
def test_ulysses_matches_jax_ulysses_and_dense(runs, group, mesh, metric):
    """[2, 4, 8 / 16, 8] blocks, a key validity: the assembled output and
    the gradients of sum(out²) against JAX's Ulysses on the same mesh and
    the dense oracle a head; 3 heads over the axis raise ValueError."""
    got, want = runs
    res, w = got[group][0][f"ulysses_{metric}"], want[f"ulysses_{metric}"]
    np.testing.assert_allclose(res["out"], w["ring"][mesh], atol=2e-5)
    np.testing.assert_allclose(res["out"], w["dense"], atol=2e-5)
    for name, g, wg in zip(("dq", "dk", "dv"), (res["dq"], res["dk"],
                                                res["dv"]), w["grads"]):
        tol = 5e-5 * max(1.0, float(np.abs(wg).max()))
        np.testing.assert_allclose(g, wg, atol=tol, err_msg=name)
    kind, msg = res["heads"]
    assert kind == "ValueError" and "3 heads" in msg and "must divide" in msg


def test_ulysses_respects_the_key_validity(runs):
    """The agent axis with a padded agent a scene (JAX's Ulysses test
    holds the real agents' features when the padded agents' inputs move):
    the losses against JAX's dense forward, the gradients against the
    port's single-process forward on the same inputs (on this batch a
    decoder ReLU lies at rounding, where the port's plain forward and
    JAX's part by one hidden unit of one row: ~1 column of
    ``decoder_x``'s first layer, 5e-4); moving the padded agents' inputs
    moves their own features, no real agent's."""
    got, want = runs
    res = got["w2"][0]["agent_ulysses_padded"]
    jout, _ = want["agent_ulysses_padded"]
    assert res["same_on_ranks"]
    for name in LOSSES:
        np.testing.assert_allclose(res["losses"][name],
                                   float(getattr(jout, name)), **TOL,
                                   err_msg=name)
        np.testing.assert_allclose(res["losses"][name],
                                   res["single"]["losses"][name], **TOL,
                                   err_msg=name)
    _assert_grads(res["grads"], res["single"]["grads"],
                  "agent_ulysses_padded")
    val = got["w2"][0]["validity"]
    assert val["real"] <= 1e-5 and val["padded"] > 1e-2, val


@pytest.mark.parametrize("group,case", [("w2", n) for n in MODEL_CASES]
                         + [("w4", n) for n in WORLD4])
def test_sttode_forward_on_a_mesh_matches_jax(runs, group, case):
    got, want = runs
    res = got[group][0][case]
    jout, jgrads = want[case]
    assert res["same_on_ranks"]
    for name in LOSSES:
        np.testing.assert_allclose(res["losses"][name],
                                   float(getattr(jout, name)), **TOL,
                                   err_msg=name)
    assert res["losses"]["loss_kl"] < 2.0     # live, not floored
    _assert_grads(res["grads"], jgrads, f"{group} {case}")


def test_kl_floor_and_normalizers_are_global(runs):
    """Ranks with 8 and 3 real agents and the KL floor between the global
    mean and rank 0's: a per-rank count or clamp would differ."""
    got, want = runs
    mean0, mean_all, floor = want["kl_means"]
    assert min(mean0, mean_all) < floor < max(mean0, mean_all)
    res = got["w2"][0]["kl_floor"]
    jout, jgrads = want["kl_floor"]
    assert res["same_on_ranks"]
    for name in LOSSES:
        np.testing.assert_allclose(res["losses"][name],
                                   float(getattr(jout, name)), **TOL,
                                   err_msg=name)
    _assert_grads(res["grads"], jgrads, "kl_floor")


@pytest.mark.parametrize("group", ["w2", "w4"])
def test_train_step_on_a_mesh_matches_jax_dp_step(runs, group):
    got, want = runs
    res = got[group][0]["step"]
    jmetrics, jparams = want["step"]
    assert res["same_metrics"] and res["equal_on_ranks"]
    for m, jm_ in zip(res["metrics"], jmetrics):
        assert set(m) == set(jm_)
        for k in m:
            np.testing.assert_allclose(m[k], jm_[k], **TOL, err_msg=k)
    assert len(res["params"]) == len(jparams)
    for i, (p, jp) in enumerate(zip(res["params"], jparams)):
        np.testing.assert_allclose(p, jp, rtol=1e-5, atol=1e-5,
                                   err_msg=f"parameter leaf {i}")


def test_mesh_step_with_a_generator_equals_the_single_process_step(runs):
    res = runs[0]["w2"][0]["generator_step"]
    assert res["mesh"]["equal_on_ranks"]
    for m, s in zip(res["mesh"]["metrics"], res["single"]["metrics"]):
        for k in m:
            np.testing.assert_allclose(m[k], s[k], rtol=1e-5, atol=1e-6,
                                       err_msg=k)
    # Adam moves an entry by at most ~lr a step whatever its gradient, and
    # the two summation orders may part on a gradient near 0
    np.testing.assert_allclose(res["mesh"]["params"],
                               res["single"]["params"], atol=2 * 2 * 1e-3)


def _assert_steps(res, want, params_tol, metrics_tol=None, what=""):
    """The mesh step's metrics and final parameters against JAX's."""
    jmetrics, jparams = want
    assert res["same_metrics"] and res["equal_on_ranks"], what
    assert len(res["metrics"]) == len(jmetrics)
    for m, jm_ in zip(res["metrics"], jmetrics):
        assert set(m) == set(jm_)
        for k in m:
            np.testing.assert_allclose(m[k], jm_[k],
                                       **(metrics_tol or params_tol),
                                       err_msg=f"{what} {k}")
    assert len(res["params"]) == len(jparams)
    for i, (p, jp) in enumerate(zip(res["params"], jparams)):
        np.testing.assert_allclose(p, jp, **params_tol,
                                   err_msg=f"{what} parameter leaf {i}")


@pytest.mark.parametrize("group", ["w2", "w4"])
def test_sampler_step_on_a_mesh_matches_jax_dp_step(runs, group):
    """Stage 2 on the padded batch, 2 SGD steps: metrics within 1e-5,
    parameters within TOL."""
    got, want = runs
    _assert_steps(got[group][0]["sampler_step"], want["sampler_step"], TOL,
                  dict(rtol=1e-5, atol=1e-5), f"{group} sampler")


def test_sampler_kl_floor_and_normalizers_are_global(runs):
    """Ranks with 8 and 3 real agents and the stage-2 KL floor between
    the global mean and rank 0's: the first step's KL is the global mean,
    floored as JAX floors it."""
    got, want = runs
    mean0, mean_all, floor = want["sampler_means"]
    assert min(mean0, mean_all) < floor < max(mean0, mean_all)
    kld = got["w2"][0]["sampler_step"]["metrics"][0]["kld"]
    np.testing.assert_allclose(kld, max(mean_all, floor), rtol=1e-5)
    np.testing.assert_allclose(kld, want["sampler_step"][0][0]["kld"],
                               rtol=1e-5)


def test_sampler_mesh_step_with_a_generator_equals_the_single_process_step(
        runs):
    """ε drawn from a generator of one seed, [M, nz] and not shared: the
    mesh step draws the single process's ε and keeps its rows."""
    res = runs[0]["w2"][0]["sampler_generator_step"]
    assert res["mesh"]["equal_on_ranks"]
    for m, s in zip(res["mesh"]["metrics"], res["single"]["metrics"]):
        for k in m:
            np.testing.assert_allclose(m[k], s[k], rtol=1e-5, atol=1e-6,
                                       err_msg=k)
    np.testing.assert_allclose(res["mesh"]["params"],
                               res["single"]["params"], atol=2 * 2 * 1e-3)


@pytest.mark.parametrize("case", ["scan_step", "scan_sampler_step"])
def test_scanned_mesh_steps_match_jax(runs, case):
    """scan_steps = 2 on the mesh, a stacked batch's rows split over the
    ranks and JAX's per-step draws: metrics [2] and parameters within
    1e-5; eager on the CPU."""
    got, want = runs
    res = got["w2"][0][case]
    assert res["mode"] == "eager"
    assert all(len(v) == 2 for v in res["metrics"][0].values())
    _assert_steps(res, want[case], dict(rtol=1e-5, atol=1e-5), what=case)


@pytest.mark.parametrize("form", list(ODE_CASES))
def test_dopri5_mesh_step_matches_jax(runs, form):
    """dopri5 under a mesh, one SGD step against JAX's: losses within
    1e-4, parameters within TOL, equal bit for bit on both ranks. The
    adjoint: the float32 step's losses against JAX's float64 step, and in
    float64 the losses and the summed gradient, within 1e-4 × max(1,
    max |g|) of the gradient of JAX's step."""
    got, want = runs
    res = got["ode"][0][f"ode_{form}"]
    jmetrics, jparams, _ = want[f"ode_{form}"]
    if form != "adjoint":
        _assert_steps(res, (jmetrics, jparams), TOL, what=form)
        return
    assert res["same_metrics"] and res["equal_on_ranks"]
    for k, v in res["metrics"][0].items():
        np.testing.assert_allclose(v, jmetrics[0][k], **TOL, err_msg=k)
    f64 = got["ode"][0]["ode_adjoint_f64"]
    jmetrics64, jgrads, _ = want["ode_adjoint_f64"]
    assert f64["same_on_ranks"]
    for name, k in zip(LOSSES, ("total", "pred", "recover", "kl",
                                "diverse")):
        np.testing.assert_allclose(f64["losses"][name], jmetrics64[0][k],
                                   **TOL, err_msg=name)
    assert len(f64["grads"]) == len(jgrads)
    for i, (g, w) in enumerate(zip(f64["grads"], jgrads)):
        np.testing.assert_allclose(
            g, w, rtol=0, atol=1e-4 * max(1.0, float(np.abs(w).max())),
            err_msg=f"adjoint: gradient leaf {i}")


@pytest.mark.parametrize("form", list(ODE_CASES))
def test_dopri5_step_counts_equal_on_ranks_and_to_jax(runs, form):
    """Every solve of the step (the adjoint's backward solves too): the
    same attempted and accepted steps and RHS evaluations on both ranks
    and in the single process; the forward solves' equal JAX's. The
    adjoint's backward solves equal the single process's in float64; in
    float32, on the rounding floor, they are alike on both ranks."""
    got, want = runs
    res = got["ode"][0][f"ode_{form}"]
    jsolves = want[f"ode_{form}"][2]
    n_fwd = 1 if form == "while" else 2
    assert len(jsolves) == n_fwd
    assert res["same_solves"]
    assert len(res["solves"]) == n_fwd * (2 if form == "adjoint" else 1)
    assert [tuple(s) for s in res["solves"][:n_fwd]] == jsolves
    assert all(s[1] > 0 for s in res["solves"])
    if form == "adjoint":
        res, jsolves = got["ode"][0]["ode_adjoint_f64"], \
            want["ode_adjoint_f64"][2]
        assert res["same_solves"] and len(res["solves"]) == 4
        assert [tuple(s) for s in res["solves"][:2]] == jsolves
    assert res["solves"] == res["single"]["solves"]


@pytest.mark.parametrize("group", ["w1", "w4", "dpsp"])
def test_restore_shardings_restores_another_worlds_checkpoint(runs, group):
    """Saved at world 2, restored at world 1, 4 and on the 2 × 2 mesh
    through ``restore_shardings`` (every rank but 0 read other values):
    the parameters and Adam moments equal the saved ones bit for bit on
    every rank, and the next step's metrics equal the saving run's."""
    got, _ = runs
    saved = got["w2"][0]["save"]
    res = got[group][0]["restore"]
    assert res["epoch"] == 1
    assert len(res["restored"]) == {"w1": 1, "w4": 4, "dpsp": 4}[group]
    for r, state in enumerate(res["restored"]):
        assert torch.equal(state, saved["saved"]), f"{group} rank {r}"
    for k, v in saved["metrics"].items():
        np.testing.assert_allclose(res["metrics"][k], v, rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    assert res["tp"][0] == "NotImplementedError"


@pytest.mark.parametrize("case", [f"step_{n}" for n in DPSP_STEPS]
                         + ["sampler_step", "scan_step"])
def test_steps_on_a_data_seq_mesh_match_jax(runs, case):
    """``make_mesh(dp=2, sp=2)``: 2 SGD steps (one stacked call under
    ``scan_steps=2``) against JAX's on its 2 × 2 mesh: metrics within 1e-4,
    parameters within 1e-5, equal bit for bit on the 4 ranks though every
    rank but 0 starts from other values."""
    got, want = runs
    res = got["dpsp"][0][case]
    assert res["mode"] == "eager"
    _assert_steps(res, want["dpsp"][case], dict(rtol=1e-5, atol=1e-5),
                  TOL, what=case)


def test_ulysses_on_the_scene_axis_needs_agents_that_divide_data(runs):
    """3 agents a scene (the rows of the scene axis' attention) over data
    = 2: JAX's ``shard_map`` refuses the shape, the port raises."""
    kind, msg = runs[0]["dpsp"][0]["ulysses_n3"]
    assert kind == "ValueError" and "3 rows" in msg and "data = 2" in msg \
        and "must divide" in msg, msg


def test_sttode_inference_on_a_mesh_matches_jax(runs):
    got, want = runs
    np.testing.assert_allclose(got["w2"][0]["inference"], want["inference"],
                               **TOL)


def test_children_import_no_jax(runs):
    assert {"w1", "w2", "w4", "dpsp", "ode"} <= set(runs[0])
    for group, (res, _) in runs[0].items():
        if group != "cli":
            assert res["_jax_imported"] is False, group


def test_mesh_shapes_and_refusals(runs):
    res = runs[0]["w2"][0]["refusals"]
    assert res["shapes"] == {"default": {"data": 2, "model": 1},
                             "hybrid": {"data": 2, "model": 1},
                             "dp_sp": {"data": 1, "seq": 2, "model": 1}}
    # the stacked layout keeps the step axis whole; every leaf replicated
    assert res["stacked"] == ((2, B // 2 * N, SMALL["past_length"], 2),
                              B // 2)
    assert res["placements"] == ["Replicate"]
    # lifted: the scanned steps of both stages and dopri5 build on a mesh
    # (eager on the CPU)
    assert res["built"] == {"scan_steps": "eager", "sampler": "eager",
                            "dopri5": "eager", "seq_axis": "eager",
                            "ulysses": "ulysses"}
    raised = res["raised"]
    for name in ("tp_step", "tp_sharding", "restore_tp"):
        assert raised[name][0] == "NotImplementedError"
        assert "tensor parallelism" in raised[name][1]
    for name in ("ring_dropout", "ulysses_dropout"):
        assert raised[name][0] == "ValueError" and \
            "dropout" in raised[name][1]
    for name, what in (("ulysses_no_mesh", "needs a mesh"),
                       ("ulysses_mask", "key-validity"),
                       ("ulysses_no_heads", "head axis")):
        assert raised[name][0] == "ValueError" and what in raised[name][1]
    assert raised["mesh_dp0"][0] == "ValueError" and \
        "dp would be 0" in raised["mesh_dp0"][1]
    assert raised["mesh_too_big"][0] == "ValueError" and \
        "needs 3 devices" in raised["mesh_too_big"][1]
    assert raised["odd_batch"][0] == "ValueError" and \
        "whole" in raised["odd_batch"][1]


def test_cli_distributed_joins_every_rank(runs):
    rcs, logs = runs[0]["cli"]
    assert rcs == [0, 0], logs
    for r, log in enumerate(logs):
        assert f"distributed: process {r} of 2 over gloo" in log, log
        assert "epoch 000" in log, log


def test_cli_distributed_without_a_launcher_exits(monkeypatch):
    for name in ("WORLD_SIZE", "MASTER_ADDR", "RANK"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(SystemExit, match="no launcher environment"):
        cli_train.main(["--distributed", "--device", "cpu"])
