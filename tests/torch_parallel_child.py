"""One rank of the multi-process CPU tests of the port's parallel layer
(``tests/test_torch_parallel.py``). It joins a gloo process group through
a file rendezvous, runs the cases of the spec file that the test wrote,
and rank 0 writes each case's result. It imports no JAX.

    python tests/torch_parallel_child.py SPEC RANK WORLD
"""

import datetime
import os
import sys
import time

import torch
import torch.distributed as dist

torch.set_num_threads(1)

from sttode_tpu_torch import bridge  # noqa: E402
from sttode_tpu_torch.models import sampler as ts  # noqa: E402
from sttode_tpu_torch.models import sttode as tm  # noqa: E402
from sttode_tpu_torch.nn.attention import geodesic_attention  # noqa: E402
from sttode_tpu_torch.ode import solvers  # noqa: E402
from sttode_tpu_torch.parallel import (make_mesh, param_sharding,  # noqa: E402
                                       shard_batch)
from sttode_tpu_torch.parallel import collectives  # noqa: E402
from sttode_tpu_torch.parallel.mesh import (axis_size,  # noqa: E402
                                            make_hybrid_mesh, mesh_shape)
from sttode_tpu_torch.parallel.ring_attention import (  # noqa: E402
    resolve_sp_axes, ring_geodesic_attention)
from sttode_tpu_torch.parallel.ulysses import (  # noqa: E402
    ulysses_geodesic_attention)
from sttode_tpu_torch.train import (checkpoint_path,  # noqa: E402
                                    load_checkpoint, make_sampler_train_step,
                                    make_train_step, restore_shardings,
                                    save_checkpoint, stack_batches,
                                    stack_noise)

LOSSES = ("total_loss", "loss_pred", "loss_recover", "loss_kl",
          "loss_diverse")


def _gather_objects(obj) -> list:
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def _block(x, dim: int, index: int, count: int):
    size = x.shape[dim] // count
    return x.narrow(dim, index * size, size)


def _leaf(t):
    return t.detach().clone().requires_grad_()


def ring(case, mesh):
    """The ring (or, with ``case["route"] == "ulysses"``, the all-to-all
    attention on [B, H, L, D]) on this rank's blocks of q, k, v and the key
    validity; returns the assembled output and the gradients of sum(out²)
    and, for ulysses, what a head count that does not divide raises."""
    tok, b_ax = resolve_sp_axes(mesh, "data")
    t, n = mesh.get_local_rank(tok), axis_size(mesh, tok)
    bi, bn = (mesh.get_local_rank(b_ax), axis_size(mesh, b_ax)) \
        if b_ax else (0, 1)
    tdim = case["q"].dim() - 2

    def local(x, dim=tdim):
        return _block(_block(x, 0, bi, bn), dim, t, n)

    attend = ulysses_geodesic_attention \
        if case.get("route") == "ulysses" else ring_geodesic_attention
    q, k, v = (_leaf(local(case[name])) for name in ("q", "k", "v"))
    out = attend(q, k, v, mesh, kv_valid=local(case["val"], 1),
                 metric=case["metric"], curvature=case["curvature"])
    torch.sum(out ** 2).backward()
    parts = _gather_objects((bi, t, out.detach(), q.grad, k.grad, v.grad))
    full = {"out": torch.zeros_like(case["q"]), "dq": torch.zeros_like(
        case["q"]), "dk": torch.zeros_like(case["k"]),
        "dv": torch.zeros_like(case["v"])}
    for bi_, t_, *blocks in parts:
        for name, blk in zip(("out", "dq", "dk", "dv"), blocks):
            _block(_block(full[name], 0, bi_, bn), tdim, t_, n).copy_(blk)
    res = {name: x.numpy() for name, x in full.items()}
    if case.get("route") == "ulysses":
        res["heads"] = _outcome(lambda: attend(q[:, :3], k[:, :3], v[:, :3],
                                               mesh))
    return res


def _sum_grads(params, group):
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in bridge.tree_leaves(params)]
    return [collectives.all_reduce(g.clone(), group).numpy() for g in grads]


def forward(case, mesh):
    """``sttode_forward(mesh=)`` on this rank's scenes: the losses (and
    whether every rank has the same), the summed gradient leaves, the
    dopri5 solves' counts (alike on every rank?) and, when the case asks,
    the single process's losses, gradients and solves (on "auto" where
    the case's route needs a mesh)."""
    cfg = tm.STTODEConfig(**case["cfg"])

    def run(m):
        params = bridge.tree_map(_leaf, case["params"])
        c = cfg._replace(attn_impl="auto") if m is None and \
            cfg.attn_impl in ("ring", "ulysses") else cfg
        with _SolveLog() as log:
            out = tm.sttode_forward(
                params, c, case["batch"] if m is None else shard_batch(
                    case["batch"], m), noise=case["noise"], mesh=m)
            out.total_loss.backward()
        losses = {name: float(getattr(out, name)) for name in LOSSES}
        grads = [p.grad.numpy() for p in bridge.tree_leaves(params)] \
            if m is None else _sum_grads(params, m.get_group("data"))
        return {"losses": losses, "grads": grads, "solves": log.solves}

    out = run(mesh)
    out.update(same_on_ranks=all(x == out["losses"] for x in
                                 _gather_objects(out["losses"])),
               same_solves=all(x == out["solves"] for x in
                               _gather_objects(out["solves"])))
    if case.get("single") and dist.get_rank() == 0:
        out["single"] = run(None)
    return out


def validity(case, mesh):
    """``sttode_forward(mesh=)`` without gradients on a padded batch and on
    its twin whose padded agents moved: the largest change of a real
    agent's past feature (none: padding reaches no real agent) and of a
    padded one's (its own input moved), over every rank."""
    cfg = tm.STTODEConfig(**case["cfg"])
    feats = []
    with torch.no_grad():
        for batch in (case["batch"], case["moved"]):
            feats.append(tm.sttode_forward(
                case["params"], cfg, shard_batch(batch, mesh),
                noise=case["noise"], mesh=mesh).past_feature)
    real = shard_batch(case["batch"], mesh).valid > 0
    diff = (feats[0] - feats[1]).abs().amax(dim=1)
    return {"real": max(_gather_objects(float(diff[real].max()))),
            "padded": min(_gather_objects(float(diff[~real].max())))}


def forward_raises(case, mesh):
    """What ``sttode_forward(mesh=)`` raises on this rank's scenes."""
    cfg = tm.STTODEConfig(**case["cfg"])
    return _outcome(lambda: tm.sttode_forward(
        case["params"], cfg, shard_batch(case["batch"], mesh),
        noise=case["noise"], mesh=mesh))


def _flat(params):
    return torch.cat([p.detach().reshape(-1)
                      for p in bridge.tree_leaves(params)])


def _equal_on_ranks(params) -> bool:
    flat = _flat(params)
    first = collectives.broadcast(flat.clone(), 0, None)
    return bool(torch.equal(first, flat)) and all(_gather_objects(
        bool(torch.equal(first, flat))))


def _sgd(lr):
    def make(leaves, capturable=False):
        return torch.optim.SGD(leaves, lr=lr)
    return make


class _SolveLog:
    """Inside, every dopri5 solve's (attempted steps, accepted steps, RHS
    evaluations) in order, the adjoint's backward solves included."""

    def __enter__(self):
        self.solves, self._real = [], solvers._dopri5_odeint

        def record(*args, **kw):
            ys, st = self._real(*args, **kw)
            self.solves.append((st["attempted_steps"], st["accepted_steps"],
                                st["rhs_evals"]))
            return ys, st

        solvers._dopri5_odeint = record
        return self

    def __exit__(self, *exc):
        solvers._dopri5_odeint = self._real


def _drive(stp, params, state, case, mesh):
    """The case's steps (one stacked call under ``scan_steps`` > 1) with
    its injected global noise → (params, metrics a call, the solves)."""
    stacked = stp.scan_steps > 1
    batches, noises = case["batches"], case["noises"]
    if stacked:
        batches, noises = [stack_batches(batches)], [stack_noise(noises)]
    metrics = []
    with _SolveLog() as log:
        for batch, noise in zip(batches, noises):
            if mesh is not None:
                batch = shard_batch(batch, mesh, stacked=stacked)
            params, state, m = stp(params, state, batch, noise=noise)
            metrics.append({k: v.tolist() for k, v in m.items()})
    return params, metrics, log.solves


def _result(params, metrics, solves) -> dict:
    return {"metrics": metrics, "solves": solves,
            "params": [p.detach().numpy() for p in
                       bridge.tree_leaves(params)],
            # under SGD the last step's summed gradient (q_c has none: the
            # reconstruction term is off)
            "grads": [(torch.zeros_like(p) if p.grad is None else p.grad)
                      .numpy() for p in bridge.tree_leaves(params)]}


def _on_mesh(make, case, mesh, optimizer):
    """Run a step that ``make(mesh)`` builds on the mesh, every rank but 0
    starting from other values (init gives rank 0's), then on rank 0 the
    single-process twin when the case asks for it."""
    stp = make(mesh)
    params = case["params"] if dist.get_rank() == 0 else bridge.tree_map(
        lambda t: t + 1.0, case["params"])
    params, state = stp.init(params)
    state = optimizer(params) or state
    params, metrics, solves = _drive(stp, params, state, case, mesh)
    out = _result(params, metrics, solves)
    out.update(mode=stp.mode,
               same_metrics=all(x == metrics for x in
                                _gather_objects(metrics)),
               same_solves=all(x == solves for x in _gather_objects(solves)),
               equal_on_ranks=_equal_on_ranks(params))
    if case.get("single") and dist.get_rank() == 0:
        stp = make(None)
        params, state = stp.init(case["params"])
        state = optimizer(params) or state
        out["single"] = _result(*_drive(stp, params, state, case, None))
    return out


def step(case, mesh):
    """``make_train_step(mesh=)`` (``scan_steps`` from the case) for the
    case's steps with its injected global noise: the metrics of each call,
    the final parameters and the last gradient, whether they are equal on
    every rank, the dopri5 solves' counts (alike on every rank?) and, when
    asked, the single-process step's."""
    cfg = tm.STTODEConfig(**case["cfg"])
    opt = _sgd(case["lr"]) if case["optimizer"] == "sgd" else None
    return _on_mesh(lambda m: make_train_step(
        cfg, case["lr"], device="cpu", mesh=m, optimizer=opt,
        scan_steps=case.get("scan_steps", 1)), case, mesh, lambda p: None)


def sampler_step(case, mesh):
    """``make_sampler_train_step(mesh=)`` under SGD, as ``step``: the
    sampler's parameters, the frozen net the case's."""
    cfg = tm.STTODEConfig(**case["cfg"])
    scfg = ts.SamplerConfig(**case["scfg"])

    def sgd(params):
        return torch.optim.SGD(bridge.tree_leaves(params), lr=case["lr"])

    return _on_mesh(lambda m: make_sampler_train_step(
        cfg, scfg, case["lr"], case["net"], device="cpu", mesh=m,
        scan_steps=case.get("scan_steps", 1)), case, mesh, sgd)


def sampler_generator_step(case, mesh):
    """The stage-2 mesh step and the single-process step on the whole
    batch, each with a generator from the same seed (ε drawn: the global
    draw), default Adam: both steps' metrics and final parameters."""
    cfg = tm.STTODEConfig(**case["cfg"])
    scfg = ts.SamplerConfig(**case["scfg"])
    out = {}
    for name, m in (("mesh", mesh), ("single", None)):
        stp = make_sampler_train_step(cfg, scfg, case["lr"], case["net"],
                                      device="cpu", mesh=m)
        params, state = stp.init(case["params"])
        gen = torch.Generator().manual_seed(case["seed"])
        metrics = []
        for batch in case["batches"]:
            b = batch if m is None else shard_batch(batch, m)
            params, state, mt = stp(params, state, b, gen)
            metrics.append({k: float(v) for k, v in mt.items()})
        out[name] = {"metrics": metrics, "params": _flat(params).numpy()}
        if m is not None:
            out[name]["equal_on_ranks"] = _equal_on_ranks(params)
    return out


def _state(params, opt_state: dict) -> torch.Tensor:
    """The parameters and every tensor of an optimizer's state_dict, laid
    end to end."""
    leaves = [p.detach().reshape(-1) for p in bridge.tree_leaves(params)]
    for i in sorted(opt_state["state"]):
        st = opt_state["state"][i]
        leaves += [st[k].reshape(-1).float() for k in sorted(st)]
    return torch.cat(leaves)


def save(case, mesh):
    """One Adam step on the mesh from the case's first batch, saved by
    rank 0 into the case's directory; then the step on its second batch:
    the saved state (``_state``) and that step's metrics."""
    cfg = tm.STTODEConfig(**case["cfg"])
    stp = make_train_step(cfg, case["lr"], device="cpu", mesh=mesh)
    params, opt = stp.init(case["params"])
    (b0, b1), (n0, n1) = case["batches"], case["noises"]
    params, opt, _ = stp(params, opt, shard_batch(b0, mesh), noise=n0)
    if dist.get_rank() == 0:
        save_checkpoint(case["ckpt_dir"], 1, params, opt, cfg)
    saved = _state(params, opt.state_dict())
    params, opt, m = stp(params, opt, shard_batch(b1, mesh), noise=n1)
    return {"saved": saved, "metrics": {k: float(v) for k, v in m.items()}}


def _perturbed(tree):
    if isinstance(tree, dict):
        return {k: _perturbed(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_perturbed(v) for v in tree]
    return tree + 1.0 if isinstance(tree, torch.Tensor) and \
        tree.is_floating_point() else tree


def restore(case, mesh):
    """Restore the checkpoint that another world saved (waiting for it)
    through ``restore_shardings``, every rank but 0 reading a copy with
    other values; then the saving run's second step from it: the restored
    state of every rank, the epoch, that step's metrics and whether
    ``tp=True`` raises."""
    path = checkpoint_path(case["ckpt_dir"], 1)
    deadline = time.monotonic() + 120.0
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no checkpoint at {path}")
        time.sleep(0.2)
    mine = path
    if dist.get_rank() != 0:
        mine = os.path.join(case["tmp"], f"other{dist.get_rank()}.pt")
        ck = torch.load(path, weights_only=True)
        torch.save(dict(ck, params=_perturbed(ck["params"]),
                        opt_state=_perturbed(ck["opt_state"])), mine)
    params_t, opt_t, _, _ = load_checkpoint(path)
    template = {"params": params_t, "opt_state": opt_t, "epoch": 1}
    params, opt_state, epoch, cfg = load_checkpoint(
        mine, shardings=restore_shardings(template, mesh))
    restored = _state(params, opt_state)
    stp = make_train_step(cfg, case["lr"], device="cpu", mesh=mesh)
    params, opt = stp.init(params, opt_state)
    params, opt, m = stp(params, opt, shard_batch(case["batches"][1], mesh),
                         noise=case["noises"][1])
    return {"restored": _gather_objects(restored), "epoch": epoch,
            "metrics": {k: float(v) for k, v in m.items()},
            "tp": _outcome(lambda: restore_shardings(template, mesh,
                                                     tp=True))}


def generator_step(case, mesh):
    """The mesh step and the single-process step on the whole batch, each
    with a generator from the same seed (the global noise), default
    Adam: both steps' metrics and final parameters."""
    cfg = tm.STTODEConfig(**case["cfg"])
    out = {}
    for name, m in (("mesh", mesh), ("single", None)):
        stp = make_train_step(cfg, case["lr"], device="cpu", mesh=m)
        params, state = stp.init(case["params"])
        gen = torch.Generator().manual_seed(case["seed"])
        metrics = []
        for batch in case["batches"]:
            b = batch if m is None else shard_batch(batch, m)
            params, state, mt = stp(params, state, b, gen)
            metrics.append({k: float(v) for k, v in mt.items()})
        out[name] = {"metrics": metrics, "params": _flat(params).numpy()}
        if m is not None:
            out[name]["equal_on_ranks"] = _equal_on_ranks(params)
    return out


def inference(case, mesh):
    cfg = tm.STTODEConfig(**case["cfg"])
    with torch.no_grad():
        pred = tm.sttode_inference(case["params"], cfg,
                                   shard_batch(case["batch"], mesh),
                                   z=case["z"], mesh=mesh)
    return collectives.all_gather(pred, mesh.get_group("data"), 1).numpy()


def _outcome(fn):
    try:
        fn()
    except (NotImplementedError, ValueError) as e:
        return type(e).__name__, str(e)
    return None, ""


def refusals(case, mesh):
    """What raises, and its message, for each refused setting."""
    cfg = tm.STTODEConfig(**case["cfg"])
    world = dist.get_world_size()
    shapes = {"default": mesh_shape(make_mesh()),
              "hybrid": mesh_shape(make_hybrid_mesh(1, dcn_dp=world))}
    if world % 2 == 0:
        shapes["dp_sp"] = mesh_shape(make_mesh(dp=world // 2, sp=2))
    seq_mesh = make_mesh(dp=world // 2, sp=2) if world % 2 == 0 else None
    params = case["params"]
    x = torch.zeros(2, 2, 4, 8)
    stacked = shard_batch(stack_batches([case["batch"]] * 2), mesh,
                          stacked=True)
    placements = bridge.tree_leaves(param_sharding(params, mesh))
    # what earlier slices refused: the scanned step (eager on the CPU),
    # the stage-2 step and dopri5 on a mesh
    built = {
        "scan_steps": make_train_step(cfg, 1e-3, device="cpu", mesh=mesh,
                                      scan_steps=2).mode,
        "sampler": make_sampler_train_step(
            cfg, ts.SamplerConfig(nk=2, nz=cfg.zdim, qnet_mlp=(8,)), 1e-3,
            params, device="cpu", mesh=mesh, scan_steps=2).mode,
        "dopri5": make_train_step(cfg._replace(ode_method="dopri5"), 1e-3,
                                  device="cpu", mesh=mesh).mode,
        # what this slice lifted: a "seq" axis, and ulysses
        "seq_axis": make_train_step(cfg._replace(attn_impl="ulysses"), 1e-3,
                                    device="cpu", mesh=seq_mesh).mode,
        "ulysses": cfg._replace(attn_impl="ulysses").validate().attn_impl}
    return {"shapes": shapes, "built": built,
            "stacked": (tuple(stacked.past.shape), stacked.batch_size),
            "placements": sorted({type(p).__name__ for p in placements}),
            "raised": {
        "tp_step": _outcome(lambda: make_train_step(
            cfg, 1e-3, device="cpu", mesh=mesh, tp=True)),
        "tp_sharding": _outcome(lambda: param_sharding(params, mesh,
                                                       tp=True)),
        "restore_tp": _outcome(lambda: restore_shardings(
            {"params": params}, mesh, tp=True)),
        "ring_dropout": _outcome(lambda: geodesic_attention(
            x, x, x, fused="ring", mesh=mesh, dropout_rate=0.1,
            dropout_mask=torch.ones(2, 2, 4, 4, dtype=torch.bool))),
        "ulysses_dropout": _outcome(lambda: geodesic_attention(
            x, x, x, fused="ulysses", mesh=mesh, dropout_rate=0.1,
            dropout_mask=torch.ones(2, 2, 4, 4, dtype=torch.bool))),
        "ulysses_no_mesh": _outcome(lambda: geodesic_attention(
            x, x, x, fused="ulysses")),
        "ulysses_mask": _outcome(lambda: geodesic_attention(
            x, x, x, fused="ulysses", mesh=mesh, mask=torch.zeros(4, 4))),
        "ulysses_no_heads": _outcome(lambda: geodesic_attention(
            x[0], x[0], x[0], fused="ulysses", mesh=mesh)),
        "mesh_dp0": _outcome(lambda: make_mesh(tp=2 * world)),
        "mesh_too_big": _outcome(lambda: make_mesh(dp=world + 1)),
        "odd_batch": _outcome(lambda: shard_batch(
            case["odd_batch"], mesh))}}


RUNNERS = {"ring": ring, "forward": forward, "step": step,
           "generator_step": generator_step, "inference": inference,
           "refusals": refusals, "sampler_step": sampler_step,
           "sampler_generator_step": sampler_generator_step, "save": save,
           "restore": restore, "validity": validity,
           "forward_raises": forward_raises}


def main(spec_path: str, rank: int, world: int) -> None:
    spec = torch.load(spec_path, weights_only=False)
    dist.init_process_group(
        "gloo", init_method=f"file://{spec['rendezvous']}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=60))
    try:
        meshes = {}
        results = {}
        for name, case in spec["cases"].items():
            key = case["mesh"]
            if key not in meshes:
                meshes[key] = make_mesh(dp=key[0], sp=key[1])
            results[name] = RUNNERS[case["kind"]](case, meshes[key])
        results["_jax_imported"] = any(
            m == "jax" or m.startswith("jax.") for m in sys.modules)
        if rank == 0:
            torch.save(results, spec["out"])
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
