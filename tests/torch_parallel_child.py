"""One rank of the multi-process CPU tests of the port's parallel layer
(``tests/test_torch_parallel.py``). It joins a gloo process group through
a file rendezvous, runs the cases of the spec file that the test wrote,
and rank 0 writes each case's result. It imports no JAX.

    python tests/torch_parallel_child.py SPEC RANK WORLD
"""

import datetime
import sys

import torch
import torch.distributed as dist

torch.set_num_threads(1)

from sttode_tpu_torch import bridge  # noqa: E402
from sttode_tpu_torch.models import sttode as tm  # noqa: E402
from sttode_tpu_torch.nn.attention import geodesic_attention  # noqa: E402
from sttode_tpu_torch.parallel import (make_mesh, param_sharding,  # noqa: E402
                                       shard_batch)
from sttode_tpu_torch.parallel import collectives  # noqa: E402
from sttode_tpu_torch.parallel.mesh import (axis_size,  # noqa: E402
                                            make_hybrid_mesh, mesh_shape)
from sttode_tpu_torch.parallel.ring_attention import (  # noqa: E402
    resolve_sp_axes, ring_geodesic_attention)
from sttode_tpu_torch.train import (make_sampler_train_step,  # noqa: E402
                                    make_train_step, stack_batches)

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
    """The ring on this rank's blocks of q, k, v and the key validity;
    returns the assembled output and the gradients of sum(out²)."""
    tok, b_ax = resolve_sp_axes(mesh, "data")
    t, n = mesh.get_local_rank(tok), axis_size(mesh, tok)
    bi, bn = (mesh.get_local_rank(b_ax), axis_size(mesh, b_ax)) \
        if b_ax else (0, 1)

    def local(x):
        return _block(_block(x, 0, bi, bn), 1, t, n)

    q, k, v = (_leaf(local(case[name])) for name in ("q", "k", "v"))
    out = ring_geodesic_attention(q, k, v, mesh, kv_valid=local(case["val"]),
                                  metric=case["metric"],
                                  curvature=case["curvature"])
    torch.sum(out ** 2).backward()
    parts = _gather_objects((bi, t, out.detach(), q.grad, k.grad, v.grad))
    full = {"out": torch.zeros_like(case["q"]), "dq": torch.zeros_like(
        case["q"]), "dk": torch.zeros_like(case["k"]),
        "dv": torch.zeros_like(case["v"])}
    for bi_, t_, *blocks in parts:
        for name, blk in zip(("out", "dq", "dk", "dv"), blocks):
            _block(_block(full[name], 0, bi_, bn), 1, t_, n).copy_(blk)
    return {name: x.numpy() for name, x in full.items()}


def _sum_grads(params, group):
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in bridge.tree_leaves(params)]
    return [collectives.all_reduce(g.clone(), group).numpy() for g in grads]


def forward(case, mesh):
    """``sttode_forward(mesh=)`` on this rank's scenes: the losses (and
    whether every rank has the same), the summed gradient leaves."""
    cfg = tm.STTODEConfig(**case["cfg"])
    params = bridge.tree_map(_leaf, case["params"])
    out = tm.sttode_forward(params, cfg, shard_batch(case["batch"], mesh),
                            noise=case["noise"], mesh=mesh)
    out.total_loss.backward()
    losses = {name: float(getattr(out, name)) for name in LOSSES}
    return {"losses": losses,
            "same_on_ranks": all(x == losses for x in
                                 _gather_objects(losses)),
            "grads": _sum_grads(params, mesh.get_group("data"))}


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


def step(case, mesh):
    """``make_train_step(mesh=)`` for the case's steps with its injected
    global noise: the metrics of each step, the final parameters and
    whether they are equal on every rank."""
    cfg = tm.STTODEConfig(**case["cfg"])
    opt = _sgd(case["lr"]) if case["optimizer"] == "sgd" else None
    stp = make_train_step(cfg, case["lr"], device="cpu", mesh=mesh,
                          optimizer=opt)
    # every rank but 0 starts from other values: init gives rank 0's
    params = case["params"] if dist.get_rank() == 0 else bridge.tree_map(
        lambda t: t + 1.0, case["params"])
    params, state = stp.init(params)
    metrics = []
    for batch, noise in zip(case["batches"], case["noises"]):
        params, state, m = stp(params, state, shard_batch(batch, mesh),
                               noise=noise)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics,
            "same_metrics": all(x == metrics for x in
                                _gather_objects(metrics)),
            "params": [p.detach().numpy() for p in
                       bridge.tree_leaves(params)],
            "equal_on_ranks": _equal_on_ranks(params)}


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
    return {"shapes": shapes,
            "stacked": (tuple(stacked.past.shape), stacked.batch_size),
            "placements": sorted({type(p).__name__ for p in placements}),
            "raised": {
        "tp_step": _outcome(lambda: make_train_step(
            cfg, 1e-3, device="cpu", mesh=mesh, tp=True)),
        "tp_sharding": _outcome(lambda: param_sharding(params, mesh,
                                                       tp=True)),
        "scan_steps": _outcome(lambda: make_train_step(
            cfg, 1e-3, device="cpu", mesh=mesh, scan_steps=2)),
        "sampler": _outcome(lambda: make_sampler_train_step(
            cfg, None, 1e-3, params, device="cpu", mesh=mesh)),
        "dopri5": _outcome(lambda: make_train_step(
            cfg._replace(ode_method="dopri5"), 1e-3, device="cpu",
            mesh=mesh)),
        "seq_axis": _outcome(lambda: make_train_step(
            cfg, 1e-3, device="cpu", mesh=seq_mesh)),
        "ulysses": _outcome(lambda: cfg._replace(
            attn_impl="ulysses").validate()),
        "ring_dropout": _outcome(lambda: geodesic_attention(
            x, x, x, fused="ring", mesh=mesh, dropout_rate=0.1,
            dropout_mask=torch.ones(2, 2, 4, 4, dtype=torch.bool))),
        "mesh_dp0": _outcome(lambda: make_mesh(tp=2 * world)),
        "mesh_too_big": _outcome(lambda: make_mesh(dp=world + 1)),
        "odd_batch": _outcome(lambda: shard_batch(
            case["odd_batch"], mesh))}}


RUNNERS = {"ring": ring, "forward": forward, "step": step,
           "generator_step": generator_step, "inference": inference,
           "refusals": refusals}


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
