"""The process-group mesh and the placement of batches and parameters (port
of ``sttode_tpu/parallel/mesh.py``).

One process a device: ``init_distributed`` joins the processes that a
launcher (torchrun, or any that sets its environment) started into one
``torch.distributed`` group, and ``make_mesh`` lays the ranks out as a
``DeviceMesh`` with the JAX package's axis names, ("data", "model"), or
("data", "seq", "model") with a sequence axis. The JAX package places
global arrays and XLA inserts the collectives; here every rank holds its
own part and the collectives are explicit (``parallel.collectives``):

- **Data parallelism.** The flattened scene·agent rows M of a ``Batch``
  are split over "data" in contiguous scene-major blocks, in rank order,
  as JAX's ``P("data")`` lays M over devices (``shard_batch``); each block
  holds whole scenes. The parameters are replicated: every rank starts
  from rank 0's values (``replicate``) and runs the same update.
- **Sequence parallelism.** ``ring_attention`` and ``ulysses`` shard the
  token axis of an attention over "seq" (or "data" on the 2-axis mesh).
  On a data × sequence mesh the batch's rows are split over "data" alone,
  alike on the "seq" ranks of a data group, and the model splits them
  over "seq" only inside those attentions (``models.sttode``).
- **Tensor parallelism** (``param_sharding(tp=True)``) is not ported.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, NamedTuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate

from sttode_tpu_torch import bridge
from sttode_tpu_torch.parallel import collectives

TP_NOT_PORTED = ("tensor parallelism (tp=True, the \"model\" axis) is not "
                 "ported yet")


def _world() -> int:
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed: call "
                           "init_distributed() or init_process_group first")
    return dist.get_world_size()


def make_mesh(dp: int | None = None, tp: int = 1, sp: int = 1) -> DeviceMesh:
    """Mesh of shape [dp, tp] over the ranks of the default process group
    (axes "data", "model"), or [dp, sp, tp] (axes "data", "seq", "model")
    when ``sp > 1``; ``dp`` defaults to world // (tp·sp). Rank r sits at
    the row-major position r, as JAX's devices do. Every rank must call it
    with the same arguments (it makes each axis' process groups)."""
    n = _world()
    if dp is None:
        dp = n // (tp * sp)
    if dp < 1:
        raise ValueError(
            f"tp·sp = {tp * sp} exceeds the {n} available devices "
            f"(dp would be 0); shrink tp/sp or pass more devices")
    if dp * tp * sp > n:
        raise ValueError(
            f"mesh {dp}x{sp}x{tp} needs {dp * tp * sp} devices, have {n}")
    # the device type names where DTensor would place shards; the port
    # places nothing through it, the groups are the backend's
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    if sp > 1:
        ranks = torch.arange(dp * sp * tp).reshape(dp, sp, tp)
        return DeviceMesh(device_type, ranks,
                          mesh_dim_names=("data", "seq", "model"))
    ranks = torch.arange(dp * tp).reshape(dp, tp)
    return DeviceMesh(device_type, ranks, mesh_dim_names=("data", "model"))


def make_hybrid_mesh(ici_dp: int, tp: int = 1, dcn_dp: int = 1) -> DeviceMesh:
    """The JAX package's multi-slice mesh, whose "data" axis spans DCN ×
    ICI. With one device a process there is no second level: the
    dcn_dp · ici_dp processes form one "data" axis, hosts in rank order."""
    return make_mesh(dp=dcn_dp * ici_dp, tp=tp)


def mesh_shape(mesh: DeviceMesh) -> dict:
    """{axis name: size}, as JAX's ``Mesh.shape``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_size(mesh: DeviceMesh | None, name: str) -> int:
    """The size of the mesh axis ``name`` (1 without a mesh or axis)."""
    if mesh is None or name not in mesh.mesh_dim_names:
        return 1
    return mesh.size(mesh.mesh_dim_names.index(name))


def axis_rank(mesh: DeviceMesh, name: str) -> int:
    """This process' coordinate on the mesh axis ``name``."""
    return mesh.get_local_rank(name)


def init_distributed(backend: str) -> bool:
    """Join the process group that a launcher described in the environment
    (torchrun's ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``
    and ``LOCAL_RANK``) over ``backend``: "nccl" on the card (this
    process' device is then cuda:LOCAL_RANK) or "gloo". Returns True when
    the world has more than one process; False, having joined nothing,
    when the environment names no world. A collective that waits a minute
    on a rank has lost it: the group's timeout. Must run before the first
    use of the device."""
    if "WORLD_SIZE" not in os.environ or "MASTER_ADDR" not in os.environ:
        return False
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r} (nccl/gloo)")
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(
        backend, init_method="env://", rank=int(os.environ["RANK"]),
        world_size=int(os.environ["WORLD_SIZE"]),
        timeout=datetime.timedelta(seconds=60))
    return dist.get_world_size() > 1


class RowBlock(NamedTuple):
    """This rank's contiguous block of a batch's rows: block ``index`` of
    ``count`` along tensor dimension ``dim`` (0, or 1 for a stacked
    [S, M, ...] batch)."""
    dim: int
    index: int
    count: int


def batch_sharding(mesh: DeviceMesh, *, stacked: bool = False) -> RowBlock:
    """The placement of a ``Batch`` on ``mesh``: its rows split over
    "data", this rank's block by its "data" coordinate (JAX's
    ``P("data")``, or ``P(None, "data")`` for the stacked layout)."""
    return RowBlock(1 if stacked else 0, axis_rank(mesh, "data"),
                    axis_size(mesh, "data"))


def shard_batch(batch, mesh: DeviceMesh, *, stacked: bool = False):
    """This rank's part of a global ``Batch``: its block of whole scenes
    (``batch_size`` // dp of them; ``batch_size`` must divide over "data"),
    the other fields as they are."""
    block = batch_sharding(mesh, stacked=stacked)
    if batch.batch_size % block.count:
        raise ValueError(f"batch_size {batch.batch_size} does not divide "
                         f"over data = {block.count}: a rank holds whole "
                         f"scenes")
    B = batch.batch_size // block.count
    rows = B * batch.agent_num
    return dataclasses.replace(batch, batch_size=B, **{
        f.name: getattr(batch, f.name).narrow(block.dim, block.index * rows,
                                              rows)
        for f in dataclasses.fields(batch)
        if isinstance(getattr(batch, f.name), torch.Tensor)})


def param_sharding(params: Any, mesh: DeviceMesh, *, tp: bool = False):
    """The placement of every parameter leaf on ``mesh``: replicated (a
    ``Replicate()`` a leaf, the tree's structure kept). ``tp=True`` (JAX's
    ``_TP_RULES`` over "model") raises NotImplementedError."""
    if tp:
        raise NotImplementedError(TP_NOT_PORTED)
    del mesh
    return bridge.tree_map(lambda _: Replicate(), params)


def replicate(params: Any, mesh: DeviceMesh) -> Any:
    """Give every rank rank 0's parameter values, in place (the replicated
    placement of ``param_sharding`` over a mesh of the whole world);
    returns ``params``."""
    del mesh
    with torch.no_grad():
        for leaf in bridge.tree_leaves(params):
            collectives.broadcast(leaf, 0, None)
    return params
