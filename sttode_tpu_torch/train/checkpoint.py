"""Checkpoints of the port (the role of ``sttode_tpu/train/checkpoint.py``,
in a ``torch.save`` format).

One file per checkpoint, ``<ckpt_dir>/model_%04d.pt`` (the JAX package's
``CKPT_FMT`` directory name plus a suffix), holding the parameter tree, the
Adam ``state_dict``, the epoch and the config (``STTODEConfig`` or, for a
stage-2 sampler under ``<ckpt_dir>/sampler/``, ``SamplerConfig``) as JSON
with its type's name, so that evaluation rebuilds the model from the
checkpoint alone (the reference's
reconstruct-from-checkpoint property). The tree is stored as plain dicts and
lists (parameter NamedTuples become tagged dicts), so the file loads with
``torch.load(weights_only=True)``: no pickled classes. A save writes a
temporary file beside the target and renames it into place, so a half-written
file is never listed or read. The optimizer state is stored device-free
(tensors on the CPU, the learning rate a float, ``capturable`` off), so a
file is the same whatever device and ``scan_steps`` wrote it, and resumes
on either. ``save_checkpoint(..., background=True)`` (``--async_ckpt``)
snapshots the state to host memory and writes the file from a background
thread, JAX's contract: a new save first waits for the one in flight,
``keep_last`` prunes only after the new file is in place, and
``wait_for_saves`` / ``flush_saves`` (the same here: the file has no
sidecars) and ``load_checkpoint`` wait for it. Reading a JAX orbax
checkpoint is not ported.

A file holds no topology, so any world size restores what any other
saved: under data parallelism ``load_checkpoint(shardings=
restore_shardings(template, mesh))`` lands every leaf on each rank's
device, replicated from rank 0 (``param_sharding``'s placement).
"""

from __future__ import annotations

import json
import os
import re
import threading
import time

import torch
from torch.distributed.tensor import Replicate

from sttode_tpu_torch import bridge
from sttode_tpu_torch.models.sampler import SamplerConfig
from sttode_tpu_torch.models.sttode import STTODEConfig
from sttode_tpu_torch.parallel import collectives
from sttode_tpu_torch.parallel.mesh import TP_NOT_PORTED, param_sharding

CKPT_FMT = "model_{:04d}"
SUFFIX = ".pt"
_NAME = re.compile(r"model_(\d{4,})\.pt")
_TMP = re.compile(r"model_\d{4,}\.pt\.tmp\.\d+")
ORPHAN_GRACE_S = 900.0   # a save's write is seconds; 15 min is ample margin
_TAG = "__namedtuple__"
_CONFIGS = {cls.__name__: cls for cls in (STTODEConfig, SamplerConfig)}


def checkpoint_path(ckpt_dir: str, epoch: int) -> str:
    return os.path.join(ckpt_dir, CKPT_FMT.format(epoch) + SUFFIX)


def _to_plain(tree):
    if isinstance(tree, dict):
        return {k: _to_plain(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {_TAG: type(tree).__name__,
                **{f: _to_plain(getattr(tree, f)) for f in tree._fields}}
    if isinstance(tree, (list, tuple)):
        return [_to_plain(v) for v in tree]
    return tree.detach().to("cpu", copy=True)


def _from_plain(tree):
    if isinstance(tree, dict) and _TAG in tree:
        cls = bridge._NAMEDTUPLES[tree[_TAG]]
        return cls(*(_from_plain(tree[f]) for f in cls._fields))
    if isinstance(tree, dict):
        return {k: _from_plain(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_from_plain(v) for v in tree]
    return tree


def _config_to_json(cfg: STTODEConfig | SamplerConfig) -> str:
    return json.dumps({"type": type(cfg).__name__, **cfg._asdict()})


def _config_from_json(s: str) -> STTODEConfig | SamplerConfig:
    """The config class named by the JSON's type tag. JSON round-trips
    tuples as lists; fields the config does not know are dropped and
    missing ones take its defaults, as in the JAX package."""
    d = json.loads(s)
    kind = d.pop("type")
    if kind not in _CONFIGS:
        raise ValueError(f"unknown checkpoint config type {kind!r}")
    cls = _CONFIGS[kind]
    return cls(**{k: tuple(v) if isinstance(v, list) else v
                  for k, v in d.items() if k in cls._fields})


def checkpoint_epochs(ckpt_dir: str) -> list[int]:
    """Epochs of the complete checkpoints under ``ckpt_dir``, ascending
    (temporary files of a save in progress are not listed)."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.fullmatch,
                                               os.listdir(ckpt_dir)) if m)


def latest_checkpoint(ckpt_dir: str) -> str | None:
    """Path of the newest complete checkpoint, or None."""
    epochs = checkpoint_epochs(ckpt_dir)
    return checkpoint_path(ckpt_dir, epochs[-1]) if epochs else None


def _opt_to_plain(opt: torch.optim.Optimizer) -> dict:
    """The optimizer's ``state_dict`` copied to the CPU, device-free: the
    learning rate a float and ``capturable`` off (``TrainStep.init`` puts
    an Adam on the card back into its capturable form)."""
    sd = opt.state_dict()
    state = {i: {k: v.detach().to("cpu", copy=True)
                 if isinstance(v, torch.Tensor) else v
                 for k, v in st.items()} for i, st in sd["state"].items()}
    groups = [{**g, "lr": float(g["lr"]),
               **({"capturable": False} if "capturable" in g else {})}
              for g in sd["param_groups"]]
    return {"state": state, "param_groups": groups}


# the background save in flight: its thread and the error it raised
_inflight: dict = {"thread": None, "error": None}


def wait_for_saves() -> None:
    """Block until the background save in flight (if any) has committed;
    re-raise its error."""
    thread = _inflight["thread"]
    if thread is not None:
        thread.join()
        _inflight["thread"] = None
    err, _inflight["error"] = _inflight["error"], None
    if err is not None:
        raise err


# JAX's flush also writes deferred sidecars and prunes; the port's file has
# no sidecars and its save prunes after its own commit
flush_saves = wait_for_saves


def prune_checkpoints(ckpt_dir: str, keep_last: int) -> list[str]:
    """Delete all but the newest ``keep_last`` complete checkpoints under
    ``ckpt_dir`` (all of them when ``keep_last`` ≤ 0) and return the
    removed paths. A save's temporary file is not a checkpoint; one left
    by a crashed save (crash debris, as JAX's orphaned directories are) is
    swept once it is older than ``ORPHAN_GRACE_S``, so that a save in
    flight, in this process or another, is never touched."""
    removed = []
    epochs = checkpoint_epochs(ckpt_dir)
    for e in epochs[:-keep_last] if keep_last > 0 else epochs:
        p = checkpoint_path(ckpt_dir, e)
        os.remove(p)
        removed.append(p)
    now = time.time()
    for name in os.listdir(ckpt_dir) if os.path.isdir(ckpt_dir) else ():
        if not _TMP.fullmatch(name):
            continue
        p = os.path.join(ckpt_dir, name)
        try:
            if now - os.path.getmtime(p) < ORPHAN_GRACE_S:
                continue
            os.remove(p)
        except OSError:
            continue   # vanished mid-scan: another process owns it
        removed.append(p)
    return removed


def _write(payload: dict, ckpt_dir: str, path: str,
           keep_last: int | None) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    if keep_last is not None:
        prune_checkpoints(ckpt_dir, max(keep_last, 1))


def _write_in_background(*args) -> None:
    try:
        _write(*args)
    except BaseException as e:  # noqa: BLE001 — re-raised by wait_for_saves
        _inflight["error"] = e


def save_checkpoint(ckpt_dir: str, epoch: int, params,
                    opt: torch.optim.Optimizer,
                    cfg: STTODEConfig | SamplerConfig,
                    keep_last: int | None = None, *,
                    background: bool = False) -> str:
    """Write ``<ckpt_dir>/model_%04d.pt`` with the parameters and the
    optimizer's state (copied to the CPU), the epoch and the config; return
    its path. ``keep_last`` then deletes all but the newest that many
    checkpoints (at least one: the one just written). A save first waits
    for a background save in flight. ``background=True`` returns once the
    state is copied to host memory and writes the file from a background
    thread (``wait_for_saves`` joins it)."""
    wait_for_saves()
    os.makedirs(ckpt_dir, exist_ok=True)
    path = checkpoint_path(ckpt_dir, epoch)
    payload = {"params": _to_plain(params), "opt_state": _opt_to_plain(opt),
               "epoch": int(epoch), "config": _config_to_json(cfg)}
    if background:
        thread = threading.Thread(target=_write_in_background, args=(
            payload, ckpt_dir, path, keep_last), name="save_checkpoint")
        _inflight["thread"] = thread
        thread.start()
    else:
        _write(payload, ckpt_dir, path, keep_last)
    return path


def restore_shardings(template: dict, mesh, *, tp: bool = False) -> dict:
    """The restoring topology's placements for
    ``load_checkpoint(shardings=...)``: ``{"params": ..., "opt_state":
    ...}`` of ``param_sharding``'s ``Replicate()`` leaves in the structure
    of ``template``'s (a checkpoint's params and optimizer ``state_dict``;
    "epoch" and None entries are left out). ``tp=True`` (the "model"
    axis' rules) raises NotImplementedError."""
    if tp:
        raise NotImplementedError(TP_NOT_PORTED)
    return {k: param_sharding(v, mesh) for k, v in template.items()
            if k in ("params", "opt_state") and v is not None}


def _replicate(tree, placements) -> None:
    """Broadcast every tensor leaf of ``tree`` from rank 0, in place; its
    placement in ``placements`` (a tree of the same structure) must be
    ``Replicate()``."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            if k in placements:
                _replicate(v, placements[k])
    elif isinstance(tree, (list, tuple)):
        for v, p in zip(tree, placements):
            _replicate(v, p)
    elif isinstance(tree, torch.Tensor):
        if not isinstance(placements, Replicate):
            raise NotImplementedError(f"placement {placements!r}: only "
                                      f"Replicate() is ported")
        collectives.broadcast(tree, 0, None)


def load_checkpoint(path: str, device: torch.device | str = "cpu", *,
                    shardings: dict | None = None):
    """Restore (params, optimizer state_dict, epoch, cfg); the tensors land
    on ``device``. Load the state into an optimizer over the restored
    parameters with ``TrainStep.init(params, opt_state)``. A background
    save in flight is waited for first. ``shardings``
    (``restore_shardings``; every rank of the world calls this) replicates
    the placed leaves from rank 0, so that every rank holds rank 0's
    values, equal bit for bit, whatever world size saved the file."""
    wait_for_saves()
    ck = torch.load(path, map_location=device, weights_only=True)
    params, opt_state = _from_plain(ck["params"]), ck["opt_state"]
    if shardings is not None:
        for key, tree in (("params", params), ("opt_state", opt_state)):
            if key in shardings:
                _replicate(tree, shardings[key])
    return params, opt_state, int(ck["epoch"]), _config_from_json(
        ck["config"])
