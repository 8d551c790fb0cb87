"""Functional NN core: initializers and primitive layers over parameter dicts.

Port of ``sttode_tpu/nn/core.py``. Parameters keep the JAX layout: a dense
weight is ``[d_in, d_out]`` and is applied as ``x @ w + b``, so that weights
carried over from the JAX package by ``bridge.params_from_jax`` are used as
they are. Initializers draw from a ``torch.Generator`` with the same
distributions as the JAX ones (the values differ: the generators differ).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F


# --------------------------------------------------------------------------- #
# initializers — each samples a [d_in, d_out] weight (fan_in = d_in)          #
# --------------------------------------------------------------------------- #

def _uniform(gen: torch.Generator, shape, bound: float, dtype) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, dtype=dtype)
    return (2.0 * u - 1.0) * bound


def xavier_uniform(gen, d_in: int, d_out: int,
                   dtype=torch.float32) -> torch.Tensor:
    return _uniform(gen, (d_in, d_out), math.sqrt(6.0 / (d_in + d_out)), dtype)


def torch_linear_weight(gen, d_in: int, d_out: int,
                        dtype=torch.float32) -> torch.Tensor:
    """nn.Linear's default reset: kaiming_uniform(a=√5) → U(±√(1/fan_in))."""
    return _uniform(gen, (d_in, d_out), math.sqrt(1.0 / d_in), dtype)


def torch_linear_bias(gen, d_in: int, d_out: int,
                      dtype=torch.float32) -> torch.Tensor:
    return _uniform(gen, (d_out,), math.sqrt(1.0 / d_in), dtype)


def kaiming_normal(gen, d_in: int, d_out: int,
                   dtype=torch.float32) -> torch.Tensor:
    """kaiming_normal_ defaults (fan_in, gain √2): std = √(2 / fan_in)."""
    return math.sqrt(2.0 / d_in) * torch.randn((d_in, d_out), generator=gen,
                                               dtype=dtype)


def normal_001(gen, d_in: int, d_out: int, dtype=torch.float32) -> torch.Tensor:
    return 0.01 * torch.randn((d_in, d_out), generator=gen, dtype=dtype)


def dense_init(gen, d_in: int, d_out: int, dtype=torch.float32) -> dict:
    return {"w": torch_linear_weight(gen, d_in, d_out, dtype),
            "b": torch_linear_bias(gen, d_in, d_out, dtype)}


def mlp_init(gen, d_in: int, hidden: Sequence[int], d_out: int | None = None,
             dtype=torch.float32) -> dict:
    """An MLP as a list of dense params; with ``d_out`` the last layer is an
    un-activated output head."""
    dims = [d_in, *hidden] + ([d_out] if d_out is not None else [])
    return {"layers": [dense_init(gen, a, b, dtype)
                       for a, b in zip(dims[:-1], dims[1:])]}


def mlp_init_normal001(gen, d_in: int, hidden: Sequence[int],
                       dtype=torch.float32) -> dict:
    """Activated-everywhere MLP with N(0, 0.01²) weights and zero bias."""
    dims = [d_in, *hidden]
    return {"layers": [{"w": normal_001(gen, a, b, dtype),
                        "b": torch.zeros(b, dtype=dtype)}
                       for a, b in zip(dims[:-1], dims[1:])]}


def layer_norm_init(dim: int, dtype=torch.float32) -> dict:
    return {"scale": torch.ones(dim, dtype=dtype),
            "bias": torch.zeros(dim, dtype=dtype)}


# --------------------------------------------------------------------------- #
# layers                                                                      #
# --------------------------------------------------------------------------- #

def dense(p: dict, x: torch.Tensor) -> torch.Tensor:
    """x @ w + b."""
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def layer_norm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Affine layer norm over the last axis (torch default eps 1e-5)."""
    return F.layer_norm(x, (x.shape[-1],), p["scale"], p["bias"], eps)


ACTIVATIONS = {"relu": torch.relu, "tanh": torch.tanh,
               "sigmoid": torch.sigmoid}


def mlp(p: dict, x: torch.Tensor, *, activation: str = "relu",
        activate_final: bool = False) -> torch.Tensor:
    act = ACTIVATIONS[activation]
    n = len(p["layers"])
    for i, lp in enumerate(p["layers"]):
        x = dense(lp, x)
        if i < n - 1 or activate_final:
            x = act(x)
    return x
