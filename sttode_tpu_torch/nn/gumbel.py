"""Gumbel-softmax dictionary MLPs (port of ``sttode_tpu/nn/gumbel.py``): an
MLP whose output is a (relaxed) one-hot code over a learned dictionary of
edge-type embeddings, gated by a sigmoid factor of the input.

Where JAX draws Gumbel noise from a key, the port takes the draw itself
(``gumbel``, the tests hand both frameworks the same one) or a
``torch.Generator`` on the logits' device.
"""

from __future__ import annotations

import torch

from sttode_tpu_torch.nn import core
from sttode_tpu_torch.utils.distributions import gumbel_noise


def gumbel_softmax(logits: torch.Tensor, *,
                   generator: torch.Generator | None = None,
                   gumbel: torch.Tensor | None = None,
                   temperature: float = 1.0,
                   hard: bool = False) -> torch.Tensor:
    """A reparameterized draw of the concrete (Gumbel-softmax) distribution
    over the last axis; with ``hard`` the one-hot of its argmax, with the
    relaxed draw's gradient (straight-through)."""
    g = gumbel_noise(logits, generator, gumbel)
    y = torch.softmax((logits + g) / temperature, dim=-1)
    if hard:
        one_hot = torch.nn.functional.one_hot(
            y.argmax(dim=-1), y.shape[-1]).to(y.dtype)
        y = y + (one_hot - y).detach()
    return y


def mlp_dict_init(gen, input_dim: int, hidden, *, edge_types: int = 10,
                  embed_dim: int | None = None, dtype=torch.float32) -> dict:
    """The logit MLP, a dictionary of ``edge_types`` embeddings
    (N(0, 0.1²)) and the factor gate."""
    if embed_dim is None:
        embed_dim = edge_types
    return {
        "mlp": core.mlp_init(gen, input_dim, list(hidden), edge_types,
                             dtype),
        "dictionary": 0.1 * torch.randn((edge_types, embed_dim),
                                        generator=gen, dtype=dtype),
        "factor": core.dense_init(gen, input_dim, 1, dtype),
    }


def mlp_dict(params: dict, x: torch.Tensor, *,
             generator: torch.Generator | None = None,
             gumbel: torch.Tensor | None = None, temperature: float = 0.5,
             hard: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """x → edge-type logits → Gumbel one-hot code → dictionary lookup,
    gated by sigmoid(factor(x)). Returns (gated embedding, code)."""
    logits = core.mlp(params["mlp"], x)
    code = gumbel_softmax(logits, generator=generator, gumbel=gumbel,
                          temperature=temperature, hard=hard)
    embed = code @ params["dictionary"]
    factor = torch.sigmoid(core.dense(params["factor"], x))
    return factor * embed, code


def mlp_dict_softmax(params: dict,
                     x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The deterministic variant: a plain softmax code over the
    dictionary."""
    logits = core.mlp(params["mlp"], x)
    code = torch.softmax(logits, dim=-1)
    embed = code @ params["dictionary"]
    factor = torch.sigmoid(core.dense(params["factor"], x))
    return factor * embed, code
