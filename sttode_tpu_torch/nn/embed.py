"""Positional agent encoding (port of ``sttode_tpu/nn/embed.py``).

Sinusoidal time encoding concatenated with the features and fused by a
linear layer. The dropout that follows it in training is inactive at
inference, the only mode this port runs.
"""

from __future__ import annotations

import numpy as np
import torch

from sttode_tpu_torch.nn import core


def positional_encoding_table(max_len: int, d_model: int) -> torch.Tensor:
    """Standard sin/cos table [max_len, d_model] (computed in numpy float32,
    exactly as the JAX package does)."""
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float32)
                      * (-np.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model), dtype=np.float32)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return torch.from_numpy(pe)


def positional_agent_encoding_init(gen, d_model: int, max_t_len: int = 200,
                                   dtype=torch.float32) -> dict:
    return {"fc": core.dense_init(gen, 2 * d_model, d_model, dtype),
            "pe": positional_encoding_table(max_t_len, d_model).to(dtype)}


def positional_agent_encoding(params: dict, x: torch.Tensor, *,
                              t_offset: int = 0) -> torch.Tensor:
    """x: [..., T, D] → concat time PE → fuse linear → [..., T, D]."""
    T = x.shape[-2]
    pe = params["pe"][t_offset:t_offset + T].expand(x.shape)
    return core.dense(params["fc"], torch.cat([x, pe], dim=-1))
