"""GRU and temporal Conv1d (port of ``sttode_tpu/nn/recurrent.py``).

- GRU: torch gate equations (r, z, n; the hidden bias inside r·(W_hn h)),
  weights in the JAX layout ``w_ih [D, 3H]``, ``w_hh [H, 3H]``, h0 = 0, the
  input projection hoisted out of the time loop.
- Conv1d: stride-1 cross-correlation over [B, T, C_in] with the weight in
  WIO layout ``[K, C_in, C_out]``, written as ONE matmul over the K shifted
  copies of the input. It does not go through cuDNN, whose fp32 convolutions
  run in TF32 by default on the card; every plain matmul of the port runs in
  full fp32 (PyTorch's default ``torch.backends.cuda.matmul.allow_tf32 =
  False``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from sttode_tpu_torch.nn import core


class GRUParams(NamedTuple):
    w_ih: torch.Tensor  # [D, 3H] (gate order r, z, n)
    w_hh: torch.Tensor  # [H, 3H]
    b_ih: torch.Tensor  # [3H]
    b_hh: torch.Tensor  # [3H]


class Conv1dParams(NamedTuple):
    w: torch.Tensor  # [K, C_in, C_out]
    b: torch.Tensor  # [C_out]


def gru_init(gen, input_dim: int, hidden_dim: int,
             dtype=torch.float32) -> GRUParams:
    """kaiming_normal weights, zero biases (the DecomposeBlock's init)."""
    return GRUParams(
        w_ih=core.kaiming_normal(gen, input_dim, 3 * hidden_dim, dtype),
        w_hh=core.kaiming_normal(gen, hidden_dim, 3 * hidden_dim, dtype),
        b_ih=torch.zeros(3 * hidden_dim, dtype=dtype),
        b_hh=torch.zeros(3 * hidden_dim, dtype=dtype))


def conv1d_init(gen, c_in: int, c_out: int, kernel: int,
                dtype=torch.float32) -> Conv1dParams:
    """kaiming_normal (fan_in = C_in·K) weights, zero bias."""
    std = math.sqrt(2.0 / (c_in * kernel))
    return Conv1dParams(
        w=std * torch.randn((kernel, c_in, c_out), generator=gen, dtype=dtype),
        b=torch.zeros(c_out, dtype=dtype))


def _gru_gates(gi: torch.Tensor, gh: torch.Tensor,
               h: torch.Tensor) -> torch.Tensor:
    i_r, i_z, i_n = gi.chunk(3, dim=-1)
    h_r, h_z, h_n = gh.chunk(3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1.0 - z) * n + z * h


def gru_cell(params: GRUParams, h: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """One GRU step: x [..., D], h [..., H] → the new h."""
    return _gru_gates(x @ params.w_ih + params.b_ih,
                      h @ params.w_hh + params.b_hh, h)


def gru(params: GRUParams, xs: torch.Tensor,
        h0: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """xs [B, T, D] → (ys [B, T, H], h_T [B, H]). The input projection of
    every step is one matmul before the time loop; each step applies the
    gates that ``gru_cell`` applies."""
    B, T, _ = xs.shape
    H = params.w_hh.shape[0]
    h = xs.new_zeros((B, H)) if h0 is None else h0
    gi_all = xs @ params.w_ih + params.b_ih                  # [B, T, 3H]
    ys = []
    for t in range(T):
        h = _gru_gates(gi_all[:, t], h @ params.w_hh + params.b_hh, h)
        ys.append(h)
    return torch.stack(ys, dim=1), h


def conv1d(params: Conv1dParams, x: torch.Tensor, *,
           padding: int = 1) -> torch.Tensor:
    """x [B, T, C_in] → [B, T', C_out], stride 1."""
    k_size, c_in, c_out = params.w.shape
    xp = F.pad(x, (0, 0, padding, padding))
    t_out = xp.shape[1] - k_size + 1
    cols = torch.cat([xp[:, j:j + t_out] for j in range(k_size)], dim=-1)
    return cols @ params.w.reshape(k_size * c_in, c_out) + params.b
