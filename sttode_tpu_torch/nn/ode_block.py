"""ODE-wrapped encoder (port of ``sttode_tpu/nn/ode_block.py::ode_encoder``).

The encoder stack is the vector field; integrating it with Euler over
[0, time] in one step gives the reference's ``relu(x + 12·layer(x))``
(quirk Q1).
"""

from __future__ import annotations

import torch

from sttode_tpu_torch.nn.transformer import LayerConfig, encoder_stack
from sttode_tpu_torch.ode import odeint


def ode_encoder(params: list, src: torch.Tensor, cfg: LayerConfig, *,
                time: float = 12.0, method: str = "euler", steps: int = 1,
                mask: torch.Tensor | None = None) -> torch.Tensor:
    """ODE-integrated encoder over [L, N, S, D] tokens, ReLU epilogue."""
    def rhs(t, y, p):
        del t    # autonomous field
        return encoder_stack(p, y, cfg, mask=mask)

    ts = torch.linspace(0.0, time, steps + 1, dtype=torch.float32)
    return torch.relu(odeint(rhs, src, ts, params, method=method)[-1])
