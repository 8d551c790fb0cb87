"""ODE-wrapped encoder (port of ``sttode_tpu/nn/ode_block.py::ode_encoder``).

The encoder stack is the vector field. Integrating it with Euler over
[0, time] in one step gives the reference's ``relu(x + 12·layer(x))``
(quirk Q1); rk4, midpoint, adaptive dopri5 (while or scan-budget form) and
the continuous adjoint are the solver's options. The parameters enter the
solver through ``*args`` so that the adjoint returns their cotangents.
Dropout keep-masks are drawn once per solve by the caller and closed over:
every RHS evaluation of a solve, the adjoint's backward solve included,
sees the same masks (JAX closes one key over the RHS), so the field stays
deterministic for the step-size controller.
"""

from __future__ import annotations

import torch

from sttode_tpu_torch.nn.transformer import (LayerConfig, LayerDropMasks,
                                             encoder_stack)
from sttode_tpu_torch.ode import odeint, odeint_adjoint


def ode_encoder(params: list, src: torch.Tensor, cfg: LayerConfig, *,
                time: float = 12.0, method: str = "euler", steps: int = 1,
                mask: torch.Tensor | None = None,
                kv_valid: torch.Tensor | None = None,
                drop: list[LayerDropMasks] | None = None,
                adjoint: bool = False, rtol: float = 1e-7,
                atol: float = 1e-9,
                scan_budget: int | None = None) -> torch.Tensor:
    """ODE-integrated encoder over [L, N, S, D] tokens, ReLU epilogue.
    ``steps`` is the fixed grid's density over [0, time]; ``drop`` the
    layers' dropout keep-masks (None: no dropout)."""
    def rhs(t, y, p):
        del t    # autonomous field
        return encoder_stack(p, y, cfg, mask=mask, kv_valid=kv_valid,
                             drop=drop)

    # dopri5 keeps its time arithmetic on the state's device: the grid is
    # made there (a host grid would be copied to the device, a host sync
    # that a CUDA graph capture refuses); the fixed grid is read on the host
    ts = torch.linspace(0.0, time, steps + 1, dtype=torch.float64
                        if src.dtype == torch.float64 else torch.float32,
                        device=src.device if method == "dopri5" else "cpu")
    integrate = odeint_adjoint if adjoint else odeint
    z = integrate(rhs, src, ts, params, method=method, rtol=rtol, atol=atol,
                  scan_budget=scan_budget)
    return torch.relu(z[-1])
