"""ODE-wrapped transformer blocks (port of ``sttode_tpu/nn/ode_block.py``:
``ode_encoder``, ``ode_decoder``).

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

from sttode_tpu_torch.nn.transformer import (DecoderDropMasks, LayerConfig,
                                             LayerDropMasks, decoder_stack,
                                             encoder_stack)
from sttode_tpu_torch.ode import odeint, odeint_adjoint


def _grid(time: float, steps: int, y: torch.Tensor,
          method: str) -> torch.Tensor:
    """The solve's output grid over [0, time]. dopri5 keeps its time
    arithmetic on the state's device: the grid is made there (a host grid
    would be copied to the device, a host sync that a CUDA graph capture
    refuses); the fixed grid is read on the host."""
    return torch.linspace(0.0, time, steps + 1, dtype=torch.float64
                          if y.dtype == torch.float64 else torch.float32,
                          device=y.device if method == "dopri5" else "cpu")


def ode_encoder(params: list, src: torch.Tensor, cfg: LayerConfig, *,
                time: float = 12.0, method: str = "euler", steps: int = 1,
                mask: torch.Tensor | None = None,
                kv_valid: torch.Tensor | None = None,
                drop: list[LayerDropMasks] | None = None,
                adjoint: bool = False, rtol: float = 1e-7,
                atol: float = 1e-9,
                scan_budget: int | None = None,
                mesh=None, ring_axis: str | None = "data",
                group=None) -> torch.Tensor:
    """ODE-integrated encoder over [L, N, S, D] tokens, ReLU epilogue.
    ``steps`` is the fixed grid's density over [0, time]; ``drop`` the
    layers' dropout keep-masks (None: no dropout); ``mesh`` and
    ``ring_axis`` the layers' (``nn.transformer.encoder_layer``);
    ``group`` the process group over whose ranks the tokens' rows are
    split (dopri5's error norms are the whole state's, ``ode.odeint``)."""
    def rhs(t, y, p):
        del t    # autonomous field
        return encoder_stack(p, y, cfg, mask=mask, kv_valid=kv_valid,
                             drop=drop, mesh=mesh, ring_axis=ring_axis)

    ts = _grid(time, steps, src, method)
    integrate = odeint_adjoint if adjoint else odeint
    z = integrate(rhs, src, ts, params, method=method, rtol=rtol, atol=atol,
                  scan_budget=scan_budget, group=group)
    return torch.relu(z[-1])


def ode_decoder(params: list, tgt: torch.Tensor, memory: torch.Tensor,
                cfg: LayerConfig, *, time: float = 12.0,
                method: str = "euler", steps: int = 1,
                tgt_mask: torch.Tensor | None = None,
                memory_mask: torch.Tensor | None = None,
                drop: list[DecoderDropMasks] | None = None):
    """ODE-integrated decoder (the reference's ODEG, which its model never
    instantiates): the decoder stack over the fixed ``memory`` is the field,
    integrated over [0, time] with ``steps`` steps of ``method``. Returns
    (relu(z(T)), {"self": weights, "cross": weights}), the weights those of
    one more stack evaluation at z(T), as in JAX (None on a forced kernel
    route)."""
    def rhs(t, y, p):
        del t    # autonomous field
        out, _, _ = decoder_stack(p, y, memory, cfg, tgt_mask=tgt_mask,
                                  memory_mask=memory_mask, drop=drop)
        return out

    z = odeint(rhs, tgt, _grid(time, steps, tgt, method), params,
               method=method)[-1]
    _, sw, cw = decoder_stack(params, z, memory, cfg, tgt_mask=tgt_mask,
                              memory_mask=memory_mask, drop=drop)
    return torch.relu(z), {"self": sw, "cross": cw}
