"""Fixed-grid ODE solvers (port of ``sttode_tpu/ode/solvers.py::odeint`` for
euler, midpoint and rk4).

As in torchdiffeq and the JAX package, the ``ts`` grid itself is the step
grid (reference quirk Q1: Euler over [0, 12] is one step). The adaptive
dopri5 solver and the continuous adjoint are not ported yet.
"""

from __future__ import annotations

from typing import Callable

import torch


def _euler_step(func, t0, dt, y0, args):
    return y0 + dt * func(t0, y0, *args)


def _midpoint_step(func, t0, dt, y0, args):
    k1 = func(t0, y0, *args)
    k2 = func(t0 + dt / 2, y0 + (dt / 2) * k1, *args)
    return y0 + dt * k2


def _rk4_step(func, t0, dt, y0, args):
    k1 = func(t0, y0, *args)
    k2 = func(t0 + dt / 2, y0 + (dt / 2) * k1, *args)
    k3 = func(t0 + dt / 2, y0 + (dt / 2) * k2, *args)
    k4 = func(t0 + dt, y0 + dt * k3, *args)
    return y0 + (dt / 6) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


_STEPPERS = {"euler": _euler_step, "midpoint": _midpoint_step,
             "rk4": _rk4_step}


def odeint(func: Callable, y0: torch.Tensor, ts: torch.Tensor, *args,
           method: str = "euler") -> torch.Tensor:
    """Integrate dy/dt = func(t, y, *args); returns y at every ``ts``
    stacked on a new leading axis. ``ts`` is a float32 grid; each step size
    is the float32 difference of neighbouring points, as in the JAX solver."""
    if method not in _STEPPERS:
        raise NotImplementedError(
            f"ode method {method!r} is not ported (euler/midpoint/rk4)")
    stepper = _STEPPERS[method]
    ys = [y0]
    t = ts.to(torch.float32).tolist()
    dts = (ts[1:] - ts[:-1]).to(torch.float32).tolist()
    for t0, dt in zip(t[:-1], dts):
        ys.append(stepper(func, t0, dt, ys[-1], args))
    return torch.stack(ys)
