"""ODE solvers of the port (fixed grid)."""

from sttode_tpu_torch.ode.solvers import odeint

__all__ = ["odeint"]
