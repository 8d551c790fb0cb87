"""ODE solvers of the port: the fixed grid, dopri5 and the continuous
adjoint."""

from sttode_tpu_torch.ode.solvers import matmul_precision, odeint, odeint_adjoint

__all__ = ["matmul_precision", "odeint", "odeint_adjoint"]
