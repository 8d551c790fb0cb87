"""ODE solvers of the port: the fixed grid, dopri5 and the continuous
adjoint."""

from sttode_tpu_torch.ode.solvers import (exhaustion_flag, matmul_precision,
                                          odeint, odeint_adjoint,
                                          warn_exhausted)

__all__ = ["exhaustion_flag", "matmul_precision", "odeint", "odeint_adjoint",
           "warn_exhausted"]
