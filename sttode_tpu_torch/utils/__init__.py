"""Utilities of the port: distributions, the parameter count
(``utils.profiling``) and the NBA horizon table (``utils.metrics``)."""

from sttode_tpu_torch.utils.distributions import DiagNormal

__all__ = ["DiagNormal"]
