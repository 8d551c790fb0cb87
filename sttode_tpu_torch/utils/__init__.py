"""Utilities used by the port's serving path."""

from sttode_tpu_torch.utils.distributions import DiagNormal

__all__ = ["DiagNormal"]
