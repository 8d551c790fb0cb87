"""Manifolds used by the port (oblique only; poincaré is not ported yet)."""

from sttode_tpu_torch.manifolds import oblique

__all__ = ["oblique"]
