"""Manifolds used by the port: the oblique manifold and the Poincaré ball."""

from sttode_tpu_torch.manifolds import oblique, pmath

__all__ = ["oblique", "pmath"]
