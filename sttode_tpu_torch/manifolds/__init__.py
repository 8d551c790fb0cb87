"""Manifolds of the port: the oblique manifold (geodesic attention and the
Riemannian ops), the Euclidean baseline and the Poincaré ball; each a
namespace of functions on tensors."""

from sttode_tpu_torch.manifolds import euclidean, oblique, pmath
from sttode_tpu_torch.manifolds.euclidean import Euclidean
from sttode_tpu_torch.manifolds.oblique import Oblique

__all__ = ["oblique", "euclidean", "pmath", "Oblique", "Euclidean"]
