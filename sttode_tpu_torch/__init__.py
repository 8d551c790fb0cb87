"""sttode_tpu_torch — the PyTorch/CUDA port of ``sttode_tpu``'s serving path.

The JAX package ``sttode_tpu`` stays the reference; this package mirrors its
module paths, public names and parameter layouts so that the same weights
(carried by ``bridge.params_from_jax``) give the same forecasts.

What is ported: best-of-K inference (``models.sttode.sttode_inference``) and
the ``serving.Predictor`` around it. Two hand-written CUDA kernels carry the
path on an NVIDIA Hopper card:

- ``kernels.mhgsa.fused_geodesic_attention`` — geodesic attention forward;
- ``kernels.select_decode.select_decode`` — the whole two-block decompose
  decode of all K samples.

On CPU tensors every kernel wrapper runs its plain PyTorch version instead;
on CUDA tensors it launches the kernel or raises. Importing this package
builds nothing and needs no CUDA compiler: the kernels are compiled with
``nvcc`` at their first launch (``kernels._build``).

This package never imports ``jax`` or ``sttode_tpu``.
"""

from sttode_tpu_torch.models.sttode import (Batch, STTODEConfig,
                                            sttode_inference, sttode_init)
from sttode_tpu_torch.serving import Predictor

__all__ = ["Batch", "Predictor", "STTODEConfig", "sttode_inference",
           "sttode_init"]
