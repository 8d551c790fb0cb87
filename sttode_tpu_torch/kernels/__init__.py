"""Hand-written CUDA kernels of the port, with their plain PyTorch versions:
``mhgsa.fused_geodesic_attention`` (whole-S),
``mhgsa.flash_geodesic_attention`` (S-tiled) and
``packed_mhgsa.packed_geodesic_attention`` (forward and backward each) and
``select_decode.select_decode`` (fp32 and bf16 storage).

Nothing here is compiled at import; ``_build.load()`` compiles at the first
launch."""

from sttode_tpu_torch.kernels.mhgsa import (flash_geodesic_attention,
                                            fused_geodesic_attention)

__all__ = ["flash_geodesic_attention", "fused_geodesic_attention"]
