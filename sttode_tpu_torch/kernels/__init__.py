"""Hand-written CUDA kernels of the port, with their plain PyTorch versions:
``mhgsa.fused_geodesic_attention`` and
``packed_mhgsa.packed_geodesic_attention`` (forward and backward each) and
``select_decode.select_decode`` (fp32 and bf16 storage).

Nothing here is compiled at import; ``_build.load()`` compiles at the first
launch."""
