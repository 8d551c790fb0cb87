"""Hand-written CUDA kernels of the port, with their plain PyTorch versions:
``mhgsa.fused_geodesic_attention`` (forward and backward) and
``select_decode.select_decode`` (fp32 and bf16 storage).

Nothing here is compiled at import; ``_build.load()`` compiles at the first
launch."""
