"""Hand-written CUDA kernels of the port, with their plain PyTorch versions:
``mhgsa.fused_geodesic_attention`` and ``select_decode.select_decode``.

Nothing here is compiled at import; ``_build.load()`` compiles at the first
launch."""
