"""Native (C++) host components of the port: the sliding-window trajectory
preprocessor of the ETH-UCY loader, the port's own copy of
``sttode_tpu/native/windowing.cpp``, built with ``g++`` at first use."""

from sttode_tpu_torch.native.binding import native_available, window_file

__all__ = ["native_available", "window_file"]
