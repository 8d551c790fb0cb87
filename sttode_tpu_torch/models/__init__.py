"""The STTODE model of the port (training forward and inference)."""

from sttode_tpu_torch.models.sttode import (Batch, ForwardOutput,
                                            STTODEConfig, TrainNoise, decode,
                                            decode_block0_state, encode_future,
                                            encode_past, prior, sttode_forward,
                                            sttode_inference, sttode_init)

__all__ = ["Batch", "ForwardOutput", "STTODEConfig", "TrainNoise", "decode",
           "decode_block0_state", "encode_future", "encode_past", "prior",
           "sttode_forward", "sttode_inference", "sttode_init"]
