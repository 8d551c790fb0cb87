"""The STTODE model of the port (inference)."""

from sttode_tpu_torch.models.sttode import (Batch, STTODEConfig, decode,
                                            decode_block0_state, encode_past,
                                            prior, sttode_inference,
                                            sttode_init)

__all__ = ["Batch", "STTODEConfig", "decode", "decode_block0_state",
           "encode_past", "prior", "sttode_inference", "sttode_init"]
