"""The models of the port: the STTODE CVAE (training forward and inference)
and the DLow diversity sampler of stage 2."""

from sttode_tpu_torch.models.sttode import (Batch, ForwardOutput,
                                            STTODEConfig, TrainNoise, decode,
                                            decode_block0_state, encode_future,
                                            encode_past, prior, sttode_forward,
                                            sttode_inference, sttode_init)
from sttode_tpu_torch.models.sampler import (DIVERSITY_CONFIG, SamplerConfig,
                                             SamplerOutput, sampler_forward,
                                             sampler_init, sampler_loss)

__all__ = ["Batch", "ForwardOutput", "STTODEConfig", "TrainNoise", "decode",
           "decode_block0_state", "encode_future", "encode_past", "prior",
           "sttode_forward", "sttode_inference", "sttode_init",
           "DIVERSITY_CONFIG", "SamplerConfig", "SamplerOutput",
           "sampler_forward", "sampler_init", "sampler_loss"]
