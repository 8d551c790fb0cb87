"""Layers of the port: the functional core, geodesic attention, transformer
encoder and decoder layers, ODE blocks, embeddings and recurrence, and
(imported by name, as in the JAX package) the Poincaré-ball layers
``nn.hyperbolic``, the dot-product baseline ``nn.dot_attention`` and the
Gumbel dictionaries ``nn.gumbel``. Every layer is an
``*_init(gen, ...) -> params`` and a function over the parameter tree, as
in the JAX package."""

from sttode_tpu_torch.nn import (attention, core, embed, ode_block, recurrent,
                                 transformer)
from sttode_tpu_torch.nn.attention import (MHGSAParams, geodesic_attention,
                                           mhgsa, mhgsa_init)
from sttode_tpu_torch.nn.ode_block import ode_decoder, ode_encoder
from sttode_tpu_torch.nn.transformer import (LayerConfig, decoder_layer,
                                             decoder_layer_init, decoder_stack,
                                             decoder_stack_init, encoder_layer,
                                             encoder_layer_init, encoder_stack,
                                             encoder_stack_init,
                                             gated_attention,
                                             gated_attention_init)

__all__ = [
    "attention", "core", "embed", "ode_block", "recurrent", "transformer",
    "MHGSAParams", "geodesic_attention", "mhgsa", "mhgsa_init",
    "ode_decoder", "ode_encoder", "LayerConfig",
    "decoder_layer", "decoder_layer_init", "decoder_stack",
    "decoder_stack_init", "encoder_layer", "encoder_layer_init",
    "encoder_stack", "encoder_stack_init", "gated_attention",
    "gated_attention_init",
]
