"""Geodesic transformer encoder (port of ``sttode_tpu/nn/transformer.py``:
``gated_attention``, ``encoder_layer``, ``encoder_stack``).

Tokens are 4-D ``[L, N, S, D]`` as in the JAX package: L is the attended
token axis, N·S the batch. The layer's own dropout is not ported
(``STTODEConfig.validate`` refuses ``dropout > 0``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sttode_tpu_torch.nn import core
from sttode_tpu_torch.nn.attention import MHGSAParams, mhgsa, mhgsa_init


class GatedAttentionParams(NamedTuple):
    attn: MHGSAParams
    info: dict   # dense d_model -> d_model
    gate: dict   # dense d_model -> d_model


class FFNParams(NamedTuple):
    linear1: dict
    linear2: dict


class EncoderLayerParams(NamedTuple):
    self_attn: GatedAttentionParams
    ffn: FFNParams
    norm1: dict
    norm2: dict


class LayerConfig(NamedTuple):
    """Static hyperparameters of one layer. ``attn_impl``: "auto" (the CUDA
    kernels on CUDA tensors, routed by shape), "fused", "packed" or "flash"
    (one kernel forced) or "dense" (plain path). ``dropout`` is carried for
    configs but must be 0 (not ported)."""
    d_model: int = 64
    num_heads: int = 8
    ff_dim: int = 1024
    dropout: float = 0.0
    activation: str = "relu"
    compat: str = "reference"
    attn_impl: str = "auto"
    attn_metric: str = "oblique"
    curvature: float = 1.0


_ATTN_IMPL_TO_FUSED = {"auto": "auto", "dense": False, "fused": True,
                       "packed": "packed", "flash": "flash"}


def gated_attention_init(gen, d_model: int,
                         dtype=torch.float32) -> GatedAttentionParams:
    return GatedAttentionParams(attn=mhgsa_init(gen, d_model, dtype),
                                info=core.dense_init(gen, d_model, d_model, dtype),
                                gate=core.dense_init(gen, d_model, d_model, dtype))


def encoder_layer_init(gen, cfg: LayerConfig,
                       dtype=torch.float32) -> EncoderLayerParams:
    return EncoderLayerParams(
        self_attn=gated_attention_init(gen, cfg.d_model, dtype),
        ffn=FFNParams(linear1=core.dense_init(gen, cfg.d_model, cfg.ff_dim, dtype),
                      linear2=core.dense_init(gen, cfg.ff_dim, cfg.d_model, dtype)),
        norm1=core.layer_norm_init(cfg.d_model, dtype),
        norm2=core.layer_norm_init(cfg.d_model, dtype))


def encoder_stack_init(gen, cfg: LayerConfig, num_layers: int,
                       dtype=torch.float32) -> list:
    return [encoder_layer_init(gen, cfg, dtype) for _ in range(num_layers)]


def gated_attention(params: GatedAttentionParams, query: torch.Tensor,
                    key: torch.Tensor, value: torch.Tensor, num_heads: int, *,
                    mask: torch.Tensor | None = None,
                    compat: str = "reference", need_weights: bool = False,
                    fused: str | bool = "auto", metric: str = "oblique",
                    curvature: float = 1.0,
                    kv_valid: torch.Tensor | None = None):
    """Gated geodesic attention over [L, N, S, D]: MHGSA on [N·S, L, D],
    then the ``tanh(info(a)) * sigmoid(gate(a))`` gate. ``kv_valid``
    [N·S, L] (or broadcastable) marks real key tokens.
    Returns (out [L, N, S, D], weights or None)."""
    L, N, S, D = query.shape

    def to_batch_first(x):
        return x.reshape(x.shape[0], N * S, D).transpose(0, 1)

    q = to_batch_first(query)
    if key is query and value is query:
        k = v = q        # keeps the packed self-attention projection
    else:
        k = to_batch_first(key)
        v = to_batch_first(value) if value is not key else k
    if compat == "reference":
        mask = kv_valid = None   # quirk Q2: masks never reach the kernel
    out, w = mhgsa(params.attn, q, k, v, num_heads, mask=mask, compat=compat,
                   need_weights=need_weights, fused=fused, metric=metric,
                   curvature=curvature, kv_valid=kv_valid)
    gated = torch.tanh(core.dense(params.info, out)) * \
        torch.sigmoid(core.dense(params.gate, out))
    return gated.transpose(0, 1).reshape(L, N, S, D), w


def encoder_layer(params: EncoderLayerParams, src: torch.Tensor,
                  cfg: LayerConfig, *,
                  mask: torch.Tensor | None = None,
                  kv_valid: torch.Tensor | None = None) -> torch.Tensor:
    """Post-norm encoder layer over [L, N, S, D] tokens."""
    if cfg.attn_impl not in _ATTN_IMPL_TO_FUSED:
        raise NotImplementedError(
            f"attn_impl={cfg.attn_impl!r} is not ported "
            "(auto/fused/packed/flash/dense)")
    attn_out, _ = gated_attention(
        params.self_attn, src, src, src, cfg.num_heads, mask=mask,
        compat=cfg.compat, fused=_ATTN_IMPL_TO_FUSED[cfg.attn_impl],
        metric=cfg.attn_metric, curvature=cfg.curvature, kv_valid=kv_valid)
    src = core.layer_norm(params.norm1, src + attn_out)
    act = core.ACTIVATIONS[cfg.activation]
    ffn_out = core.dense(params.ffn.linear2,
                         act(core.dense(params.ffn.linear1, src)))
    return core.layer_norm(params.norm2, src + ffn_out)


def encoder_stack(params: list, src: torch.Tensor, cfg: LayerConfig, *,
                  mask: torch.Tensor | None = None,
                  kv_valid: torch.Tensor | None = None) -> torch.Tensor:
    for p in params:
        src = encoder_layer(p, src, cfg, mask=mask, kv_valid=kv_valid)
    return src
