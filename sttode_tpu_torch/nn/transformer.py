"""Geodesic transformer layers (port of ``sttode_tpu/nn/transformer.py``:
``gated_attention``, ``encoder_layer``, ``encoder_stack``, ``decoder_layer``,
``decoder_stack``).

Tokens are 4-D ``[L, N, S, D]`` as in the JAX package: L is the attended
token axis, N·S the batch. The encoder layer's dropout (rate
``LayerConfig.dropout``) has JAX's four sites: the attention weights, the
attention residual, the FFN hidden layer and the FFN residual. It applies
where a layer is given its keep-masks (``LayerDropMasks``, one per layer,
injected or drawn with ``draw_dropout_masks``); without them the layer is
deterministic.

The decoder layer (self-attention, cross-attention over a memory
[L_mem, N, S, D], FFN, three post-norms) asks both attentions for their
weights, as JAX's does: ``attn_impl="auto"`` therefore takes the plain
path and returns them, a forced kernel route ("fused", "packed", "flash")
runs the kernels and returns None weights. Its dropout has JAX's six
sites (``DecoderDropMasks``). A cross-attention with L == L_mem is square,
so under reference compat it runs in quirk Q3's swapped orientation too.
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


class DecoderLayerParams(NamedTuple):
    self_attn: GatedAttentionParams
    cross_attn: GatedAttentionParams
    ffn: FFNParams
    norm1: dict
    norm2: dict
    norm3: dict


class LayerDropMasks(NamedTuple):
    """One encoder layer's dropout keep-masks (bool): the attention weights
    [N·S, H, L, L], the attention residual [L, N, S, D], the FFN hidden
    layer [L, N, S, ff] and the FFN residual [L, N, S, D] — the draws of
    JAX's ``encoder_layer`` keys (attn, d1, ffn, d2) in that order."""
    attn: torch.Tensor
    resid1: torch.Tensor
    ffn: torch.Tensor
    resid2: torch.Tensor


class DecoderDropMasks(NamedTuple):
    """One decoder layer's dropout keep-masks (bool), in the order of JAX's
    six ``decoder_layer`` keys: the self-attention weights [N·S, H, L, L],
    its residual [L, N, S, D], the cross-attention weights
    [N·S, H, L, L_mem], its residual, the FFN hidden layer [L, N, S, ff]
    and the FFN residual."""
    self_attn: torch.Tensor
    resid1: torch.Tensor
    cross_attn: torch.Tensor
    resid2: torch.Tensor
    ffn: torch.Tensor
    resid3: torch.Tensor


class LayerConfig(NamedTuple):
    """Static hyperparameters of one layer. ``attn_impl``: "auto" (the CUDA
    kernels on CUDA tensors, routed by shape), "fused", "packed" or "flash"
    (one kernel forced), "dense" (plain path), "ring" or "ulysses"
    (sequence-parallel over a mesh given to the layer). ``dropout``: the
    layer's dropout rate where it is given keep-masks."""
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
                       "packed": "packed", "flash": "flash", "ring": "ring",
                       "ulysses": "ulysses"}


def gated_attention_init(gen, d_model: int,
                         dtype=torch.float32) -> GatedAttentionParams:
    return GatedAttentionParams(attn=mhgsa_init(gen, d_model, dtype),
                                info=core.dense_init(gen, d_model, d_model, dtype),
                                gate=core.dense_init(gen, d_model, d_model, dtype))


def _ffn_init(gen, cfg: LayerConfig, dtype) -> FFNParams:
    return FFNParams(
        linear1=core.dense_init(gen, cfg.d_model, cfg.ff_dim, dtype),
        linear2=core.dense_init(gen, cfg.ff_dim, cfg.d_model, dtype))


def encoder_layer_init(gen, cfg: LayerConfig,
                       dtype=torch.float32) -> EncoderLayerParams:
    return EncoderLayerParams(
        self_attn=gated_attention_init(gen, cfg.d_model, dtype),
        ffn=_ffn_init(gen, cfg, dtype),
        norm1=core.layer_norm_init(cfg.d_model, dtype),
        norm2=core.layer_norm_init(cfg.d_model, dtype))


def decoder_layer_init(gen, cfg: LayerConfig,
                       dtype=torch.float32) -> DecoderLayerParams:
    return DecoderLayerParams(
        self_attn=gated_attention_init(gen, cfg.d_model, dtype),
        cross_attn=gated_attention_init(gen, cfg.d_model, dtype),
        ffn=_ffn_init(gen, cfg, dtype),
        norm1=core.layer_norm_init(cfg.d_model, dtype),
        norm2=core.layer_norm_init(cfg.d_model, dtype),
        norm3=core.layer_norm_init(cfg.d_model, dtype))


def decoder_stack_init(gen, cfg: LayerConfig, num_layers: int,
                       dtype=torch.float32) -> list:
    return [decoder_layer_init(gen, cfg, dtype) for _ in range(num_layers)]


def encoder_stack_init(gen, cfg: LayerConfig, num_layers: int,
                       dtype=torch.float32) -> list:
    return [encoder_layer_init(gen, cfg, dtype) for _ in range(num_layers)]


def draw_dropout_masks(cfg: LayerConfig, src_shape: tuple, num_layers: int,
                       generator: torch.Generator | None = None,
                       device=None) -> list[LayerDropMasks]:
    """Keep-masks (probability 1 − ``cfg.dropout``) of ``num_layers``
    encoder layers over [L, N, S, D] tokens, drawn from ``generator`` (on
    ``device``)."""
    L, N, S, D = src_shape
    keep = 1.0 - cfg.dropout

    def draw(*shape):
        return torch.rand(shape, generator=generator, device=device) < keep
    return [LayerDropMasks(draw(N * S, cfg.num_heads, L, L), draw(L, N, S, D),
                           draw(L, N, S, cfg.ff_dim), draw(L, N, S, D))
            for _ in range(num_layers)]


def gated_attention(params: GatedAttentionParams, query: torch.Tensor,
                    key: torch.Tensor, value: torch.Tensor, num_heads: int, *,
                    mask: torch.Tensor | None = None,
                    compat: str = "reference", need_weights: bool = False,
                    fused: str | bool = "auto", metric: str = "oblique",
                    curvature: float = 1.0,
                    kv_valid: torch.Tensor | None = None,
                    dropout_rate: float = 0.0,
                    dropout_mask: torch.Tensor | None = None,
                    mesh=None, ring_axis: str | None = "data"):
    """Gated geodesic attention over [L, N, S, D]: MHGSA on [N·S, L, D],
    then the ``tanh(info(a)) * sigmoid(gate(a))`` gate. ``kv_valid``
    [N·S, L] (or broadcastable) marks real key tokens; ``dropout_mask``
    [N·S, H, L, L] keeps attention weights at ``dropout_rate``. Under a
    ``mesh`` L is this rank's block of the token axis, split over
    ``mesh[ring_axis]``, or with ``ring_axis=None`` the whole token axis
    and N·S this rank's rows over "data"
    (``nn.attention.geodesic_attention``).
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
                   curvature=curvature, kv_valid=kv_valid,
                   dropout_rate=dropout_rate, dropout_mask=dropout_mask,
                   mesh=mesh, ring_axis=ring_axis)
    gated = torch.tanh(core.dense(params.info, out)) * \
        torch.sigmoid(core.dense(params.gate, out))
    return gated.transpose(0, 1).reshape(L, N, S, D), w


def encoder_layer(params: EncoderLayerParams, src: torch.Tensor,
                  cfg: LayerConfig, *,
                  mask: torch.Tensor | None = None,
                  kv_valid: torch.Tensor | None = None,
                  drop: LayerDropMasks | None = None,
                  mesh=None, ring_axis: str | None = "data") -> torch.Tensor:
    """Post-norm encoder layer over [L, N, S, D] tokens, with dropout at
    ``cfg.dropout`` where ``drop`` gives its keep-masks. Under a ``mesh``
    (needed by ``attn_impl="ring"`` and ``"ulysses"``) L is this rank's
    block of the tokens over ``mesh[ring_axis]``, or the whole tokens with
    ``ring_axis=None`` (``gated_attention``)."""
    if cfg.attn_impl not in _ATTN_IMPL_TO_FUSED:
        raise NotImplementedError(
            f"attn_impl={cfg.attn_impl!r} is not ported "
            "(auto/fused/packed/flash/dense/ring/ulysses)")
    rate = cfg.dropout if drop is not None else 0.0
    attn_out, _ = gated_attention(
        params.self_attn, src, src, src, cfg.num_heads, mask=mask,
        compat=cfg.compat, fused=_ATTN_IMPL_TO_FUSED[cfg.attn_impl],
        metric=cfg.attn_metric, curvature=cfg.curvature, kv_valid=kv_valid,
        dropout_rate=rate, dropout_mask=None if drop is None else drop.attn,
        mesh=mesh, ring_axis=ring_axis)
    if rate > 0.0:
        attn_out = core.dropout(attn_out, rate, keep_mask=drop.resid1)
    src = core.layer_norm(params.norm1, src + attn_out)
    ffn_out = _ffn(params.ffn, src, cfg, rate, None if drop is None
                   else drop.ffn)
    if rate > 0.0:
        ffn_out = core.dropout(ffn_out, rate, keep_mask=drop.resid2)
    return core.layer_norm(params.norm2, src + ffn_out)


def _ffn(p: FFNParams, x: torch.Tensor, cfg: LayerConfig, rate: float,
         keep: torch.Tensor | None) -> torch.Tensor:
    """linear2(dropout(act(linear1(x)))), the hidden layer's dropout at
    ``rate`` with keep-mask ``keep``."""
    hidden = core.ACTIVATIONS[cfg.activation](core.dense(p.linear1, x))
    if rate > 0.0:
        hidden = core.dropout(hidden, rate, keep_mask=keep)
    return core.dense(p.linear2, hidden)


def encoder_stack(params: list, src: torch.Tensor, cfg: LayerConfig, *,
                  mask: torch.Tensor | None = None,
                  kv_valid: torch.Tensor | None = None,
                  drop: list[LayerDropMasks] | None = None,
                  mesh=None, ring_axis: str | None = "data") -> torch.Tensor:
    """The layers in turn; ``drop`` holds one ``LayerDropMasks`` per layer
    (JAX's per-layer key order), or None for no dropout."""
    for i, p in enumerate(params):
        src = encoder_layer(p, src, cfg, mask=mask, kv_valid=kv_valid,
                            drop=None if drop is None else drop[i],
                            mesh=mesh, ring_axis=ring_axis)
    return src


def decoder_layer(params: DecoderLayerParams, tgt: torch.Tensor,
                  memory: torch.Tensor, cfg: LayerConfig, *,
                  tgt_mask: torch.Tensor | None = None,
                  memory_mask: torch.Tensor | None = None,
                  drop: DecoderDropMasks | None = None):
    """Post-norm decoder layer over tgt [L, N, S, D] and memory
    [L_mem, N, S, D]: self-attention, cross-attention, FFN. Returns (tgt,
    self-attention weights, cross-attention weights), the weights
    [N·S, L, L] and [N·S, L, L_mem] on the plain path ("auto", "dense"),
    None on a forced kernel route. Dropout at ``cfg.dropout`` where
    ``drop`` gives its keep-masks. The sequence-parallel routes raise
    ValueError, as in JAX: the decoder carries no mesh."""
    if cfg.attn_impl in ("ring", "ulysses"):
        raise ValueError(
            f"decoder layers do not support attn_impl='{cfg.attn_impl}' "
            "(no mesh plumbing on the decoder side); use "
            "auto/dense/fused/flash/packed")
    if cfg.attn_impl not in _ATTN_IMPL_TO_FUSED:
        raise NotImplementedError(
            f"attn_impl={cfg.attn_impl!r} is not ported "
            "(auto/fused/packed/flash/dense)")
    fused = _ATTN_IMPL_TO_FUSED[cfg.attn_impl]
    forced = cfg.attn_impl in ("fused", "packed", "flash")
    rate = cfg.dropout if drop is not None else 0.0

    def attend(p, q, kv, mask, keep):
        out, w = gated_attention(
            p, q, kv, kv, cfg.num_heads, mask=mask, compat=cfg.compat,
            need_weights=True, fused=fused, metric=cfg.attn_metric,
            curvature=cfg.curvature, dropout_rate=rate, dropout_mask=keep)
        return out, None if forced else w

    def residual(x, y, norm, keep):
        if rate > 0.0:
            y = core.dropout(y, rate, keep_mask=keep)
        return core.layer_norm(norm, x + y)

    keep = drop if drop is not None else DecoderDropMasks(*[None] * 6)
    sa, sw = attend(params.self_attn, tgt, tgt, tgt_mask, keep.self_attn)
    tgt = residual(tgt, sa, params.norm1, keep.resid1)
    ca, cw = attend(params.cross_attn, tgt, memory, memory_mask,
                    keep.cross_attn)
    tgt = residual(tgt, ca, params.norm2, keep.resid2)
    tgt = residual(tgt, _ffn(params.ffn, tgt, cfg, rate, keep.ffn),
                   params.norm3, keep.resid3)
    return tgt, sw, cw


def decoder_stack(params: list, tgt: torch.Tensor, memory: torch.Tensor,
                  cfg: LayerConfig, *,
                  tgt_mask: torch.Tensor | None = None,
                  memory_mask: torch.Tensor | None = None,
                  drop: list[DecoderDropMasks] | None = None):
    """The decoder layers in turn over the same memory; returns (tgt, the
    last layer's self- and cross-attention weights). ``drop`` holds one
    ``DecoderDropMasks`` per layer, or None for no dropout."""
    sw = cw = None
    for i, p in enumerate(params):
        tgt, sw, cw = decoder_layer(p, tgt, memory, cfg, tgt_mask=tgt_mask,
                                    memory_mask=memory_mask,
                                    drop=None if drop is None else drop[i])
    return tgt, sw, cw
