"""STTODE best-of-K inference (port of ``sttode_tpu/models/sttode.py``).

B scenes × N agents are flattened to M = B·N rows. The past encoder's
interaction attention runs over the scene axis (``attn_axis="scene"``, the
reference, quirk Q4) or over the agents of each scene with the validity mask
(``"agent"``, requires ``compat="tpu"``). Best-of-K decoding draws K latents
per agent from the standard-normal prior and decodes them with the
two-block decompose decoder.

Routing on a CUDA device: attention goes to the geodesic-attention kernel
unless ``attn_impl="dense"``, and the K-sample decode goes to the
selection-decode kernel (mode "traj") unless ``select_impl="xla"`` — a name
kept from the JAX package so configs carry over; in the port it means the
plain PyTorch decode. On the CPU both take the plain PyTorch path.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from sttode_tpu_torch.kernels.select_decode import select_decode
from sttode_tpu_torch.nn import core, embed
from sttode_tpu_torch.nn.ode_block import ode_encoder
from sttode_tpu_torch.nn.recurrent import conv1d, conv1d_init, gru, gru_init
from sttode_tpu_torch.nn.transformer import LayerConfig, encoder_stack_init
from sttode_tpu_torch.utils.distributions import DiagNormal


class STTODEConfig(NamedTuple):
    """Model hyperparameters, field for field the JAX ``STTODEConfig`` (so a
    JAX config converts with ``STTODEConfig(**jax_cfg._asdict())``).

    ``validate`` raises NotImplementedError on what the port does not run
    yet rather than running something else. Training-only fields (dropout,
    remat, loss_terms, diverse_grad, ...) are carried but unused: the port
    serves inference. One default differs from the JAX package:
    ``select_impl="auto"``, the selection-decode kernel on CUDA (the JAX
    default "xla" keeps its meaning, the plain decode)."""
    hidden_dim: int = 64
    zdim: int = 32
    num_heads: int = 8
    ff_dim: int = 1024
    nlayer: int = 1
    ode_time: float = 12.0
    ode_method: str = "euler"
    ode_steps: int = 1
    ode_adjoint: bool = False
    ode_rtol: float = 1e-7
    ode_atol: float = 1e-9
    ode_scan_budget: int = 0
    past_length: int = 8
    future_length: int = 12
    num_decompose: int = 2
    min_clip: float = 2.0
    sample_k: int = 20
    scale_num: int = 4
    learn_prior: bool = False
    compat: str = "reference"
    attn_axis: str = "scene"
    attn_impl: str = "auto"
    attn_metric: str = "oblique"
    curvature: float = 1.0
    pe_dropout: float = 0.1
    dropout: float = 0.0
    remat: bool = False
    compute_dtype: str = "float32"
    loss_terms: tuple = ("pred", "recover", "kl", "diverse")
    diverse_grad: str = "sparse"
    select_dtype: str = "float32"
    select_impl: str = "auto"
    decode_dtype: str = "float32"

    @property
    def layer_cfg(self) -> LayerConfig:
        return LayerConfig(d_model=self.hidden_dim, num_heads=self.num_heads,
                           ff_dim=self.ff_dim, dropout=self.dropout,
                           compat=self.compat, attn_impl=self.attn_impl,
                           attn_metric=self.attn_metric,
                           curvature=self.curvature)

    def validate(self) -> "STTODEConfig":
        """Fail fast on inconsistent or not-yet-ported settings."""
        if self.hidden_dim % self.num_heads:
            raise ValueError(f"hidden_dim {self.hidden_dim} must divide "
                             f"num_heads {self.num_heads}")
        if self.compat not in ("reference", "tpu"):
            raise ValueError(f"compat {self.compat!r}")
        if self.attn_axis not in ("scene", "agent"):
            raise ValueError(f"attn_axis {self.attn_axis!r}")
        if self.attn_axis == "agent" and self.compat == "reference":
            raise ValueError("attn_axis='agent' requires compat='tpu': "
                             "reference compat drops attention masks (Q2)")
        if self.ode_steps < 1 or self.sample_k < 1:
            raise ValueError("ode_steps and sample_k must be >= 1")
        if self.select_impl not in ("xla", "fused", "auto"):
            raise ValueError(f"select_impl {self.select_impl!r}")
        not_ported = {
            "attn_impl": (self.attn_impl, ("auto", "dense", "fused")),
            "attn_metric": (self.attn_metric, ("oblique",)),
            "ode_method": (self.ode_method, ("euler", "midpoint", "rk4")),
            "ode_adjoint": (self.ode_adjoint, (False,)),
            "learn_prior": (self.learn_prior, (False,)),
            "select_dtype": (self.select_dtype, ("float32",)),
            "decode_dtype": (self.decode_dtype, ("float32",)),
            "compute_dtype": (self.compute_dtype, ("float32",)),
        }
        for name, (value, ported) in not_ported.items():
            if value not in ported:
                raise NotImplementedError(
                    f"{name}={value!r} is not ported yet (ported: {ported})")
        if self.num_decompose != 2 and self.select_impl != "xla":
            raise NotImplementedError(
                "the selection-decode kernel route needs num_decompose=2; "
                "use select_impl='xla' (plain decode) for other depths")
        return self


@dataclasses.dataclass(frozen=True)
class Batch:
    """Scene batch, already normalized by the data layer. Per-agent tensors
    are [M, T, 2] with M = batch_size·agent_num; ``valid`` [M] marks real
    (non-padded) agents."""
    past: torch.Tensor
    past_vel: torch.Tensor
    future: torch.Tensor
    future_vel: torch.Tensor
    valid: torch.Tensor
    batch_size: int
    agent_num: int

    @property
    def inputs(self) -> torch.Tensor:
        return torch.cat([self.past, self.past_vel], dim=-1)

    @property
    def inputs_for_posterior(self) -> torch.Tensor:
        return torch.cat([self.future, self.future_vel], dim=-1)

    @property
    def cur_location(self) -> torch.Tensor:
        return self.past[:, -1:]

    def to(self, device) -> "Batch":
        move = {f.name: getattr(self, f.name).to(device)
                for f in dataclasses.fields(self)
                if f.name not in ("batch_size", "agent_num")}
        return dataclasses.replace(self, **move)


# --------------------------------------------------------------------------- #
# init                                                                        #
# --------------------------------------------------------------------------- #

def _trunk_init(gen, cfg: STTODEConfig, seq_len: int, dtype) -> dict:
    D = cfg.hidden_dim
    return {
        "input_fc": core.dense_init(gen, 4, D, dtype),
        "pe": embed.positional_agent_encoding_init(gen, D, dtype=dtype),
        "input_fc2": core.dense_init(gen, D * seq_len, D, dtype),
        "input_fc3": core.dense_init(gen, D + 3, D, dtype),
        "ode_layers": encoder_stack_init(gen, cfg.layer_cfg, cfg.nlayer, dtype),
    }


def _decompose_init(gen, cfg: STTODEConfig, dtype) -> dict:
    feat_dim = 2 * cfg.hidden_dim + cfg.zdim + 96
    return {
        "conv_past": conv1d_init(gen, 2, 32, 3, dtype),
        "gru": gru_init(gen, 32, 96, dtype),
        "decoder_y": core.mlp_init(gen, feat_dim, [512, 256],
                                   cfg.future_length * 2, dtype),
        "decoder_x": core.mlp_init(gen, feat_dim, [512, 256],
                                   cfg.past_length * 2, dtype),
    }


def sttode_init(gen: torch.Generator | int, cfg: STTODEConfig,
                dtype=torch.float32) -> dict:
    """Random parameters (on the CPU) with the JAX package's structure and
    initializer distributions, drawn from ``gen`` (a CPU generator or a
    seed). Includes the posterior head and future encoder so that the
    parameter tree matches the JAX one leaf for leaf."""
    if isinstance(gen, int):
        gen = torch.Generator().manual_seed(gen)
    D = cfg.hidden_dim
    return {
        "past_encoder": _trunk_init(gen, cfg, cfg.past_length, dtype),
        "future_encoder": _trunk_init(gen, cfg, cfg.future_length, dtype),
        "out_mlp": core.mlp_init_normal001(gen, cfg.scale_num * D, [128],
                                           dtype),
        "qz_layer": {"w": core.normal_001(gen, 128, 2 * cfg.zdim, dtype),
                     "b": torch.zeros(2 * cfg.zdim, dtype=dtype)},
        "decoder": [_decompose_init(gen, cfg, dtype)
                    for _ in range(cfg.num_decompose)],
    }


# --------------------------------------------------------------------------- #
# encoder                                                                     #
# --------------------------------------------------------------------------- #

def _add_category(x: torch.Tensor) -> torch.Tensor:
    """Append a 3-dim one-hot category marking only the last agent slot."""
    B, N, _ = x.shape
    category = x.new_zeros((B, N, 3))
    category[:, N - 1, 2] = 1.0
    return torch.cat([x, category], dim=-1)


def _agent_attn_mask(valid: torch.Tensor, B: int, N: int) -> torch.Tensor:
    """Additive [B, 1, N] key mask: 0 for real agents, finfo.min for padding
    (the exclusion sentinel of the attention kernel's mask contract)."""
    v = valid.reshape(B, 1, N)
    return torch.zeros_like(v).masked_fill(~(v > 0), torch.finfo(v.dtype).min)


def _encode_trunk(p: dict, cfg: STTODEConfig, inputs: torch.Tensor, B: int,
                  N: int, valid: torch.Tensor, *,
                  isolate_scenes: bool = False) -> torch.Tensor:
    """Shared trunk → [M, 2D] concat(skip, interaction) feature.

    ``isolate_scenes`` (scene axis only) makes every scene its own
    batch_size=1 problem: the attention token axis never crosses scenes,
    exactly as running each scene alone (the JAX Predictor's vmapped lanes)."""
    D = cfg.hidden_dim
    T = inputs.shape[1]
    x = core.dense(p["input_fc"], inputs)                     # [M, T, D]
    x = embed.positional_agent_encoding(p["pe"], x)
    x = core.dense(p["input_fc2"], x.reshape(B, N, T * D))    # [B, N, D]
    x = core.dense(p["input_fc3"], _add_category(x))          # [B, N, D]

    if cfg.attn_axis == "agent" and cfg.compat == "reference":
        raise ValueError("attn_axis='agent' requires compat='tpu': reference "
                         "compat drops attention masks (Q2), so padded "
                         "agents would leak into attention")
    mask = None
    if cfg.attn_axis == "scene":
        tokens = (x.reshape(1, B * N, 1, D) if isolate_scenes
                  else x[:, :, None, :])                      # [L=B, N, 1, D]
    else:
        tokens = x.transpose(0, 1)[:, :, None, :]             # [L=N, B, 1, D]
        mask = _agent_attn_mask(valid, B, N)
    z = ode_encoder(p["ode_layers"], tokens, cfg.layer_cfg,
                    time=cfg.ode_time, method=cfg.ode_method,
                    steps=cfg.ode_steps, mask=mask)
    if cfg.attn_axis == "scene":
        z = z.reshape(B, N, D)
    else:
        z = z[:, :, 0].transpose(0, 1)                         # [B, N, D]
    return torch.cat([x, z], dim=-1).reshape(B * N, 2 * D)


def encode_past(params: dict, cfg: STTODEConfig, batch: Batch, *,
                isolate_scenes: bool = False) -> torch.Tensor:
    """past_feature [M, 2D]."""
    return _encode_trunk(params["past_encoder"], cfg, batch.inputs,
                         batch.batch_size, batch.agent_num, batch.valid,
                         isolate_scenes=isolate_scenes)


def prior(params: dict, cfg: STTODEConfig,
          past_feature: torch.Tensor) -> DiagNormal:
    """p(z) = N(0, I) (``learn_prior`` is not ported)."""
    if cfg.learn_prior:
        raise NotImplementedError("learn_prior is not ported yet")
    return DiagNormal.standard((past_feature.shape[0], cfg.zdim),
                               past_feature.dtype, past_feature.device)


# --------------------------------------------------------------------------- #
# decoder                                                                     #
# --------------------------------------------------------------------------- #

def decode_block0_state(params: dict, past_traj: torch.Tensor) -> torch.Tensor:
    """Decompose block 0's conv + GRU state [M, 96]: block 0 sees the residual
    x_true − 0 = past_traj, independent of z, so one scan serves all K."""
    block = params["decoder"][0]
    h = torch.relu(conv1d(block["conv_past"], past_traj, padding=1))
    _, state = gru(block["gru"], h)
    return state


def decode(params: dict, cfg: STTODEConfig, past_feature: torch.Tensor,
           z: torch.Tensor, past_traj: torch.Tensor,
           cur_location: torch.Tensor, sample_num: int,
           block0_state: torch.Tensor | None = None):
    """Iterative decompose decoder. past_feature [M·s, 2D] (pre-repeated),
    z [M·s, Z], past_traj [M, T_p, 2], cur_location [M, 1, 2].
    Returns (out_seq [M·s, T_f, 2] absolute, reconstruction [M·s, T_p, 2])."""
    s = sample_num
    x_true = past_traj.repeat_interleave(s, dim=0)
    hidden = torch.cat([past_feature, z], dim=-1)
    rows = x_true.shape[0]
    x_hat = torch.zeros_like(x_true)
    prediction = x_true.new_zeros((rows, cfg.future_length, 2))
    reconstruction = x_true.new_zeros((rows, cfg.past_length, 2))
    for i, block in enumerate(params["decoder"]):
        if i == 0 and block0_state is not None:
            state = block0_state.repeat_interleave(s, dim=0)
        elif i == 0 and s > 1:
            state = decode_block0_state(params, past_traj) \
                .repeat_interleave(s, dim=0)
        else:
            h = torch.relu(conv1d(block["conv_past"], x_true - x_hat,
                                  padding=1))
            _, state = gru(block["gru"], h)
        feat = torch.cat([hidden, state], dim=-1)
        x_hat = core.mlp(block["decoder_x"], feat).reshape(
            -1, cfg.past_length, 2)
        y_hat = core.mlp(block["decoder_y"], feat).reshape(
            -1, cfg.future_length, 2)
        prediction = prediction + y_hat
        reconstruction = reconstruction + x_hat
    return prediction + cur_location.repeat_interleave(s, dim=0), \
        reconstruction


# --------------------------------------------------------------------------- #
# inference                                                                   #
# --------------------------------------------------------------------------- #

def sttode_inference(params: dict, cfg: STTODEConfig, batch: Batch, *,
                     generator: torch.Generator | None = None,
                     z: torch.Tensor | None = None,
                     sample_k: int | None = None,
                     isolate_scenes: bool = False) -> torch.Tensor:
    """Best-of-K prior decode: [K, M, T_f, 2] in scene-normalized
    coordinates (the caller re-adds the scene origin).

    The only random draw is z [M·K, Z] (m-major: row m·K + k), taken from
    ``generator`` (on the batch's device) unless injected with ``z``."""
    K = sample_k or cfg.sample_k
    M = batch.batch_size * batch.agent_num
    Tf = cfg.future_length
    past_feature = encode_past(params, cfg, batch,
                               isolate_scenes=isolate_scenes)
    if z is None:
        z = prior(params, cfg, past_feature.repeat_interleave(K, dim=0)) \
            .rsample(generator)
    elif tuple(z.shape) != (M * K, cfg.zdim):
        raise ValueError(f"z must be [{M * K}, {cfg.zdim}], got "
                         f"{tuple(z.shape)}")

    if cfg.select_impl != "xla" and past_feature.is_cuda:
        state0 = decode_block0_state(params, batch.past)
        z_km = z.reshape(M, K, -1).transpose(0, 1)
        rel = select_decode(params, past_feature, z_km, state0,
                            batch.past.reshape(M, -1), mode="traj")
        return rel.reshape(K, M, Tf, 2) + batch.cur_location[None]

    diverse, _ = decode(params, cfg, past_feature.repeat_interleave(K, dim=0),
                        z, batch.past, batch.cur_location, K)
    return diverse.reshape(M, K, Tf, 2).transpose(0, 1)
