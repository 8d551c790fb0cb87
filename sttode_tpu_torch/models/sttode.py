"""STTODE: the CVAE training forward and best-of-K inference (port of
``sttode_tpu/models/sttode.py``).

B scenes × N agents are flattened to M = B·N rows. The past encoder's
interaction attention runs over the scene axis (``attn_axis="scene"``, the
reference, quirk Q4) or over the agents of each scene with the validity mask
(``"agent"``, requires ``compat="tpu"``). The interaction encoder is an ODE
block (``nn.ode_block``): the fixed grid, or dopri5 in its while or
scan-budget form (``ode_scan_budget``), with direct or continuous-adjoint
(``ode_adjoint``) gradients. Best-of-K decoding draws K latents per agent
from the prior — standard normal, or with ``learn_prior`` the Gaussian
``pz_layer`` reads off the past feature — and decodes them with the
two-block decompose decoder.

``sttode_forward`` is the stage-1 training forward: posterior decode, KL
against the prior, and the best-of-K diverse loss, with the sparse
(winner-only) or dense best-of-K gradient. Its random draws (two
positional-encoding dropout masks, the encoder layers' dropout masks under
``dropout > 0``, and the posterior and prior latents) come from a
generator, or are injected with ``TrainNoise`` so that a test can hand the
port the JAX package's draws.

Routing on a CUDA device: attention goes to the geodesic-attention kernels
(forward and backward) unless ``attn_impl="dense"``, and the K-sample decode
goes to the selection-decode kernel (mode "traj" at inference, mode "dist"
at ``select_dtype`` in training) unless ``select_impl="xla"`` — a name kept
from the JAX package so configs carry over; in the port it means the plain
PyTorch decode. The attention metric is ``attn_metric``: "oblique" (the
reference's) or "poincare" (the Möbius distance on the ball of
``curvature`` c, the paper's framing). The attention kernel
(``nn.attention._kernel_route``) is the small-shape key-validity one
(``kernels.packed_mhgsa``, oblique only) where the problems are small, the
S-tiled one (``kernels.mhgsa.flash_geodesic_attention``) for
maskless problems beyond the whole-S kernels' shared memory or JAX's
S > 2048 — on the scene axis, batches of more than 1036 scenes — and the
whole-S one otherwise. On the CPU both take the plain PyTorch path, except
that ``select_impl="fused"`` in training and ``attn_impl="packed"`` or
``"flash"`` run the kernel's plain version, as the JAX package runs its
Pallas kernels in interpret mode off the TPU.

Data parallelism (``mesh=``, a ``parallel.make_mesh`` mesh over "data",
or "data" × "seq"): each rank passes its own block of whole scenes
(``parallel.shard_batch``, by its "data" coordinate) and computes the
model that the single process computes on the whole batch. On the scene
axis the scenes are the attention's tokens (quirk Q4), so each rank
attends its scenes to the keys and values of every rank's
(``nn.attention``: gathered over "data", or a sequence-parallel route);
on the agent axis the attention stays within a scene, except that the
ring and ulysses split each scene's agents over the ranks. The loss
normalizers are global (the batch size, the count of real agents, and
the KL floor's gate, which reads the global mean), and so is the noise:
the draws are those of the single process over the whole batch, of which
each rank keeps its rows. The selection kernel decodes each rank's own
rows. dopri5's error norms are those of the whole state (``ode.odeint``'s
``group``, "data"), so every rank integrates with the single process's
steps.

On a data × sequence mesh [dp, sp] the sp ranks of a data group hold the
same scenes and compute the same rows, losses and gradient; the sums
above run over "data" alone, and so does the step's gradient sum. Only
the sequence-parallel routes part them, in JAX's ``shard_map`` layout:
the attention's tokens split over "seq" and its batch rows over "data".
On the scene axis rank (d, s) then attends, for block d of the batch rows
(agents, × heads under the ring), the queries of scene block s (of the
global batch's scenes) to every scene; on the agent axis, for its own
scenes, the queries of agent block s to every agent. Each gives its rows
back (``nn.attention._from_sp``), whole again on every sequence rank,
with the cotangent rules that keep each rank's gradient whole
(``parallel.collectives``). The other routes attend over the keys
gathered across "data", the same on every sequence rank. Where JAX's
``shard_map`` refuses a shape (the batch rows or the tokens not dividing
their axis, the heads not dividing "seq" under ulysses) the port raises
ValueError.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from sttode_tpu_torch import bridge
from sttode_tpu_torch.kernels.select_decode import select_decode
from sttode_tpu_torch.nn import core, embed
from sttode_tpu_torch.nn.ode_block import ode_encoder
from sttode_tpu_torch.nn.recurrent import conv1d, conv1d_init, gru, gru_init
from sttode_tpu_torch.nn.transformer import (LayerConfig, LayerDropMasks,
                                             draw_dropout_masks,
                                             encoder_stack_init)
from sttode_tpu_torch.parallel import collectives
from sttode_tpu_torch.parallel.mesh import (TP_NOT_PORTED, axis_rank,
                                            axis_size, mesh_shape)
from sttode_tpu_torch.utils.distributions import DiagNormal


class STTODEConfig(NamedTuple):
    """Model hyperparameters, field for field the JAX ``STTODEConfig`` (so a
    JAX config converts with ``STTODEConfig(**jax_cfg._asdict())``).

    ``validate`` raises NotImplementedError on what the port does not run
    rather than running something else: ``compute_dtype="bfloat16"`` and
    ``num_decompose != 2`` on the selection-decode kernel route.
    ``remat`` is carried but unused: PyTorch stores what autograd needs.
    One default differs from the JAX package: ``select_impl="auto"``, the
    selection-decode kernel on CUDA (the JAX default "xla" keeps its
    meaning, the plain decode)."""
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
        if self.attn_metric not in ("oblique", "poincare"):
            raise ValueError(f"attn_metric {self.attn_metric!r}")
        if not self.curvature > 0.0:
            raise ValueError(f"curvature {self.curvature} must be > 0")
        if self.ode_steps < 1 or self.sample_k < 1:
            raise ValueError("ode_steps and sample_k must be >= 1")
        if self.ode_method not in ("euler", "midpoint", "rk4", "dopri5"):
            raise ValueError(f"ode_method {self.ode_method!r}")
        if self.ode_scan_budget < 0:
            raise ValueError(f"ode_scan_budget {self.ode_scan_budget} must "
                             f"be >= 0 (0: dopri5's while form)")
        if not 0.0 <= self.dropout < 1.0:
            raise ValueError(f"dropout {self.dropout} must be in [0, 1)")
        if self.select_impl not in ("xla", "fused", "auto"):
            raise ValueError(f"select_impl {self.select_impl!r}")
        if self.diverse_grad not in ("sparse", "dense"):
            raise ValueError(f"diverse_grad {self.diverse_grad!r}")
        if self.diverse_grad != "sparse" and (
                self.select_impl == "fused" or
                self.select_dtype == "bfloat16"):
            raise ValueError(
                "select_impl='fused' and select_dtype='bfloat16' require "
                "diverse_grad='sparse': the dense path differentiates "
                "through the K-decode, which the forward-only kernel and "
                "bf16 selection do not serve")
        unknown = set(self.loss_terms) - {"pred", "recover", "kl", "diverse"}
        if unknown:
            raise ValueError(f"unknown loss_terms {sorted(unknown)}")
        for name, value, known in (
                ("attn_impl", self.attn_impl, ("auto", "dense", "fused",
                                               "packed", "flash", "ring",
                                               "ulysses")),
                ("select_dtype", self.select_dtype, ("float32", "bfloat16")),
                ("decode_dtype", self.decode_dtype, ("float32", "bfloat16")),
                ("compute_dtype", self.compute_dtype, ("float32",
                                                       "bfloat16"))):
            if value not in known:
                raise ValueError(f"{name} {value!r}")
        if self.compute_dtype != "float32":
            raise NotImplementedError(
                "compute_dtype='bfloat16' is not ported (decode_dtype and "
                "select_dtype give the decode bf16 storage)")
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
    params = {
        "past_encoder": _trunk_init(gen, cfg, cfg.past_length, dtype),
        "future_encoder": _trunk_init(gen, cfg, cfg.future_length, dtype),
        "out_mlp": core.mlp_init_normal001(gen, cfg.scale_num * D, [128],
                                           dtype),
        "qz_layer": {"w": core.normal_001(gen, 128, 2 * cfg.zdim, dtype),
                     "b": torch.zeros(2 * cfg.zdim, dtype=dtype)},
        "decoder": [_decompose_init(gen, cfg, dtype)
                    for _ in range(cfg.num_decompose)],
    }
    if cfg.learn_prior:
        # drawn last, so the other leaves are those of a model without it;
        # its input is the 2D-wide past feature (quirk Q8: the reference's
        # scale_num·D width is dead code)
        params["pz_layer"] = {
            "w": core.normal_001(gen, 2 * D, 2 * cfg.zdim, dtype),
            "b": torch.zeros(2 * cfg.zdim, dtype=dtype)}
    return params


# --------------------------------------------------------------------------- #
# encoder                                                                     #
# --------------------------------------------------------------------------- #

def _add_category(x: torch.Tensor) -> torch.Tensor:
    """Append a 3-dim one-hot category marking only the last agent slot."""
    B, N, _ = x.shape
    category = x.new_zeros((B, N, 3))
    category[:, N - 1, 2].fill_(1.0)
    return torch.cat([x, category], dim=-1)


def _agent_attn_mask(valid: torch.Tensor, B: int, N: int) -> torch.Tensor:
    """Additive [B, 1, N] key mask: 0 for real agents, finfo.min for padding
    (the exclusion sentinel of the attention kernel's mask contract)."""
    v = valid.reshape(B, 1, N)
    return torch.zeros_like(v).masked_fill(~(v > 0), torch.finfo(v.dtype).min)


def _encode_trunk(p: dict, cfg: STTODEConfig, inputs: torch.Tensor, B: int,
                  N: int, valid: torch.Tensor, *,
                  isolate_scenes: bool = False, train: bool = False,
                  keep_mask: torch.Tensor | None = None,
                  enc_masks: list | None = None,
                  generator: torch.Generator | None = None,
                  mesh=None) -> torch.Tensor:
    """Shared trunk → [M, 2D] concat(skip, interaction) feature.

    ``isolate_scenes`` (scene axis only) makes every scene its own
    batch_size=1 problem: the attention token axis never crosses scenes,
    exactly as running each scene alone (the JAX Predictor's vmapped lanes).
    With ``train`` the positional encoding's dropout applies, its keep-mask
    [M, T, D] injected or drawn from ``generator``, and under
    ``cfg.dropout > 0`` so does the encoder layers' (``enc_masks``, one
    ``LayerDropMasks`` per layer, injected or drawn once for the solve).
    Under a ``mesh`` the B scenes are this rank's (see the module's
    docstring)."""
    D = cfg.hidden_dim
    T = inputs.shape[1]
    x = core.dense(p["input_fc"], inputs)                     # [M, T, D]
    x = embed.positional_agent_encoding(
        p["pe"], x, dropout_rate=cfg.pe_dropout, train=train,
        keep_mask=keep_mask, generator=generator)
    x = core.dense(p["input_fc2"], x.reshape(B, N, T * D))    # [B, N, D]
    x = core.dense(p["input_fc3"], _add_category(x))          # [B, N, D]

    if cfg.attn_axis == "agent" and cfg.compat == "reference":
        raise ValueError("attn_axis='agent' requires compat='tpu': reference "
                         "compat drops attention masks (Q2), so padded "
                         "agents would leak into attention")
    mask = kv_valid = enc_mesh = None
    ring_axis = "data"
    group = None if mesh is None else mesh.get_group("data")
    if cfg.attn_axis == "scene":
        tokens = (x.reshape(1, B * N, 1, D) if isolate_scenes
                  else x[:, :, None, :])                      # [L=B, N, 1, D]
        # the scenes, split over "data", are the tokens
        enc_mesh = None if isolate_scenes else mesh
    elif cfg.attn_impl in ("ring", "ulysses"):
        # the sequence-parallel routes' only mask form is key validity
        tokens = x.transpose(0, 1)[:, :, None, :]             # [L=N, B, 1, D]
        kv_valid = valid.reshape(B, N)
        # every rank holds its scenes' agents whole: the route splits them
        # (nn.attention)
        enc_mesh, ring_axis = mesh, None
    else:
        tokens = x.transpose(0, 1)[:, :, None, :]             # [L=N, B, 1, D]
        mask = _agent_attn_mask(valid, B, N)
    drop = None
    if train and cfg.dropout > 0.0:
        drop = enc_masks if enc_masks is not None else draw_dropout_masks(
            cfg.layer_cfg, tuple(tokens.shape), cfg.nlayer, generator,
            tokens.device)
    z = ode_encoder(p["ode_layers"], tokens, cfg.layer_cfg,
                    time=cfg.ode_time, method=cfg.ode_method,
                    steps=cfg.ode_steps, mask=mask, kv_valid=kv_valid,
                    drop=drop, adjoint=cfg.ode_adjoint, rtol=cfg.ode_rtol,
                    atol=cfg.ode_atol,
                    scan_budget=cfg.ode_scan_budget or None, mesh=enc_mesh,
                    ring_axis=ring_axis, group=group)
    if cfg.attn_axis == "scene":
        z = z.reshape(B, N, D)
    else:
        z = z[:, :, 0].transpose(0, 1)                         # [B, N, D]
    return torch.cat([x, z], dim=-1).reshape(B * N, 2 * D)


def encode_past(params: dict, cfg: STTODEConfig, batch: Batch, *,
                isolate_scenes: bool = False, train: bool = False,
                keep_mask: torch.Tensor | None = None,
                enc_masks: list | None = None,
                generator: torch.Generator | None = None,
                mesh=None) -> torch.Tensor:
    """past_feature [M, 2D]."""
    return _encode_trunk(params["past_encoder"], cfg, batch.inputs,
                         batch.batch_size, batch.agent_num, batch.valid,
                         isolate_scenes=isolate_scenes, train=train,
                         keep_mask=keep_mask, enc_masks=enc_masks,
                         generator=generator, mesh=mesh)


def encode_future(params: dict, cfg: STTODEConfig, batch: Batch,
                  past_feature: torch.Tensor, *,
                  keep_mask: torch.Tensor | None = None,
                  enc_masks: list | None = None,
                  generator: torch.Generator | None = None,
                  mesh=None) -> DiagNormal:
    """Posterior q(z | past, future), a training-only head: the future trunk
    (its PE dropout on), then the posterior head on [past_feature |
    future_feature]."""
    fut_feat = _encode_trunk(params["future_encoder"], cfg,
                             batch.inputs_for_posterior, batch.batch_size,
                             batch.agent_num, batch.valid, train=True,
                             keep_mask=keep_mask, enc_masks=enc_masks,
                             generator=generator, mesh=mesh)
    h = torch.cat([past_feature, fut_feat], dim=-1)
    h = core.mlp(params["out_mlp"], h, activation="relu", activate_final=True)
    return DiagNormal.from_params(core.dense(params["qz_layer"], h))


def prior(params: dict, cfg: STTODEConfig,
          past_feature: torch.Tensor) -> DiagNormal:
    """p(z): N(0, I), or under ``learn_prior`` the diagonal Gaussian whose
    (mu, logvar) ``pz_layer`` reads off the past feature."""
    if cfg.learn_prior:
        return DiagNormal.from_params(core.dense(params["pz_layer"],
                                                 past_feature))
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


def _bf16_tree(tree):
    """Cast every floating leaf to bfloat16. The cast is differentiable:
    fp32 master weights receive fp32 gradients through it."""
    return bridge.tree_map(
        lambda t: t.to(torch.bfloat16) if t.is_floating_point() else t, tree)


def _decode_mp(params: dict, cfg: STTODEConfig, past_feature, z, past_traj,
               cur_location, sample_num: int, *, block0_state):
    """``decode`` at ``cfg.decode_dtype`` storage. Under "bfloat16" the
    decoder params and every operand are cast once at entry, every decode
    activation is stored in bf16, and the outputs return in fp32 so the loss
    reductions keep fp32 numerics."""
    if cfg.decode_dtype != "bfloat16":
        return decode(params, cfg, past_feature, z, past_traj, cur_location,
                      sample_num, block0_state=block0_state)
    b0 = None if block0_state is None else _bf16_tree(block0_state)
    out, rec = decode({"decoder": _bf16_tree(params["decoder"])}, cfg,
                      _bf16_tree(past_feature), _bf16_tree(z),
                      _bf16_tree(past_traj), _bf16_tree(cur_location),
                      sample_num, block0_state=b0)
    return out.to(torch.float32), rec.to(torch.float32)


# --------------------------------------------------------------------------- #
# losses                                                                      #
# --------------------------------------------------------------------------- #

def loss_pred(pred, target, batch_size, valid):
    """ΣSE / B / T — the reference's normalization (÷batch÷horizon, not
    ÷agents); ``valid`` [M] masks padded agents."""
    se = torch.square(target - pred) * valid[:, None, None]
    return torch.sum(se) / batch_size / pred.shape[1]


def _masked_mean(per_agent, valid, count=None):
    """Mean of a per-agent [M] quantity over the real agents (the
    reference's B·N denominator on an unpadded batch); ``count`` is the
    real agents' count when it is not ``valid``'s (under a mesh: every
    rank's)."""
    if count is None:
        count = torch.sum(valid)
    return torch.sum(per_agent * valid) / torch.clamp(count, min=1.0)


def loss_kl(qz: DiagNormal, pz: DiagNormal, min_clip, valid, count=None,
            group=None):
    """Σ KL / (real agent count), floored at min_clip with max() (quirk Q5:
    zero gradient while the unfloored loss is below the floor). Under a
    mesh ``count`` is every rank's count of real agents and ``group`` sums
    the ranks' shares before the floor, so that its gate reads the global
    mean."""
    loss = _masked_mean(torch.sum(qz.kl(pz), dim=-1), valid, count)
    if group is not None:
        loss = collectives.global_sum(loss, group)
    # the floor made on the device (a host scalar tensor would be copied)
    return torch.maximum(loss, torch.full_like(loss, min_clip))


def loss_diverse(pred_k, target, valid, count=None):
    """Best-of-K: min over samples of ΣSE, averaged over agents.
    pred_k [M, K, T, 2], target [M, T, 2]."""
    dist = torch.sum(torch.square(target[:, None] - pred_k), dim=(-1, -2))
    return _masked_mean(torch.min(dist, dim=1).values, valid, count)


# --------------------------------------------------------------------------- #
# training forward                                                            #
# --------------------------------------------------------------------------- #

class TrainNoise(NamedTuple):
    """The training forward's random draws, for injection: the positional
    encoding's dropout keep-masks of the past [M, T_p, D] and future
    [M, T_f, D] trunks (bool), the posterior latent noise [M, Z], the
    prior latent noise [M·K, Z] (m-major: row m·K + k), and under
    ``dropout > 0`` the encoder layers' keep-masks of the past and future
    trunks (a list of ``nn.transformer.LayerDropMasks``, one per layer;
    None: drawn from the generator)."""
    pe_past: torch.Tensor
    pe_future: torch.Tensor
    eps_q: torch.Tensor
    eps_p: torch.Tensor
    enc_past: list | None = None
    enc_future: list | None = None


def draw_train_noise(cfg: STTODEConfig, B: int, N: int,
                     generator: torch.Generator | None, device,
                     dtype=torch.float32) -> TrainNoise:
    """The draws of ``sttode_forward`` over B scenes × N agents, from
    ``generator`` (on ``device``; the latent noise in ``dtype``, the
    model's), in the order the forward uses them: the
    past trunk's PE keep-mask and encoder masks, the future trunk's, the
    posterior noise, the prior noise (when "diverse" is a loss term).
    Fields that the config does not draw are None."""
    M, D = B * N, cfg.hidden_dim
    tokens = (B, N, 1, D) if cfg.attn_axis == "scene" else (N, B, 1, D)

    def trunk(T):
        pe = (torch.rand((M, T, D), generator=generator, device=device)
              < 1.0 - cfg.pe_dropout) if cfg.pe_dropout > 0.0 else None
        enc = draw_dropout_masks(cfg.layer_cfg, tokens, cfg.nlayer,
                                 generator, device) \
            if cfg.dropout > 0.0 else None
        return pe, enc

    pe_past, enc_past = trunk(cfg.past_length)
    pe_future, enc_future = trunk(cfg.future_length)
    eps_q = torch.randn((M, cfg.zdim), generator=generator, dtype=dtype,
                        device=device)
    eps_p = torch.randn((M * cfg.sample_k, cfg.zdim), generator=generator,
                        dtype=dtype, device=device) \
        if "diverse" in cfg.loss_terms else None
    return TrainNoise(pe_past, pe_future, eps_q, eps_p, enc_past, enc_future)


def _rows(x, index: int, rows: int, dim: int = 0):
    return None if x is None else x.narrow(dim, index * rows, rows)


def _local_noise(noise: TrainNoise, cfg: STTODEConfig, B: int, N: int,
                 index: int) -> TrainNoise:
    """This rank's part of the global draws: block ``index`` of B scenes
    (its rows, and its scenes' entries of the encoder masks: the query
    rows of the attention masks and the token rows of the others on the
    scene axis, the batch rows on the agent axis)."""
    M, K = B * N, cfg.sample_k
    scene = cfg.attn_axis == "scene"

    def enc(masks):
        if masks is None:
            if cfg.dropout > 0.0:
                raise ValueError("under a mesh an injected TrainNoise "
                                 "carries the encoder's dropout masks")
            return None
        return [LayerDropMasks(
            _rows(m.attn, index, B, 2 if scene else 0),
            *(_rows(t, index, B, 0 if scene else 1)
              for t in (m.resid1, m.ffn, m.resid2))) for m in masks]

    return TrainNoise(_rows(noise.pe_past, index, M),
                      _rows(noise.pe_future, index, M),
                      _rows(noise.eps_q, index, M),
                      _rows(noise.eps_p, index, M * K),
                      enc(noise.enc_past), enc(noise.enc_future))


def check_mesh(mesh) -> None:
    """Raise NotImplementedError for a mesh the model does not run on: a
    "model" axis (tensor parallelism). A "seq" axis runs (the module's
    docstring)."""
    if mesh is not None and mesh_shape(mesh).get("model", 1) > 1:
        raise NotImplementedError(TP_NOT_PORTED)


class ForwardOutput(NamedTuple):
    total_loss: torch.Tensor
    loss_pred: torch.Tensor
    loss_recover: torch.Tensor
    loss_kl: torch.Tensor
    loss_diverse: torch.Tensor
    qz: DiagNormal
    pz: DiagNormal
    past_feature: torch.Tensor
    pred_traj: torch.Tensor     # [M, T_f, 2] posterior decode
    diverse_pred: torch.Tensor  # [M, K, T_f, 2] prior samples, values only.
                                # NaN on the selection-kernel route (only
                                # the [M, K] distances leave the kernel);
                                # zeros when "diverse" is not a loss term.


def _select_dist(params, cfg: STTODEConfig, batch: Batch, past_feature,
                 pz_sample, state0, K: int):
    """Gradient-free decode of all K prior samples → (dist [M, K], diverse
    [M, K, T_f, 2] or NaN). Routes: the selection kernel in mode "dist" at
    ``select_dtype`` ("fused", or "auto" on CUDA; the plain version of the
    kernel on a CPU tensor); otherwise the plain decode, which under
    ``select_dtype="bfloat16"`` runs wholly in bf16 (params and inputs cast
    once, every intermediate stored bf16)."""
    M, Tf = past_feature.shape[0], cfg.future_length
    use_kernel = cfg.select_impl == "fused" or (
        cfg.select_impl == "auto" and past_feature.is_cuda)
    with torch.no_grad():
        if use_kernel:
            dist = select_decode(
                params, past_feature, pz_sample.reshape(M, K, -1)
                .transpose(0, 1), state0, batch.past.reshape(M, -1),
                (batch.future - batch.cur_location).reshape(M, -1),
                mode="dist", dtype=getattr(torch, cfg.select_dtype))
            diverse = torch.full((M, K, Tf, 2), float("nan"),
                                 device=past_feature.device)
            return dist, diverse
        pf_k = past_feature.repeat_interleave(K, dim=0)
        if cfg.select_dtype == "bfloat16":
            diverse, _ = decode(
                {"decoder": _bf16_tree(params["decoder"])}, cfg,
                _bf16_tree(pf_k), _bf16_tree(pz_sample),
                _bf16_tree(batch.past), _bf16_tree(batch.cur_location), K,
                block0_state=_bf16_tree(state0))
            diverse = diverse.to(batch.future.dtype)
        else:
            diverse, _ = decode(params, cfg, pf_k, pz_sample, batch.past,
                                batch.cur_location, K, block0_state=state0)
        diverse = diverse.reshape(M, K, Tf, 2)
        dist = torch.sum(torch.square(batch.future[:, None] - diverse),
                         dim=(-1, -2))
    return dist, diverse


def sttode_forward(params: dict, cfg: STTODEConfig, batch: Batch, *,
                   generator: torch.Generator | None = None,
                   noise: TrainNoise | None = None,
                   mesh=None) -> ForwardOutput:
    """Full CVAE training forward: posterior decode + KL + best-of-K diverse
    loss. The random draws are ``noise`` when given, else drawn from
    ``generator`` (on the batch's device, ``draw_train_noise``). With
    ``diverse_grad="sparse"`` the K samples are decoded without gradients
    only to pick each agent's winner, and ONE differentiable decode of
    (posterior, winner) follows; "dense" back-propagates through all K.

    Under a ``mesh`` (data parallelism, ``check_mesh``) ``batch`` is this
    rank's block of whole scenes and ``noise`` the global draws (those of
    the whole batch; drawn so from ``generator`` when not given). The loss
    values are the global losses, alike on every rank; each rank's
    backward pass gives its share of the gradient, whose sum over the
    ranks is the single process's gradient. The other outputs are this
    rank's rows."""
    B, N = batch.batch_size, batch.agent_num
    M = B * N
    K = cfg.sample_k
    valid = batch.valid
    check_mesh(mesh)
    group = None if mesh is None else mesh.get_group("data")
    dp = axis_size(mesh, "data")
    if noise is None:
        noise = draw_train_noise(cfg, B * dp, N, generator,
                                 batch.past.device, batch.past.dtype)
    nz = noise if mesh is None else _local_noise(
        noise, cfg, B, N, axis_rank(mesh, "data"))

    past_feature = encode_past(params, cfg, batch, train=True,
                               keep_mask=nz.pe_past, enc_masks=nz.enc_past,
                               generator=generator, mesh=mesh)
    qz = encode_future(params, cfg, batch, past_feature,
                       keep_mask=nz.pe_future, enc_masks=nz.enc_future,
                       generator=generator, mesh=mesh)
    pz = prior(params, cfg, past_feature)
    qz_sample = qz.rsample(generator, noise=nz.eps_q)

    # decompose block 0's GRU state depends only on past_traj: one scan
    # serves every decode below
    state0 = decode_block0_state(params, batch.past)

    # the real agents of the whole batch: the means' denominator
    count = torch.sum(valid)
    if group is not None:
        count = collectives.all_reduce(count.detach().clone(), group)

    sparse = cfg.diverse_grad == "sparse" and K > 1 and \
        "diverse" in cfg.loss_terms
    if sparse:
        # deferred: the posterior decode batches with the winner's below
        pred_traj = recover_traj = None
    else:
        pred_traj, recover_traj = _decode_mp(params, cfg, past_feature,
                                             qz_sample, batch.past,
                                             batch.cur_location, 1,
                                             block0_state=state0)
    l_kl = loss_kl(qz, pz, cfg.min_clip, valid, count, group)

    if "diverse" not in cfg.loss_terms:
        # VAE-only objective: no K-sample decode at all
        l_div = past_feature.new_zeros(())
        diverse = past_feature.new_zeros((M, K, cfg.future_length, 2))
    else:
        pz_sample = prior(params, cfg,
                          past_feature.repeat_interleave(K, dim=0)) \
            .rsample(generator, noise=nz.eps_p)              # [M·K, Z]
        if sparse:
            dist, diverse = _select_dist(params, cfg, batch, past_feature,
                                         pz_sample, state0, K)
            best = torch.argmin(dist, dim=1)                   # [M]
            # the winners' latents, gathered from the non-stopped samples
            z_best = pz_sample.reshape(M, K, -1)[
                torch.arange(M, device=best.device), best]
            # ONE differentiable decode for (posterior, winner), interleaved
            # as a sample axis of 2
            pf2 = past_feature.repeat_interleave(2, dim=0)
            z2 = torch.stack([qz_sample, z_best], dim=1).reshape(2 * M, -1)
            out2, rec2 = _decode_mp(params, cfg, pf2, z2, batch.past,
                                    batch.cur_location, 2,
                                    block0_state=state0)
            out2 = out2.reshape(M, 2, cfg.future_length, 2)
            pred_traj, best_pred = out2[:, 0], out2[:, 1]
            recover_traj = rec2.reshape(M, 2, cfg.past_length, 2)[:, 0]
            best_se = torch.sum(torch.square(batch.future - best_pred),
                                dim=(-1, -2))
            l_div = _masked_mean(best_se, valid, count)
        else:
            diverse, _ = _decode_mp(params, cfg,
                                    past_feature.repeat_interleave(K, dim=0),
                                    pz_sample, batch.past,
                                    batch.cur_location, K, block0_state=state0)
            diverse = diverse.reshape(M, K, cfg.future_length, 2)
            l_div = loss_diverse(diverse, batch.future, valid, count)

    l_pred = loss_pred(pred_traj, batch.future, B * dp, valid)
    l_recover = loss_pred(recover_traj, batch.past, B * dp, valid)
    parts = torch.stack([l_pred, l_recover, l_div])
    if group is not None:
        # each rank's terms are its shares of the global ones
        parts = collectives.global_sum(parts, group)
    l_pred, l_recover, l_div = parts.unbind()
    terms = {"pred": l_pred, "recover": l_recover, "kl": l_kl,
             "diverse": l_div}
    total = sum(terms[name] for name in cfg.loss_terms)
    return ForwardOutput(total, l_pred, l_recover, l_kl, l_div, qz, pz,
                         past_feature, pred_traj, diverse.detach())


# --------------------------------------------------------------------------- #
# inference                                                                   #
# --------------------------------------------------------------------------- #

def sttode_inference(params: dict, cfg: STTODEConfig, batch: Batch, *,
                     generator: torch.Generator | None = None,
                     z: torch.Tensor | None = None,
                     sample_k: int | None = None,
                     isolate_scenes: bool = False,
                     mesh=None) -> torch.Tensor:
    """Best-of-K prior decode: [K, M, T_f, 2] in scene-normalized
    coordinates (the caller re-adds the scene origin).

    The only random draw is the prior's standard-normal noise [M·K, Z]
    (m-major: row m·K + k), taken from ``generator`` (on the batch's
    device) unless injected with ``z``; it is the latent itself under the
    standard prior, and ``mu + z·sigma`` under ``learn_prior``. Under a
    ``mesh`` ``batch`` is this rank's block of whole scenes, ``z`` (or
    the draw) is that of the whole batch, and the result is this rank's
    rows."""
    K = sample_k or cfg.sample_k
    M = batch.batch_size * batch.agent_num
    Tf = cfg.future_length
    check_mesh(mesh)
    dp = axis_size(mesh, "data")
    past_feature = encode_past(params, cfg, batch,
                               isolate_scenes=isolate_scenes, mesh=mesh)
    if z is not None and tuple(z.shape) != (dp * M * K, cfg.zdim):
        raise ValueError(f"z must be [{dp * M * K}, {cfg.zdim}], got "
                         f"{tuple(z.shape)}")
    if mesh is not None:
        if z is None:
            z = torch.randn((dp * M * K, cfg.zdim), generator=generator,
                            dtype=past_feature.dtype,
                            device=past_feature.device)
        z = _rows(z, axis_rank(mesh, "data"), M * K)
    if z is None or cfg.learn_prior:
        z = prior(params, cfg, past_feature.repeat_interleave(K, dim=0)) \
            .rsample(generator, noise=z)

    if cfg.select_impl != "xla" and past_feature.is_cuda:
        state0 = decode_block0_state(params, batch.past)
        z_km = z.reshape(M, K, -1).transpose(0, 1)
        rel = select_decode(params, past_feature, z_km, state0,
                            batch.past.reshape(M, -1), mode="traj")
        return rel.reshape(K, M, Tf, 2) + batch.cur_location[None]

    diverse, _ = decode(params, cfg, past_feature.repeat_interleave(K, dim=0),
                        z, batch.past, batch.cur_location, K)
    return diverse.reshape(M, K, Tf, 2).transpose(0, 1)
