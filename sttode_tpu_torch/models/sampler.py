"""The DLow-style diversity sampler, stage 2, and its losses (port of
``sttode_tpu/models/sampler.py``).

The sampler learns an affine flow ``z_k = A_k ⊙ ε + b_k`` over the frozen
stage-1 net's latent space, so that the K decodes of one agent spread out;
it is trained with KL(sampler ‖ the net's prior) plus a pairwise repulsion
of the K decodes.

The frozen net: its parameters are used detached (the counterpart of JAX's
``stop_gradient``; ``pz_layer`` too, under ``learn_prior``) and the past
encoder runs without autograd, since its output does not depend on the
sampler's parameters: no attention backward runs, no net leaf receives a
gradient, and a dopri5 net integrates on the while form. The decodes stay differentiable
in their activations, so the sampler's parameters receive gradients through
the net's decoder, as in the reference's trainer. Both decodes go through
``_decode_mp`` at ``cfg.decode_dtype``, never through the selection-decode
kernel, as in the JAX package.

Data parallelism (``mesh=``, as in ``models.sttode``): each rank passes its
block of whole scenes; the frozen encoder attends each rank's scenes to
the keys and values of every rank's, ε is the single process's draw (the
one shared row alike on every rank, or each rank's rows of the [M, nz]
draw), and the losses' sums, real-agent counts and the KL floor's gate
are global, so every rank computes the single process's losses.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sttode_tpu_torch import bridge
from sttode_tpu_torch.models.sttode import (Batch, STTODEConfig, _decode_mp,
                                            _rows, check_mesh, encode_past,
                                            prior)
from sttode_tpu_torch.nn import core
from sttode_tpu_torch.parallel import collectives
from sttode_tpu_torch.parallel.mesh import axis_rank, axis_size
from sttode_tpu_torch.utils.distributions import DiagNormal


class SamplerConfig(NamedTuple):
    """Stage-2 hyperparameters, field for field the JAX ``SamplerConfig``
    (the reference trainer's defaults)."""
    nk: int = 20                    # number of diverse samples
    nz: int = 32                    # latent dim
    qnet_mlp: tuple = (512, 256)
    share_eps: bool = True
    train_w_mean: bool = True
    kld_weight: float = 0.1
    kld_min_clamp: float = 10.0
    div_weight: float = 1.0
    div_scale: float = 1.0


DIVERSITY_CONFIG = {
    # dataset -> (div_weight, div_scale), the reference trainer's table
    "sdd": (0.5, 0.5),
    "eth": (1.0, 1.0),
    "univ": (10.0, 10.0),
    "nba": (1.0, 1.0),
    "hotel": (3.0, 2.0),
    "zara1": (3.0, 2.0),
    "zara2": (3.0, 2.0),
}


def sampler_init(gen: torch.Generator | int, cfg: SamplerConfig,
                 pred_model_dim: int = 64, past_feature_dim: int = 128,
                 dtype=torch.float32) -> dict:
    """Random sampler parameters (on the CPU) with the JAX package's tree and
    initializer distributions, drawn from ``gen`` (a CPU generator or a
    seed): linear (past feature → model dim), the tanh MLP ``qnet_mlp``
    (N(0, 0.01²) weights, zero biases), the A and b heads (→ nk·nz) and q_c
    (nk·nz → nz)."""
    if isinstance(gen, int):
        gen = torch.Generator().manual_seed(gen)
    kz = cfg.nk * cfg.nz
    return {
        "linear": core.dense_init(gen, past_feature_dim, pred_model_dim,
                                  dtype),
        "q_mlp": core.mlp_init_normal001(gen, pred_model_dim,
                                         list(cfg.qnet_mlp), dtype),
        "q_A": core.dense_init(gen, cfg.qnet_mlp[-1], kz, dtype),
        "q_b": core.dense_init(gen, cfg.qnet_mlp[-1], kz, dtype),
        "q_c": core.dense_init(gen, kz, cfg.nz, dtype),
    }


class SamplerOutput(NamedTuple):
    dec_motion: torch.Tensor     # [M, K, T_f, 2] diverse decode (scene-normed)
    sampler_dist: DiagNormal     # q(z) = N(b, A²)  [M·K, nz]
    vae_dist: DiagNormal         # the frozen net's prior, repeated K times
    recon_motion: torch.Tensor   # [M, T_f, 2] decode of the fused latent


def sampler_forward(sampler_params: dict, net_params: dict,
                    scfg: SamplerConfig, cfg: STTODEConfig, batch: Batch, *,
                    mean: bool | None = None,
                    generator: torch.Generator | None = None,
                    eps: torch.Tensor | None = None,
                    isolate_scenes: bool = False,
                    mesh=None) -> SamplerOutput:
    """The sampler's forward over the frozen net. ``mean=None`` resolves to
    ``scfg.train_w_mean`` (the default deterministic path, z = b); with
    ``mean=False`` the latents are A·ε + b, ε one [1, nz] draw shared by
    every row under ``share_eps``, else one [M, nz] draw shared by each
    agent's K samples. ε is injected with ``eps`` (that draw's shape) or
    drawn from ``generator`` (on the batch's device). ``isolate_scenes``
    keeps every scene its own attention problem on the scene axis (the
    server's contract). Under a ``mesh`` ``batch`` is this rank's block of
    whole scenes, ε (injected or drawn) the whole batch's, and the outputs
    this rank's rows."""
    if mean is None:
        mean = scfg.train_w_mean
    check_mesh(mesh)
    net_params = bridge.tree_map(torch.Tensor.detach, net_params)
    M = batch.batch_size * batch.agent_num
    K, Z = scfg.nk, scfg.nz
    dp = axis_size(mesh, "data")

    with torch.no_grad():
        past_feature = encode_past(net_params, cfg, batch,
                                   isolate_scenes=isolate_scenes, mesh=mesh)

    h = core.dense(sampler_params["linear"], past_feature)        # [M, 64]
    h = core.mlp(sampler_params["q_mlp"], h, activation="tanh",
                 activate_final=True)                              # [M, 256]
    A = core.dense(sampler_params["q_A"], h).reshape(M * K, Z)
    b = core.dense(sampler_params["q_b"], h).reshape(M * K, Z)

    if mean:
        z_flow = b
    else:
        shape = (1, Z) if scfg.share_eps else (dp * M, Z)
        if eps is None:
            eps = torch.randn(shape, generator=generator, dtype=b.dtype,
                              device=b.device)
        elif tuple(eps.shape) != shape:
            raise ValueError(f"eps must be {list(shape)}, got "
                             f"{list(eps.shape)}")
        if mesh is not None and not scfg.share_eps:
            eps = _rows(eps, axis_rank(mesh, "data"), M)
        # one draw for every row, or each agent's draw for its K rows
        eps = eps.expand(M * K, Z) if scfg.share_eps \
            else eps.repeat_interleave(K, dim=0)
        z_flow = A * eps + b

    sampler_dist = DiagNormal(mu=b, logvar=torch.log(torch.square(A) + 1e-8))

    # q_c fuses the K flow latents into one: the reconstruction decode
    z_fused = core.dense(sampler_params["q_c"], z_flow.reshape(M, K * Z))
    recon_motion, _ = _decode_mp(net_params, cfg, past_feature, z_fused,
                                 batch.past, batch.cur_location, 1,
                                 block0_state=None)

    # the diverse decode of the K flow latents, agent-major (row m·K + k)
    past_feature_k = past_feature.repeat_interleave(K, dim=0)
    diverse, _ = _decode_mp(net_params, cfg, past_feature_k, z_flow,
                            batch.past, batch.cur_location, K,
                            block0_state=None)
    dec_motion = diverse.reshape(M, K, cfg.future_length, 2)

    vae_dist = prior(net_params, cfg, past_feature_k)
    return SamplerOutput(dec_motion, sampler_dist, vae_dist, recon_motion)


# --------------------------------------------------------------------------- #
# stage-2 losses                                                              #
# --------------------------------------------------------------------------- #

def _global_count(valid: torch.Tensor, group) -> torch.Tensor:
    """The real agents of ``valid`` (of every rank's under ``group``), at
    least 1."""
    count = torch.sum(valid)
    if group is not None:
        count = collectives.all_reduce(count.detach().clone(), group)
    return torch.clamp(count, min=1.0)


def _global_total(x: torch.Tensor, group) -> torch.Tensor:
    total = torch.sum(x)
    return total if group is None else collectives.global_sum(total, group)


def sampler_kld(sampler_dist: DiagNormal, vae_dist: DiagNormal,
                agent_num: int, min_clip: float, weight: float,
                valid: torch.Tensor | None = None, group=None):
    """(weighted, unweighted) KL(sampler ‖ prior) over the agents, floored
    at ``min_clip`` with max() (quirk Q5: no gradient below the floor).
    With ``valid`` [M] the padded agents' rows are dropped and the sum is
    divided by the real agent count (at least 1), as the reference, which
    never pads, divides. Under data parallelism ``group`` sums the ranks'
    KL and real agents before the floor, and ``agent_num`` counts every
    rank's agents."""
    kl = sampler_dist.kl(vae_dist)                               # [M·K, Z]
    if valid is not None:
        K = kl.shape[0] // valid.shape[0]
        kl = kl * valid.repeat_interleave(K)[:, None]
        denom = _global_count(valid, group)
    else:
        denom = agent_num
    loss_uw = _global_total(kl, group) / denom
    loss_uw = torch.maximum(loss_uw, torch.full_like(loss_uw, min_clip))
    return weight * loss_uw, loss_uw


def sampler_diversity(dec_motion: torch.Tensor, agent_num: int,
                      weight: float, scale: float,
                      valid: torch.Tensor | None = None, group=None):
    """(weighted, unweighted) repulsion exp(−‖Δ‖² / scale) between the K
    samples of each agent (dec_motion [M, K, T, 2]), averaged over the
    K·(K − 1) ordered pairs, summed over the agents and divided by their
    count (the real ones under ``valid``, at least 1). The grouping is per
    agent (PARITY.md, Q11). ``group`` and ``agent_num`` as in
    ``sampler_kld``."""
    M, K = dec_motion.shape[:2]
    flat = dec_motion.reshape(M, K, -1)
    d2 = torch.sum(torch.square(flat[:, :, None] - flat[:, None, :]), dim=-1)
    off_diag = 1.0 - torch.eye(K, dtype=flat.dtype, device=flat.device)
    per_agent = torch.sum(torch.exp(-d2 / scale) * off_diag, dim=(1, 2)) / (
        K * (K - 1))
    if valid is not None:
        per_agent = per_agent * valid
        denom = _global_count(valid, group)
    else:
        denom = agent_num
    loss_uw = _global_total(per_agent, group) / denom
    return weight * loss_uw, loss_uw


def sampler_loss(out: SamplerOutput, scfg: SamplerConfig, batch: Batch,
                 mesh=None):
    """The stage-2 objective, weighted KL + weighted diversity (the
    reference's reconstruction term is off in its totals and is left out):
    (total, {"kld": unweighted KL, "diverse": unweighted diversity}). Under
    a ``mesh`` ``out`` and ``batch`` are this rank's rows and the losses
    the whole batch's, alike on every rank."""
    group = None if mesh is None else mesh.get_group("data")
    M = batch.batch_size * batch.agent_num * axis_size(mesh, "data")
    kld, kld_uw = sampler_kld(out.sampler_dist, out.vae_dist, M,
                              scfg.kld_min_clamp, scfg.kld_weight, batch.valid,
                              group)
    div, div_uw = sampler_diversity(out.dec_motion, M, scfg.div_weight,
                                    scfg.div_scale, batch.valid, group)
    return kld + div, {"kld": kld_uw, "diverse": div_uw}
