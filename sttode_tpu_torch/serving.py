"""Batched best-of-K inference serving (port of ``sttode_tpu/serving.py``).

``Predictor`` keeps the parameters on its device, pads incoming scenes to
agent-count buckets, and answers each group of same-bucket scenes with one
``sttode_inference`` call. Every group is launched before the first result
is copied back, so on a CUDA device the host prepares group i+1 while the
card runs group i.

Determinism contract (the latent draws are the only randomness):
- scene axis (``attn_axis="scene"``, the reference default): scenes are
  isolated — each is its own batch_size=1 problem inside the shared call and
  draws its latents from a generator seeded by (seed, scene content), so the
  same (seed, scene) gives the same samples whatever else shares the call,
  up to float reassociation across call compositions;
- agent axis: scenes of one group share one call and one generator seeded by
  (seed, group content), so the contract is per (seed, group).
Seeds are folded with crc32 of the float32 scene bytes, stable across
processes. The port's draws differ from the JAX package's (different
generators); the contract is the same.

With a trained stage-2 sampler (``sampler_params`` and ``sampler_cfg``) the
nk forecasts come from the sampler's deterministic flow (mean=True, z = b)
over the frozen net instead of prior draws (JAX's production path): the
seed then changes nothing.
"""

from __future__ import annotations

import threading
import zlib
from typing import Sequence

import numpy as np
import torch

from sttode_tpu_torch.bridge import resolve_device, to_device
from sttode_tpu_torch.data.batching import DEFAULT_BUCKETS, bucket_for
from sttode_tpu_torch.data.preprocess import prepare_scene_group
from sttode_tpu_torch.models.sampler import SamplerConfig, sampler_forward
from sttode_tpu_torch.models.sttode import STTODEConfig, sttode_inference


def _digest(obs: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(obs, np.float32).tobytes()) \
        & 0x7FFFFFFF


def _generator(seed: int, digest: int, device: torch.device) -> torch.Generator:
    state = np.random.SeedSequence([seed & 0xFFFFFFFF, digest]) \
        .generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


class Predictor:
    """Best-of-K trajectory predictor.

    >>> pred = Predictor(params, cfg, device="cuda")
    >>> samples = pred.predict(obs)     # obs [N, T_p, 2] → [K, N, T_f, 2]

    ``params`` is a port parameter tree (``sttode_init`` or
    ``bridge.params_from_jax``); it is moved to ``device``. The default is
    the card: without a CUDA device the constructor raises unless the
    caller passes ``device="cpu"``. ``sampler_params`` with ``sampler_cfg``
    serve the stage-2 sampler's nk forecasts (both or neither; nz must
    equal the net's zdim, and ``sample_k``, when given, nk)."""

    def __init__(self, params, cfg: STTODEConfig, *,
                 device: torch.device | str = "cuda",
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 sample_k: int | None = None, max_group: int = 16,
                 isolated_group_max: int = 64, sampler_params=None,
                 sampler_cfg: SamplerConfig | None = None):
        self.cfg = cfg.validate()
        if (sampler_params is None) != (sampler_cfg is None):
            raise ValueError("pass sampler_params AND sampler_cfg together")
        if sampler_cfg is not None:
            if sampler_cfg.nz != cfg.zdim:
                raise ValueError(
                    f"sampler nz {sampler_cfg.nz} must equal the net's "
                    f"zdim {cfg.zdim}")
            if sample_k is not None and sample_k != sampler_cfg.nk:
                raise ValueError(
                    f"sample_k {sample_k} conflicts with the sampler's "
                    f"nk {sampler_cfg.nk} (the flow emits exactly nk "
                    f"samples)")
            sample_k = sampler_cfg.nk
        self.device = resolve_device(device)
        self.params = to_device(params, self.device)
        self.sampler_cfg = sampler_cfg
        self.sampler_params = None if sampler_params is None else \
            to_device(sampler_params, self.device)
        self.buckets = tuple(buckets)
        self.sample_k = sample_k or cfg.sample_k
        self.max_group = max(1, int(max_group))                # agent axis
        self.isolated_group_max = max(1, int(isolated_group_max))  # scene axis
        self._lock = threading.Lock()

    def predict(self, obs: np.ndarray, *, seed: int = 0) -> np.ndarray:
        """One scene: obs [N, T_p, 2] absolute coords → samples
        [K, N, T_f, 2] absolute coords."""
        return self.predict_many([obs], seed=seed)[0]

    def predict_many(self, scenes: Sequence[np.ndarray], *,
                     seed: int = 0) -> list[np.ndarray]:
        """Several scenes; same-bucket scenes share one call, at most
        ``max_group`` (agent axis) or ``isolated_group_max`` (scene axis)
        scenes per call."""
        Tp = self.cfg.past_length
        by_bucket: dict[int, list[int]] = {}
        for i, obs in enumerate(scenes):
            if obs.ndim != 3 or obs.shape[-2:] != (Tp, 2):
                raise ValueError(
                    f"scene {i}: expected [N, {Tp}, 2], got {obs.shape}"
                    + (" — wrap a single agent as obs[None]"
                       if obs.ndim == 2 else ""))
            by_bucket.setdefault(bucket_for(len(obs), self.buckets),
                                 []).append(i)
        isolate = self.cfg.attn_axis != "agent"
        cap = self.isolated_group_max if isolate else self.max_group
        out: list[np.ndarray | None] = [None] * len(scenes)
        with self._lock, torch.inference_mode():
            launched = [self._launch_group(scenes, idxs[g0:g0 + cap], bucket,
                                           seed, isolate)
                        for bucket, idxs in sorted(by_bucket.items())
                        for g0 in range(0, len(idxs), cap)]
            for preds_dev, idxs, ns, origs in launched:
                preds = preds_dev.cpu().numpy()       # [K, B, bucket, Tf, 2]
                for j, i in enumerate(idxs):
                    out[i] = preds[:, j, :ns[j]] + origs[j][None, None, None]
        return out  # type: ignore[return-value]

    def _launch_group(self, scenes, idxs, bucket, seed, isolate):
        """Prepare one group on the host and start its inference; returns
        the device result [K, B, bucket, T_f, 2] un-fetched."""
        cfg, K = self.cfg, self.sample_k
        B = len(idxs)
        obs = np.zeros((B, bucket, cfg.past_length, 2), np.float32)
        valid = np.zeros((B, bucket), np.float32)
        ns = []
        for j, i in enumerate(idxs):
            a = np.asarray(scenes[i], np.float32)
            obs[j, :len(a)] = a
            valid[j, :len(a)] = 1.0
            ns.append(len(a))
        pred_zeros = np.zeros((B, bucket, cfg.future_length, 2), np.float32)
        batch, origs = prepare_scene_group(obs, pred_zeros, valid,
                                           training=False)
        batch = batch.to(self.device)
        if self.sampler_params is not None:
            dec = sampler_forward(self.sampler_params, self.params,
                                  self.sampler_cfg, cfg, batch, mean=True,
                                  isolate_scenes=isolate).dec_motion
            return (dec.transpose(0, 1).reshape(K, B, bucket,
                                                cfg.future_length, 2),
                    idxs, ns, origs)
        if isolate:
            # per-scene draws: rows of scene j are [j·bucket·K, (j+1)·bucket·K)
            z = torch.cat([
                torch.randn((bucket * K, cfg.zdim), device=self.device,
                            generator=_generator(seed, _digest(scenes[i]),
                                                 self.device))
                for i in idxs])
        else:
            digest = 0
            for i in idxs:
                digest ^= _digest(scenes[i])
            z = torch.randn((B * bucket * K, cfg.zdim), device=self.device,
                            generator=_generator(seed, digest, self.device))
        preds = sttode_inference(self.params, cfg, batch, z=z, sample_k=K,
                                 isolate_scenes=isolate)
        return (preds.reshape(K, B, bucket, cfg.future_length, 2), idxs, ns,
                origs)

    def warmup(self, agent_counts: Sequence[int] = (1,), *,
               scenes_per: int = 1) -> None:
        """Run one call per expected bucket (builds the CUDA kernels and
        warms the allocator before the first real request)."""
        for n in agent_counts:
            obs = np.zeros((n, self.cfg.past_length, 2), np.float32)
            self.predict_many([obs] * scenes_per)
