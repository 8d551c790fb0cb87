"""Bucketed padded scene batching (port of ``sttode_tpu/data/batching.py``).

The reference steps one scene of any agent count at a time. Here scenes are
padded to a small ladder of agent counts (buckets) and, with
``scenes_per_batch`` > 1, stacked into multi-scene batches of one bucket:
few distinct shapes, dense [B·N_pad] tensors, validity masks carrying
correctness. Serving shares the ladder, so that requests of similar size
share one batched call.

Numpy on the host, a copy of the JAX package's functions that draws the
numpy rng in its order (the shuffle, each cap's subsample in stream order,
then one rotation angle a scene per emitted group), so the batches equal
JAX's bit for bit for the same seed.
"""

from __future__ import annotations

from typing import Iterator, Sequence

import numpy as np

from sttode_tpu_torch.data.preprocess import prepare_scene_group
from sttode_tpu_torch.models.sttode import Batch

DEFAULT_BUCKETS = (8, 16, 32, 64, 128)


def bucket_for(n: int, buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    """Smallest bucket ≥ n; beyond the ladder, the next multiple of the
    largest bucket."""
    for b in buckets:
        if n <= b:
            return b
    top = buckets[-1]
    return ((n + top - 1) // top) * top


def _emit_group(group: list[dict], bucket: int, *, training: bool,
                rng, rand_rot: bool, compat: str = "tpu"):
    """Stack the raw scenes of one bucket and prepare them in one numpy
    pass (``prepare_scene_group``)."""
    B = len(group)
    obs = np.zeros((B, bucket) + group[0]["obs"].shape[1:], np.float32)
    pred = np.zeros((B, bucket) + group[0]["pred"].shape[1:], np.float32)
    valid = np.zeros((B, bucket), np.float32)
    for j, s in enumerate(group):
        n = s["obs"].shape[0]
        obs[j, :n] = s["obs"]
        pred[j, :n] = s["pred"]
        valid[j, :n] = 1.0
    if compat == "reference" and B > 1:
        # reference compat drops attention masks (Q2) and attends over the
        # scene axis (Q4): grouped scenes would cross-attend, and a padded
        # agent slot of one scene would enter the softmax of every other
        # scene's token for that slot. One scene a batch is safe (a softmax
        # over a single token; the losses mask padded rows).
        raise ValueError(
            "compat='reference' with scenes_per_batch>1 "
            f"(bucket {bucket}, fills {[len(s['obs']) for s in group]}): "
            "grouped scenes cross-attend on the maskless scene axis and "
            "padded agents would leak into its softmax — reference ETH/SDD "
            "numerics are per-scene. Use compat='tpu' with "
            "attn_axis='agent', or scenes_per_batch=1.")
    return prepare_scene_group(obs, pred, valid, training=training, rng=rng,
                               rand_rot=rand_rot)


def scene_batches(scenes: list[dict], *, training: bool,
                  rng: np.random.Generator | None = None,
                  scenes_per_batch: int = 1,
                  buckets: Sequence[int] = DEFAULT_BUCKETS,
                  max_train_agent: int = 100, rand_rot: bool = True,
                  shuffle: bool | None = None,
                  compat: str = "tpu") -> Iterator[tuple[Batch, np.ndarray]]:
    """Yield (Batch of CPU tensors, scene_origs [B, 2]) of static
    per-bucket shapes.

    ``scenes_per_batch=1`` is the reference's per-scene stepping (padded);
    more groups same-bucket scenes into one batch (``attn_axis="agent"``);
    a bucket's short last group is emitted as it is. In training, a scene
    above ``max_train_agent`` agents is subsampled to it with replacement
    (Q6). ``compat="reference"`` with more than one scene a group raises."""
    if training and rng is None:
        raise ValueError("scene_batches(training=True) needs an rng — "
                         "shuffling, augmentation, and agent subsampling all "
                         "draw from it (silently skipping them would change "
                         "training statistics)")
    if shuffle is None:
        shuffle = training
    if shuffle and rng is None:
        raise ValueError("shuffle=True needs an rng (silently yielding "
                         "dataset order would defeat the explicit request)")
    order = np.arange(len(scenes))
    if shuffle:
        rng.shuffle(order)

    cap = max_train_agent
    pending: dict[int, list] = {}
    for i in order:
        scene = scenes[i]
        n = scene["obs"].shape[0]
        if training and n > cap:
            idx = rng.choice(n, cap)                  # with replacement (Q6)
            scene = {"obs": scene["obs"][idx], "pred": scene["pred"][idx]}
            n = cap
        b = bucket_for(n, buckets)
        pending.setdefault(b, []).append(scene)
        if len(pending[b]) == scenes_per_batch:
            yield _emit_group(pending.pop(b), b, training=training, rng=rng,
                              rand_rot=rand_rot, compat=compat)
    for b, group in pending.items():
        yield _emit_group(group, b, training=training, rng=rng,
                          rand_rot=rand_rot, compat=compat)


def compiled_shape_count(scenes: list[dict],
                         buckets: Sequence[int] = DEFAULT_BUCKETS,
                         max_train_agent: int = 100, *,
                         training: bool = True) -> dict[int, int]:
    """Scenes per bucket: how many distinct batch shapes a sweep makes.
    ``training=False`` skips the subsampling cap (evaluation never
    subsamples, so oversized scenes land in extended buckets)."""
    counts: dict[int, int] = {}
    for s in scenes:
        n = len(s["obs"])
        if training:
            n = min(n, max_train_agent)
        b = bucket_for(n, buckets)
        counts[b] = counts.get(b, 0) + 1
    return counts
