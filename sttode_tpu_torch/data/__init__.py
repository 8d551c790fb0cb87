"""Data pipelines of the port (numpy on the host, no JAX): the ETH-UCY, SDD
and NBA loaders, scene preparation and bucketed padded batching; the
prefetch thread is ``data.prefetch``."""

from sttode_tpu_torch.data.batching import (
    DEFAULT_BUCKETS,
    bucket_for,
    compiled_shape_count,
    scene_batches,
)
from sttode_tpu_torch.data.eth_ucy import load_eth_ucy, poly_fit_nonlinear
from sttode_tpu_torch.data.nba import load_nba, nba_batches
from sttode_tpu_torch.data.preprocess import (
    prepare_nba_batch,
    prepare_scene,
    rotate_2d,
    stack_scenes,
)
from sttode_tpu_torch.data.sdd import load_sdd

__all__ = [
    "DEFAULT_BUCKETS", "bucket_for", "compiled_shape_count", "scene_batches",
    "load_eth_ucy", "poly_fit_nonlinear", "load_nba", "nba_batches",
    "prepare_nba_batch", "prepare_scene", "rotate_2d",
    "stack_scenes", "load_sdd",
]
