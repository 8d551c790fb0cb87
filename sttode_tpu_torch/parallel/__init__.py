"""Parallelism over ``torch.distributed`` (port of ``sttode_tpu/parallel``):
the process-group mesh, the placement of batches and parameters, and the
ring and all-to-all (Ulysses) sequence-parallel attentions. Tensor
parallelism is not ported."""

from sttode_tpu_torch.parallel.mesh import (
    batch_sharding,
    make_mesh,
    param_sharding,
    shard_batch,
)

__all__ = ["batch_sharding", "make_mesh", "param_sharding", "shard_batch"]
