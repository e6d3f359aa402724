"""Multi-chip parallelism: mesh construction and sharding helpers.

The reference has no distributed training (SURVEY.md §2.6) — its only
multi-GPU feature is render offload via peer copies. The design here:
- one `jax.sharding.Mesh` with a `data` axis over all chips (rays/pixels/
  samples sharded), parameters replicated;
- gradients are reduced by XLA-inserted collectives: with jit +
  sharding annotations, the `psum` appears automatically from the batch
  reduction in the loss;
- occupancy-grid updates computed on sharded samples then max-reduced.
"""

from .mesh import (data_parallel_mesh, replicate, shard_along,  # noqa: F401
                   shard_batch)
