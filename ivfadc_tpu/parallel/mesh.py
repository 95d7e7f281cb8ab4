"""Device-mesh helpers.

The reference has zero distributed support (SURVEY §2.4). This layer is the
scale-out story: inverted lists are sharded over a `"shard"` mesh axis,
query batches over a `"data"` axis; codebooks/centroids are replicated
(they're small). On GPUs XLA runs the collectives over NCCL; the cards of
one host are joined all to all, so the mesh shape follows the algorithm
alone.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

SHARD_AXIS = "shard"
DATA_AXIS = "data"


def make_mesh(n_shards: int = 0, n_data: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a (data, shard) mesh. n_shards=0 -> use all remaining devices."""
    devices = list(devices if devices is not None else jax.devices())
    if n_shards == 0:
        n_shards = len(devices) // n_data
        if n_shards == 0:
            raise ValueError(
                f"n_data={n_data} exceeds the {len(devices)} available "
                "devices — no room for a shard axis")
    need = n_data * n_shards
    if need > len(devices):
        raise ValueError(f"need {need} devices, have {len(devices)}")
    dev_array = np.asarray(devices[:need]).reshape(n_data, n_shards)
    return Mesh(dev_array, (DATA_AXIS, SHARD_AXIS))


def shard_spec(mesh: Mesh) -> NamedSharding:
    """Leading-axis sharding over the shard axis (for stacked per-shard arrays)."""
    return NamedSharding(mesh, P(SHARD_AXIS))


def replicated_spec(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def data_spec(mesh: Mesh) -> NamedSharding:
    """Batch-axis sharding over the data axis (for query batches)."""
    return NamedSharding(mesh, P(DATA_AXIS))
