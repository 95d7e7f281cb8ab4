"""ivfadc_tpu.parallel — scale-out: device meshes, sharded serving,
distributed build, multi-host bootstrap, shard-aware persistence.

The reference has no distributed support (SURVEY §2.4;
/root/reference/TODO.md:2 marks parallelism as future work) — this package
is the from-scratch scale-out story: inverted lists sharded over a "shard"
mesh axis, queries data-parallel over a "data" axis, XLA collectives over
NCCL.
"""

from ivfadc_tpu.parallel.bootstrap import (initialize_cluster, process_info,
                                           shutdown_cluster)
from ivfadc_tpu.parallel.mesh import (DATA_AXIS, SHARD_AXIS, make_mesh)
from ivfadc_tpu.parallel.persistence import (consolidate_sharded_index,
                                             consolidate_sharded_to_file,
                                             load_sharded_index,
                                             save_sharded_index)
from ivfadc_tpu.parallel.sharded import ShardedIVFADCIndex

__all__ = [
    "ShardedIVFADCIndex", "make_mesh", "SHARD_AXIS", "DATA_AXIS",
    "save_sharded_index", "load_sharded_index", "consolidate_sharded_index",
    "consolidate_sharded_to_file",
    "initialize_cluster", "shutdown_cluster", "process_info",
]
