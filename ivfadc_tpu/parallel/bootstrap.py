"""Multi-host bootstrap: the `jax.distributed.initialize` entry path.

The reference is strictly single-process (SURVEY §2.4; the only parallelism
note is the TODO at /root/reference/TODO.md:2). This module is the new
framework's process-group entry point for one-process-per-host runs on a
multi-host GPU cluster: call `initialize_cluster()` first thing in each process, then
`make_mesh()` sees the GLOBAL device set and `ShardedIVFADCIndex.build` /
`save_sharded_index` / `load_sharded_index` operate per-process on
addressable shards only (no cross-host traffic for persistence).

Resolution order for cluster parameters: explicit arguments, then
`IVFADC_COORDINATOR` / `IVFADC_NUM_PROCESSES` / `IVFADC_PROCESS_ID` /
`IVFADC_LOCAL_DEVICE_IDS` environment variables, then JAX's own cluster
auto-detection (SLURM, Open MPI). With none of those
present this is a no-op returning False — single-process behavior is
unchanged, so library users never have to think about it.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

_INITIALIZED = False

# env markers JAX's ClusterEnv auto-detection understands; presence of any
# means `jax.distributed.initialize()` can resolve the cluster without args
_AUTO_DETECT_VARS = (
    "JAX_COORDINATOR_ADDRESS",      # manual JAX cluster spec
    "SLURM_NTASKS",                 # SLURM
    "OMPI_COMM_WORLD_SIZE",         # Open MPI
)


def _int_env(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def initialize_cluster(coordinator_address: Optional[str] = None,
                       num_processes: Optional[int] = None,
                       process_id: Optional[int] = None,
                       local_device_ids: Optional[Sequence[int]] = None,
                       ) -> bool:
    """Join (or form) the multi-host process group. Returns True iff a
    multi-process runtime was initialized (idempotent — repeat calls after a
    successful init return True without re-initializing).

    Single-process runs (no args, no cluster env) return False and touch
    nothing.
    """
    global _INITIALIZED
    if _INITIALIZED:
        return True
    env = os.environ
    coordinator_address = coordinator_address or env.get("IVFADC_COORDINATOR")
    if num_processes is None:
        num_processes = _int_env("IVFADC_NUM_PROCESSES")
    if process_id is None:
        process_id = _int_env("IVFADC_PROCESS_ID")
    if local_device_ids is None:
        raw = env.get("IVFADC_LOCAL_DEVICE_IDS")
        if raw:
            local_device_ids = [int(x) for x in raw.split(",")]
    explicit = (coordinator_address is not None
                or num_processes is not None
                or process_id is not None
                or local_device_ids is not None)
    if not explicit and not any(v in env for v in _AUTO_DETECT_VARS):
        return False                              # single-process: no-op
    import jax
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids)
    _INITIALIZED = True
    return True


def shutdown_cluster() -> None:
    """Tear down the process group (end-of-job cleanup)."""
    global _INITIALIZED
    if _INITIALIZED:
        import jax
        jax.distributed.shutdown()
        _INITIALIZED = False


def process_info() -> dict:
    """This process's view of the cluster: counts for logging/sanity checks."""
    import jax
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_device_count": jax.local_device_count(),
        "global_device_count": jax.device_count(),
        "initialized": _INITIALIZED,
    }
