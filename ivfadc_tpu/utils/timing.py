"""Host-clock timing of device work.

JAX dispatch is asynchronous: a call returns before the device finishes.
Every timed region here therefore ends in `jax.block_until_ready` on the
call's outputs, and the first `warm` calls (compilation, first-touch
allocation) are run and waited for outside it.
"""

from __future__ import annotations

import time
from typing import Callable, List

import jax


def require_gpu(what: str):
    """Measurements are taken on the card only: exit with an error when
    JAX's first device is not a GPU (no CPU fallback). Returns the device."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"{what}: needs an NVIDIA GPU, JAX found "
                         f"{dev.platform!r}")
    return dev


def call_times(fn: Callable, reps: int = 20, warm: int = 2) -> List[float]:
    """Seconds of each of `reps` blocking calls of the nullary `fn` — the
    per-request latency distribution (take percentiles of it)."""
    for _ in range(warm):
        jax.block_until_ready(fn())
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        out.append(time.perf_counter() - t0)
    return out


def mean_time(fn: Callable, reps: int = 20, warm: int = 2) -> float:
    """Mean seconds per call of the nullary `fn` when `reps` calls are
    dispatched back to back and waited for once — the throughput view,
    in which the host's dispatch of call i+1 overlaps call i on device."""
    for _ in range(warm):
        jax.block_until_ready(fn())
    t0 = time.perf_counter()
    outs = [fn() for _ in range(reps)]
    jax.block_until_ready(outs)
    return (time.perf_counter() - t0) / reps
