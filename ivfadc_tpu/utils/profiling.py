"""Build-phase timing and search counters.

The reference's only observability is four `@debug` lines during build
(/root/reference/src/index.jl:128-154) and `Base.show` pretty-printers.
Here: structured phase timings (blocking on device work so numbers are real)
and an optional jax.profiler trace context.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict


def _block_device():
    """Drain pending device work so wall-clock phase timings are honest."""
    try:
        import jax
        jax.effects_barrier()
    except Exception:
        pass


class BuildTimer:
    def __init__(self):
        self.timings: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        _block_device()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _block_device()
            self.timings[name] = self.timings.get(name, 0.0) + (
                time.perf_counter() - t0)


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler trace context for device timeline capture."""
    import jax
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class SearchStats:
    """Lightweight counters a serving layer can aggregate."""

    def __init__(self):
        import threading
        self.queries = 0
        self.batches = 0
        self.seconds = 0.0
        self._lock = threading.Lock()   # serving dispatch pools record
                                        # concurrently (serving.py)

    def record(self, batch: int, seconds: float):
        with self._lock:
            self.queries += batch
            self.batches += 1
            self.seconds += seconds

    @property
    def qps(self) -> float:
        return self.queries / self.seconds if self.seconds else 0.0


def probe_stats(index, queries, w: int) -> Dict[str, float]:
    """Per-query work counters for a probe width (SURVEY §5 observability:
    nprobe, scanned postings/query): how many postings the scan kernel
    touches, the padding overhead the CSR slack adds, and the selectivity
    vs a full-database scan."""
    import numpy as np
    import jax.numpy as jnp

    q = jnp.asarray(np.asarray(queries, np.float32))
    w_eff = min(w, index.config.kc)
    cells, _ = index.coarse.search(q, w_eff)
    cells_h = np.asarray(cells)
    sizes = np.asarray(index.store.sizes)[cells_h]          # (B, w)
    caps = np.asarray(index.store.caps)[cells_h]
    n = max(1, len(index))
    return {
        "nprobe": float(w_eff),
        "scanned_postings_per_query": float(sizes.sum(1).mean()),
        "scanned_slots_per_query": float(caps.sum(1).mean()),
        "scan_selectivity": float(sizes.sum(1).mean() / n),
        "max_cell_in_probe": float(sizes.max(initial=0)),
    }
