#!/usr/bin/env python
"""Dynamic-workload benchmark: interleaved
push / delete / search streams against a live index.

Two regimes:
  * batched (the batched serving pattern): rounds of push_batch /
    vectorized delete / batched search — reports points/s, deletes/s, QPS;
  * scalar: a short sample of single push/pop/delete ops — reports per-op
    latency.

Verifies invariants under churn (ids stay the contiguous range {0..n-1})
and prints one JSON line.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax
    import jax.numpy as jnp

    from ivfadc_tpu import IVFADCIndex
    from ivfadc_tpu.utils.datasets import synthetic_clustered_device

    from ivfadc_tpu.utils.compile_cache import enable_compile_cache
    from ivfadc_tpu.utils.timing import require_gpu
    require_gpu(os.path.basename(__file__))
    enable_compile_cache()
    n = int(os.environ.get("IVFADC_BENCH_N",
                           100_000))
    d, kc, m, kq = 128, 256, 8, 256
    rounds = int(os.environ.get("IVFADC_BENCH_ROUNDS", 10))
    push_b, del_b, search_b = 2048, 256, 4096
    rng = np.random.RandomState(0)

    based = synthetic_clustered_device(n, d, seed=0)
    t0 = time.time()
    idx = IVFADCIndex.build(based, kc=kc, k=kq, m=m, seed=0,
                            kmeanspp_sample=min(n, 32768))
    build_s = time.time() - t0

    key = jax.random.PRNGKey(3)
    new_points = np.asarray(
        synthetic_clustered_device(rounds * push_b, d, seed=3))
    qdev = based[jax.random.randint(key, (search_b,), 0, n)]

    # first mutation hydrates the device-built store to host (one-time)
    # — do it before timing so the
    # loop reports steady-state dynamic throughput, and report it apart
    t0 = time.time()
    idx.push(new_points[0])
    idx.delete([len(idx) - 1])
    hydrate_s = time.time() - t0

    timings = {"push_batch": 0.0, "delete": 0.0, "search": 0.0}
    t_all = time.time()
    for r in range(rounds):
        t0 = time.time()
        idx.push_batch(new_points[r * push_b:(r + 1) * push_b])
        timings["push_batch"] += time.time() - t0
        t0 = time.time()
        idx.delete(rng.choice(len(idx), del_b, replace=False))
        timings["delete"] += time.time() - t0
        t0 = time.time()
        ids, dists = idx.search_padded(qdev, 10, w=8)
        _ = float(np.asarray(dists[0, 0]))     # force completion
        timings["search"] += time.time() - t0
    total_s = time.time() - t_all

    # invariant: live ids are exactly {0..n'-1}
    live = np.sort(idx.store.ids[idx.store.ids >= 0])
    assert np.array_equal(live, np.arange(len(idx))), "id contiguity broken"

    # scalar-op latency sample
    t0 = time.time()
    n_scalar = 10
    for i in range(n_scalar):
        idx.push(new_points[i])
    for i in range(n_scalar):
        idx.pop()
    scalar_ms = (time.time() - t0) / (2 * n_scalar) * 1e3

    result = {
        "metric": "dynamic workload (batched push/delete/search rounds)",
        "value": round(rounds * (push_b + del_b + search_b) / total_s, 1),
        "unit": "ops/s",
        "n": n, "rounds": rounds,
        "push_points_s": round(rounds * push_b / max(timings["push_batch"],
                                                     1e-9), 1),
        "delete_ids_s": round(rounds * del_b / max(timings["delete"], 1e-9), 1),
        "search_qps": round(rounds * search_b / max(timings["search"], 1e-9), 1),
        "scalar_op_ms": round(scalar_ms, 1),
        "build_seconds": round(build_s, 1),
        "host_hydration_seconds": round(hydrate_s, 1),
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
