#!/usr/bin/env python
"""Recall/QPS curves vs nprobe (sweep 1-64), on the GPU.

Also covers the GIST1M-shape high-dim config (960-dim, m=16/32) via
IVFADC_SWEEP_CONFIG=gist. Prints one JSON line per nprobe point.
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

    from ivfadc_tpu import IVFADCIndex
    from ivfadc_tpu.utils.datasets import synthetic_clustered
    from ivfadc_tpu.utils.evaluation import brute_force_topk, recall_at_r

    cfg_name = os.environ.get("IVFADC_SWEEP_CONFIG", "sift")
    from ivfadc_tpu.utils.compile_cache import enable_compile_cache
    from ivfadc_tpu.utils.timing import require_gpu
    require_gpu(os.path.basename(__file__))
    enable_compile_cache()
    if cfg_name == "gist":
        d, m = 960, int(os.environ.get("IVFADC_BENCH_M", 16))
        n = int(os.environ.get("IVFADC_BENCH_N", 1_000_000))
    else:
        d, m = 128, 8
        n = int(os.environ.get("IVFADC_BENCH_N", 1_000_000))
    kc = int(os.environ.get("IVFADC_BENCH_KC", 1024))
    nq = int(os.environ.get("IVFADC_BENCH_NQ", 1_000))
    batch = int(os.environ.get("IVFADC_BENCH_BATCH", 16384))
    topk = 10

    import jax.numpy as jnp
    from ivfadc_tpu.utils.datasets import synthetic_clustered_device
    from ivfadc_tpu.utils.timing import mean_time

    based = synthetic_clustered_device(n, d, seed=0)
    key = jax.random.PRNGKey(1)
    kq_, kn_ = jax.random.split(key)
    qdev = based[jax.random.randint(kq_, (max(nq, batch),), 0, n)] + \
        0.05 * jax.random.normal(kn_, (max(nq, batch), d), jnp.float32)
    queries = np.asarray(qdev[:nq])

    idx = IVFADCIndex.build(based, kc=kc, k=256, m=m, seed=0,
                            kmeanspp_sample=min(n, 65536))
    ms = idx.memory_stats()
    print(json.dumps({"config": cfg_name, "n": n, "d": d, "m": m,
                      "memory_stats": ms}), file=sys.stderr)
    _, gt_i = brute_force_topk(based, qdev[:nq], topk)
    for nprobe in (1, 2, 4, 8, 16, 32, 64):
        ids, _ = idx.search_padded(queries, topk, w=nprobe)
        rec = recall_at_r(ids, gt_i, topk)
        t = mean_time(
            lambda: idx._device_search(qdev[:batch], topk, nprobe),
            reps=10, warm=2)
        qps = batch / t
        print(json.dumps({"config": cfg_name, "n": n, "d": d, "m": m,
                          "kc": kc, "nprobe": nprobe,
                          "recall_at_10": round(rec, 4),
                          "qps": round(qps, 1)}))


if __name__ == "__main__":
    main()
