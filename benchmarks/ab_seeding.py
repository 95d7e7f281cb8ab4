#!/usr/bin/env python
"""Recall A/B of k-means|| seeding vs uniform-random at the Deep1B shape:
2M x 96, kc=2^18, m=16, two-level coarse — the regime where sequential
k-means++ is infeasible.

Builds one index per seeding mode in its own subprocess (seeding is the
only difference: this script monkeypatches the init), then measures recall@10 on matched queries against
exact GT over a 200k-row slice, plus QPS at the standard probe dial.

The parent process never imports JAX, so each child has the card to
itself (one process per card).

Usage: python benchmarks/ab_seeding.py [--n 2000000] [--nq 2048]
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

CHILD = r'''
import os, sys, time
import numpy as np
sys.path.insert(0, {root!r})
import jax
from ivfadc_tpu.utils.compile_cache import enable_compile_cache
from ivfadc_tpu.utils.timing import mean_time, require_gpu
require_gpu("child")
enable_compile_cache()
import jax.numpy as jnp

# force the seeding mode: "parallel" = the default beyond _PP_MAX_K
# (k-means||); "random" = uniform random seeds
mode = {mode!r}
if mode == "random":
    from ivfadc_tpu.ops import kmeans as km
    _orig = km.kmeans
    def _forced(key, x, k, **kw):
        if k > km._PP_MAX_K:
            kw["init"] = "random"
        return _orig(key, x, k, **kw)
    km.kmeans = _forced
    import ivfadc_tpu.models.index as mi      # rebind the imported name
    # models/index imports kmeans lazily inside _train_components — the
    # module-level patch above is what it resolves

from ivfadc_tpu import IVFADCIndex
from ivfadc_tpu.utils.datasets import synthetic_clustered_device
from ivfadc_tpu.utils.evaluation import brute_force_topk, recall_at_r

n, d, kc, m, kq = {n}, 96, 262144, 16, 256
nq, w, k = {nq}, 32, 10
base = synthetic_clustered_device(n, d, seed=0)
t0 = time.time()
idx = IVFADCIndex.build(base, kc=kc, k=kq, m=m, seed=0,
                        coarse_quantizer="hnsw", kmeanspp_sample=65536)
print(f"build[{{mode}}]: {{time.time() - t0:.1f}}s", flush=True)

key = jax.random.PRNGKey(1)
sel = jax.random.randint(key, (nq,), 0, 200_000)
qdev = base[sel] + 0.05 * jax.random.normal(key, (nq, d), jnp.float32)
qdev = jax.block_until_ready(qdev)
# exact GT on the 200k-row slice the queries were drawn near (full-2M GT
# is minutes of matmul; the slice keeps the A/B apples-to-apples)
gt_d, gt_i = brute_force_topk(base[:200_000], np.asarray(qdev), 10)
ids, _ = idx.search_padded(np.asarray(qdev), k, w=w)
ids = np.asarray(ids)
# count only hits that land inside the GT slice
ids_sl = np.where(ids < 200_000, ids, -1)
rec = recall_at_r(ids_sl, gt_i, 10)
t = mean_time(lambda: idx._device_search(qdev, k, w), reps=6, warm=2)
print(f"RESULT mode={{mode}} recall10={{rec:.4f}} ms={{t*1e3:.2f}} "
      f"qps={{nq/t:.0f}}", flush=True)
'''


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=2_000_000)
    ap.add_argument("--nq", type=int, default=2048)
    ap.add_argument("--modes", default="parallel,random")
    args = ap.parse_args()
    for mode in args.modes.split(","):
        code = CHILD.format(root=ROOT, n=args.n, nq=args.nq, mode=mode)
        r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                           capture_output=True, text=True, timeout=3600)
        print(r.stdout.strip(), flush=True)
        if r.returncode != 0:
            print(r.stderr[-4000:])


if __name__ == "__main__":
    main()
