#!/usr/bin/env python
"""Build-phase timing: each phase ends with a forced scalar fetch so no
phase's work runs into the next. Distinguishes compile time (first call)
from steady-state by running key jits twice.

Usage: python benchmarks/profile_build.py [--n 1000000] [--no-cache]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))



def fetch(x):
    """Force real completion: fetch one scalar data-dependent on x."""
    import jax.numpy as jnp
    leaves = [l for l in __import__("jax").tree_util.tree_leaves(x)
              if hasattr(l, "ravel")]
    return float(sum(jnp.sum(l.ravel()[-1].astype(jnp.float32))
                     for l in leaves))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--kc", type=int, default=1024)
    ap.add_argument("--m", type=int, default=8)
    ap.add_argument("--no-cache", action="store_true")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from ivfadc_tpu.utils.compile_cache import enable_compile_cache
    from ivfadc_tpu.utils.timing import require_gpu
    require_gpu(os.path.basename(__file__))
    if not args.no_cache:
        enable_compile_cache()
    from ivfadc_tpu.config import IVFADCConfig
    from ivfadc_tpu.ops import pq as pq_ops
    from ivfadc_tpu.ops.kmeans import kmeans
    from ivfadc_tpu.ops.metrics import SQEUCLIDEAN
    from ivfadc_tpu.models.inverted import PostingStore
    from ivfadc_tpu.utils.datasets import load_or_synthesize

    n, kc, m, kq, d = args.n, args.kc, args.m, 256, 128
    data = load_or_synthesize("sift_base", n, d, seed=0)
    key = jax.random.PRNGKey(0)
    k_coarse, k_quant = jax.random.split(key)

    t0 = time.time()
    xd = jnp.asarray(data, jnp.float32)
    fetch(xd)
    print(f"upload {data.nbytes/1e6:.0f}MB      : {time.time()-t0:7.1f}s")

    for rep in ("cold", "warm"):
        t0 = time.time()
        cres = kmeans(k_coarse, xd, kc, maxiter=25, metric=SQEUCLIDEAN,
                      block=16384, pp_sample=65536)
        fetch(cres.centers)
        print(f"coarse kmeans ({rep}): {time.time()-t0:7.1f}s")

    t0 = time.time()
    residuals = xd - cres.centers[cres.assignments]
    fetch(residuals)
    print(f"residuals          : {time.time()-t0:7.1f}s")

    for rep in ("cold", "warm"):
        t0 = time.time()
        quant = pq_ops.train_quantizer(k_quant, residuals, m=m, k=kq,
                                       method="pq", maxiter=25,
                                       metric=SQEUCLIDEAN, block=16384)
        fetch(quant.codebooks)
        print(f"train pq ({rep})     : {time.time()-t0:7.1f}s")

    t0 = time.time()
    codes = pq_ops.encode(quant, residuals, metric=SQEUCLIDEAN)
    fetch(codes)
    print(f"encode             : {time.time()-t0:7.1f}s")

    t0 = time.time()
    assignments_h = np.asarray(cres.assignments)
    codes_h = np.asarray(codes)
    print(f"to host assign+codes: {time.time()-t0:6.1f}s "
          f"({(assignments_h.nbytes+codes_h.nbytes)/1e6:.0f}MB)")

    t0 = time.time()
    store = PostingStore.build(assignments_h, codes_h, kc, slack=1.25)
    print(f"store build (host) : {time.time()-t0:7.1f}s")

    t0 = time.time()
    dec = pq_ops.decode_rotated(quant, codes)
    fetch(dec)
    print(f"decode_rotated(dev): {time.time()-t0:7.1f}s")


if __name__ == "__main__":
    main()
