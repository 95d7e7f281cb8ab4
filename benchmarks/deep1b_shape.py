#!/usr/bin/env python
"""Deep1B-shard single-card profile: 2M x 96, kc=2^18, m=16, two-level
coarse (~8-row cells).

Times the LUT scan and the dense gathered scan (ops/gather_scan.py) on
this tiny-cell regime. Each mode runs in its own subprocess; the parent
never imports JAX, so each child has the card to itself.

Usage: python benchmarks/deep1b_shape.py [--nq 4096] [--w 32] [--reps 8]
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
from ivfadc_tpu import IVFADCIndex
from ivfadc_tpu.utils.datasets import synthetic_clustered_device

n, d, kc, m, kq = 2_000_000, 96, 262144, 16, 256
nq, w, k = {nq}, {w}, 10
cache = os.path.join({root!r}, ".cache", f"idx_deep1b_n{{n}}_kc{{kc}}_m{{m}}.npz")
base = synthetic_clustered_device(n, d, seed=0)
if os.path.exists(cache):
    idx = IVFADCIndex.load(cache)
else:
    t0 = time.time()
    idx = IVFADCIndex.build(base, kc=kc, k=kq, m=m, seed=0,
                            coarse_quantizer="hnsw",
                            kmeanspp_sample=65536)
    print(f"build: {{time.time() - t0:.1f}}s", flush=True)
    idx.save(cache)
mode = {mode!r}
import dataclasses
idx.config = dataclasses.replace(idx.config, scan_mode=mode)
key = jax.random.PRNGKey(1)
sel = jax.random.randint(key, (nq,), 0, n)
qdev = base[sel] + 0.05 * jax.random.normal(key, (nq, d), jnp.float32)
qdev = jax.block_until_ready(qdev)
t = mean_time(lambda: idx._device_search(qdev, k, w), reps={reps}, warm=2)
print(f"RESULT mode={{mode}} ms={{t*1e3:.3f}} qps={{nq/t:.0f}}", flush=True)
'''


def run(mode: str, nq: int, w: int, reps: int) -> None:
    code = CHILD.format(root=ROOT, nq=nq, w=w, reps=reps, mode=mode)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=3600)
    print(r.stdout.strip())
    if r.returncode != 0:
        print(r.stderr[-4000:])
        raise SystemExit(1)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nq", type=int, default=4096)
    ap.add_argument("--w", type=int, default=32)
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--modes", default="lut,dense")
    args = ap.parse_args()
    for mode in args.modes.split(","):
        print(f"[scan_mode={mode}]", flush=True)
        run(mode, args.nq, args.w, args.reps)


if __name__ == "__main__":
    main()
