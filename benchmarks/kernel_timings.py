#!/usr/bin/env python
"""Time each layer that once had a TPU kernel, as XLA compiles it for the
GPU, at the SIFT1M headline shapes (16,384 queries, d=128, kc=1024, w=8):

  topk_coarse   smallest-8 of (16384, 1024)          (coarse probe select)
  topk_merge    smallest-10 of (16384, 8 * 5120)     (LUT scan merge: w
                probes x the 1M index's 5,120-row window)
  coarse        (16384, 128) x (128, 1024) distances at full float32
                precision + top-8 (NaiveCoarseQuantizer.search); also at
                TF32, to show what exactness costs
  two_level     TwoLevelCoarseQuantizer.search at kc=16,384, w=8
  triton_topk   the Pallas (Triton route) min-extract top-k of
                ops/topk.py — the TPU kernel's algorithm ported to a GPU
                block — at both top-k shapes, checked against lax.top_k
                before it is timed

Plus a large bf16 matmul and a 1 GiB copy, as the card's reachable rates.
Times are host-clock milliseconds per call around block_until_ready (mean
of back-to-back calls after warm-up). Needs a GPU; prints one JSON line.

    python benchmarks/kernel_timings.py
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import jax
    import jax.numpy as jnp
    import numpy as np
    from ivfadc_tpu.models.coarse import NaiveCoarseQuantizer, build_two_level
    from ivfadc_tpu.ops.metrics import Metric, SQEUCLIDEAN
    from ivfadc_tpu.ops import topk
    from ivfadc_tpu.utils.compile_cache import enable_compile_cache
    from ivfadc_tpu.utils.timing import mean_time, require_gpu

    dev = require_gpu("kernel_timings")
    enable_compile_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}", flush=True)
    key = jax.random.PRNGKey(0)
    out = {"device": dev.device_kind, "card": smi}

    def ms(fn, reps=20):
        return round(mean_time(fn, reps=reps, warm=2) * 1e3, 4)

    B, d, kc, w = 16384, 128, 1024, 8
    xc = jax.random.normal(key, (B, kc), jnp.float32)
    xm = jax.random.normal(key, (B, 8 * 5120), jnp.float32)
    xla = jax.jit(topk._xla_smallest, static_argnums=1)
    tri = jax.jit(topk.chunked_smallest, static_argnums=1)
    for name, x, k in (("coarse", xc, 8), ("merge", xm, 10)):
        ref_v, _ = xla(x, k)
        v, i = tri(x, k)
        np.testing.assert_array_equal(np.asarray(v), np.asarray(ref_v))
        got = np.take_along_axis(np.asarray(x), np.asarray(i), axis=1)
        np.testing.assert_array_equal(got, np.asarray(v))
        out[f"topk_{name}_ms"] = ms(lambda: xla(x, k))
        out[f"triton_topk_{name}_ms"] = ms(lambda: tri(x, k))

    q = jax.random.normal(key, (B, d), jnp.float32)
    cents = jax.random.normal(jax.random.PRNGKey(1), (kc, d), jnp.float32)
    naive = NaiveCoarseQuantizer(cents, SQEUCLIDEAN)
    coarse = jax.jit(lambda cq, q: cq.search(q, w))
    out["coarse_highest_ms"] = ms(lambda: coarse(naive, q))

    def tf32_pairwise(x, y):
        cross = jnp.dot(x, y.T, precision=jax.lax.Precision.DEFAULT,
                        preferred_element_type=jnp.float32)
        return (jnp.sum(x * x, -1, keepdims=True) + jnp.sum(y * y, -1)[None]
                - 2.0 * cross)
    tf32 = NaiveCoarseQuantizer(cents, Metric("tf32", tf32_pairwise,
                                              lambda v: v, additive=True))
    out["coarse_tf32_ms"] = ms(lambda: coarse(tf32, q))

    c16k = jax.random.normal(jax.random.PRNGKey(2), (16384, d), jnp.float32)
    tl = build_two_level(jax.random.PRNGKey(3), c16k, SQEUCLIDEAN)
    out["two_level_kc16384_ms"] = ms(lambda: coarse(tl, q), reps=5)
    out["naive_kc16384_ms"] = ms(
        lambda: coarse(NaiveCoarseQuantizer(c16k, SQEUCLIDEAN), q))

    a = jax.random.normal(key, (8192, 8192), jnp.bfloat16)
    mm = jax.jit(lambda a: jnp.dot(a, a, preferred_element_type=jnp.float32))
    t = ms(lambda: mm(a), reps=10)
    out["bf16_matmul_8192_tflops"] = round(2 * 8192 ** 3 / (t * 1e-3) / 1e12,
                                           1)
    buf = jnp.zeros((1 << 28,), jnp.float32)
    cp = jax.jit(lambda x: x + 1.0)
    t = ms(lambda: cp(buf), reps=10)
    out["copy_1gib_gbps"] = round(2 * (1 << 30) / (t * 1e-3) / 1e9, 1)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
