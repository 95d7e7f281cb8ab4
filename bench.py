#!/usr/bin/env python
"""Headline benchmark: QPS per card at recall@10 (SIFT1M shape, m=8,
nprobe=8), on an NVIDIA GPU.

Prints ONE JSON line:
  {"metric": ..., "value": QPS, "unit": "qps", "vs_baseline": ratio,
   "device": {...}, ...}

Baseline = the NumPy oracle of the reference's exact single-core search
algorithm (benchmarks/oracle.py) running on this host.

Config: 128-dim x 1M base, kc=1024, m=8, k=256, nprobe=8. Uses real SIFT1M
if IVFADC_DATA_DIR points at TEXMEX files, else clustered synthetic data of
the same shape generated on the card. Override sizes with IVFADC_BENCH_N /
IVFADC_BENCH_NQ / IVFADC_BENCH_BATCH / IVFADC_BENCH_KC.

Timing: host clock around work that ends in block_until_ready, after
warm-up (ivfadc_tpu.utils.timing). Exits non-zero without a GPU.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main():
    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py: needs an NVIDIA GPU, JAX found "
                         f"{dev.platform!r}")
    from ivfadc_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    n = int(os.environ.get("IVFADC_BENCH_N", 1_000_000))
    nq = int(os.environ.get("IVFADC_BENCH_NQ", 32_768))
    batch = int(os.environ.get("IVFADC_BENCH_BATCH", 16_384))
    kc = int(os.environ.get("IVFADC_BENCH_KC", 1024))
    m, kq, d = 8, 256, 128
    nprobe, topk = 8, 10
    n_gt = min(nq, 1000)          # queries used for recall ground truth
    n_oracle = min(nq, 1000)      # queries used for oracle QPS baseline

    from ivfadc_tpu import IVFADCIndex
    from ivfadc_tpu.utils.datasets import (load_or_synthesize,
                                           synthetic_clustered_device)
    from ivfadc_tpu.utils.evaluation import brute_force_topk, recall_at_r
    from ivfadc_tpu.utils.timing import call_times, mean_time
    from benchmarks.oracle import ReferenceOracle

    t_all = time.time()
    data_dir = os.environ.get("IVFADC_DATA_DIR", "")
    gt_file_i = None
    qdev = None
    if data_dir:
        from ivfadc_tpu.utils.datasets import read_fvecs, read_ivecs
        base = load_or_synthesize("sift_base", n, d, seed=0)
        n, d = base.shape
        based = jnp.asarray(base, jnp.float32)
        qp = os.path.join(data_dir, "sift_query.fvecs")
        gp = os.path.join(data_dir, "sift_groundtruth.ivecs")
        if os.path.exists(qp):
            qreal = read_fvecs(qp, max_rows=nq)
            if qreal.shape[1] != d:
                raise ValueError(
                    f"{qp} holds {qreal.shape[1]}-dim queries but the bench "
                    f"config is d={d}; np.resize would scramble rows")
            nq = min(nq, qreal.shape[0])
            qdev = jnp.asarray(qreal[:nq], jnp.float32)
            # the published .ivecs ground truth is only valid if the whole
            # base file went into the index (we may have truncated to n rows)
            file_rows = os.path.getsize(
                os.path.join(data_dir, "sift_base.fvecs")) // (4 * (d + 1)) \
                if os.path.exists(os.path.join(data_dir, "sift_base.fvecs")) \
                else -1
            if os.path.exists(gp) and n >= file_rows > 0:
                gt_file_i = read_ivecs(gp)[:n_gt, :topk]
    else:
        based = synthetic_clustered_device(n, d, seed=0)   # device-resident

    # queries: real TEXMEX query set when provided, else perturbed base
    # points (guaranteed near-neighbor structure) derived on device; only
    # the small query set crosses to host (oracle).
    if qdev is None:
        key = jax.random.PRNGKey(1)
        kq_, kn_ = jax.random.split(key)
        qidx = jax.random.randint(kq_, (nq,), 0, n)
        qdev = based[qidx] + 0.05 * jax.random.normal(kn_, (nq, d),
                                                      jnp.float32)
    # only the oracle/recall slice crosses to host
    queries = np.asarray(qdev[:max(n_gt, n_oracle)])

    t0 = time.time()
    index = IVFADCIndex.build(
        based, kc=kc, k=kq, m=m, seed=0,
        kmeanspp_sample=min(n, 65536))
    build_s = time.time() - t0

    # --- ground truth + recall: published .ivecs GT when valid, else exact
    # brute force on device (tiny D2H either way) ---
    if gt_file_i is not None:
        gt_i = gt_file_i
    else:
        gt_d, gt_i = brute_force_topk(based, qdev[:n_gt], topk)
    ids, _ = index.search_padded(queries[:n_gt], topk, w=nprobe)
    recall = recall_at_r(ids, gt_i, topk)

    # --- QPS: back-to-back batches, waited for once ---
    nbatches = max(1, nq // batch)

    def run_wave():
        return [index._device_search(qdev[s * batch:(s + 1) * batch],
                                     topk, nprobe)
                for s in range(nbatches)]

    qps = nbatches * batch / mean_time(run_wave, reps=10, warm=2)
    # latency: individually timed single batches, and B=1 / B=8 requests
    singles = call_times(
        lambda: index._device_search(qdev[:batch], topk, nprobe), reps=10)
    p50_batch_ms = float(np.percentile(singles, 50) * 1e3)
    max_batch_ms = float(np.max(singles) * 1e3)
    tiny_lat_ms = {
        bsz: float(np.percentile(call_times(
            lambda bsz=bsz: index._device_search(qdev[:bsz], topk, nprobe),
            reps=20), 50) * 1e3)
        for bsz in (1, 8)}

    # --- oracle baseline (reference algorithm, single core, this host) ---
    oracle = ReferenceOracle.from_index(index)
    t0 = time.time()
    o_ids, _ = oracle.search_batch(queries[:n_oracle], topk, nprobe)
    oracle_qps = n_oracle / (time.time() - t0)
    o_pad = np.full((n_oracle, topk), -1, np.int64)
    for i, oi in enumerate(o_ids):
        o_pad[i, :len(oi)] = oi
    oracle_recall = recall_at_r(o_pad, gt_i[:n_oracle], topk)

    result = {
        "metric": "QPS/card at recall@10 (SIFT1M%s, m=8, nprobe=8)"
                  % ("" if data_dir else "-shape synthetic"),
        "value": round(qps, 1),
        "unit": "qps",
        "vs_baseline": round(qps / max(oracle_qps, 1e-9), 2),
        "recall_at_10": round(recall, 4),
        "oracle_recall_at_10": round(oracle_recall, 4),
        "oracle_qps": round(oracle_qps, 1),
        "p50_batch_latency_ms": round(p50_batch_ms, 3),
        "max_batch_latency_ms": round(max_batch_ms, 3),
        "p50_latency_b1_ms": round(tiny_lat_ms[1], 3),
        "p50_latency_b8_ms": round(tiny_lat_ms[8], 3),
        "gt_source": "ivecs" if gt_file_i is not None else "brute_force",
        "n": n, "nq": nq, "batch": batch, "kc": kc,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "build_seconds": round(build_s, 1),
        "total_seconds": round(time.time() - t_all, 1),
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
