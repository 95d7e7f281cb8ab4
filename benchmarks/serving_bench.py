#!/usr/bin/env python
"""Serving-layer benchmark: request-coalescing vs direct dispatch.

Measures, on the GPU:
  1. closed-loop p50/p99 single-request latency through BatchingSearcher
     (client thread waits for each result) vs direct search_padded(B=1);
  2. open-loop throughput with C concurrent client threads submitting
     back-to-back — how many requests/s the coalescer sustains and how
     large its dispatched batches actually get.

Env: IVFADC_SERVE_N, IVFADC_SERVE_CLIENTS.
"""

from __future__ import annotations

import os
import sys
import threading
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax

    from ivfadc_tpu import IVFADCIndex, BatchingSearcher
    from ivfadc_tpu.utils.datasets import synthetic_clustered_device

    from ivfadc_tpu.utils.compile_cache import enable_compile_cache
    from ivfadc_tpu.utils.timing import require_gpu
    require_gpu(os.path.basename(__file__))
    enable_compile_cache()
    n = int(os.environ.get("IVFADC_SERVE_N", 1_000_000))
    clients = int(os.environ.get("IVFADC_SERVE_CLIENTS", 16))
    k, w, kc, m = 10, 8, 1024, 8
    d = 128

    base = synthetic_clustered_device(n, d, seed=0)
    index = IVFADCIndex.build(base, kc=kc, k=256, m=m, seed=0,
                              kmeanspp_sample=min(n, 65536))
    rng = np.random.RandomState(1)
    queries = rng.randn(4096, d).astype(np.float32)
    # mutation payloads are IN-DISTRIBUTION points (drawn from the same
    # clustered model as the index): off-distribution pushes concentrate
    # into a handful of cells and force cell GROWS within a few rounds —
    # a real but amortized event whose cost on this remote-compile runtime
    # (regrow + program reload, measured ~6 s) would drown the
    # steady-state serving-under-mutation signal this phase measures.
    pushes = np.asarray(synthetic_clustered_device(2048, d, seed=7))
    index.search_padded(queries[:1], k, w)            # warm compile (B=1)
    index.search_padded(queries[:8], k, w)

    # 1. closed-loop single-request latency
    def p50_p99(samples):
        return (float(np.percentile(samples, 50) * 1e3),
                float(np.percentile(samples, 99) * 1e3))

    direct = []
    for i in range(50):
        t0 = time.perf_counter()
        index.search_padded(queries[i:i + 1], k, w)
        direct.append(time.perf_counter() - t0)

    with BatchingSearcher(index, max_batch=256, max_wait_ms=1.0) as s:
        served = []
        for i in range(50):
            t0 = time.perf_counter()
            s.search(queries[50 + i], k, w)
            served.append(time.perf_counter() - t0)
    d50, d99 = p50_p99(direct)
    s50, s99 = p50_p99(served)
    print(f"closed-loop B=1 ms: direct p50={d50:.2f} p99={d99:.2f} | "
          f"coalesced p50={s50:.2f} p99={s99:.2f}")

    # 2. open-loop: C clients hammer the searcher for a fixed request count
    per_client = 2048 // clients
    with BatchingSearcher(index, max_batch=1024, max_wait_ms=2.0) as s:
        lat = [[] for _ in range(clients)]

        def client(c):
            for i in range(per_client):
                t0 = time.perf_counter()
                s.search(queries[(c * per_client + i) % len(queries)], k, w)
                lat[c].append(time.perf_counter() - t0)

        ts = [threading.Thread(target=client, args=(c,))
              for c in range(clients)]
        t0 = time.perf_counter()
        [t.start() for t in ts]
        [t.join() for t in ts]
        wall = time.perf_counter() - t0
        total = clients * per_client
        all_lat = np.concatenate(lat)
        l50, l99 = p50_p99(all_lat)
        print(f"open-loop: {total} reqs / {clients} clients in {wall:.2f}s = "
              f"{total / wall:.0f} req/s; per-req p50={l50:.2f}ms "
              f"p99={l99:.2f}ms; dispatches={s.stats.batches} "
              f"(mean batch {s.stats.queries / max(1, s.stats.batches):.1f})")
        open_loop_mean_batch = s.stats.queries / max(1, s.stats.batches)
    # 3. mutation under load: clients keep submitting while a writer thread
    #    interleaves push_batch/delete through the searcher's write lock
    #    (epoch contract: dispatches never see a half-mutated store)
    mut_rounds = 8
    # warm the mutation-path compiles OUTSIDE the measured window (the
    # search warmup above does the same for dispatches), with data from
    # the SAME distribution as the measured rounds — an off-distribution
    # warmup can funnel into one cell, force a regrow + device-view
    # rebuild, and push shape recompiles into the measured window
    with BatchingSearcher(index, max_batch=1024, max_wait_ms=2.0) as s:
        # two warmup mutation rounds THROUGH the searcher (same sizes as
        # the measured rounds, plus one larger): compiles the fork/patch/
        # flush programs at the dirty-slot shape buckets the rounds will
        # hit, then re-warms the dispatch shapes
        for warm_r in (97, 98):
            s.push_batch(pushes[warm_r * 8:warm_r * 8 + 64])
            s.delete(list(range(len(index) - 32, len(index))))
            s.search(queries[0], k, w)
        s.push_batch(pushes[1024:1152])
        s.delete(list(range(len(index) - 128, len(index))))
        for b in (1, 2, 4, 8):
            s.submit(queries[:b], k, w).result(timeout=300)
        lat3 = [[] for _ in range(clients)]     # (t_done, dt) tuples
        stop = threading.Event()

        def client3(c):
            i = 0
            while not stop.is_set():
                t0 = time.perf_counter()
                s.search(queries[(c * 131 + i) % len(queries)], k, w)
                td = time.perf_counter()
                lat3[c].append((td, td - t0))
                i += 1

        muts = []
        ts = [threading.Thread(target=client3, args=(c,))
              for c in range(clients)]
        [t.start() for t in ts]
        n0 = len(index)
        time.sleep(1.5)                        # reach steady state first
        t0 = time.perf_counter()
        for r in range(mut_rounds):
            tm = time.perf_counter()
            s.push_batch(pushes[r * 64:(r + 1) * 64])
            s.delete(list(range(len(index) - 32, len(index))))
            muts.append(time.perf_counter() - tm)
            time.sleep(0.4)                    # mutation burst cadence
        time.sleep(1.0)                        # let queued tails complete
        t1 = time.perf_counter()
        mut_wall = t1 - t0
        stop.set()
        [t.join() for t in ts]
        # stats over requests COMPLETED inside the mutation window only
        win = [dt for lane in lat3 for (td, dt) in lane if t0 <= td <= t1]
        served3 = len(win)
        m50, m99 = p50_p99(win) if win else (0.0, 0.0)
        print(f"mutation-under-load: {mut_rounds} rounds of "
              f"push_batch(64)+delete(32) across {mut_wall:.2f}s "
              f"(p50 mutation {np.percentile(muts, 50)*1e3:.0f}ms) while "
              f"serving {served3} reqs at p50={m50:.2f}ms p99={m99:.2f}ms; "
              f"index n {n0} -> {len(index)}")

    print("RESULT",
          {"direct_b1_p50_ms": round(d50, 2),
           "coalesced_b1_p50_ms": round(s50, 2),
           "open_loop_req_s": round(total / wall, 1),
           "open_loop_p50_ms": round(l50, 2),
           "mean_dispatch_batch": round(open_loop_mean_batch, 1),
           "mut_under_load_req_s": round(served3 / mut_wall, 1),
           "mut_p50_ms": round(float(np.percentile(muts, 50)) * 1e3, 1),
           "mut_serving_p50_ms": round(m50, 2),
           "mut_serving_p99_ms": round(m99, 2),
           "clients": clients, "n": n,
           "device": jax.devices()[0].device_kind})


if __name__ == "__main__":
    main()
