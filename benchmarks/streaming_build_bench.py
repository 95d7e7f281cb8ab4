#!/usr/bin/env python
"""Out-of-core ingest benchmark: `IVFADCIndex.build_from_files` over a
generated TEXMEX .fvecs file, vs the in-memory `build` on the same data.

Reports per-phase wall times (sample / train / encode / layout), ingest
rows/s, and the recall delta between the streamed (reservoir-trained)
index and the in-memory build at the same operating point. The chunked
host->device upload is a cost an out-of-core ingest really pays, so it is
reported, not hidden. Prints one JSON line.

Env: IVFADC_STREAM_N (default 262144), IVFADC_STREAM_D (128),
IVFADC_STREAM_CHUNK (65536), IVFADC_STREAM_KC (1024).
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ivfadc_tpu import IVFADCIndex                             # noqa: E402
from ivfadc_tpu.utils.evaluation import (brute_force_topk,     # noqa: E402
                                         recall_at_r)


def main() -> None:
    from ivfadc_tpu.utils.compile_cache import enable_compile_cache
    from ivfadc_tpu.utils.timing import require_gpu
    require_gpu(os.path.basename(__file__))
    enable_compile_cache()
    n = int(os.environ.get("IVFADC_STREAM_N", 131072))
    d = int(os.environ.get("IVFADC_STREAM_D", 128))
    chunk = int(os.environ.get("IVFADC_STREAM_CHUNK", 32768))
    kc = int(os.environ.get("IVFADC_STREAM_KC", 1024))
    kw = dict(kc=kc, k=256, m=8, seed=0)

    rng = np.random.RandomState(0)
    centers = rng.randn(256, d).astype(np.float32) * 2.0
    data = (centers[rng.randint(0, 256, n)]
            + rng.randn(n, d).astype(np.float32))

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "base.fvecs")
        with open(path, "wb") as f:   # TEXMEX row framing: i32 dim + f32 row
            head = np.full((n, 1), d, np.int32).view(np.float32)
            np.ascontiguousarray(
                np.concatenate([head, data], axis=1)).tofile(f)

        # Cold run: pays the per-process remote compiles AND this runtime's
        # one-time layout-conversion compile on the first int-output
        # device->host fetch (measured ~60-380 s — an environment artifact,
        # not ingest cost). Warm run = steady-state ingest.
        t0 = time.perf_counter()
        sidx = IVFADCIndex.build_from_files(
            path, chunk_rows=chunk, train_sample=1 << 17, **kw)
        cold_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        sidx = IVFADCIndex.build_from_files(
            path, chunk_rows=chunk, train_sample=1 << 17, **kw)
        stream_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    full = IVFADCIndex.build(data, **kw)
    build_s = time.perf_counter() - t0

    nq = 1024
    queries = data[rng.choice(n, nq, replace=False)]
    _, gt = brute_force_topk(data, queries, 10)
    r_stream = recall_at_r(
        np.asarray(sidx.search_padded(queries, 10, w=8)[0]), gt, 10)
    r_full = recall_at_r(
        np.asarray(full.search_padded(queries, 10, w=8)[0]), gt, 10)

    enc_s = sidx.build_timings.get("encode", stream_s)
    print(json.dumps({
        "metric": "streaming ingest rows/s",
        "value": round(n / enc_s, 1),        # steady-state encode pass
        "unit": "rows/s",
        "n": n, "d": d, "chunk_rows": chunk, "kc": kc,
        "stream_build_seconds": round(stream_s, 2),
        "cold_stream_build_seconds": round(cold_s, 2),
        "inmem_build_seconds": round(build_s, 2),
        "stream_phase_seconds": {k: round(v, 2)
                                 for k, v in sidx.build_timings.items()},
        "recall_at_10_stream": round(float(r_stream), 4),
        "recall_at_10_inmem": round(float(r_full), 4),
        "file_mb": round(n * (d + 1) * 4 / 1e6, 1),
    }))


if __name__ == "__main__":
    main()
