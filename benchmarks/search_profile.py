#!/usr/bin/env python
"""Where one search batch spends its device time, on the GPU.

Builds the SIFT1M-shape index of chip_smoke.py (1M x 128, kc=1024, PQ m=8
k=256), then for B=16,384 queries at k=10, w=8:

  1. times the LUT search with each smallest-k implementation in turns —
     XLA's `lax.top_k` and the Pallas/Triton min-extract (ops/topk.py) —
     as xla, triton, triton, xla (host clock around block_until_ready,
     mean of back-to-back calls after warm-up);
  2. traces three batches with the shipped implementation and prints the
     device time per XLA op, summed over the trace, largest first.

The trace goes to chiprun_out/search_trace/. Needs a GPU.

    python benchmarks/search_profile.py
"""

from __future__ import annotations

import collections
import glob
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def device_op_times(trace_dir: str):
    """({kernel name: summed device ns}, busy ns, window ns) over the GPU
    planes of the newest trace in `trace_dir`; busy is the union of the
    kernel intervals, the window runs from the first start to the last
    end."""
    from jax.profiler import ProfileData
    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    ops = collections.Counter()
    spans = []
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for e in line.events:
                ops[e.name] += e.duration_ns
                spans.append((e.start_ns, e.start_ns + e.duration_ns))
    spans.sort()
    busy, end = 0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    window = (spans[-1][1] - spans[0][0]) if spans else 0
    return ops, busy, window


def main() -> int:
    import jax
    import jax.numpy as jnp
    import chip_smoke
    from ivfadc_tpu import IVFADCIndex
    from ivfadc_tpu.ops import adc, gather_scan, topk
    from ivfadc_tpu.utils.compile_cache import enable_compile_cache
    from ivfadc_tpu.utils.timing import mean_time, require_gpu

    require_gpu("search_profile")
    enable_compile_cache()
    shape = chip_smoke.FULL
    base, queries, _ = chip_smoke.make_data(shape, seed=0)
    idx = IVFADCIndex.build(base, chip_smoke._config(shape, seed=0))
    k, w = shape.topk, shape.w
    shipped = topk.topk_lastdim

    def xla(x, kk):
        return topk._xla_smallest(x.astype(jnp.float32), kk)

    def use(impl):
        for mod in (topk, adc, gather_scan):
            mod.topk_lastdim = impl
        jax.clear_caches()

    out = {"card": chip_smoke.device_phase(1)}
    times = collections.defaultdict(list)
    for name, impl in (("xla", xla), ("triton", shipped),
                       ("triton", shipped), ("xla", xla)):
        use(impl)
        times[name].append(round(mean_time(
            lambda: idx._device_search(queries, k, w), reps=10) * 1e3, 3))
    out["lut_search_ms"] = dict(times)
    use(shipped)

    trace_dir = os.path.join(ROOT, "chiprun_out", "search_trace")
    jax.block_until_ready(idx._device_search(queries, k, w))
    with jax.profiler.trace(trace_dir):
        for _ in range(3):
            jax.block_until_ready(idx._device_search(queries, k, w))
    ops, busy, window = device_op_times(trace_dir)
    total = sum(ops.values())
    print(f"3 batches: kernels {total / 1e6:.3f} ms, device busy "
          f"{busy / 1e6:.3f} ms of a {window / 1e6:.3f} ms window "
          f"(idle share {1 - busy / max(window, 1):.3f})", flush=True)
    for name, ns in ops.most_common(15):
        print(f"  {ns / 3e6:9.3f} ms/batch  {100 * ns / max(total, 1):5.1f}%"
              f"  {name}", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
