"""Asymmetric-distance computation (ADC): table build + posting scan.

Reference behavior being replaced (/root/reference/src/index.jl:204-258):
  per probed cell, build m LittleDict lookup tables of code -> distance
  (:232-236), then scan the cell's postings accumulating
  `coarse_dist + sum_i table_i[code_i]` (:241-246) with a SortedMultiDict
  keeping the k best (:247-254).

Redesign for an accelerator (SURVEY §7):
  * tables are one dense (B, w, m, k) array built by a batched matmul at
    full float32 precision (the metric's pairwise, ops/metrics.py) — no
    dicts;
  * the scan gathers a static-width window of each probed cell's slots from
    the flat CSR arrays, does m table lookups (`take_along_axis`), masks the
    padding with +inf and finishes with one top-k (ops/topk.py) — no heap;
  * batch queries are the leading vectorized axis, not an outer loop
    (inverting the reference's serial batch loop, src/index.jl:261-273).

Divergence (deliberate, SURVEY §2.3): tables use the *quantization* metric,
not the coarse metric — the reference passes `Dc()` at src/index.jl:234 even
though codebooks were trained under the quantization distance; both default
to SqEuclidean so the default behavior is identical.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ivfadc_tpu.ops.metrics import Metric
from ivfadc_tpu.ops.topk import topk_lastdim


def build_adc_tables(metric: Metric, residuals: jax.Array,
                     codebooks: jax.Array) -> jax.Array:
    """residuals (..., d) x codebooks (m, k, dsub) -> tables (..., m, k).

    Generic over metrics: vmaps the metric's pairwise over subspaces. For
    sqeuclidean this lowers to one batched matmul.
    """
    m, k, dsub = codebooks.shape
    lead = residuals.shape[:-1]
    r = residuals.reshape(-1, m, dsub)                 # (L, m, dsub)
    r = jnp.moveaxis(r, 1, 0)                          # (m, L, dsub)
    t = jax.vmap(metric.pairwise)(r, codebooks)        # (m, L, k)
    return jnp.moveaxis(t, 0, 1).reshape(*lead, m, k)


def scan_postings(tables: jax.Array, base: jax.Array, cells: jax.Array,
                  offsets: jax.Array, sizes: jax.Array, codes: jax.Array,
                  ids: jax.Array, *, k: int, window: int
                  ) -> Tuple[jax.Array, jax.Array]:
    """Score every posting in the probed cells and return the k best.

    tables  (B, w, m, kq) f32 — ADC lookup tables per query x probe
    base    (B, w) f32        — additive per-probe base (coarse distance in
                                "reference" score mode, zeros in "pure" mode)
    cells   (B, w) int32      — probed cell ids
    offsets/sizes             — (kc,) CSR arrays
    codes   (total_cap, m)    — flat code storage
    ids     (total_cap,) i32  — flat external ids (-1 in padding slots)
    k, window                 — static: result count, gather width

    Returns (ids (B, k) int32 with -1 padding, dists (B, k) f32 with +inf
    padding), sorted ascending by distance.
    """
    B, w, m, kq = tables.shape
    starts = offsets[cells]                                    # (B, w)
    lanes = jnp.arange(window, dtype=jnp.int32)                # (window,)
    valid = lanes[None, None, :] < sizes[cells][..., None]     # (B, w, window)
    pos = starts[..., None] + lanes[None, None, :]
    pos = jnp.where(valid, pos, 0)

    cand_ids = ids[pos]                                        # (B, w, window)
    acc = jnp.broadcast_to(base[..., None], (B, w, window))
    # Static unroll over the (small) m subspaces: each step is one gather of
    # codes + one table lookup — XLA fuses these; peak temp is (B, w, window).
    for j in range(m):
        cj = codes[pos, j].astype(jnp.int32)                   # (B, w, window)
        acc = acc + jnp.take_along_axis(tables[:, :, j, :], cj, axis=-1)
    scores = jnp.where(valid, acc, jnp.inf).reshape(B, w * window)

    k_eff = min(k, w * window)
    out_dists, which = topk_lastdim(scores, k_eff)
    out_ids = jnp.take_along_axis(cand_ids.reshape(B, -1), which, axis=1)
    out_ids = jnp.where(jnp.isfinite(out_dists), out_ids, -1)
    if k_eff < k:
        pad = k - k_eff
        out_ids = jnp.pad(out_ids, ((0, 0), (0, pad)), constant_values=-1)
        out_dists = jnp.pad(out_dists, ((0, 0), (0, pad)),
                            constant_values=jnp.inf)
    return out_ids, out_dists
