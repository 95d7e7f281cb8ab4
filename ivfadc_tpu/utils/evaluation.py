"""Recall evaluation: exact brute-force ground truth + recall@R.

The reference never measures recall (SURVEY §4 "not tested"); recall@10
at fixed code size is the primary parity metric, so this is first-class
here. Ground truth runs on device as chunked matmuls at full float32
precision: it is the exact answer every recall is measured against.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


@functools.partial(jax.jit, static_argnames=("k",))
def _topk_block(queries, base_block, running_d, running_i, base_offset, k):
    """Merge the exact top-k of one base block into the running top-k."""
    from ivfadc_tpu.ops.topk import topk_lastdim
    qn = jnp.sum(queries * queries, axis=1, keepdims=True)
    bn = jnp.sum(base_block * base_block, axis=1)
    d = qn + bn[None, :] - 2.0 * jnp.dot(queries, base_block.T,
                                         precision=jax.lax.Precision.HIGHEST,
                                         preferred_element_type=jnp.float32)
    bd, idx = topk_lastdim(d, min(k, base_block.shape[0]))
    cand_d = jnp.concatenate([running_d, bd], axis=1)
    cand_i = jnp.concatenate([running_i, idx + base_offset], axis=1)
    md, which = topk_lastdim(cand_d, k)
    return md, jnp.take_along_axis(cand_i, which, axis=1)


def brute_force_topk(base, queries, k: int, block: int = 8192):
    """Exact squared-euclidean top-k neighbors. Returns (dists, ids) np
    arrays. `base` may be a host np array or a device-resident jax array
    (blocks then slice on-device — no host-to-device copy)."""
    queries = jnp.asarray(queries, jnp.float32)
    nq = queries.shape[0]
    run_d = jnp.full((nq, k), jnp.inf, jnp.float32)
    run_i = jnp.full((nq, k), -1, jnp.int32)
    n = base.shape[0]
    for start in range(0, n, block):
        blk = jnp.asarray(base[start:start + block], jnp.float32)
        run_d, run_i = _topk_block(queries, blk, run_d, run_i,
                                   jnp.int32(start), k)
    return np.asarray(run_d), np.asarray(run_i)


def recall_at_r(found_ids: np.ndarray, gt_ids: np.ndarray, r: int) -> float:
    """Mean |found[:r] ∩ gt[:r]| / r over queries. found may contain -1 pads.

    Vectorized (one (nq, r, r) broadcast compare) — the per-query Python
    set loop cost ~1 s per 10k queries at r=10, which distorted bench
    wall-clock at large nq."""
    f = np.asarray(found_ids)[:, :r]
    g = np.asarray(gt_ids)[:, :r]
    # per-row membership: found id j ∈ gt row? (-1 pads never match: gt ids
    # are >= 0). Rows of found are unique by construction (top-k of unique
    # external ids), so summing matches counts the intersection exactly.
    # Blocked over queries: the (nq, r, r) broadcast would be ~10 GB at
    # nq=1M, r=100 in one shot.
    block = max(1, (1 << 26) // max(r * r, 1))
    hits = 0
    for s in range(0, f.shape[0], block):
        fb, gb = f[s:s + block], g[s:s + block]
        # mask repeats within a found row (keep only each id's first
        # occurrence): the old set-based recall deduplicated, and a future
        # engine bug emitting duplicate ids must depress recall, not
        # silently inflate it by counting one true neighbor several times
        first = (fb[:, :, None] == fb[:, None, :]).argmax(axis=2) \
            == np.arange(fb.shape[1])[None, :]
        eq = fb[:, :, None] == gb[:, None, :]
        hits += int((eq.any(axis=2) & (fb >= 0) & first).sum())
    return float(hits) / (f.shape[0] * r)
