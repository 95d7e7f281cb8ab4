"""Dense scan over the resident decoded-residual cache ("dense" scan mode).

Each probed cell's postings are gathered as decoded rows and scored by one
batched contraction against the probe's score vector:

    rows   = decoded[start_p + j],  j < win        (w, win, d) per query
    scores = rows . v_p + coef * ||rows||^2 + base_p

For the squared-euclidean family v = -2 * r (r the rotated query residual)
and base = ||r||^2 (+ the coarse distance in "reference" score mode), which
is exactly ||r - r_hat||^2 = the LUT engine's score up to the cache's
bf16/int8 rounding; for inner product v = -q, coef = 0.

`win` covers the largest cell, so every probed posting is scored: the engine
is exact for any k. Queries are processed in chunks (`lax.map` with a batch
size derived from a byte budget) so the gathered (chunk, w, win, d) block
stays bounded whatever the batch size; each chunk ends in its own top-k.

Reference counterpart: the per-cell posting loop at
/root/reference/src/index.jl:241-246, here as one dense batch per chunk.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ivfadc_tpu.ops.topk import topk_lastdim

# bytes of gathered bf16 rows one query chunk may materialize
_CHUNK_BYTES = 1 << 28


def query_chunk(w: int, win: int, d: int, budget: int = _CHUNK_BYTES) -> int:
    """Queries per chunk: the largest power of two whose gathered
    (chunk, w, win, d) bf16 block fits `budget` (at least 1)."""
    per_query = max(1, w * win * d * 2)
    c = 1
    while 2 * c * per_query <= budget:
        c *= 2
    return c


@functools.partial(jax.jit, static_argnames=("k", "win", "norm_coef",
                                             "chunk"))
def gathered_scan(starts, sizes, v, base, decoded, scale, ids, *, k: int,
                  win: int, norm_coef: float = 1.0, chunk: int = 0):
    """Top-k over every posting of each query's probed cells.

    starts/sizes (B, w) i32 — slot ranges of the probed cells (size 0 skips)
    v            (B, w, d)  — score vectors (e.g. -2 * rotated residual)
    base         (B, w) f32 — per-probe additive constants (inf kills a probe)
    decoded      (cap, d) bf16 or int8 — resident decoded residuals
    scale        (d,) f32 or None — int8 dequantization scales
    ids          (cap,) i32 — external ids per slot (-1 in empty slots)
    win          static     — rows read per probe; must cover every size
    chunk        static     — queries per chunk (0: derived from the budget)

    Returns (ids (B, k) i32 with -1 padding, dists (B, k) f32 ascending with
    +inf padding).
    """
    B, w, d = v.shape
    k_eff = min(k, w * win)
    lanes = jnp.arange(win, dtype=jnp.int32)
    cap = decoded.shape[0]
    bc = min(chunk or query_chunk(w, win, d), B)
    nch = -(-B // bc)

    def one_chunk(args):
        st, sz, vq, bq = args                  # (bc,w), (bc,w), (bc,w,d), (bc,w)
        valid = lanes < sz[..., None]                        # (bc, w, win)
        idx = jnp.minimum(jnp.where(valid, st[..., None] + lanes, 0),
                          cap - 1)
        rows = decoded[idx].astype(jnp.bfloat16)             # (bc, w, win, d)
        if scale is not None:
            rows = rows * scale.astype(jnp.bfloat16)
        # bf16 operands, f32 accumulation: the cache is bf16/int8 already,
        # so a wider product would not make the scores any more exact
        scores = jnp.einsum("bpwd,bpd->bpw", rows, vq.astype(jnp.bfloat16),
                            precision=jax.lax.Precision.DEFAULT,
                            preferred_element_type=jnp.float32)
        if norm_coef != 0.0:
            rf = rows.astype(jnp.float32)
            scores = scores + norm_coef * jnp.sum(rf * rf, axis=-1)
        scores = jnp.where(valid, scores + bq[..., None], jnp.inf)
        dist, which = topk_lastdim(scores.reshape(bc, w * win), k_eff)
        pos = jnp.take_along_axis(idx.reshape(bc, w * win), which, axis=1)
        out = jnp.where(jnp.isfinite(dist), ids[pos], -1)
        return out.astype(jnp.int32), dist

    def chunked(a, fill):
        a = jnp.pad(a, ((0, nch * bc - B),) + ((0, 0),) * (a.ndim - 1),
                    constant_values=fill)
        return a.reshape((nch, bc) + a.shape[1:])

    out_ids, out_d = jax.lax.map(
        one_chunk, (chunked(starts, 0), chunked(sizes, 0), chunked(v, 0),
                    chunked(base, jnp.inf)))
    out_ids = out_ids.reshape(nch * bc, k_eff)[:B]
    out_d = out_d.reshape(nch * bc, k_eff)[:B]
    if k_eff < k:
        out_ids = jnp.pad(out_ids, ((0, 0), (0, k - k_eff)),
                          constant_values=-1)
        out_d = jnp.pad(out_d, ((0, 0), (0, k - k_eff)),
                        constant_values=jnp.inf)
    return out_ids, out_d
