"""Batched k-means.

Replaces Clustering.jl's `kmeans(data, kc; init=:kmpp, maxiter, distance)`
as called by the reference at /root/reference/src/index.jl:129-134.

Design:
  * assignment = one fused `||x||^2 + ||c||^2 - 2 x c^T` matmul + argmin per
    block of points (full float32 precision, ops/metrics.py), streamed with
    `lax.scan` so the (n, k) distance matrix is never materialized;
  * centroid update = one-hot matmul (block, k)^T @ (block, d) accumulated in
    the same scan — a scatter-free, deterministic segment sum;
  * k-means++ seeding = `lax.fori_loop` of rank-1 distance updates + weighted
    categorical sampling via cumsum/searchsorted;
  * empty clusters are re-seeded each iteration to the currently-farthest
    points (Clustering.jl repairs empties too; exact policy differs — parity
    is asserted on recall, not centroids, per SURVEY §7).

Everything is jittable with static (n, d, k, maxiter, block) and vmappable
(PQ training vmaps this over the m subspaces).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ivfadc_tpu.ops.metrics import Metric, SQEUCLIDEAN


class KMeansResult(NamedTuple):
    centers: jax.Array       # (k, d) float32
    assignments: jax.Array   # (n,) int32


# beyond this k, "kmeans++" seeding runs as k-means|| (kmeans_parallel)
_PP_MAX_K = 4096


def _pad_blocks(x: jax.Array, block: int):
    """Zero-pad points to a multiple of `block`; returns (blocks, mask_blocks)."""
    n, d = x.shape
    nb = -(-n // block)
    pad = nb * block - n
    xp = jnp.pad(x, ((0, pad), (0, 0)))
    mask = jnp.pad(jnp.ones((n,), jnp.float32), (0, pad))
    return xp.reshape(nb, block, d), mask.reshape(nb, block)


@functools.partial(jax.jit, static_argnames=("k", "metric"))
def kmeans_plus_plus(key: jax.Array, x: jax.Array, k: int,
                     metric: Metric = SQEUCLIDEAN) -> jax.Array:
    """k-means++ seeding (:kmpp at /root/reference/src/index.jl:133).

    Returns (k, d) float32 initial centers. O(k * n * d), bandwidth-bound.
    """
    n, d = x.shape
    x = x.astype(jnp.float32)
    k0, kloop = jax.random.split(key)
    first = x[jax.random.randint(k0, (), 0, n)]
    centers0 = jnp.zeros((k, d), jnp.float32).at[0].set(first)
    mind0 = metric.pairwise(x, first[None, :])[:, 0]

    def body(j, carry):
        centers, mind = carry
        kj = jax.random.fold_in(kloop, j)
        # D^2 sampling weight. Metrics whose "distances" can go negative
        # (inner_product returns -<x,c>) would have every near point's
        # weight clipped to 0 — for all-positive-orthant data that zeroes
        # the TOTAL mass and silently degrades to uniform picks each step.
        # Shift by the (non-positive) minimum first: ordering is preserved,
        # farthest points keep the largest weight, and sqeuclidean-family
        # metrics (min >= 0) are bit-unchanged.
        w = jnp.maximum(mind - jnp.minimum(jnp.min(mind), 0.0), 0.0)
        cum = jnp.cumsum(w)
        total = cum[-1]
        u = jax.random.uniform(kj, ()) * jnp.maximum(total, 1e-30)
        idx = jnp.searchsorted(cum, u)
        idx = jnp.clip(idx, 0, n - 1)
        # Degenerate guard: all residual mass zero -> fall back to uniform pick.
        idx = jnp.where(total > 0, idx, jax.random.randint(kj, (), 0, n))
        c = x[idx]
        centers = centers.at[j].set(c)
        mind = jnp.minimum(mind, metric.pairwise(x, c[None, :])[:, 0])
        return centers, mind

    centers, _ = jax.lax.fori_loop(1, k, body, (centers0, mind0))
    return centers


@functools.partial(
    jax.jit, static_argnames=("k", "rounds", "m_r", "block", "metric"))
def _kmeans_parallel_impl(key, x, k: int, rounds: int, m_r: int,
                          block: int, metric: Metric):
    """k-means||-style seeding (after Bahmani et al., VLDB'12) in
    matmul form.

    Sequential k-means++ is a k-step loop of rank-1 updates — hours at
    Deep1B's kc=2^18 — so beyond _PP_MAX_K seeding runs this parallel
    variant: `rounds` rounds each draw `m_r` seeds by D^2-weighted
    sampling WITHOUT replacement (Gumbel-top-m_r: one sort per round, no
    sequential draws), and the running min-distance updates against each
    round's whole batch as one blocked matmul pass. The k seeds are the
    pooled draws themselves — measured on separated-cluster data, a
    weighted "recluster the pool" step only HURT spread versus taking the
    pool at rounds=16 (within-round redundancy is the residual gap to
    sequential k-means++: two nearby far-away points can both be drawn in
    the same round; more rounds shrink it, rounds == k recovers k-means++
    exactly). Already-chosen points have distance 0 => weight 0 => are
    never redrawn.
    """
    n, d = x.shape
    x = x.astype(jnp.float32)
    k0, kloop = jax.random.split(key)
    first = x[jax.random.randint(k0, (), 0, n)]
    mind0 = metric.pairwise(x, first[None, :])[:, 0]
    cand0 = jnp.zeros((1 + rounds * m_r, d), jnp.float32).at[0].set(first)

    x_blocks, mask_blocks = _pad_blocks(x, block)

    def min_vs(mind, new_c):
        """Blocked mind update against a (m_r, d) candidate batch."""
        def step(carry, xb_mb):
            xb, mb = xb_mb
            dmin = jnp.min(metric.pairwise(xb, new_c), axis=1)
            return carry, dmin
        _, dm = jax.lax.scan(step, 0, (x_blocks, mask_blocks))
        return jnp.minimum(mind, dm.reshape(-1)[:n])

    def round_body(j, carry):
        cand, mind = carry
        kj = jax.random.fold_in(kloop, j)
        # same non-negative shift discipline as kmeans_plus_plus: metrics
        # with negative "distances" keep ordering, sqeuclidean unchanged
        w = jnp.maximum(mind - jnp.minimum(jnp.min(mind), 0.0), 0.0)
        g = jnp.log(jnp.maximum(w, 1e-30)) + jax.random.gumbel(kj, (n,))
        g = jnp.where(w > 0, g, -jnp.inf)
        _, idx = jax.lax.top_k(g, m_r)
        new_c = x[idx]
        cand = jax.lax.dynamic_update_slice(cand, new_c, (1 + j * m_r, 0))
        return cand, min_vs(mind, new_c)

    cand, _ = jax.lax.fori_loop(0, rounds, round_body, (cand0, mind0))
    return cand[:k]


def kmeans_parallel(key: jax.Array, x: jax.Array, k: int,
                    metric: Metric = SQEUCLIDEAN, *, rounds: int = 16,
                    block: int = 16384) -> jax.Array:
    """Public wrapper: (k, d) float32 seeds via parallel k-means||-style
    D^2 seeding (see _kmeans_parallel_impl). Cost: `rounds` blocked
    (n x k/rounds) matmul passes + one n-wide sort per round."""
    n, _ = x.shape
    if n < k:
        raise AssertionError(
            f"k-means|| needs at least k={k} points to seed from, got {n}")
    rounds = max(1, min(rounds, k))
    m_r = -(-k // rounds)          # pool 1 + rounds*m_r >= k
    m_r = int(min(m_r, n))
    block = max(256, min(block, (1 << 28) // max(m_r, 1)))
    return _kmeans_parallel_impl(key, jnp.asarray(x, jnp.float32), k,
                                 rounds, m_r, block, metric)


def _assign_pass(x_blocks, mask_blocks, centers, metric: Metric):
    """One streamed pass: per-point argmin/min plus accumulated one-hot sums.

    Returns (assignments (nb, block) int32, mindists (nb, block) f32,
             sums (k, d) f32, counts (k,) f32).
    """
    k = centers.shape[0]

    def step(carry, xb_mb):
        sums, counts = carry
        xb, mb = xb_mb
        dist = metric.pairwise(xb, centers)                  # (block, k)
        a = jnp.argmin(dist, axis=1).astype(jnp.int32)
        md = jnp.min(dist, axis=1)
        onehot = jax.nn.one_hot(a, k, dtype=jnp.float32) * mb[:, None]
        # Default precision (TF32 on the GPU) rounds each coordinate to
        # 2^-11 relative before the f32 accumulation: the centroid is a
        # running mean, not a contracted exact value, and full precision
        # would double the cost of every Lloyd iteration.
        sums = sums + jnp.dot(onehot.T, xb,
                              precision=jax.lax.Precision.DEFAULT,
                              preferred_element_type=jnp.float32)
        counts = counts + jnp.sum(onehot, axis=0)
        # Invalidate padded points so they are never picked as re-seed targets.
        md = jnp.where(mb > 0, md, -jnp.inf)
        return (sums, counts), (a, md)

    d = x_blocks.shape[-1]
    init = (jnp.zeros((k, d), jnp.float32), jnp.zeros((k,), jnp.float32))
    (sums, counts), (assigns, mindists) = jax.lax.scan(
        step, init, (x_blocks, mask_blocks))
    return assigns, mindists, sums, counts


def _lloyd_update(x_blocks, mask_blocks, flat_x, centers, metric: Metric):
    """One Lloyd iteration: assignment pass + mean update + empty reseed."""
    _, mindists, sums, counts = _assign_pass(x_blocks, mask_blocks,
                                             centers, metric)
    new_centers = sums / jnp.maximum(counts[:, None], 1.0)
    empty = counts < 0.5
    # Re-seed empty clusters at far-away points. A global top-k over all
    # n mindists would be an n-wide sort each iteration (dominates both
    # compile and run time at n~1e6); instead take each block's farthest
    # point — nb candidates, ranked by a tiny nb-wide sort. Rarely are
    # there more empties than blocks; if so, candidates are reused.
    bfar = jnp.max(mindists, axis=1)                      # (nb,)
    barg = jnp.argmax(mindists, axis=1).astype(jnp.int32)  # (nb,)
    nb = bfar.shape[0]
    order = jnp.argsort(-bfar)                            # farthest first
    cand_idx = barg[order] + order.astype(jnp.int32) * mindists.shape[1]
    slot = jnp.cumsum(empty.astype(jnp.int32)) - 1     # rank among empties
    reseed = flat_x[cand_idx[jnp.clip(slot, 0, nb - 1)]]
    new_centers = jnp.where(empty[:, None], reseed, new_centers)
    # Keep the old center when a cluster is empty AND there is no mass to
    # re-seed from (degenerate tiny inputs).
    any_mass = jnp.isfinite(jnp.max(bfar))
    return jnp.where(any_mass | ~empty[:, None], new_centers, centers)


@functools.partial(jax.jit, static_argnames=("k", "maxiter", "block", "metric"))
def _kmeans_impl(x, k: int, maxiter: int, block: int, metric: Metric,
                 init_centers):
    """Deterministic Lloyd iterations — all randomness lives in seeding."""
    n, d = x.shape
    x = x.astype(jnp.float32)
    x_blocks, mask_blocks = _pad_blocks(x, block)
    flat_x = x_blocks.reshape(-1, d)

    def iteration(_, centers):
        return _lloyd_update(x_blocks, mask_blocks, flat_x, centers, metric)

    centers = jax.lax.fori_loop(0, maxiter, iteration, init_centers)
    assigns, _, _, _ = _assign_pass(x_blocks, mask_blocks, centers, metric)
    return centers, assigns.reshape(-1)[:n]


def kmeans(key: jax.Array, x: jax.Array, k: int, *,
           maxiter: int = 25, metric: Metric = SQEUCLIDEAN,
           init: str = "kmeans++", block: int = 16384,
           pp_sample: int = 0) -> KMeansResult:
    """Lloyd k-means. `x` is (n, d); returns float32 centers + int32 assignments.

    `pp_sample > 0` runs the k-means++ seeding on a uniform subsample of at
    most that many points (a standard large-n accelerator; 0 = all points).
    """
    n, d = x.shape
    if k > n:
        raise AssertionError(f"k={k} must be <= number of points {n}")
    if not metric.trainable:
        raise ValueError(f"metric {metric.name!r} does not support k-means training")
    key_init, key_seed = jax.random.split(jax.random.fold_in(key, k))
    x = jnp.asarray(x, jnp.float32)
    block = min(block, max(256, n))
    # the assignment step materializes a (block, k) distance matrix and a
    # (block, k) one-hot — cap their footprint (~1 GB f32) for huge-k builds
    block = max(256, min(block, (1 << 28) // max(k, 1)))

    # k-means++ is a k-step sequential loop (rank-1 distance updates) — fine
    # to a few thousand centers, hours at Deep1B-scale kc=2^18. Past the
    # cutoff, seeding switches to k-means|| (kmeans_parallel): the same
    # D^2-weighted spread, as a handful of batched matmul/top-k rounds,
    # never a silent downgrade to random (the reference always seeds
    # :kmpp, /root/reference/src/index.jl:133).
    if init == "kmeans++" and k > _PP_MAX_K:
        init = "kmeans||"
    if init in ("kmeans++", "kmeans||"):
        xs = x
        if pp_sample and pp_sample < n:
            # k-means|| draws k DISTINCT seeds — the sample must hold
            # comfortably more than k of them (total seeding work is
            # ~ n_sample * k * d, one Lloyd-assignment-pass equivalent,
            # so falling back to more points is affordable)
            eff_sample = max(pp_sample, min(n, 2 * k)) \
                if init == "kmeans||" else pp_sample
            if eff_sample < n:
                sel = jax.random.choice(key_seed, n, (eff_sample,),
                                        replace=False)
                xs = x[sel]
        if init == "kmeans||":
            init_centers = kmeans_parallel(key_init, xs, k, metric,
                                           block=block)
        else:
            init_centers = kmeans_plus_plus(key_init, xs, k, metric)
    elif init == "random":
        sel = jax.random.choice(key_init, n, (k,), replace=False)
        init_centers = x[sel]
    else:
        raise ValueError(f"unknown init {init!r}")

    centers, assignments = _kmeans_impl(x, k, maxiter, block, metric,
                                        init_centers)
    return KMeansResult(centers, assignments)


@functools.partial(jax.jit, static_argnames=("block", "metric"))
def _assign_impl(x, centers, block: int, metric: Metric):
    n = x.shape[0]
    x_blocks, _ = _pad_blocks(x.astype(jnp.float32), block)

    def step(_, xb):
        dist = metric.pairwise(xb, centers)
        return 0, jnp.argmin(dist, axis=1).astype(jnp.int32)

    _, assigns = jax.lax.scan(step, 0, x_blocks)
    return assigns.reshape(-1)[:n]


def assign(x, centers, *, metric: Metric = SQEUCLIDEAN,
           block: int = 16384) -> jax.Array:
    """Nearest-center assignment only — one streamed Lloyd assignment pass
    without the update sums. Used by the out-of-core streaming build
    (`IVFADCIndex.build_streaming`) to place each ingest chunk against the
    already-trained coarse centers."""
    k = centers.shape[0]
    block = max(256, min(block, (1 << 28) // max(k, 1)))
    return _assign_impl(jnp.asarray(x), jnp.asarray(centers, jnp.float32),
                        block, metric)
