"""Distributed index *training* (build): data-parallel k-means + PQ encode.

The reference's build is single-threaded (SURVEY §2.4). Here the hot build
steps are expressed as shard_map programs over the ("data", "shard") mesh:

  * k-means assignment+accumulation runs data-parallel: each device scans its
    local slice of points, computes per-cluster one-hot partial sums as a
    matmul, and a `psum` over the data axis produces the exact global Lloyd
    update — the classic sufficient-statistics reduction.
  * PQ encoding is embarrassingly data-parallel (pure map over points).

`distributed_kmeans` runs the Lloyd iterations as one program; `train_step` bundles one
k-means iteration + an encode pass — the "full training step" used by the
multi-device dry run.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from jax import shard_map

from ivfadc_tpu.ops.metrics import Metric, SQEUCLIDEAN
from ivfadc_tpu.parallel.mesh import DATA_AXIS


def _local_stats(x_local, mask_local, centers, metric: Metric,
                 block: int = 16384):
    """Per-device Lloyd sufficient statistics: (sums (k,d), counts (k,)).

    Blocked with `lax.map` so the (block, k) distance matrix — not the full
    (n_local, k) one — is the peak temporary (Deep1B-scale kc would otherwise
    materialize gigabytes per device)."""
    k, d = centers.shape
    nl = x_local.shape[0]
    block = min(block, nl)
    nb = -(-nl // block)
    pad = nb * block - nl
    xb = jnp.pad(x_local, ((0, pad), (0, 0))).reshape(nb, block, d)
    mb = jnp.pad(mask_local, (0, pad)).reshape(nb, block)

    def per_block(args):
        xl, ml = args
        dist = metric.pairwise(xl, centers)
        a = jnp.argmin(dist, axis=1).astype(jnp.int32)
        onehot = jax.nn.one_hot(a, k, dtype=jnp.float32) * ml[:, None]
        # default precision: a running-mean update, see ops/kmeans.py
        sums = jnp.dot(onehot.T, xl, precision=jax.lax.Precision.DEFAULT,
                       preferred_element_type=jnp.float32)
        return a, sums, jnp.sum(onehot, axis=0)

    a_b, sums_b, counts_b = jax.lax.map(per_block, (xb, mb))
    return (a_b.reshape(-1)[:nl], jnp.sum(sums_b, axis=0),
            jnp.sum(counts_b, axis=0))


@functools.partial(jax.jit,
                   static_argnames=("mesh", "metric", "axes", "maxiter"))
def distributed_lloyd(centers, x, mask, *, mesh, metric: Metric,
                      axes=(DATA_AXIS,), maxiter: int = 1):
    """`maxiter` exact Lloyd iterations with points sharded over `axes`, as
    ONE program.

    centers (k, d) replicated; x (n, d) and mask (n,) sharded on `axes`.
    Returns (new_centers replicated, assignments sharded) — the assignments
    of the last iteration, made against the centers it started from.

    The iterations run in one `fori_loop` rather than as `maxiter`
    back-to-back dispatches: several in-flight programs that each hold a
    cross-device all-reduce can starve one another of the host threads
    the CPU backend runs devices on, and the all-reduce rendezvous then
    aborts the process.
    """

    def step(centers_l, x_l, mask_l):
        a, sums, counts = _local_stats(x_l, mask_l, centers_l, metric)
        sums = jax.lax.psum(sums, axes)
        counts = jax.lax.psum(counts, axes)
        new_centers = sums / jnp.maximum(counts[:, None], 1.0)
        # keep old center for empty clusters (repair is a host-side concern
        # in the distributed path)
        new_centers = jnp.where(counts[:, None] > 0.5, new_centers, centers_l)
        return new_centers, a

    def loop(centers_l, x_l, mask_l):
        a0 = jnp.zeros(x_l.shape[0], jnp.int32)
        return jax.lax.fori_loop(
            0, maxiter, lambda _, c: step(c[0], x_l, mask_l),
            (centers_l, a0))

    fn = shard_map(
        loop, mesh=mesh,
        in_specs=(P(), P(axes), P(axes)),
        out_specs=(P(), P(axes)),
        check_vma=False)
    return fn(centers, x, mask)


def distributed_kmeans(key, x, k: int, mesh, *,
                       maxiter: int = 25, metric: Metric = SQEUCLIDEAN,
                       mask=None, n_valid: int = 0, axes=(DATA_AXIS,)
                       ) -> Tuple[jax.Array, jax.Array]:
    """Full data-parallel Lloyd k-means over the given mesh axes.

    `x` is either a host (n, d) array (padded + uploaded here) or a device
    array already sharded over `axes` (pass its validity `mask` and the true
    point count `n_valid`). Seeds from k-means++ on a replicated subsample,
    then runs `maxiter` exact distributed iterations.
    Returns (centers (k, d) replicated, assignments (n,) sharded).
    """
    from ivfadc_tpu.ops.kmeans import (_PP_MAX_K, kmeans_parallel,
                                       kmeans_plus_plus)

    axes = tuple(axes) if isinstance(axes, (tuple, list)) else (axes,)
    n_dev = int(np.prod([mesh.shape[ax] for ax in axes]))
    axes_sh = NamedSharding(mesh, P(axes))
    if isinstance(x, jax.Array) and mask is not None:
        xd, maskd = x, mask
        n = n_valid or x.shape[0]
    else:
        x = np.asarray(x, np.float32)
        n = x.shape[0]
        n_pad = ((n + n_dev - 1) // n_dev) * n_dev
        xd = jax.device_put(np.pad(x, ((0, n_pad - n), (0, 0))), axes_sh)
        maskd = jax.device_put(
            np.pad(np.ones(n, np.float32), (0, n_pad - n)), axes_sh)

    # k-means++ on a replicated subsample (gathered device-side when the
    # input is already sharded — the sample is tiny)
    n_samp = min(n, max(k * 16, 1024))
    from ivfadc_tpu.utils.datasets import sample_indices
    sel = sample_indices(0, n, n_samp)         # O(n_samp), not O(n)
    sample = jnp.asarray(np.asarray(x)[sel]) if not isinstance(x, jax.Array) \
        else xd[jnp.asarray(sel)]
    if k > _PP_MAX_K:
        # huge-kc seeding: k-means|| (batched rounds) — the sequential
        # k-means++ loop would run for hours at Deep1B's kc=2^18
        centers = kmeans_parallel(key, sample, k, metric)
    else:
        centers = kmeans_plus_plus(key, sample, k, metric)
    centers = jax.device_put(np.asarray(centers), NamedSharding(mesh, P()))

    centers, assignments = distributed_lloyd(
        centers, xd, maskd, mesh=mesh, metric=metric, axes=axes,
        maxiter=maxiter)
    return centers, assignments[:n]


@functools.partial(jax.jit, static_argnames=("mesh", "metric", "m"))
def train_step(centers, codebooks, x, mask, *, mesh, metric: Metric, m: int):
    """One full distributed training step (used by the multi-device dry run):

      1. data-parallel Lloyd iteration over the coarse centers (dp + psum);
      2. residual computation against the updated centers;
      3. PQ encode of the local residuals against replicated codebooks.

    x/mask sharded on DATA_AXIS; centers/codebooks replicated.
    Returns (new_centers, assignments, codes) with codes sharded on DATA_AXIS.
    """

    def step(centers_l, codebooks_l, x_l, mask_l):
        a, sums, counts = _local_stats(x_l, mask_l, centers_l, metric)
        sums = jax.lax.psum(sums, DATA_AXIS)
        counts = jax.lax.psum(counts, DATA_AXIS)
        new_centers = sums / jnp.maximum(counts[:, None], 1.0)
        new_centers = jnp.where(counts[:, None] > 0.5, new_centers, centers_l)
        resid = x_l - new_centers[a]                       # (nl, d)
        nl, d = resid.shape
        sub = resid.reshape(nl, m, d // m)                 # (nl, m, dsub)
        sub = jnp.moveaxis(sub, 1, 0)                      # (m, nl, dsub)
        codes = jax.vmap(
            lambda xs, cb: jnp.argmin(metric.pairwise(xs, cb), axis=1)
        )(sub, codebooks_l).T.astype(jnp.int32)            # (nl, m)
        return new_centers, a, codes

    fn = shard_map(
        step, mesh=mesh,
        in_specs=(P(), P(), P(DATA_AXIS), P(DATA_AXIS)),
        out_specs=(P(), P(DATA_AXIS), P(DATA_AXIS)),
        check_vma=False)
    return fn(centers, codebooks, x, mask)
