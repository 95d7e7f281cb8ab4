"""Metric registry.

The reference threads Distances.jl `PreMetric` objects through every layer
(/root/reference/src/coarsequantizers.jl:34, /root/reference/src/index.jl:234).
Here a metric is a small frozen object of pure functions that jitted kernels
close over — no dispatch at trace time, everything fuses into XLA.

Only metrics whose subspace decomposition is additive make the ADC estimator
exact (true for sqeuclidean / cityblock / inner_product; euclidean is handled
by finalizing with sqrt at the very end). The reference never validates this;
we document it per-metric via `.additive`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp

# Every pairwise matmul runs at full float32 precision. Without it the GPU
# runs float32 products in TF32 (~3 decimal digits), and these distances feed
# results that are contracted as exact: the brute-force coarse probe, k-means
# and PQ assignment, and the ADC tables.
_HIGHEST = jax.lax.Precision.HIGHEST


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    # pairwise(X:(n,d), Y:(c,d)) -> (n,c) distances. Hot path: implemented as
    # a matmul wherever possible.
    pairwise: Callable
    # finalize(d) applied to accumulated distances before returning to user.
    finalize: Callable
    # Whether sum-over-subspaces of this metric equals the metric on the
    # concatenated vector (makes the ADC table sum exact).
    additive: bool
    # Whether k-means training under this metric is supported (Lloyd updates
    # assume a mean minimizer, i.e. squared-euclidean geometry).
    trainable: bool = True
    # ADC tables: True -> built from the query residual (translation-invariant
    # metrics: ||q-x|| depends on r - r_hat); False -> built from the query
    # itself (inner-product family: q.x = q.c + q.decode), in which case the
    # coarse term is always part of the score.
    residual_based: bool = True


def _sqeuclidean_pairwise(x, y):
    # ||x - y||^2 = ||x||^2 + ||y||^2 - 2 x.y  — one matmul.
    xn = jnp.sum(x * x, axis=-1, keepdims=True)            # (n, 1)
    yn = jnp.sum(y * y, axis=-1)                           # (c,)
    cross = jnp.dot(x, y.T, precision=_HIGHEST,
                    preferred_element_type=jnp.float32)
    d = xn + yn[None, :] - 2.0 * cross
    return jnp.maximum(d, 0.0)


def _cityblock_pairwise(x, y):
    # O(n*c*d) elementwise — fine for codebook-sized y.
    return jnp.sum(jnp.abs(x[:, None, :] - y[None, :, :]), axis=-1)


def _inner_product_pairwise(x, y):
    # Negated inner product so that "smaller is closer" holds uniformly.
    return -jnp.dot(x, y.T, precision=_HIGHEST,
                    preferred_element_type=jnp.float32)


def _cosine_pairwise(x, y):
    xn = x / jnp.maximum(jnp.linalg.norm(x, axis=-1, keepdims=True), 1e-30)
    yn = y / jnp.maximum(jnp.linalg.norm(y, axis=-1, keepdims=True), 1e-30)
    return 1.0 - jnp.dot(xn, yn.T, precision=_HIGHEST,
                         preferred_element_type=jnp.float32)


_identity = lambda d: d

SQEUCLIDEAN = Metric("sqeuclidean", _sqeuclidean_pairwise, _identity, additive=True)
# euclidean accumulates squared distances and takes sqrt at the end, so the
# ADC sum stays additive and the user sees true euclidean distances.
EUCLIDEAN = Metric("euclidean", _sqeuclidean_pairwise,
                   lambda d: jnp.sqrt(jnp.maximum(d, 0.0)), additive=True)
# cityblock stays trainable for parity with the reference: Clustering.jl's
# kmeans likewise assigns under the given metric but updates centroids by
# MEAN (the L1 minimizer would be the per-coordinate median), so a
# cityblock coarse build behaves identically here and there — a heuristic,
# not a converging L1 k-means.
CITYBLOCK = Metric("cityblock", _cityblock_pairwise, _identity, additive=True)
# inner_product / cosine train like Clustering.jl trains them when passed as
# `coarse_distance` (/root/reference/src/index.jl:129-134): Lloyd assigns
# under the metric and updates centroids by MEAN — the same
# assign-under-metric / mean-update policy as cityblock above. For cosine
# this is well-behaved (assignment is scale-invariant, and the mean keeps
# centroids in data space so coarse residuals stay small); for inner_product
# it is the same heuristic the reference inherits. cosine remains invalid as
# a QUANTIZATION metric (non-additive — rejected at index construction).
INNER_PRODUCT = Metric("inner_product", _inner_product_pairwise, _identity,
                       additive=True, residual_based=False)
COSINE = Metric("cosine", _cosine_pairwise, _identity, additive=False)

_REGISTRY = {
    m.name: m for m in (SQEUCLIDEAN, EUCLIDEAN, CITYBLOCK, INNER_PRODUCT, COSINE)
}


def get_metric(name: str) -> Metric:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"Unknown metric {name!r}; available: {sorted(_REGISTRY)}") from None


def register_metric(metric: Metric) -> None:
    _REGISTRY[metric.name] = metric
