"""Coarse quantizers.

The reference defines an AbstractCoarseQuantizer with two implementations
(/root/reference/src/coarsequantizers.jl):
  * NaiveQuantizer — brute-force colwise distance over all kc centroids (:18-48)
  * HNSWQuantizer  — graph ANN over the centroids (:58-93)

Here the brute-force scan is one (B, d) x (d, kc) matmul + a top-k,
which beats pointer-chasing graph traversal up to very large kc (SURVEY
§2.2). So:
  * NaiveCoarseQuantizer  — the matmul scan (default), exact.
  * TwoLevelCoarseQuantizer — the ":hnsw" replacement for huge kc (~2^18,
    Deep1B-scale): cluster the kc centroids into g groups, probe the top
    groups, then scan only their members. Sublinear in kc, still all
    matmul/top_k, fully static shapes.

Both are registered as JAX pytrees so a quantizer can be passed straight into
jitted search functions; their `search` is trace-compatible.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ivfadc_tpu.ops.metrics import Metric


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class NaiveCoarseQuantizer:
    """Brute-force coarse scan (reference NaiveQuantizer,
    /root/reference/src/coarsequantizers.jl:18-48)."""

    centroids: jax.Array        # (kc, d) float32
    metric: Metric              # static

    kind = "naive"

    @property
    def kc(self) -> int:
        return self.centroids.shape[0]

    @property
    def dim(self) -> int:
        return self.centroids.shape[1]

    def __repr__(self) -> str:
        # reference show parity (/root/reference/src/coarsequantizers.jl:22-25)
        return (f"NaiveCoarseQuantizer({self.metric.name}), "
                f"{self.dim}×{self.kc} cluster centres")

    def search(self, queries: jax.Array, w: int
               ) -> Tuple[jax.Array, jax.Array]:
        """(B, d) queries -> (cells (B, w) int32, dists (B, w) f32). Jittable.
        Exact: the metric's pairwise runs at full float32 precision."""
        from ivfadc_tpu.ops.topk import topk_lastdim
        dist = self.metric.pairwise(queries, self.centroids)    # (B, kc)
        dists, cells = topk_lastdim(dist, w)
        return cells.astype(jnp.int32), dists

    def tree_flatten(self):
        return (self.centroids,), (self.metric,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], aux[0])


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class TwoLevelCoarseQuantizer:
    """Two-level coarse scan standing in for the reference's :hnsw option
    (/root/reference/src/coarsequantizers.jl:58-93): same role (sublinear
    coarse search over many centroids), different mechanics (two stacked
    scans instead of graph traversal). Like HNSW it is approximate: the
    probed cells are the best within the gp nearest groups.

    Stage 2 gathers the member centroids of the probed groups and scores
    them exactly, in query chunks so the (chunk, gp*gmax, d) gather stays
    bounded at any kc.
    """

    centroids: jax.Array        # (kc, d) float32 — the actual cells
    group_centers: jax.Array    # (g, d) float32
    members: jax.Array          # (g, gmax) int32, padded with -1
    metric: Metric              # static
    n_probe_groups: int         # static

    kind = "two_level"

    @classmethod
    def create(cls, centroids, group_centers, members, metric,
               n_probe_groups: int) -> "TwoLevelCoarseQuantizer":
        """From (centroids, group centers, members) — the arrays persisted
        by utils/persistence.py."""
        return cls(jnp.asarray(centroids, jnp.float32),
                   jnp.asarray(group_centers, jnp.float32),
                   jnp.asarray(np.asarray(members), jnp.int32), metric,
                   n_probe_groups)

    @property
    def kc(self) -> int:
        return self.centroids.shape[0]

    @property
    def dim(self) -> int:
        return self.centroids.shape[1]

    def __repr__(self) -> str:
        # reference show parity (/root/reference/src/coarsequantizers.jl:62-65)
        return (f"TwoLevelCoarseQuantizer({self.metric.name}), "
                f"{self.dim}×{self.kc} cluster centres in "
                f"{self.group_centers.shape[0]} groups "
                f"(gp={self.n_probe_groups})")

    def search(self, queries: jax.Array, w: int
               ) -> Tuple[jax.Array, jax.Array]:
        from ivfadc_tpu.ops.topk import topk_lastdim
        B = queries.shape[0]
        gp = min(self.n_probe_groups, self.group_centers.shape[0])
        gdist = self.metric.pairwise(queries, self.group_centers)   # (B, g)
        _, gids = topk_lastdim(gdist, gp)                           # (B, gp)
        n_cand = gp * self.members.shape[1]
        w_eff = min(w, n_cand)      # fewer candidates than w: pad below
        # chunk queries so the gathered (chunk, C, d) f32 block stays
        # within ~256 MB
        bc = max(1, min(B, (1 << 28) // max(1, n_cand * self.dim * 4)))
        nch = -(-B // bc)

        def stage2(args):
            q, g = args                                 # (bc, d), (bc, gp)
            cand = self.members[g].reshape(bc, n_cand)
            valid = cand >= 0
            cvecs = self.centroids[jnp.where(valid, cand, 0)]  # (bc, C, d)
            cdist = jax.vmap(self.metric.pairwise)(q[:, None, :],
                                                   cvecs)[:, 0, :]
            cdist = jnp.where(valid, cdist, jnp.inf)
            dists, pos = topk_lastdim(cdist, w_eff)
            return jnp.take_along_axis(cand, pos, axis=1), dists

        pad = nch * bc - B
        cells, dists = jax.lax.map(stage2, (
            jnp.pad(queries, ((0, pad), (0, 0))).reshape(nch, bc, -1),
            jnp.pad(gids, ((0, pad), (0, 0))).reshape(nch, bc, gp)))
        cells = cells.reshape(nch * bc, w_eff)[:B]
        dists = dists.reshape(nch * bc, w_eff)[:B]
        cells = jnp.where(jnp.isfinite(dists), cells, 0)
        if w_eff < w:
            cells = jnp.pad(cells, ((0, 0), (0, w - w_eff)))
            dists = jnp.pad(dists, ((0, 0), (0, w - w_eff)),
                            constant_values=jnp.inf)
        return cells.astype(jnp.int32), dists

    def tree_flatten(self):
        return ((self.centroids, self.group_centers, self.members),
                (self.metric, self.n_probe_groups))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, aux[0], aux[1])


def build_two_level(key: jax.Array, centroids: jax.Array, metric: Metric,
                    n_groups: int = 0, n_probe_groups: int = 0,
                    maxiter: int = 16) -> TwoLevelCoarseQuantizer:
    """Cluster the kc centroids into ~sqrt(kc) groups."""
    from ivfadc_tpu.ops.kmeans import kmeans

    kc = centroids.shape[0]
    g = n_groups or max(1, int(math.ceil(math.sqrt(kc))))
    g = min(g, kc)
    if g <= 1:
        group_centers = jnp.mean(centroids, axis=0, keepdims=True)
        members = jnp.arange(kc, dtype=jnp.int32)[None, :]
        return TwoLevelCoarseQuantizer.create(centroids, group_centers,
                                              members, metric, 1)
    res = kmeans(key, centroids, g, maxiter=maxiter, metric=metric)
    assign = np.asarray(res.assignments)
    counts = np.bincount(assign, minlength=g)
    gmax = max(1, int(counts.max()))
    members = np.full((g, gmax), -1, np.int32)
    order = np.argsort(assign, kind="stable")
    within = np.arange(kc, dtype=np.int64) - np.concatenate(
        [[0], np.cumsum(counts)[:-1]])[assign[order]]
    members[assign[order], within] = order
    # probe a quarter of the groups, but never fewer than 8: at small g the
    # quarter rule prunes too hard (uniform data spreads a query's true
    # cells across groups) while 8 groups is still cheap
    # default dial: g/4 groups at small g, tapering to g/16 at large g —
    # measured on Deep1B-shape (kc=2^18, g=512, w=32) recall@10 saturates
    # by gp=32 (=g/16) while gp=128 (=g/4) costs +35% latency; at small g
    # (kc~1e4: g~100) the candidate pool gp*(kc/g) is thinner and g/4 is
    # needed (pinned by tests/test_topk.py's two-level recall bound)
    gp = n_probe_groups or max(min(g, 8),
                               min(-(-g // 4), max(32, -(-g // 16))))
    return TwoLevelCoarseQuantizer.create(centroids, res.centers, members,
                                          metric, gp)


def make_coarse_quantizer(kind: str, key, centroids, metric: Metric,
                          n_groups: int = 0, n_probe_groups: int = 0):
    if kind == "naive":
        return NaiveCoarseQuantizer(jnp.asarray(centroids, jnp.float32), metric)
    if kind in ("hnsw", "two_level"):
        return build_two_level(key, jnp.asarray(centroids, jnp.float32),
                               metric, n_groups=n_groups,
                               n_probe_groups=n_probe_groups)
    raise ValueError(f"unknown coarse quantizer kind {kind!r}")
