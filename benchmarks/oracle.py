"""NumPy oracle of the reference's exact search algorithm.

Julia isn't installed in this environment, so this is the
executable stand-in for JuliaNeighbors/IVFADC.jl: a faithful single-core
reimplementation of `knn_search` (/root/reference/src/index.jl:204-258) —
brute-force coarse scan + per-probe ADC table build + serial posting scan,
one query at a time, with the reference's "coarse_dist + sum(table)" score
(:242-246). It operates on the SAME trained arrays as the JAX index, so
recall parity isolates search semantics and QPS ratio isolates speed.

Vectorized per-query with NumPy, so its inner loops run at C speed — a fair
proxy for the compiled single-threaded Julia reference.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _coarse_dists(centroids: np.ndarray, q: np.ndarray,
                  metric: str) -> np.ndarray:
    """colwise(Dc(), centroids, q) — the reference's pluggable coarse metric
    (/root/reference/src/coarsequantizers.jl:33-37, kwarg at
    /root/reference/src/index.jl:107)."""
    if metric in ("sqeuclidean", "euclidean"):
        diff = centroids - q
        d = np.einsum("ij,ij->i", diff, diff)
        return np.sqrt(d) if metric == "euclidean" else d
    if metric == "cityblock":
        return np.abs(centroids - q).sum(axis=1)
    if metric == "inner_product":
        return -centroids @ q
    if metric == "cosine":
        cn = centroids / np.maximum(
            np.linalg.norm(centroids, axis=1, keepdims=True), 1e-30)
        qn = q / max(np.linalg.norm(q), 1e-30)
        return 1.0 - cn @ qn
    raise ValueError(f"oracle: unknown coarse metric {metric!r}")


class ReferenceOracle:
    def __init__(self, centroids: np.ndarray, codebooks: np.ndarray,
                 cell_ids: list, cell_codes: list,
                 coarse_metric: str = "sqeuclidean"):
        """centroids (kc, d); codebooks (m, k, dsub);
        cell_ids[c] (sz,), cell_codes[c] (sz, m) per cell."""
        self.centroids = np.asarray(centroids, np.float32)
        self.codebooks = np.asarray(codebooks, np.float32)
        self.cell_ids = [np.asarray(i) for i in cell_ids]
        self.cell_codes = [np.asarray(c) for c in cell_codes]
        self.kc, self.d = self.centroids.shape
        self.m, self.k, self.dsub = self.codebooks.shape
        self.coarse_metric = coarse_metric

    @classmethod
    def from_index(cls, index) -> "ReferenceOracle":
        ids, codes = [], []
        for c in range(index.config.kc):
            i, co = index.store.cell_entries(c)
            ids.append(i)
            codes.append(co)
        return cls(np.asarray(index.coarse.centroids),
                   np.asarray(index.quantizer.codebooks), ids, codes,
                   coarse_metric=index.config.coarse_metric)

    def search(self, q: np.ndarray, k: int, w: int
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Single query, the reference's algorithm step by step."""
        q = np.asarray(q, np.float32)
        # coarse_search: colwise dist over all centroids + sortperm
        # (/root/reference/src/coarsequantizers.jl:33-37)
        cd = _coarse_dists(self.centroids, q, self.coarse_metric)
        probes = np.argsort(cd)[:min(w, self.kc)]
        all_ids, all_d = [], []
        for c in probes:
            ids = self.cell_ids[c]
            if ids.size == 0:
                continue
            # m ADC lookup tables from the residual
            # (/root/reference/src/index.jl:232-236)
            r = (q - self.centroids[c]).reshape(self.m, self.dsub)
            tdiff = self.codebooks - r[:, None, :]          # (m, k, dsub)
            tables = np.einsum("mks,mks->mk", tdiff, tdiff)  # (m, k)
            # posting scan: d = coarse_dist + sum_i table_i[code_i]
            # (/root/reference/src/index.jl:241-246)
            codes = self.cell_codes[c].astype(np.int64)      # (sz, m)
            d = cd[c] + tables[np.arange(self.m)[None, :], codes].sum(1)
            all_ids.append(ids)
            all_d.append(d)
        if not all_ids:
            return np.empty(0, np.int64), np.empty(0, np.float32)
        ids = np.concatenate(all_ids)
        d = np.concatenate(all_d)
        kk = min(k, len(ids))
        part = np.argpartition(d, kk - 1)[:kk]
        order = part[np.argsort(d[part])]
        return ids[order], d[order]

    def search_batch(self, queries: np.ndarray, k: int, w: int):
        out_i, out_d = [], []
        for q in queries:
            i, d = self.search(q, k, w)
            out_i.append(i)
            out_d.append(d)
        return out_i, out_d
