"""Search-semantics parity with the reference algorithm.

benchmarks/oracle.py reimplements the reference's exact knn_search
(/root/reference/src/index.jl:204-258) in NumPy. Running it against the SAME
trained index state isolates search semantics: the JAX path must return the
same neighbors (and the same "coarse_dist + sum(table)" scores) up to f32
rounding and tie order.
"""

import sys
import os

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmarks.oracle import ReferenceOracle
from ivfadc_tpu import IVFADCIndex


@pytest.mark.parametrize("scan_mode,scan_cache,rt",
                         [("lut", "bf16", 2e-3),
                          ("dense", "bf16", 2e-3),
                          # int8 decoded cache adds <=scale/2 per-dim
                          # quantization noise on top of bf16 rounding
                          ("dense", "int8", 2e-2)])
def test_search_matches_reference_oracle(scan_mode, scan_cache, rt):
    rng = np.random.RandomState(0)
    centers = rng.randn(32, 16).astype(np.float32) * 3
    data = np.concatenate(
        [c + rng.randn(40, 16).astype(np.float32) for c in centers])
    idx = IVFADCIndex.build(data, kc=32, k=16, m=4, seed=0,
                            coarse_maxiter=8, quantization_maxiter=8,
                            scan_mode=scan_mode, scan_cache=scan_cache)
    oracle = ReferenceOracle.from_index(idx)
    queries = data[rng.choice(len(data), 24)] + \
        0.05 * rng.randn(24, 16).astype(np.float32)
    for w in (1, 4, 8):
        ours_i, ours_d = idx.search(queries, 10, w=w)
        for q, oi, od in zip(queries, ours_i, ours_d):
            ri, rd = oracle.search(q, 10, w)
            # ids must agree except for rounding ties at the k-th boundary:
            # every neighbor either appears in the oracle's set or scores
            # within tolerance of the oracle's k-th distance
            kth = rd[-1]
            tol = rt * max(1.0, abs(float(kth)))
            for cand, cd in zip(oi.tolist(), od.tolist()):
                assert cand in set(ri.tolist()) or abs(cd - kth) <= tol, \
                    (w, cand, cd, kth)
            np.testing.assert_allclose(np.sort(od), np.sort(rd),
                                       rtol=rt, atol=rt)


def test_reconstruct_matches_oracle_decode():
    """pop() reconstruction = centroid + decoded residual, identical to
    doing it by hand from the stored arrays."""
    rng = np.random.RandomState(1)
    data = rng.rand(200, 12).astype(np.float32)
    idx = IVFADCIndex.build(data, kc=10, k=8, m=3, seed=2,
                            coarse_maxiter=6, quantization_maxiter=6)
    ext = 137
    cell, slot = idx.store.find(ext)
    codes = idx.store.codes[slot]
    cb = np.asarray(idx.quantizer.codebooks)          # (m, k, dsub)
    manual = np.concatenate([cb[j, codes[j]] for j in range(cb.shape[0])])
    recon = idx.reconstruct(ext)
    centroid = np.asarray(idx.coarse.centroids[cell])
    np.testing.assert_allclose(recon, centroid + manual[:12], rtol=1e-5)


def test_cosine_coarse_metric_matches_oracle():
    """coarse_metric="cosine" end-to-end: the coarse k-means trains under
    cosine (Clustering.jl accepts any coarse_distance,
    /root/reference/src/index.jl:129-134), probes rank by cosine, and the
    reference score composes cosine coarse distance + sqeuclidean residual
    tables. Parity against the oracle running the same composition."""
    rng = np.random.RandomState(11)
    dirs = rng.randn(8, 12)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    data = np.concatenate([
        (dvec[None, :] + 0.08 * rng.randn(50, 12))
        * rng.uniform(0.5, 5.0, (50, 1))
        for dvec in dirs]).astype(np.float32)
    idx = IVFADCIndex.build(data, kc=8, k=16, m=3, seed=3,
                            coarse_metric="cosine",
                            coarse_maxiter=10, quantization_maxiter=8)
    assert idx.config.coarse_metric == "cosine"
    oracle = ReferenceOracle.from_index(idx)
    assert oracle.coarse_metric == "cosine"
    queries = data[rng.choice(len(data), 16)] + \
        0.02 * rng.randn(16, 12).astype(np.float32)
    for w in (1, 3):
        ours_i, ours_d = idx.search(queries, 8, w=w)
        for q, oi, od in zip(queries, ours_i, ours_d):
            ri, rd = oracle.search(q, 8, w)
            kth = rd[-1]
            tol = 2e-2 * max(1.0, abs(float(kth)))
            for cand, cd in zip(oi.tolist(), od.tolist()):
                assert cand in set(ri.tolist()) or abs(cd - kth) <= tol, \
                    (w, cand, cd, kth)
            np.testing.assert_allclose(np.sort(od), np.sort(rd),
                                       rtol=2e-2, atol=2e-2)


def test_inner_product_coarse_metric_builds_and_searches():
    """coarse_metric="inner_product" builds (trainable now) and search
    returns valid ids; parity vs the oracle under the same composition."""
    rng = np.random.RandomState(12)
    data = (rng.rand(200, 10) + 0.1).astype(np.float32)
    idx = IVFADCIndex.build(data, kc=6, k=16, m=2, seed=4,
                            coarse_metric="inner_product",
                            coarse_maxiter=8, quantization_maxiter=8)
    oracle = ReferenceOracle.from_index(idx)
    queries = data[:8]
    ours_i, ours_d = idx.search(queries, 5, w=2)
    for q, oi, od in zip(queries, ours_i, ours_d):
        ri, rd = oracle.search(q, 5, 2)
        kth = rd[-1]
        tol = 2e-2 * max(1.0, abs(float(kth)))
        for cand, cd in zip(oi.tolist(), od.tolist()):
            assert cand in set(ri.tolist()) or abs(cd - kth) <= tol
