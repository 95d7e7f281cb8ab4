"""Search typing + golden-cluster recall semantics
(reference test/search.jl:1-49)."""

import numpy as np
import pytest

from ivfadc_tpu import IVFADCIndex, knn_search
from tests.conftest import build_random_index

# The reference's hand-built 2x13 golden matrix (test/search.jl:27-28),
# transposed to (n, d) numpy convention. Three obvious clusters.
GOLDEN = np.array([
    [0, 0.1], [0, 0.11], [0, 0.12],
    [1, 8], [1, 10], [1, 15], [1, 14], [1, 16],
    [20, 5], [20, 5.1], [20, 5.2], [20, 5.4], [20, 5.5]], dtype=np.float64)


@pytest.mark.parametrize("coarse_quantizer", ["naive", "hnsw"])
def test_search_types(random_data, coarse_quantizer):
    # mirror of test/search.jl:1-23
    idx = build_random_index(random_data, coarse_quantizer=coarse_quantizer,
                             index_dtype="uint32")
    rng = np.random.RandomState(0)
    query = rng.rand(10)
    ids, dists = idx.search(query, 3, w=2)
    assert ids.dtype == np.uint32
    assert dists.dtype == query.dtype
    assert len(ids) == len(dists) <= 3
    with pytest.raises(AssertionError):
        idx.search(query, 0)
    with pytest.raises(AssertionError):
        idx.search(query, 1, w=0)
    # batch
    queries = rng.rand(10, 10)
    bids, bdists = idx.search(queries, 3, w=2)
    assert isinstance(bids, list) and len(bids) == 10
    assert all(b.dtype == np.uint32 for b in bids)
    assert all(d.dtype == queries.dtype for d in bdists)
    # free-function parity
    fids, _ = knn_search(idx, query, 3, w=2)
    assert np.array_equal(fids, ids)


def test_dense_large_k_exact():
    """k > 128 must not be truncated: the dense engine scores every posting
    of the probed cells (its window covers the largest cell), so it keeps
    the exact k-best for any k like the reference (src/index.jl:247-254),
    up to the decoded cache's int8 rounding."""
    rng = np.random.RandomState(3)
    # two tight clusters -> one probed cell holds ~1000 postings
    data = np.concatenate([
        rng.randn(1000, 16).astype(np.float32) * 0.05,
        rng.randn(1000, 16).astype(np.float32) * 0.05 + 50.0])
    dense = IVFADCIndex.build(data, kc=2, k=16, m=4, seed=0,
                              scan_mode="dense")
    lut = IVFADCIndex.build(data, kc=2, k=16, m=4, seed=0, scan_mode="lut")
    q = data[:4] + 0.01
    ids_d, dists_d = dense.search_padded(q, 200, w=1)
    ids_l, dists_l = lut.search_padded(q, 200, w=1)
    assert ids_d.shape == (4, 200)
    # all 200 slots fill (the probed cell holds 1000 postings) and ranks
    # beyond 128 are real neighbors, not padding
    assert (ids_d >= 0).all()
    assert (np.diff(dists_d, axis=1) >= -1e-6).all()
    overlap = np.mean([len(set(a) & set(b)) / 200
                       for a, b in zip(ids_d, ids_l)])
    assert overlap > 0.95, overlap
    # int8 cache: each coordinate off by <= scale/2 (~1e-3 here), so the
    # k-th distances differ by far less than the spread of the list
    np.testing.assert_allclose(dists_d[:, -1], dists_l[:, -1], atol=2e-3)


@pytest.mark.parametrize("coarse_quantizer", ["naive", "hnsw"])
def test_golden_cluster_recall(coarse_quantizer):
    # exact port of test/search.jl:26-49 (ids shifted to 0-based)
    idx = IVFADCIndex.build(GOLDEN, kc=3, k=8, m=2,
                            coarse_quantizer=coarse_quantizer, seed=0)
    points = [np.array([1.0, 10.0]), np.array([0.0, 0.0]),
              np.array([20.0, 5.0])]
    neighbors_w1 = [{4, 3, 6, 5, 7}, {0, 1, 2}, {8, 9, 10, 11, 12}]
    for point, expect in zip(points, neighbors_w1):
        ids, _ = idx.search(point, 5, w=1)
        assert set(ids.tolist()) - expect == set(), (point, ids, expect)
    neighbors_w2 = [{4, 3, 6, 5, 7}, {0, 1, 2, 3, 4}, {8, 9, 10, 11, 12}]
    for point, expect in zip(points, neighbors_w2):
        ids, _ = idx.search(point, 5, w=2)
        assert set(ids.tolist()) - expect == set(), (point, ids, expect)


def test_at_most_k_results():
    # "at most k" semantics (src/index.jl:200): probing one tiny cell
    idx = IVFADCIndex.build(GOLDEN, kc=3, k=8, m=2, seed=0)
    ids, dists = idx.search(np.array([0.0, 0.0]), 10, w=1)
    assert len(ids) < 10
    assert np.all(np.diff(dists) >= 0)       # sorted ascending


def test_distances_sorted_and_finite(random_data):
    idx = build_random_index(random_data)
    ids, dists = idx.search(random_data[17], 7, w=5)
    assert np.all(np.diff(dists) >= -1e-6)
    assert np.isfinite(dists).all()


def test_padded_batch_search(random_data):
    idx = build_random_index(random_data)
    q = random_data[:32]
    ids, dists = idx.search_padded(q, 5, w=4)
    assert ids.shape == (32, 5) and dists.shape == (32, 5)
    valid = ids >= 0
    assert valid.any(axis=1).all()
    assert np.isfinite(dists[valid]).all()


def test_self_query_returns_self(random_data):
    # querying with a database point must rank that point first at decent w
    idx = build_random_index(random_data, kc=10)
    hits = 0
    for i in [0, 50, 100, 200]:
        ids, _ = idx.search(random_data[i], 1, w=5)
        hits += int(ids[0] == i)
    assert hits >= 3   # PQ is lossy; allow one miss


def test_recall_vs_bruteforce():
    # what the reference never tests (SURVEY §4 "not tested"): recall@10
    # against exact ground truth on clustered synthetic data
    rng = np.random.RandomState(0)
    centers = rng.randn(32, 16).astype(np.float32) * 5
    base = np.concatenate(
        [c + rng.randn(128, 16).astype(np.float32) for c in centers])
    queries = base[rng.choice(len(base), 64, replace=False)] + \
        0.01 * rng.randn(64, 16).astype(np.float32)
    idx = IVFADCIndex.build(base, kc=32, k=64, m=4, seed=1)
    d2 = ((queries[:, None] - base[None]) ** 2).sum(-1)
    gt = np.argsort(d2, axis=1)[:, :10]
    ids, _ = idx.search_padded(queries, 10, w=8)
    recall = np.mean([len(set(ids[i]) & set(gt[i])) / 10
                      for i in range(len(queries))])
    assert recall > 0.6, recall


def test_metrics_inner_product_and_euclidean():
    rng = np.random.RandomState(5)
    base = rng.randn(500, 16).astype(np.float32)
    q = rng.randn(16).astype(np.float32)
    # euclidean: distances should be sqrt of sqeuclidean mode
    i1 = IVFADCIndex.build(base, kc=8, k=32, m=4, seed=2)
    i2 = IVFADCIndex.build(base, kc=8, k=32, m=4, seed=2,
                           coarse_metric="euclidean",
                           quantization_metric="euclidean")
    ids1, d1 = i1.search(q, 5, w=8)
    ids2, d2 = i2.search(q, 5, w=8)
    assert np.array_equal(ids1, ids2)
    assert np.allclose(d2, np.sqrt(d1), rtol=1e-4)
    # inner product: top hit should be the true max-dot point most of the time
    i3 = IVFADCIndex.build(base, kc=8, k=64, m=4, seed=2,
                           quantization_metric="inner_product")
    ids3, d3 = i3.search(q, 10, w=8)
    true_best = (base @ q).argmax()
    assert true_best in set(ids3.tolist())


def test_search_stream_matches_padded(random_data):
    """search_stream == per-batch search_padded stacked; SearchStats records."""
    from tests.conftest import build_random_index
    from ivfadc_tpu.utils.profiling import SearchStats
    idx = build_random_index(random_data)
    q = np.asarray(random_data[:40], np.float32)
    stats = SearchStats()
    ids_s, d_s = idx.search_stream(q, 5, w=6, batch=16, stats=stats)
    ids_p, d_p = idx.search_padded(q, 5, w=6)
    np.testing.assert_array_equal(ids_s, ids_p)
    np.testing.assert_allclose(d_s, d_p, rtol=1e-6)
    assert stats.queries == 40 and stats.qps > 0


def test_two_level_padded_probes_no_duplicates():
    """When w exceeds the two-level quantizer's candidate supply, the
    padded probes (cell 0, dist inf) must stay dead. In score modes whose
    per-probe base is recomputed (pure / inner_product) a finite base
    would re-scan cell 0 once per padded probe and duplicate its
    neighbors in the top-k."""
    from ivfadc_tpu import IVFADCIndex
    rng = np.random.RandomState(0)
    data = rng.rand(120, 16).astype(np.float32)
    for metric_kw in (dict(score_mode="pure"),
                      dict(quantization_metric="inner_product",
                           coarse_metric="sqeuclidean")):
        idx = IVFADCIndex.build(
            data, kc=6, m=4, k=16, coarse_quantizer="two_level",
            coarse_n_groups=3, coarse_probe_groups=1, **metric_kw)
        # candidate supply = gp * gmax = 1 * ceil(6/3)-ish < w=6
        ids, dists = idx.search_padded(data[:16], 10, w=6)
        for row in ids:
            live = row[row >= 0]
            assert len(live) == len(set(live.tolist())), row
