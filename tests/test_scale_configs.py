"""Functional coverage of the benchmark scale configs (shrunk to CPU size):
Deep1B-style huge-kc two-level coarse, GIST-style high dims, push_batch."""

import numpy as np
import pytest

from ivfadc_tpu import IVFADCIndex
from ivfadc_tpu.utils.datasets import synthetic_clustered
from ivfadc_tpu.utils.evaluation import brute_force_topk, recall_at_r


def test_two_level_coarse_large_kc():
    # Deep1B config uses kc=262144 with a sublinear coarse stage; functional
    # shrink: kc=512 over 4096 points — two_level must group/probe correctly
    base = synthetic_clustered(4096, 32, n_clusters=128, seed=0)
    idx = IVFADCIndex.build(base, kc=512, k=64, m=4, seed=0,
                            coarse_quantizer="two_level",
                            coarse_maxiter=8, quantization_maxiter=8)
    assert type(idx.coarse).__name__ == "TwoLevelCoarseQuantizer"
    assert idx.coarse.group_centers.shape[0] >= 22   # ~sqrt(512)
    q = base[:32]
    ids, dists = idx.search_padded(q, 10, w=16)
    # self-hit: each query is a database point
    hits = np.mean([i in set(row.tolist()) for i, row in zip(range(32), ids)])
    assert hits > 0.8, hits


def test_gist_shape_high_dim():
    # GIST1M is 960-dim with m=16/32; functional shrink n=2000
    base = synthetic_clustered(2000, 960, n_clusters=32, seed=1)
    idx = IVFADCIndex.build(base, kc=32, k=64, m=16, seed=0,
                            coarse_maxiter=6, quantization_maxiter=6)
    assert idx.quantizer.dsub == 60
    q = base[:8]
    ids, dists = idx.search_padded(q, 5, w=4)
    hits = np.mean([i in set(row.tolist()) for i, row in zip(range(8), ids)])
    assert hits > 0.7, hits
    # high-dim works through the dense scan too
    idx2 = IVFADCIndex.build(base, kc=32, k=64, m=16, seed=0,
                             coarse_maxiter=6, quantization_maxiter=6,
                             scan_mode="dense")
    ids2, _ = idx2.search_padded(q, 5, w=4)
    same = np.mean([len(set(a.tolist()) & set(b.tolist())) / 5
                    for a, b in zip(ids, ids2)])
    assert same > 0.9, (ids, ids2)
    # the other GIST code size, m=32 (dsub=30): finer codes must
    # not lose the self-neighbor and should beat/equal m=16 on recall
    idx32 = IVFADCIndex.build(base, kc=32, k=64, m=32, seed=0,
                              coarse_maxiter=6, quantization_maxiter=6)
    assert idx32.quantizer.dsub == 30
    ids32, _ = idx32.search_padded(q, 5, w=4)
    hits32 = np.mean([i in set(row.tolist())
                      for i, row in zip(range(8), ids32)])
    assert hits32 >= hits, (hits32, hits)


def test_push_batch():
    base = synthetic_clustered(1000, 16, seed=2)
    idx = IVFADCIndex.build(base, kc=16, k=32, m=4, seed=0,
                            coarse_maxiter=6, quantization_maxiter=6)
    extra = synthetic_clustered(64, 16, seed=3)
    idx.push_batch(extra)
    assert len(idx) == 1064
    live = np.sort(idx.store.ids[idx.store.ids >= 0])
    assert np.array_equal(live, np.arange(1064))
    # pushed points findable
    ids, _ = idx.search_padded(extra[:4], 3, w=16)
    found = np.mean([1000 + i in set(row.tolist())
                     for i, row in enumerate(ids)])
    assert found > 0.7, found
    # capacity law enforced batch-wise
    small = IVFADCIndex.build(base[:200], kc=4, k=16, m=4, seed=0,
                              index_dtype="uint8", coarse_maxiter=4,
                              quantization_maxiter=4)
    with pytest.raises(AssertionError):
        small.push_batch(synthetic_clustered(100, 16, seed=4))


def test_recall_improves_with_nprobe():
    base = synthetic_clustered(8192, 32, n_clusters=64, seed=5)
    idx = IVFADCIndex.build(base, kc=64, k=64, m=8, seed=0,
                            coarse_maxiter=8, quantization_maxiter=8)
    rng = np.random.RandomState(6)
    q = base[rng.choice(8192, 64)] + 0.01 * rng.randn(64, 32).astype(np.float32)
    _, gt = brute_force_topk(base, q, 10)
    recalls = []
    for w in (1, 4, 16):
        ids, _ = idx.search_padded(q, 10, w=w)
        recalls.append(recall_at_r(ids, gt, 10))
    assert recalls[0] <= recalls[1] <= recalls[2] + 1e-9
    assert recalls[2] > 0.5, recalls
