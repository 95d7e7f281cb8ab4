"""TEXMEX reader hardening.

The readers in ivfadc_tpu/utils/datasets.py parse the fvecs/bvecs/ivecs
byte layouts SIFT1M/GIST1M ship in (per-row [int32 d][d x elem]). No real
dataset exists in this environment, so these tests generate format-exact
files and assert byte-level round-trips — a layout bug would otherwise
surface only when real data first appears (the headline metric
names SIFT1M).
"""

import os

import numpy as np
import pytest

from ivfadc_tpu.utils.datasets import (load_or_synthesize, read_bvecs,
                                       read_fvecs, read_ivecs)


def write_fvecs(path, arr):
    """Emit the TEXMEX .fvecs layout: per row [int32 d][d x float32]."""
    arr = np.asarray(arr, np.float32)
    n, d = arr.shape
    out = np.empty((n, d + 1), np.float32)
    out[:, 0] = np.frombuffer(np.full(n, d, np.int32).tobytes(),
                              np.float32)
    out[:, 1:] = arr
    out.tofile(path)


def write_bvecs(path, arr):
    """Emit the TEXMEX .bvecs layout: per row [int32 d][d x uint8]."""
    arr = np.asarray(arr, np.uint8)
    n, d = arr.shape
    rows = np.empty((n, 4 + d), np.uint8)
    rows[:, :4] = np.frombuffer(np.full(n, d, np.int32).tobytes(),
                                np.uint8).reshape(n, 4)
    rows[:, 4:] = arr
    rows.tofile(path)


def write_ivecs(path, arr):
    """Emit the TEXMEX .ivecs layout: per row [int32 d][d x int32]."""
    arr = np.asarray(arr, np.int32)
    n, d = arr.shape
    out = np.empty((n, d + 1), np.int32)
    out[:, 0] = d
    out[:, 1:] = arr
    out.tofile(path)


def test_fvecs_roundtrip(tmp_path):
    rng = np.random.RandomState(0)
    a = rng.randn(57, 13).astype(np.float32)
    p = str(tmp_path / "x.fvecs")
    write_fvecs(p, a)
    # file size must match the spec exactly: n * 4 * (d + 1)
    assert os.path.getsize(p) == 57 * 4 * (13 + 1)
    b = read_fvecs(p)
    assert b.dtype == np.float32 and b.shape == (57, 13)
    np.testing.assert_array_equal(a, b)


def test_fvecs_max_rows(tmp_path):
    a = np.arange(40, dtype=np.float32).reshape(10, 4)
    p = str(tmp_path / "x.fvecs")
    write_fvecs(p, a)
    b = read_fvecs(p, max_rows=3)
    np.testing.assert_array_equal(a[:3], b)
    # max_rows beyond the file returns everything, not garbage
    c = read_fvecs(p, max_rows=99)
    np.testing.assert_array_equal(a, c)


def test_fvecs_empty_file(tmp_path):
    p = str(tmp_path / "empty.fvecs")
    open(p, "wb").close()
    b = read_fvecs(p)
    assert b.size == 0


def test_bvecs_roundtrip(tmp_path):
    rng = np.random.RandomState(1)
    a = rng.randint(0, 256, (31, 128)).astype(np.uint8)
    p = str(tmp_path / "x.bvecs")
    write_bvecs(p, a)
    assert os.path.getsize(p) == 31 * (4 + 128)
    b = read_bvecs(p)
    # reader promotes to float32 (index input dtype)
    assert b.dtype == np.float32 and b.shape == (31, 128)
    np.testing.assert_array_equal(a.astype(np.float32), b)
    np.testing.assert_array_equal(a[:5].astype(np.float32),
                                  read_bvecs(p, max_rows=5))


def test_ivecs_roundtrip(tmp_path):
    rng = np.random.RandomState(2)
    a = rng.randint(0, 1_000_000, (17, 100)).astype(np.int32)
    p = str(tmp_path / "gt.ivecs")
    write_ivecs(p, a)
    b = read_ivecs(p)
    assert b.dtype == np.int32 and b.shape == (17, 100)
    np.testing.assert_array_equal(a, b)


def test_load_or_synthesize_prefers_real_file(tmp_path):
    rng = np.random.RandomState(3)
    a = rng.randn(20, 8).astype(np.float32)
    write_fvecs(str(tmp_path / "sift_base.fvecs"), a)
    got = load_or_synthesize("sift_base", 12, 8, data_dir=str(tmp_path))
    np.testing.assert_array_equal(a[:12], got)
    # absent file -> synthetic of the requested shape
    syn = load_or_synthesize("gist_base", 12, 8, data_dir=str(tmp_path))
    assert syn.shape == (12, 8) and syn.dtype == np.float32


def test_readers_feed_index_end_to_end(tmp_path):
    """Format file -> reader -> build -> search -> recall vs the ivecs GT,
    i.e. the exact path bench.py takes when IVFADC_DATA_DIR is set."""
    from ivfadc_tpu import IVFADCIndex
    from ivfadc_tpu.utils.evaluation import recall_at_r

    rng = np.random.RandomState(4)
    centers = rng.randn(8, 16).astype(np.float32)
    base = (centers[rng.randint(0, 8, 400)]
            + 0.05 * rng.randn(400, 16)).astype(np.float32)
    queries = base[:10] + 0.01 * rng.randn(10, 16).astype(np.float32)
    d2 = ((queries[:, None, :] - base[None]) ** 2).sum(-1)
    gt = np.argsort(d2, axis=1)[:, :5].astype(np.int32)

    write_fvecs(str(tmp_path / "b.fvecs"), base)
    write_fvecs(str(tmp_path / "q.fvecs"), queries)
    write_ivecs(str(tmp_path / "gt.ivecs"), gt)

    base_r = read_fvecs(str(tmp_path / "b.fvecs"))
    q_r = read_fvecs(str(tmp_path / "q.fvecs"))
    gt_r = read_ivecs(str(tmp_path / "gt.ivecs"))
    idx = IVFADCIndex.build(base_r, kc=8, m=4, k=32, seed=0)
    # PQ reorders near-ties among same-cluster members, so assert the 5 GT
    # neighbors all land in the top-20 (a byte-layout bug would give ~0)
    # and the near-duplicate query's self-hit is rank 0.
    ids, _ = idx.search_padded(q_r, 20, w=8)
    ids = np.asarray(ids)
    np.testing.assert_array_equal(ids[:, 0], np.arange(10))
    in_top20 = np.mean([
        len(set(f.tolist()) & set(g.tolist())) / 5
        for f, g in zip(ids, gt_r)])
    assert in_top20 > 0.9, in_top20
    assert recall_at_r(ids, gt_r, 5) > 0.4  # sanity floor on strict recall


def test_sample_indices_distinct_sorted():
    """sample_indices: `size` distinct sorted draws in [0, n), across the
    rejection-sampling path (size << n), the permutation fallback
    (size > n/2), and the size >= n identity."""
    from ivfadc_tpu.utils.datasets import sample_indices
    for n, size in ((100_000, 512), (100, 70), (50, 50), (50, 80)):
        out = sample_indices(seed=3, n=n, size=size)
        assert out.size == min(size, n)
        assert np.unique(out).size == out.size          # distinct
        assert (np.sort(out) == out).all()              # sorted
        assert out.min() >= 0 and out.max() < n
    # deterministic under the same seed
    a = sample_indices(7, 10_000, 128)
    b = sample_indices(7, 10_000, 128)
    np.testing.assert_array_equal(a, b)
