"""Dense scan (ops/gather_scan.py) vs the LUT reference path."""

import numpy as np
import pytest

from ivfadc_tpu import IVFADCIndex


def _build(n=2000, d=32, kc=16, m=4, seed=0, **kw):
    rng = np.random.RandomState(seed)
    centers = rng.randn(kc, d).astype(np.float32) * 4
    base = np.concatenate(
        [c + rng.randn(n // kc, d).astype(np.float32) for c in centers])
    idx = IVFADCIndex.build(base, kc=kc, k=32, m=m, seed=seed,
                            coarse_maxiter=10, quantization_maxiter=10, **kw)
    return base, idx


def _compare(idx_dense, idx_lut, queries, k, w):
    ids_d, dd = idx_dense.search_padded(queries, k, w=w)
    ids_l, dl = idx_lut.search_padded(queries, k, w=w)
    # same candidate sets (bf16 rounding can reorder near-ties)
    overlap = np.mean([
        len(set(a[a >= 0]) & set(b[b >= 0])) / max(len(set(b[b >= 0])), 1)
        for a, b in zip(ids_d, ids_l)])
    assert overlap > 0.95, overlap
    # distances agree to bf16 tolerance where ids agree
    agree = ids_d == ids_l
    np.testing.assert_allclose(dd[agree], dl[agree], rtol=2e-2, atol=1e-2)


def test_dense_scan_matches_lut_sqeuclidean():
    base, idx = _build(scan_mode="dense")
    _, idx_lut = _build(scan_mode="lut")
    q = base[np.random.RandomState(1).choice(len(base), 16, replace=False)]
    _compare(idx, idx_lut, q, k=10, w=4)


def test_dense_scan_empty_and_small_cells():
    # kc close to n -> many tiny/empty cells; kernel must mask correctly
    base, idx = _build(n=300, kc=64, m=4, scan_mode="dense")
    q = base[:8]
    ids, dists = idx.search_padded(q, 20, w=8)
    valid = ids >= 0
    assert valid.any(axis=1).all()
    assert np.isfinite(dists[valid]).all()
    assert (dists[~valid] == np.inf).all()
    # no duplicate ids within a query's results
    for row in ids:
        live = row[row >= 0]
        assert len(live) == len(set(live.tolist()))


def test_dense_scan_opq():
    base, idx = _build(scan_mode="dense", quantization_method="opq")
    _, idx_lut = _build(scan_mode="lut", quantization_method="opq")
    q = base[:8]
    _compare(idx, idx_lut, q, k=5, w=4)


def test_dense_scan_inner_product_matches_lut():
    # the dense kernel must reproduce the LUT path's -q.x_hat estimator
    # exactly (PQ quantization error itself is config-dependent and tested
    # at the estimator level in test_search.py)
    base, idx = _build(scan_mode="dense",
                       quantization_metric="inner_product")
    _, idx_lut = _build(scan_mode="lut",
                        quantization_metric="inner_product")
    q = np.random.RandomState(2).randn(4, 32).astype(np.float32)
    ids_d, dd = idx.search_padded(q, 10, w=16)
    ids_l, dl = idx_lut.search_padded(q, 10, w=16)
    same = np.mean([len(set(a.tolist()) & set(b.tolist())) / 10
                    for a, b in zip(ids_d, ids_l)])
    assert same > 0.9, (ids_d, ids_l)
    agree = ids_d == ids_l
    np.testing.assert_allclose(dd[agree], dl[agree], rtol=2e-2, atol=5e-2)


def test_dense_scan_after_dynamic_ops():
    base, idx = _build(scan_mode="dense")
    target = np.full(32, 0.321, np.float32)
    idx.push(target)          # invalidates the decoded cache
    new_id = len(idx) - 1
    ids, _ = idx.search_padded(target[None], 5, w=8)
    assert new_id in set(ids[0].tolist())
    idx.delete([0])
    ids, _ = idx.search_padded(target[None], 5, w=8)
    assert (new_id - 1) in set(ids[0].tolist())


def test_dense_rejects_cityblock():
    with pytest.raises(ValueError):
        _build(scan_mode="dense", quantization_metric="cityblock")


def test_dense_scan_int8_cache_matches_lut():
    base, idx = _build(scan_mode="dense", scan_cache="int8")
    _, idx_lut = _build(scan_mode="lut")
    q = base[np.random.RandomState(3).choice(len(base), 16, replace=False)]
    _compare(idx, idx_lut, q, k=10, w=4)


def test_dense_scan_int8_cache_opq():
    base, idx = _build(scan_mode="dense", scan_cache="int8",
                       quantization_method="opq")
    _, idx_lut = _build(scan_mode="lut", quantization_method="opq")
    q = base[:8]
    _compare(idx, idx_lut, q, k=5, w=4)


def test_dense_scan_int8_dynamic_patch_matches_rebuild():
    # incremental device-cache patches after push/delete must agree with a
    # from-scratch rebuild of the int8 cache (same quantized codebooks)
    base, idx = _build(scan_mode="dense", scan_cache="int8")
    rng = np.random.RandomState(4)
    _ = idx.search_padded(base[:4], 5, w=4)     # materialize device cache
    target = np.full(32, 0.321, np.float32)
    idx.push(target)
    idx.push_batch(rng.randn(10, 32).astype(np.float32))
    idx.delete(list(range(40, 60)))
    idx.pop_front()
    ids_a, d_a = idx.search_padded(target[None], 5, w=8)
    idx.store._invalidate()                     # force full cache rebuild
    ids_b, d_b = idx.search_padded(target[None], 5, w=8)
    np.testing.assert_array_equal(ids_a, ids_b)
    np.testing.assert_allclose(d_a, d_b, rtol=1e-5, atol=1e-5)


def test_gathered_engine_matches_lut():
    # tiny cells (kc close to n/5): the gathered engine must cover every
    # probed cell and match the exact LUT scan
    base, idx = _build(n=300, kc=64, m=4, scan_mode="dense")
    _, idx_lut = _build(n=300, kc=64, m=4, scan_mode="lut")
    _compare(idx, idx_lut, base[:8], k=10, w=8)


def test_gathered_hybrid_oversized_cells_match_lut():
    # one heavily-populated cell among tiny ones: the window covers the
    # largest cell, so probes of both kinds score every posting
    rng = np.random.RandomState(5)
    d, kc = 16, 32
    centers = rng.randn(kc, d).astype(np.float32) * 6
    small = np.concatenate(
        [c + 0.1 * rng.randn(6, d).astype(np.float32) for c in centers[1:]])
    big = centers[0] + 0.1 * rng.randn(400, d).astype(np.float32)
    base = np.concatenate([big, small])
    kw = dict(kc=kc, k=16, m=4, seed=0, coarse_maxiter=10,
              quantization_maxiter=10)
    idx = IVFADCIndex.build(base, scan_mode="dense", **kw)
    assert idx.store.window >= int(idx.store.sizes.max())
    idx_lut = IVFADCIndex.build(base, scan_mode="lut", **kw)
    q = np.concatenate([big[:4], small[:4]])  # probe both regimes
    _compare(idx, idx_lut, q, k=10, w=4)


def test_gathered_plan_survives_in_place_cell_growth():
    # _grow_cell mutates caps IN PLACE; the scan window must follow, or the
    # grown cell's postings past the old window silently vanish from search
    rng = np.random.RandomState(9)
    d, kc = 16, 32
    centers = rng.randn(kc, d).astype(np.float32) * 8
    base = np.concatenate(
        [c + 0.05 * rng.randn(8, d).astype(np.float32) for c in centers])
    idx = IVFADCIndex.build(base, kc=kc, k=16, m=4, seed=0,
                            coarse_maxiter=10, quantization_maxiter=10,
                            scan_mode="dense", index_dtype="uint32")
    win0 = idx.store.window
    idx.search_padded(base[:8], 5, w=2)          # materialize the cache
    # flood one cluster until its cell grows past the old window
    extra = centers[0] + 0.05 * rng.randn(2 * win0, d).astype(np.float32)
    idx.push_batch(extra)
    assert int(idx.store.caps.max()) > win0      # growth actually happened
    ids, _ = idx.search_padded(extra[-4:], 5, w=2)
    # the last pushed points sit past the old window in the grown cell
    expect = len(base) + 2 * win0 - 4 + np.arange(4)
    assert (np.asarray(ids)[:, 0] == expect).all(), (ids[:, 0], expect)


def test_gathered_engine_inner_product_matches_lut():
    # norm_coef=0 path of the gathered engine (score = v.x + base)
    base, idx = _build(n=300, kc=64, m=4, scan_mode="dense",
                       quantization_metric="inner_product")
    _, idx_lut = _build(n=300, kc=64, m=4, scan_mode="lut",
                        quantization_metric="inner_product")
    q = np.random.RandomState(2).randn(4, 32).astype(np.float32)
    ids_d, dd = idx.search_padded(q, 10, w=16)
    ids_l, dl = idx_lut.search_padded(q, 10, w=16)
    same = np.mean([len(set(a.tolist()) & set(b.tolist())) / 10
                    for a, b in zip(ids_d, ids_l)])
    assert same > 0.9, (ids_d, ids_l)
    agree = ids_d == ids_l
    np.testing.assert_allclose(dd[agree], dl[agree], rtol=2e-2, atol=5e-2)


def _scan_inputs(B=12, w=3, cap=200, d=8, seed=0):
    """Random gathered_scan inputs: B queries x w probes over a bf16 cache
    of `cap` rows, cells of 0..40 rows."""
    import jax.numpy as jnp
    rng = np.random.RandomState(seed)
    starts = rng.randint(0, cap - 40, (B, w)).astype(np.int32)
    sizes = rng.randint(0, 41, (B, w)).astype(np.int32)
    v = rng.randn(B, w, d).astype(np.float32)
    base = rng.rand(B, w).astype(np.float32)
    base[0, 0] = np.inf                      # a killed (padded) probe
    dec = jnp.asarray(rng.randn(cap, d), jnp.bfloat16)
    ids = np.arange(cap, dtype=np.int32) * 7
    return starts, sizes, v, base, dec, ids


def _numpy_scan(starts, sizes, v, base, dec, ids, k):
    """Float64 reference of gathered_scan over the same bf16 values."""
    dec = np.asarray(dec.astype(np.float32), np.float64)
    vb = np.asarray(v, np.float64)
    out_d, out_i = [], []
    for b in range(starts.shape[0]):
        cand = []
        for p in range(starts.shape[1]):
            for j in range(sizes[b, p]):
                r = dec[starts[b, p] + j]
                cand.append((r @ vb[b, p] + r @ r + base[b, p],
                             ids[starts[b, p] + j]))
        cand = sorted(c for c in cand if np.isfinite(c[0]))[:k]
        out_d.append([c[0] for c in cand] + [np.inf] * (k - len(cand)))
        out_i.append([c[1] for c in cand] + [-1] * (k - len(cand)))
    return np.asarray(out_i), np.asarray(out_d)


@pytest.mark.parametrize("chunk", [0, 1, 5, 12, 64])
def test_gathered_scan_query_chunking(chunk):
    """Query chunking (lax.map batch size, non-dividing sizes included)
    must not change results, and the results match a float64 reference
    up to the bf16 score-vector rounding."""
    import jax.numpy as jnp
    from ivfadc_tpu.ops.gather_scan import gathered_scan
    starts, sizes, v, base, dec, ids = _scan_inputs()
    args = (jnp.asarray(starts), jnp.asarray(sizes), jnp.asarray(v),
            jnp.asarray(base), dec, None, jnp.asarray(ids))
    got_i, got_d = gathered_scan(*args, k=10, win=40, chunk=chunk)
    ref_i, ref_d = gathered_scan(*args, k=10, win=40, chunk=12)
    np.testing.assert_array_equal(np.asarray(got_i), np.asarray(ref_i))
    np.testing.assert_array_equal(np.asarray(got_d), np.asarray(ref_d))
    np_i, np_d = _numpy_scan(starts, sizes, v, base, dec, ids, 10)
    got_d = np.asarray(got_d)
    fin = np.isfinite(np_d)
    np.testing.assert_array_equal(np.isfinite(got_d), fin)
    # bf16 score vectors: |v| ~ 3, |rows| ~ 3, 2^-8 relative rounding
    np.testing.assert_allclose(got_d[fin], np_d[fin], rtol=0, atol=0.15)
    np.testing.assert_array_equal(np.asarray(got_i)[~fin], -1)


@pytest.mark.parametrize("w,win,d,budget,expect", [
    (8, 4096, 128, 1 << 28, 32), (8, 128, 128, 1 << 28, 1024),
    (1, 8, 8, 1, 1), (4, 1000, 96, 1 << 20, 1)])
def test_query_chunk_budget(w, win, d, budget, expect):
    """The per-chunk gathered block (chunk, w, win, d) bf16 stays within
    the byte budget, as a power of two, and never drops below one query."""
    from ivfadc_tpu.ops.gather_scan import query_chunk
    c = query_chunk(w, win, d, budget)
    assert c == expect
    assert c == 1 or c * w * win * d * 2 <= budget


def test_gathered_scan_pads_past_candidate_supply():
    """k larger than w * win: outputs are padded with -1 / +inf."""
    import jax.numpy as jnp
    from ivfadc_tpu.ops.gather_scan import gathered_scan
    starts, sizes, v, base, dec, ids = _scan_inputs(B=4, w=2)
    got_i, got_d = gathered_scan(
        jnp.asarray(starts[:, :2]), jnp.asarray(np.minimum(sizes, 3)),
        jnp.asarray(v), jnp.asarray(base), dec, None, jnp.asarray(ids),
        k=10, win=3)
    got_i, got_d = np.asarray(got_i), np.asarray(got_d)
    assert got_i.shape == (4, 10)
    assert (got_i[:, 6:] == -1).all() and np.isinf(got_d[:, 6:]).all()
