"""Multi-device tests on the 8-device virtual CPU mesh (SURVEY §4: distributed
logic testable without a pod)."""

import jax
import numpy as np
import pytest

from ivfadc_tpu import IVFADCIndex
from ivfadc_tpu.parallel.mesh import make_mesh, SHARD_AXIS, DATA_AXIS
from ivfadc_tpu.parallel.sharded import ShardedIVFADCIndex, partition_store
from ivfadc_tpu.parallel.distributed import (distributed_kmeans, train_step)


@pytest.fixture(scope="module")
def base_index():
    rng = np.random.RandomState(0)
    centers = rng.randn(16, 16).astype(np.float32) * 5
    base = np.concatenate(
        [c + rng.randn(64, 16).astype(np.float32) for c in centers])
    idx = IVFADCIndex.build(base, kc=16, k=32, m=4, seed=0)
    return base, idx


def test_partition_store_covers_everything(base_index):
    _, idx = base_index
    parts = partition_store(idx.store, 4)
    # every live id appears exactly once across shards
    ids = parts["ids"][parts["ids"] >= 0]
    assert sorted(ids.tolist()) == list(range(len(idx)))
    # cell c lives on shard c % 4
    for c in range(idx.config.kc):
        for s in range(4):
            expected = idx.store.sizes[c] if s == c % 4 else 0
            assert parts["sizes"][s, c] == expected


@pytest.mark.parametrize("n_shards,n_data", [(8, 1), (4, 2), (2, 4)])
def test_sharded_search_matches_single_chip(base_index, n_shards, n_data):
    base, idx = base_index
    mesh = make_mesh(n_shards=n_shards, n_data=n_data)
    sidx = ShardedIVFADCIndex(idx, mesh)
    q = base[np.random.RandomState(1).choice(len(base), 24, replace=False)]
    ids_s, d_s = sidx.search_padded(q, 10, w=4)
    ids_1, d_1 = idx.search_padded(q, 10, w=4)
    # exact same neighbor sets and distances (merge is exact); order can
    # differ only between equal distances
    np.testing.assert_allclose(np.sort(d_s, 1), np.sort(d_1, 1), rtol=1e-5)
    same = [set(a[a >= 0]) == set(b[b >= 0]) for a, b in zip(ids_s, ids_1)]
    assert np.mean(same) == 1.0


def test_sharded_search_two_level_coarse(base_index):
    base, _ = base_index
    idx = IVFADCIndex.build(base, kc=16, k=32, m=4, seed=0,
                            coarse_quantizer="hnsw")
    mesh = make_mesh(n_shards=8)
    sidx = ShardedIVFADCIndex(idx, mesh)
    q = base[:8]
    ids_s, _ = sidx.search_padded(q, 5, w=4)
    ids_1, _ = idx.search_padded(q, 5, w=4)
    same = [set(a[a >= 0]) == set(b[b >= 0]) for a, b in zip(ids_s, ids_1)]
    assert np.mean(same) == 1.0


def test_distributed_kmeans_matches_quality():
    rng = np.random.RandomState(2)
    true = rng.randn(8, 12).astype(np.float32) * 10
    x = np.concatenate([c + 0.1 * rng.randn(100, 12).astype(np.float32)
                        for c in true])
    mesh = make_mesh(n_shards=1, n_data=8)
    centers, assign = distributed_kmeans(
        jax.random.PRNGKey(0), x, 8, mesh, maxiter=10)
    centers = np.asarray(centers)
    d = ((centers[:, None] - true[None]) ** 2).sum(-1)
    assert (d.min(1) < 1.0).all()
    assert np.asarray(assign).shape == (800,)


def test_distributed_train_step_runs_and_is_exact():
    rng = np.random.RandomState(3)
    x = rng.randn(256, 8).astype(np.float32)
    mesh = make_mesh(n_shards=2, n_data=4)
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    centers = jax.device_put(x[:4].copy(), NamedSharding(mesh, P()))
    codebooks = jax.device_put(
        rng.randn(2, 8, 4).astype(np.float32), NamedSharding(mesh, P()))
    xd = jax.device_put(x, NamedSharding(mesh, P(DATA_AXIS)))
    mask = jax.device_put(np.ones(256, np.float32),
                          NamedSharding(mesh, P(DATA_AXIS)))
    new_centers, assign, codes = train_step(
        centers, codebooks, xd, mask, mesh=mesh,
        metric=__import__("ivfadc_tpu.ops.metrics", fromlist=["SQEUCLIDEAN"]).SQEUCLIDEAN,
        m=2)
    # oracle check: one Lloyd step in numpy
    d = ((x[:, None] - np.asarray(x[:4])[None]) ** 2).sum(-1)
    a = d.argmin(1)
    np.testing.assert_array_equal(np.asarray(assign), a)
    for j in range(4):
        if (a == j).any():
            np.testing.assert_allclose(np.asarray(new_centers)[j],
                                       x[a == j].mean(0), rtol=1e-4)
    assert np.asarray(codes).shape == (256, 2)


def test_sharded_dense_scan_matches_single_chip(base_index):
    # the dense gathered engine inside shard_map, at two batch sizes
    base, _ = base_index
    idx = IVFADCIndex.build(base, kc=16, k=32, m=4, seed=0,
                            scan_mode="dense")
    mesh = make_mesh(n_shards=4, n_data=2)
    sidx = ShardedIVFADCIndex(idx, mesh)
    assert sidx.scan_mode == "dense"
    q = base[:16]
    ids_s, d_s = sidx.search_padded(q, 10, w=4)
    ids_1, d_1 = idx.search_padded(q, 10, w=4)
    same = [set(a[a >= 0]) == set(b[b >= 0]) for a, b in zip(ids_s, ids_1)]
    assert np.mean(same) == 1.0
    np.testing.assert_allclose(np.sort(d_s, 1), np.sort(d_1, 1),
                               rtol=2e-2, atol=1e-2)
    q2 = base[:64]
    ids_s2, d_s2 = sidx.search_padded(q2, 10, w=8)
    ids_12, d_12 = idx.search_padded(q2, 10, w=8)
    same2 = [set(a[a >= 0]) == set(b[b >= 0])
             for a, b in zip(ids_s2, ids_12)]
    assert np.mean(same2) == 1.0
    np.testing.assert_allclose(np.sort(d_s2, 1), np.sort(d_12, 1),
                               rtol=2e-2, atol=1e-2)


def test_partition_store_owner_only_capacity(base_index):
    """Non-owner shards carry ZERO capacity for foreign cells: ownership is
    fixed round-robin, so the >= align floor on S-1 copies of every cell
    would be permanently dead rows (scaling with S in codes/ids and the
    decoded scan cache)."""
    from ivfadc_tpu.parallel.sharded import partition_store
    base, idx = base_index
    S = 4
    parts = partition_store(idx.store, S)
    caps = np.asarray(parts["caps"])
    kc = caps.shape[1]
    cells = np.arange(kc)
    owners = cells % S
    for s in range(S):
        foreign = caps[s, owners != s]
        assert (foreign == 0).all(), foreign.max()
        assert (caps[s, owners == s] > 0).all()
    # total capacity is within ~1 aligned block per owned cell of the data
    assert caps.sum() <= idx.store.total_cap + kc * parts["align"]


def test_sharded_gathered_engine_matches_single_chip(base_index):
    # small batch (4 queries per data replica) with the bf16 cache: the
    # per-shard gathered engine (ops/gather_scan.py) must stay exact vs
    # the single-card path
    base, _ = base_index
    idx = IVFADCIndex.build(base, kc=16, k=32, m=4, seed=0,
                            scan_mode="dense", scan_cache="bf16")
    mesh = make_mesh(n_shards=4, n_data=2)
    sidx = ShardedIVFADCIndex(idx, mesh)
    assert sidx.scan_mode == "dense" and sidx.scale is None
    q = base[:8]
    ids_s, d_s = sidx.search_padded(q, 10, w=4)
    ids_1, d_1 = idx.search_padded(q, 10, w=4)
    same = [set(a[a >= 0]) == set(b[b >= 0]) for a, b in zip(ids_s, ids_1)]
    assert np.mean(same) == 1.0
    np.testing.assert_allclose(np.sort(d_s, 1), np.sort(d_1, 1),
                               rtol=2e-2, atol=1e-2)


def test_sharded_refresh_after_dynamic_ops(random_data):
    """ShardedIVFADCIndex.refresh() re-snapshots the base index after
    push/delete; results must equal the single-chip index afterwards."""
    from tests.conftest import build_random_index
    from ivfadc_tpu.parallel.mesh import make_mesh
    from ivfadc_tpu.parallel.sharded import ShardedIVFADCIndex
    rng = np.random.RandomState(5)
    idx = build_random_index(random_data)
    sidx = ShardedIVFADCIndex(idx, make_mesh(n_shards=4, n_data=2))
    q = np.asarray(random_data[:8], np.float32)
    idx.push_batch(rng.rand(12, 10).astype(np.float32))
    idx.delete([0, 3, 5])
    sidx.refresh()
    ids_s, _ = sidx.search_padded(q, 5, w=6)
    ids_1, _ = idx.search_padded(q, 5, w=6)
    for a, b in zip(ids_s, ids_1):
        assert set(a[a >= 0]) == set(b[b >= 0])


def test_sharded_refresh_is_incremental(random_data):
    """A small dynamic workload must take the incremental patch path (cost
    proportional to dirty slots) and produce shard arrays
    identical to a from-scratch re-partition of the same base index."""
    from tests.conftest import build_random_index
    from ivfadc_tpu.parallel.mesh import make_mesh
    from ivfadc_tpu.parallel.sharded import ShardedIVFADCIndex
    rng = np.random.RandomState(11)
    idx = build_random_index(random_data)
    mesh = make_mesh(n_shards=4, n_data=2)
    sidx = ShardedIVFADCIndex(idx, mesh)
    # one of each mutation family: append, front-shift, rank-delete, pop
    idx.push(rng.rand(10).astype(np.float32))
    idx.push_front(rng.rand(10).astype(np.float32))
    idx.delete([2, 40, 41])
    idx.pop()
    sidx.refresh()
    assert sidx._last_refresh == "incremental"
    fresh = ShardedIVFADCIndex(idx, mesh)
    q = np.asarray(random_data[:16], np.float32)
    ids_a, d_a = sidx.search_padded(q, 5, w=8)
    ids_b, d_b = fresh.search_padded(q, 5, w=8)
    np.testing.assert_array_equal(ids_a, ids_b)
    np.testing.assert_allclose(d_a, d_b, rtol=1e-6)
    # and the single-chip index agrees on neighbor sets
    ids_1, _ = idx.search_padded(q, 5, w=8)
    for a, b in zip(ids_a, ids_1):
        assert set(a[a >= 0]) == set(b[b >= 0])


def test_sharded_refresh_noop_and_repeat(random_data):
    """refresh() with no pending ops is a no-op; a second dynamic round
    patches on top of the first incremental refresh correctly."""
    from tests.conftest import build_random_index
    from ivfadc_tpu.parallel.mesh import make_mesh
    from ivfadc_tpu.parallel.sharded import ShardedIVFADCIndex
    rng = np.random.RandomState(12)
    idx = build_random_index(random_data)
    mesh = make_mesh(n_shards=4, n_data=2)
    sidx = ShardedIVFADCIndex(idx, mesh)
    sidx.refresh()
    assert sidx._last_refresh == "noop"
    for round_ in range(2):
        idx.push_batch(rng.rand(6, 10).astype(np.float32))
        idx.delete([int(len(idx) // 2)])
        sidx.refresh()
        assert sidx._last_refresh == "incremental"
    fresh = ShardedIVFADCIndex(idx, mesh)
    q = np.asarray(random_data[8:24], np.float32)
    ids_a, d_a = sidx.search_padded(q, 5, w=8)
    ids_b, d_b = fresh.search_padded(q, 5, w=8)
    np.testing.assert_array_equal(ids_a, ids_b)


def test_sharded_refresh_overflow_falls_back(random_data):
    """A bulk workload beyond the log limits falls back to a full
    re-partition and still serves correct results."""
    from tests.conftest import build_random_index
    from ivfadc_tpu.parallel.mesh import make_mesh
    from ivfadc_tpu.parallel.sharded import ShardedIVFADCIndex
    rng = np.random.RandomState(13)
    idx = build_random_index(random_data)
    sidx = ShardedIVFADCIndex(idx, make_mesh(n_shards=4, n_data=2))
    # touch far more cells than the kc//4 dirty-cell limit allows
    idx.push_batch(rng.rand(400, 10).astype(np.float32))
    sidx.refresh()
    assert sidx._last_refresh == "full"
    q = np.asarray(random_data[:8], np.float32)
    ids_s, _ = sidx.search_padded(q, 5, w=6)
    ids_1, _ = idx.search_padded(q, 5, w=6)
    for a, b in zip(ids_s, ids_1):
        assert set(a[a >= 0]) == set(b[b >= 0])


def test_sharded_overlapped_merge_matches_blocking(base_index):
    """The double-buffered merge (scan wave 1 while wave 0's all_gather is
    in flight) must agree with the blocking path. Splitting the batch
    changes float accumulation grouping, so distances may drift within
    cache-quantization noise — sorted distances match loosely and neighbor
    sets match up to near-tie swaps."""
    base, idx = base_index
    mesh = make_mesh(n_shards=4, n_data=2)
    sidx = ShardedIVFADCIndex(idx, mesh)
    q = base[np.random.RandomState(3).choice(len(base), 48, replace=False)]
    ids_b, d_b = sidx.search_padded(q, 10, w=4, overlap=False)
    ids_o, d_o = sidx.search_padded(q, 10, w=4, overlap=True)
    np.testing.assert_allclose(np.sort(d_b, 1), np.sort(d_o, 1),
                               rtol=1e-2, atol=1e-2)
    jac = np.mean([len(set(a[a >= 0]) & set(b[b >= 0])) / 10
                   for a, b in zip(ids_b, ids_o)])
    assert jac > 0.95, jac
    # search_stream (overlap on by default) agrees the same way, and its
    # wave splitting must reassemble rows in order
    ids_s, d_s = sidx.search_stream(q, 10, w=4, batch=16)
    np.testing.assert_allclose(np.sort(d_o[:16], 1), np.sort(d_s[:16], 1),
                               rtol=1e-2, atol=1e-2)
    assert ids_s.shape == (48, 10)
    # blocking default keeps exact single-chip parity
    ids_1, _ = idx.search_padded(q, 10, w=4)
    np.testing.assert_array_equal(ids_b, ids_1)


def test_refresh_push_then_delete_in_empty_cell(random_data):
    """Regression: a cell that was empty at partition time, gets a push, and
    is emptied again before refresh() produced zero-span patches for every
    dirty cell — the patch assembly must tolerate an all-zero-span log (and
    still apply the id-renumbering ops)."""
    from tests.conftest import build_random_index
    idx = build_random_index(random_data, kc=100)
    sidx = ShardedIVFADCIndex(idx, make_mesh(n_shards=4, n_data=2))
    p = np.asarray(random_data[7], np.float32)
    n0 = len(idx)
    idx.push(p)              # lands in some cell (possibly empty)
    idx.delete([n0])         # remove it again -> cell back to its old size
    sidx.refresh()
    assert sidx._last_refresh in ("incremental", "full")
    q = np.asarray(random_data[:8], np.float32)
    ids_s, _ = sidx.search_padded(q, 5, w=6)
    ids_1, _ = idx.search_padded(q, 5, w=6)
    for a, b in zip(ids_s, ids_1):
        assert set(a[a >= 0]) == set(b[b >= 0])


def test_two_views_refresh_independently(random_data):
    """Regression: two sharded views over one base index each hold their own
    mutation log — creating or refreshing one must not starve the other."""
    from tests.conftest import build_random_index
    rng = np.random.RandomState(23)
    idx = build_random_index(random_data)
    v1 = ShardedIVFADCIndex(idx, make_mesh(n_shards=4, n_data=2))
    idx.push_batch(rng.rand(6, 10).astype(np.float32))
    # second view created AFTER the push: must not wipe v1's pending log
    v2 = ShardedIVFADCIndex(idx, make_mesh(n_shards=2, n_data=4))
    idx.delete([1, 4])
    v1.refresh()
    v2.refresh()
    q = np.asarray(random_data[:8], np.float32)
    ids_1, _ = idx.search_padded(q, 5, w=6)
    for v in (v1, v2):
        ids_s, _ = v.search_padded(q, 5, w=6)
        for a, b in zip(ids_s, ids_1):
            assert set(a[a >= 0]) == set(b[b >= 0])


def test_mutation_log_stops_accumulating_after_overflow():
    """Regression: past its bounds the log collapses to a bare overflow flag
    instead of growing without bound."""
    from ivfadc_tpu.models.inverted import MutationLog
    log = MutationLog(kc=8)
    for i in range(5000):
        log.log_op(("shift", i, 1))
    assert log.overflow and len(log.ops) == 0 and len(log.cells) == 0
    out = log.drain()
    assert out["overflow"] and not out["ops"]
    assert not log.overflow      # drained log starts clean


def test_sharded_dense_k_gt_128_reroutes_to_lut(random_data):
    """Regression: k>128 on a dense-mode sharded view must not raise — the
    resident PQ codes let it take the exact LUT scan, matching the base
    index's own k>128 reroute."""
    from tests.conftest import build_random_index
    idx = build_random_index(random_data)
    sidx = ShardedIVFADCIndex(idx, make_mesh(n_shards=4, n_data=2))
    q = np.asarray(random_data[:4], np.float32)
    ids_s, d_s = sidx.search_padded(q, 200, w=100)
    ids_1, d_1 = idx.search_padded(q, 200, w=100)
    for a, b in zip(ids_s, ids_1):
        assert set(a[a >= 0]) == set(b[b >= 0])


def test_dispatch_accepts_device_queries(base_index):
    """Device-resident queries stay on device (no host round-trip) and give
    the same results as host input."""
    import jax.numpy as jnp
    base, idx = base_index
    mesh = make_mesh(n_shards=4, n_data=2)
    sidx = ShardedIVFADCIndex(idx, mesh)
    q = base[:16]
    ids_h, d_h = sidx.search_padded(q, 10, w=4)
    ids_d, d_d = sidx.search_padded(jnp.asarray(q), 10, w=4)
    np.testing.assert_array_equal(ids_h, ids_d)
    np.testing.assert_allclose(d_h, d_d, rtol=1e-6)


def test_sharded_refresh_fuzz(random_data):
    """Randomized dynamic workload against the sharded view: after every
    refresh(), sharded search must agree with the single-chip index AND
    with a from-scratch re-partition of the same base — whichever refresh
    path (incremental or full) each round happened to take."""
    from tests.conftest import build_random_index
    rng = np.random.RandomState(77)
    idx = build_random_index(random_data)
    mesh = make_mesh(n_shards=4, n_data=2)
    sidx = ShardedIVFADCIndex(idx, mesh)
    q = np.asarray(random_data[:8], np.float32)
    paths = set()
    for round_ in range(6):
        for _ in range(rng.randint(1, 4)):
            op = rng.randint(0, 4)
            if op == 0:
                idx.push_batch(rng.rand(rng.randint(1, 9), 10)
                               .astype(np.float32))
            elif op == 1 and len(idx) > 8:
                live = len(idx)
                dels = sorted(set(rng.randint(0, live, 3).tolist()))
                idx.delete(dels)
            elif op == 2:
                idx.push_front(rng.rand(10).astype(np.float32))
            elif op == 3 and len(idx) > 8:
                idx.pop() if rng.rand() < 0.5 else idx.pop_front()
        sidx.refresh()
        paths.add(sidx._last_refresh)
        ids_s, d_s = sidx.search_padded(q, 5, w=6)
        fresh = ShardedIVFADCIndex(idx, mesh)
        ids_f, d_f = fresh.search_padded(q, 5, w=6)
        np.testing.assert_array_equal(ids_s, ids_f, err_msg=f"round {round_}")
        np.testing.assert_allclose(d_s, d_f, rtol=1e-6)
        ids_1, _ = idx.search_padded(q, 5, w=6)
        for a, b in zip(ids_s, ids_1):
            assert set(a[a >= 0]) == set(b[b >= 0]), round_
    assert "incremental" in paths, paths   # the cheap path actually ran


def test_sharded_search_free_function_and_trimmed(base_index):
    """knn_search() parity over the sharded view: single point -> trimmed
    (ids, dists) matching the single-chip search; batch -> per-query lists."""
    import ivfadc_tpu as pkg
    base, idx = base_index
    sidx = ShardedIVFADCIndex(idx, make_mesh(n_shards=4, n_data=2))
    ids_s, d_s = pkg.knn_search(sidx, base[17], 5, w=4)
    ids_1, d_1 = pkg.knn_search(idx, base[17], 5, w=4)
    assert set(ids_s.tolist()) == set(ids_1.tolist())
    np.testing.assert_allclose(np.sort(d_s), np.sort(d_1), rtol=1e-5)
    assert ids_s.dtype == np.dtype(idx.config.index_dtype)
    bi, bd = pkg.knn_search(sidx, base[:3], 4, w=2)
    assert len(bi) == 3 and all(len(r) <= 4 for r in bi)
    with pytest.raises(AssertionError, match="dimension"):
        sidx.search(base[0][:5], 3)


@pytest.mark.parametrize("scan_cache", ["int8", "bf16"])
def test_sharded_dense_push_matches_rebuild(scan_cache):
    """Native push_batch on a distributed-built dense view patches the
    decoded cache and the per-shard sizes in one donated program; the
    result must equal a fresh view of the same rows. (The int8 path once
    read a scale slice in place of the sorted cells for the size update:
    with m * dsub equal to the 16-row push bucket the shapes agree, and
    the 3 padding rows of a 13-row push were counted into cell 0.)"""
    rng = np.random.RandomState(4)
    centers = rng.randn(8, 16).astype(np.float32) * 4
    data = np.concatenate(
        [c + rng.randn(150, 16).astype(np.float32) for c in centers])
    mesh = make_mesh(n_shards=4, n_data=2)
    kw = dict(kc=16, k=16, m=4, seed=0, scan_mode="dense",
              scan_cache=scan_cache)
    sidx = ShardedIVFADCIndex.build(data, mesh, **kw)
    extra = centers[:2].repeat(8, axis=0)[:13] + 0.1 * rng.randn(
        13, 16).astype(np.float32)
    sidx.push_batch(extra)
    assert int(np.asarray(sidx.arrays["sizes"]).sum()) == len(data) + 13
    np.testing.assert_array_equal(
        np.asarray(sidx.arrays["sizes"]).sum(axis=0),
        sidx.index.store.sizes)
    # rebuild the serving view from the pushed state: a save/load round
    # trip re-derives every array (decoded cache included) from the codes
    import tempfile
    from ivfadc_tpu.parallel.persistence import (load_sharded_index,
                                                 save_sharded_index)
    with tempfile.TemporaryDirectory() as tmp:
        save_sharded_index(tmp, sidx)
        fresh = load_sharded_index(tmp, mesh)
    q = np.concatenate([extra[:8], data[:8]])
    ids_a, d_a = sidx.search_padded(q, 10, w=4)
    ids_b, d_b = fresh.search_padded(q, 10, w=4)
    np.testing.assert_array_equal(ids_a, ids_b)
    np.testing.assert_allclose(d_a, d_b, rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(sidx.arrays["codes"]),
                                  np.asarray(fresh.arrays["codes"]))
