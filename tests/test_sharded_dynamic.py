"""Dynamic ops (push/push_front/pop/pop_front/delete) on DISTRIBUTED-BUILT
sharded views — the payload-free-base regime where the reference's
insertion/deletion contract (/root/reference/src/utils.jl:114,90-105) must
hold without any single-host copy of the postings: rows are encoded on
device, scattered into the owner shard's CSR block, and id renumbering
replays as device arithmetic.

Parity oracle: a single-host IVFADCIndex constructed from the SAME trained
components (so encode/assignment are bit-identical), mutated with the same
op sequence through the host path.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from ivfadc_tpu import IVFADCIndex
from ivfadc_tpu.models.inverted import PostingStore
from ivfadc_tpu.ops import pq as pq_ops
from ivfadc_tpu.parallel.mesh import make_mesh
from ivfadc_tpu.parallel.sharded import ShardedIVFADCIndex


def _clustered(n, d, kc_true, seed=0):
    rng = np.random.RandomState(seed)
    centers = rng.randn(kc_true, d).astype(np.float32) * 5
    return np.concatenate(
        [c + rng.randn(n // kc_true, d).astype(np.float32) for c in centers])


def _host_twin(sidx, data):
    """Host IVFADCIndex from the distributed build's trained components,
    replicating the distributed encode exactly."""
    base = sidx.index
    q = jnp.asarray(data, jnp.float32)
    cells = jnp.argmin(
        base.coarse_metric.pairwise(q, base.coarse.centroids), axis=1)
    resid = q - base.coarse.centroids[cells]
    codes = pq_ops.encode(base.quantizer, resid, metric=base.quant_metric)
    store = PostingStore.build(np.asarray(cells), np.asarray(codes),
                               base.config.kc,
                               slack=base.config.cell_slack)
    return IVFADCIndex(base.config, base.coarse, base.quantizer, store,
                       np.dtype(np.float32), data.shape[1])


def _cell_multisets(sidx):
    """{cell: sorted [(id, codes...)]} straight off the shard arrays."""
    ids = np.asarray(sidx.arrays["ids"])
    codes = np.asarray(sidx.shard_pq_codes)
    out = {}
    S = sidx.n_shards
    for c in range(sidx.index.config.kc):
        s = c % S
        off = int(sidx._h_offsets[s, c])
        sz = int(sidx.index.store.sizes[c])
        rows = [(int(ids[s, off + r]), tuple(codes[s, off + r].tolist()))
                for r in range(sz)]
        out[c] = sorted(rows)
    return out


def _host_cell_multisets(idx):
    out = {}
    for c in range(idx.config.kc):
        cids, ccodes = idx.store.cell_entries(c)
        out[c] = sorted((int(i), tuple(np.asarray(k).tolist()))
                        for i, k in zip(cids, ccodes))
    return out


def _assert_state_parity(sidx, twin):
    assert len(sidx.index) == len(twin)
    np.testing.assert_array_equal(sidx.index.store.sizes, twin.store.sizes)
    assert _cell_multisets(sidx) == _host_cell_multisets(twin)
    # live ids are exactly the contiguous range {0..n-1}, each placed once
    ids = np.asarray(sidx.arrays["ids"])
    live = np.sort(ids[ids >= 0])
    np.testing.assert_array_equal(live, np.arange(len(twin)))


def _assert_search_parity(sidx, twin, queries, k=5, w=4):
    vi, vd = sidx.search_padded(queries, k, w=w)
    hi, hd = twin.search_padded(queries, k, w=w)
    np.testing.assert_array_equal(vi, hi)
    np.testing.assert_allclose(vd, hd, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def dist_view():
    data = _clustered(2000, 16, 8, seed=11)
    mesh = make_mesh(n_shards=4, n_data=2)
    sidx = ShardedIVFADCIndex.build(data, mesh, kc=16, k=16, m=4, seed=0)
    assert not sidx.index.store.has_payload
    return sidx, data


def _fresh_pair(dist_view):
    sidx, data = dist_view
    # rebuild the view each test (module fixture would leak mutations)
    mesh = sidx.mesh
    fresh = ShardedIVFADCIndex.build(data, mesh, kc=16, k=16, m=4, seed=0)
    return fresh, _host_twin(fresh, data), data


def test_push_batch_then_delete_parity(dist_view):
    sidx, twin, data = _fresh_pair(dist_view)
    rng = np.random.RandomState(3)
    queries = data[rng.choice(len(data), 32, replace=False)] \
        + rng.randn(32, data.shape[1]).astype(np.float32) * 0.1

    new_pts = _clustered(64, 16, 8, seed=21)
    sidx.push_batch(new_pts)
    twin.push_batch(new_pts)
    _assert_state_parity(sidx, twin)
    _assert_search_parity(sidx, twin, queries)

    dels = rng.choice(len(twin), 40, replace=False)
    sidx.delete(dels)
    twin.delete(dels)
    _assert_state_parity(sidx, twin)
    _assert_search_parity(sidx, twin, queries)

    # second round on the already-mutated view (shifted-id regime)
    sidx.push_batch(new_pts[:8])
    twin.push_batch(new_pts[:8])
    dels2 = [0, 1, len(twin) - 1]
    sidx.delete(dels2)
    twin.delete(dels2)
    _assert_state_parity(sidx, twin)
    _assert_search_parity(sidx, twin, queries)


def test_scalar_ops_parity(dist_view):
    sidx, twin, data = _fresh_pair(dist_view)
    pt = data[7] * 1.01

    sidx.push(pt)
    twin.push(pt)
    _assert_state_parity(sidx, twin)

    sidx.push_front(pt + 0.5)
    twin.push_front(pt + 0.5)
    _assert_state_parity(sidx, twin)

    v_s = sidx.pop()
    v_h = twin.pop()
    np.testing.assert_allclose(v_s, v_h, rtol=1e-5, atol=1e-5)
    _assert_state_parity(sidx, twin)

    v_s = sidx.pop_front()
    v_h = twin.pop_front()
    np.testing.assert_allclose(v_s, v_h, rtol=1e-5, atol=1e-5)
    _assert_state_parity(sidx, twin)

    # reconstruct on the distributed view matches the host path
    np.testing.assert_allclose(sidx.reconstruct(3), twin.reconstruct(3),
                               rtol=1e-5, atol=1e-5)


def test_regrow_on_capacity_overflow(dist_view):
    sidx, twin, data = _fresh_pair(dist_view)
    old_window = sidx.window
    old_caps = sidx._h_caps.copy()
    # flood one region of space so one cell overflows its per-shard cap
    target = data[:1] + np.random.RandomState(5).randn(
        600, data.shape[1]).astype(np.float32) * 0.05
    sidx.push_batch(target)
    twin.push_batch(target)
    assert sidx.window >= old_window
    assert int(sidx._h_caps.max()) > int(old_caps.max())
    _assert_state_parity(sidx, twin)
    rng = np.random.RandomState(6)
    queries = data[rng.choice(len(data), 16, replace=False)]
    _assert_search_parity(sidx, twin, queries)
    # dynamic ops still work after the regrow
    sidx.delete([5, 10, 15])
    twin.delete([5, 10, 15])
    _assert_state_parity(sidx, twin)
    _assert_search_parity(sidx, twin, queries)


def test_persistence_after_native_dynamic_ops(dist_view, tmp_path):
    from ivfadc_tpu.parallel.persistence import (consolidate_sharded_index,
                                                 load_sharded_index,
                                                 save_sharded_index)
    sidx, twin, data = _fresh_pair(dist_view)
    new_pts = _clustered(32, 16, 8, seed=31)
    sidx.push_batch(new_pts)
    twin.push_batch(new_pts)
    sidx.delete([2, 17, 100, len(twin) - 1])
    twin.delete([2, 17, 100, len(twin) - 1])

    path = str(tmp_path / "dyn_sharded")
    save_sharded_index(path, sidx)
    rng = np.random.RandomState(8)
    queries = data[rng.choice(len(data), 16, replace=False)]

    # consolidation to a host index reproduces the mutated state exactly
    host = consolidate_sharded_index(path)
    assert len(host) == len(twin)
    assert _host_cell_multisets(host) == _host_cell_multisets(twin)
    _assert_search_parity(sidx, host, queries)

    # reshard onto a different shard count preserves the mutated state
    mesh2 = make_mesh(n_shards=2, n_data=1)
    sidx2 = load_sharded_index(path, mesh2)
    _assert_search_parity(sidx2, twin, queries)
    # and the reloaded view supports further dynamic ops
    sidx2.push_batch(new_pts[:4])
    twin.push_batch(new_pts[:4])
    sidx2.delete([0])
    twin.delete([0])
    _assert_state_parity(sidx2, twin)
    _assert_search_parity(sidx2, twin, queries)


def test_dynamic_op_errors(dist_view):
    sidx, _, data = _fresh_pair(dist_view)
    with pytest.raises(AssertionError):
        sidx.push_batch(np.zeros((3, data.shape[1] + 1), np.float32))
    with pytest.raises((IndexError, KeyError)):
        sidx.delete([len(sidx.index) + 5])
    with pytest.raises(AssertionError):
        sidx.push(np.zeros(data.shape[1] + 2, np.float32))


def test_empty_push_batch_is_noop(dist_view):
    sidx, _, data = _fresh_pair(dist_view)
    n0 = len(sidx.index)
    ids_before, _ = sidx.search_padded(data[:8], 5, w=4)
    sidx.push_batch(np.empty((0, data.shape[1]), np.float32))
    assert len(sidx.index) == n0
    ids_after, _ = sidx.search_padded(data[:8], 5, w=4)
    np.testing.assert_array_equal(ids_before, ids_after)


def test_native_mutations_are_single_sync():
    """Fused mutation contract: one device->host
    sync per native push_batch (the cells fetch) and per delete (the
    locate fetch; zero in wide mode), with the whole row-data epilogue a
    single donated program — no row ever crosses to host."""
    data = _clustered(1200, 16, 8, seed=3)
    sidx = ShardedIVFADCIndex.build(
        data, make_mesh(n_shards=4, n_data=2), kc=32, m=4, k=16,
        index_dtype="uint32", seed=2)
    rng = np.random.RandomState(0)
    extra = rng.rand(16, 16).astype(np.float32)
    # warm every traced shape first (compiles would not add syncs, but keep
    # the count assertion about steady state)
    sidx.push_batch(extra)
    sidx.delete([5, 10, 700])

    counts = {"n": 0}
    orig = sidx._host

    def counting_host(arr):
        counts["n"] += 1
        return orig(arr)

    sidx._host = counting_host
    try:
        sidx.push_batch(rng.rand(16, 16).astype(np.float32))
        push_syncs = counts["n"]
        counts["n"] = 0
        sidx.delete([3, 17, 400])
        del_syncs = counts["n"]
    finally:
        sidx._host = orig
    assert push_syncs == 1, push_syncs
    assert del_syncs == 1, del_syncs
    # state stays searchable and consistent after the fused ops
    ids, _ = sidx.search_padded(data[:8], 5, w=4)
    assert (np.asarray(ids)[:, 0] >= 0).all()
