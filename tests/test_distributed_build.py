"""Distributed end-to-end build on the 8-device virtual CPU mesh.

Pins the SURVEY §5 / §7 M4 contract: the sharded index is constructed with
data sharded over every mesh device, via psum'd k-means + sharded encode +
all_to_all redistribution — the full flat posting arrays never exist on a
single device — and its search results match a single-host build from the
same trained components (bit-compatible ids/layout semantics).
"""

import jax
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


def _single_host_from_same_components(sidx, data):
    """IVFADCIndex built from the distributed build's trained centroids +
    codebooks, replicating the distributed encode exactly (same argmin
    assignment, same encode) — isolates the sharding/redistribution logic."""
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


@pytest.mark.parametrize("n_shards,n_data", [(8, 1), (4, 2)])
def test_distributed_build_matches_single_host_components(n_shards, n_data):
    data = _clustered(4000, 16, 16, seed=3)
    mesh = make_mesh(n_shards=n_shards, n_data=n_data)
    sidx = ShardedIVFADCIndex.build(data, mesh, kc=32, k=32, m=4, seed=0)
    # metadata-only base: layout/histogram present, payload sharded
    assert not sidx.index.store.has_payload
    assert len(sidx.index) == len(data)
    assert int(np.asarray(sidx.arrays["sizes"]).sum()) == len(data)
    # every id placed exactly once across shards
    ids = np.asarray(sidx.arrays["ids"])
    live = np.sort(ids[ids >= 0])
    np.testing.assert_array_equal(live, np.arange(len(data)))
    # cell c lives on shard c % S with the global histogram's count
    sizes = np.asarray(sidx.arrays["sizes"])
    for c in range(32):
        for s in range(n_shards):
            if s != c % n_shards:
                assert sizes[s, c] == 0
    ref = _single_host_from_same_components(sidx, data)
    q = data[np.random.RandomState(1).choice(len(data), 24, replace=False)]
    ids_s, d_s = sidx.search_padded(q, 10, w=4)
    ids_r, d_r = ref.search_padded(q, 10, w=4)
    same = [set(a[a >= 0]) == set(b[b >= 0]) for a, b in zip(ids_s, ids_r)]
    assert np.mean(same) == 1.0
    np.testing.assert_allclose(np.sort(d_s, 1), np.sort(d_r, 1),
                               rtol=2e-2, atol=1e-2)


def test_distributed_build_lut_mode_exact():
    data = _clustered(2048, 12, 8, seed=5)
    mesh = make_mesh(n_shards=8)
    sidx = ShardedIVFADCIndex.build(data, mesh, kc=16, k=16, m=3,
                                    scan_mode="lut", seed=0)
    ref = _single_host_from_same_components(sidx, data)
    q = data[:16]
    ids_s, d_s = sidx.search_padded(q, 8, w=3)
    ids_r, d_r = ref.search_padded(q, 8, w=3)
    same = [set(a[a >= 0]) == set(b[b >= 0]) for a, b in zip(ids_s, ids_r)]
    assert np.mean(same) == 1.0
    np.testing.assert_allclose(np.sort(d_s, 1), np.sort(d_r, 1), rtol=1e-5)


def test_distributed_build_recall_parity_with_single_host_build():
    """End-to-end training quality: the distributed k-means/PQ pipeline must
    reach the same recall as the single-host build on the same data."""
    data = _clustered(3000, 16, 12, seed=7)
    rng = np.random.RandomState(2)
    queries = data[rng.choice(len(data), 32, replace=False)] \
        + 0.05 * rng.randn(32, 16).astype(np.float32)
    # brute-force ground truth
    d2 = ((queries[:, None] - data[None]) ** 2).sum(-1)
    gt = np.argsort(d2, axis=1)[:, :10]

    def recall(ids):
        return np.mean([len(set(a[a >= 0]) & set(g)) / 10
                        for a, g in zip(ids, gt)])

    mesh = make_mesh(n_shards=4, n_data=2)
    sidx = ShardedIVFADCIndex.build(data, mesh, kc=24, k=32, m=4, seed=0)
    ids_s, _ = sidx.search_padded(queries, 10, w=8)
    single = IVFADCIndex.build(data, kc=24, k=32, m=4, seed=0)
    ids_1, _ = single.search_padded(queries, 10, w=8)
    r_s, r_1 = recall(ids_s), recall(ids_1)
    assert r_s >= r_1 - 0.05, (r_s, r_1)


@pytest.mark.heavy                # large-kc distributed build
def test_distributed_build_large_kc_zero_extent_cells():
    """kc >= 4096: non-local cells take zero rows per shard (no kc*align*S
    padding blow-up), and search still answers correctly."""
    data = _clustered(8192, 8, 32, seed=9)
    mesh = make_mesh(n_shards=8)
    sidx = ShardedIVFADCIndex.build(data, mesh, kc=4096, k=16, m=2, seed=0)
    sizes = np.asarray(sidx.arrays["sizes"])
    # per-shard extent is bounded by live cells (align rows each) — NOT
    # kc * align * S (every shard padding every cell)
    live_per_shard = int((sizes > 0).sum(axis=1).max())
    width = np.asarray(sidx.arrays["ids"]).shape[1]
    assert width <= live_per_shard * 128 + 4096, (width, live_per_shard)
    assert width < 4096 * 128 // 4
    ref = _single_host_from_same_components(sidx, data)
    q = data[:8]
    ids_s, _ = sidx.search_padded(q, 5, w=4)
    ids_r, _ = ref.search_padded(q, 5, w=4)
    same = [set(a[a >= 0]) == set(b[b >= 0]) for a, b in zip(ids_s, ids_r)]
    assert np.mean(same) == 1.0
    # dynamic ops patch the shard arrays natively (no host base needed);
    # refresh() is a no-op in this regime
    sidx.refresh()
    assert sidx._last_refresh == "native"
    n0 = len(sidx.index)
    sidx.push_batch(data[:4] + 0.01)
    assert len(sidx.index) == n0 + 4
    sidx.delete([0, n0 + 1])
    assert len(sidx.index) == n0 + 2
    # the base store itself stays payload-free
    with pytest.raises(RuntimeError):
        _ = sidx.index.store.codes
