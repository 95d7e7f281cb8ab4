"""Shard-aware persistence + multi-host bootstrap.

Contract: a sharded index saves as a directory (manifest + common.npz + one
payload npz per shard; each process writes only its addressable shards) and
restores onto a mesh with IDENTICAL search results — for BOTH construction
paths (distributed build and partition-of-a-host-built-index). Reference
analogue: whole-index binary round-trip at
/root/reference/src/persistency.jl:1-305 / test/persistency.jl:13-29.
"""

import os

import numpy as np
import pytest

from ivfadc_tpu import IVFADCIndex
from ivfadc_tpu.parallel.mesh import make_mesh
from ivfadc_tpu.parallel.persistence import (load_sharded_index,
                                             save_sharded_index)
from ivfadc_tpu.parallel.sharded import ShardedIVFADCIndex


def _clustered(n, d, kc_true, seed=0):
    rng = np.random.RandomState(seed)
    centers = rng.randn(kc_true, d).astype(np.float32) * 5
    return np.concatenate(
        [c + rng.randn(n // kc_true, d).astype(np.float32) for c in centers])


def _assert_same_search(a, b, queries, k=10, w=4):
    ids_a, d_a = a.search_padded(queries, k, w=w)
    ids_b, d_b = b.search_padded(queries, k, w=w)
    np.testing.assert_array_equal(ids_a, ids_b)
    np.testing.assert_allclose(d_a, d_b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("scan_mode", ["lut", "dense"])
def test_roundtrip_distributed_build(tmp_path, scan_mode):
    data = _clustered(2048, 16, 8, seed=1)
    mesh = make_mesh(n_shards=8)
    sidx = ShardedIVFADCIndex.build(data, mesh, kc=32, k=16, m=4,
                                    scan_mode=scan_mode, seed=0)
    path = str(tmp_path / "sharded_idx")
    save_sharded_index(path, sidx)
    assert os.path.exists(os.path.join(path, "manifest.json"))
    assert len([f for f in os.listdir(path)
                if f.startswith("shard_")]) == 8
    restored = load_sharded_index(path, mesh)
    assert len(restored.index) == len(data)
    q = data[np.random.RandomState(3).choice(len(data), 24, replace=False)]
    _assert_same_search(sidx, restored, q)


@pytest.mark.parametrize("scan_mode", ["lut", "dense"])
def test_roundtrip_partitioned_host_index(tmp_path, scan_mode):
    """The partition-of-a-host-built-index path saves/loads identically."""
    data = _clustered(1536, 12, 6, seed=2)
    idx = IVFADCIndex.build(data, kc=24, k=16, m=3, scan_mode=scan_mode,
                            seed=0)
    mesh = make_mesh(n_shards=8)
    sidx = ShardedIVFADCIndex(idx, mesh)
    path = str(tmp_path / "part_idx")
    save_sharded_index(path, sidx)
    restored = load_sharded_index(path, mesh)
    q = data[:24]
    _assert_same_search(sidx, restored, q)
    # and the restored (payload-free base) view matches the original
    # single-host index's results too
    ids_r, _ = restored.search_padded(q, 10, w=4)
    ids_h, _ = idx.search_padded(q, 10, w=4)
    np.testing.assert_array_equal(ids_r, ids_h)


def test_roundtrip_two_level_coarse(tmp_path):
    data = _clustered(4096, 8, 16, seed=4)
    mesh = make_mesh(n_shards=8)
    sidx = ShardedIVFADCIndex.build(data, mesh, kc=256, k=16, m=2,
                                    coarse_quantizer="hnsw", seed=0)
    path = str(tmp_path / "twolevel_idx")
    save_sharded_index(path, sidx)
    restored = load_sharded_index(path, mesh)
    q = data[:16]
    _assert_same_search(sidx, restored, q, k=5, w=8)


@pytest.mark.parametrize("s_new,n_data", [(2, 4), (8, 1)])
def test_reshard_on_load(tmp_path, s_new, n_data):
    """Mesh-portable restore: a directory saved with S=4 shards loads onto
    S'=2 and S'=8 meshes with identical search results (cells re-dealt
    c -> c % S' on load). The reference's loader is environment-independent
    (/root/reference/src/persistency.jl:82-134); this is the sharded
    equivalent — no rebuild needed to change the serving topology."""
    data = _clustered(1024, 12, 8, seed=5)
    mesh4 = make_mesh(n_shards=4, n_data=2)
    sidx = ShardedIVFADCIndex.build(data, mesh4, kc=32, k=16, m=4, seed=0)
    path = str(tmp_path / "reshard_idx")
    save_sharded_index(path, sidx)
    restored = load_sharded_index(path, make_mesh(n_shards=s_new,
                                                  n_data=n_data))
    assert restored.n_shards == s_new
    assert len(restored.index) == len(data)
    q = data[np.random.RandomState(7).choice(len(data), 24, replace=False)]
    _assert_same_search(sidx, restored, q)
    # every id survives the re-deal exactly once
    placed = np.asarray(restored.arrays["ids"])
    placed = np.sort(placed[placed >= 0])
    np.testing.assert_array_equal(placed, np.arange(len(data)))


def test_reshard_roundtrips_back(tmp_path):
    """S=4 -> save -> load S'=2 -> save -> load S''=4 stays identical."""
    data = _clustered(768, 10, 6, seed=8)
    mesh4 = make_mesh(n_shards=4, n_data=2)
    sidx = ShardedIVFADCIndex.build(data, mesh4, kc=24, k=16, m=2, seed=0)
    p1, p2 = str(tmp_path / "a"), str(tmp_path / "b")
    save_sharded_index(p1, sidx)
    via2 = load_sharded_index(p1, make_mesh(n_shards=2, n_data=4))
    save_sharded_index(p2, via2)
    back4 = load_sharded_index(p2, mesh4)
    q = data[:16]
    _assert_same_search(sidx, back4, q)


def test_consolidate_to_single_file_index(tmp_path):
    """4-shard directory -> plain IVFADCIndex: payload reassembled on host,
    search results identical, full dynamic-op support back."""
    from ivfadc_tpu.parallel.persistence import consolidate_sharded_index
    data = _clustered(1024, 12, 8, seed=9)
    mesh4 = make_mesh(n_shards=4, n_data=2)
    sidx = ShardedIVFADCIndex.build(data, mesh4, kc=32, k=16, m=4, seed=0)
    path = str(tmp_path / "consol_idx")
    save_sharded_index(path, sidx)
    plain = consolidate_sharded_index(path)
    assert len(plain) == len(data)
    assert plain.store.has_payload
    q = data[:24]
    ids_s, d_s = sidx.search_padded(q, 10, w=4)
    ids_p, d_p = plain.search_padded(q, 10, w=4)
    np.testing.assert_array_equal(ids_s, ids_p)
    np.testing.assert_allclose(d_s, d_p, rtol=1e-6, atol=1e-6)
    # dynamic ops work on the consolidated index (the distributed-built
    # sharded view's base was payload-free)
    n0 = len(plain)
    plain.push(data[0] + 0.01)
    assert len(plain) == n0 + 1
    plain.delete([n0])               # the pushed point got id n0
    assert len(plain) == n0
    # and it round-trips through single-file persistence
    fp = str(tmp_path / "plain.npz")
    plain.save(fp)
    from ivfadc_tpu import IVFADCIndex as _I
    re = _I.load(fp)
    ids_r, _ = re.search_padded(q, 10, w=4)
    np.testing.assert_array_equal(ids_p, ids_r)


def test_consolidate_partitioned_host_index_matches_original(tmp_path):
    """partition -> save -> consolidate reproduces the ORIGINAL host index
    field-for-field (cell entries, sizes, search) — the strictest round-trip:
    host -> shards -> directory -> host."""
    from ivfadc_tpu.parallel.persistence import consolidate_sharded_index
    data = _clustered(768, 10, 6, seed=10)
    idx = IVFADCIndex.build(data, kc=24, k=16, m=3, seed=0)
    mesh = make_mesh(n_shards=4, n_data=2)
    sidx = ShardedIVFADCIndex(idx, mesh)
    path = str(tmp_path / "consol_host")
    save_sharded_index(path, sidx)
    plain = consolidate_sharded_index(path)
    assert len(plain) == len(idx)
    for c in range(idx.config.kc):
        i0, c0 = idx.store.cell_entries(c)
        i1, c1 = plain.store.cell_entries(c)
        np.testing.assert_array_equal(i0, i1)
        np.testing.assert_array_equal(c0, c1)
    q = data[:16]
    ids_h, d_h = idx.search_padded(q, 10, w=4)
    ids_p, d_p = plain.search_padded(q, 10, w=4)
    np.testing.assert_array_equal(ids_h, ids_p)
    np.testing.assert_allclose(d_h, d_p, rtol=1e-6, atol=1e-6)


def test_newer_format_version_raises(tmp_path):
    import json
    data = _clustered(512, 8, 4, seed=6)
    mesh = make_mesh(n_shards=8)
    sidx = ShardedIVFADCIndex.build(data, mesh, kc=16, k=16, m=2, seed=0)
    path = str(tmp_path / "ver_idx")
    save_sharded_index(path, sidx)
    mf = os.path.join(path, "manifest.json")
    with open(mf) as f:
        meta = json.load(f)
    meta["format_version"] = 999
    with open(mf, "w") as f:
        json.dump(meta, f)
    with pytest.raises(ValueError, match="newer"):
        load_sharded_index(path, mesh)


def test_bootstrap_noop_single_process(monkeypatch):
    """No cluster env, no args -> no-op (library users on one host never
    touch jax.distributed)."""
    from ivfadc_tpu.parallel import bootstrap
    for v in bootstrap._AUTO_DETECT_VARS + (
            "IVFADC_COORDINATOR", "IVFADC_NUM_PROCESSES"):
        monkeypatch.delenv(v, raising=False)
    monkeypatch.setattr(bootstrap, "_INITIALIZED", False)
    assert bootstrap.initialize_cluster() is False
    info = bootstrap.process_info()
    assert info["process_count"] == 1
    assert info["initialized"] is False


def test_bootstrap_env_resolution(monkeypatch):
    """IVFADC_* env vars are resolved and handed to
    jax.distributed.initialize (call intercepted — no real cluster here)."""
    from ivfadc_tpu.parallel import bootstrap
    import jax
    calls = {}

    def fake_init(**kw):
        calls.update(kw)

    monkeypatch.setattr(bootstrap, "_INITIALIZED", False)
    monkeypatch.setattr(jax.distributed, "initialize", fake_init)
    monkeypatch.setenv("IVFADC_COORDINATOR", "10.0.0.1:1234")
    monkeypatch.setenv("IVFADC_NUM_PROCESSES", "4")
    monkeypatch.setenv("IVFADC_PROCESS_ID", "2")
    monkeypatch.setenv("IVFADC_LOCAL_DEVICE_IDS", "0,1")
    assert bootstrap.initialize_cluster() is True
    assert calls == dict(coordinator_address="10.0.0.1:1234",
                         num_processes=4, process_id=2,
                         local_device_ids=[0, 1])
    # idempotent
    calls.clear()
    assert bootstrap.initialize_cluster() is True
    assert calls == {}
    monkeypatch.setattr(bootstrap, "_INITIALIZED", False)


def test_consolidate_after_cell_relocation(tmp_path):
    """A host-based index whose cell outgrew its cap relocates that cell to
    the END of the flat store, making the layout non-monotone. Consolidation
    must size the rebuilt store by (offsets+caps).max(), not the last cell's
    end — the old formula under-allocated and crashed on such checkpoints."""
    from ivfadc_tpu.parallel.persistence import consolidate_sharded_index
    rng = np.random.RandomState(3)
    data = _clustered(512, 10, 8, seed=3)
    idx = IVFADCIndex.build(data, kc=8, k=16, m=2, seed=0,
                            cell_slack=1.05)
    # push many near-identical points so ONE cell overflows and relocates
    target = data[7] + 0.001 * rng.randn(600, 10).astype(np.float32)
    idx.push_batch(target)
    off_end = idx.store.offsets + idx.store.caps
    assert int(off_end.max()) > int(off_end[-1]), \
        "fixture failed to relocate a grown cell"
    mesh = make_mesh(n_shards=2, n_data=1)
    sidx = ShardedIVFADCIndex(idx, mesh)
    path = str(tmp_path / "reloc_idx")
    save_sharded_index(path, sidx)
    plain = consolidate_sharded_index(path)
    assert len(plain) == len(idx)
    q = data[:16]
    ids_a, d_a = idx.search_padded(q, 10, w=4)
    ids_b, d_b = plain.search_padded(q, 10, w=4)
    np.testing.assert_array_equal(ids_a, ids_b)
    np.testing.assert_allclose(d_a, d_b, rtol=1e-6, atol=1e-6)


def test_out_of_core_consolidation_matches_in_memory(tmp_path):
    """consolidate_sharded_to_file streams shard files into a single-file
    index one shard at a time: the loaded result
    is field-for-field identical to the in-memory consolidation, and the
    streaming path never holds two shard payloads at once."""
    import ivfadc_tpu.parallel.persistence as pers
    from ivfadc_tpu import load_ivfadc_index
    from ivfadc_tpu.parallel.persistence import (
        consolidate_sharded_index, consolidate_sharded_to_file,
        save_sharded_index)
    from ivfadc_tpu.parallel.mesh import make_mesh
    from ivfadc_tpu.parallel.sharded import ShardedIVFADCIndex

    rng = np.random.RandomState(4)
    data = rng.rand(2500, 16).astype(np.float32)
    sidx = ShardedIVFADCIndex.build(
        data, make_mesh(n_shards=4, n_data=2), kc=48, m=4, k=16,
        index_dtype="uint32", seed=6)
    d = str(tmp_path / "dir")
    save_sharded_index(d, sidx)

    mem_idx = consolidate_sharded_index(d)

    # instrument np.load: at most one shard payload open at a time
    open_shards = {"now": 0, "peak": 0}
    real_load = np.load

    class _Tracking:
        def __init__(self, z, shard):
            self._z, self._shard = z, shard

        def __enter__(self):
            if self._shard:
                open_shards["now"] += 1
                open_shards["peak"] = max(open_shards["peak"],
                                          open_shards["now"])
            self._z.__enter__()
            return self._z

        def __exit__(self, *exc):
            if self._shard:
                open_shards["now"] -= 1
            return self._z.__exit__(*exc)

    def tracking_load(fp, *a, **kw):
        return _Tracking(real_load(fp, *a, **kw), "shard_" in str(fp))

    out = str(tmp_path / "flat.npz")
    pers.np.load = tracking_load
    try:
        consolidate_sharded_to_file(d, out, chunk_rows=512)
    finally:
        pers.np.load = real_load
    assert open_shards["peak"] == 1, open_shards

    ooc_idx = load_ivfadc_index(out)
    assert len(ooc_idx) == len(mem_idx) == 2500
    np.testing.assert_array_equal(ooc_idx.store.offsets, mem_idx.store.offsets)
    np.testing.assert_array_equal(ooc_idx.store.sizes, mem_idx.store.sizes)
    np.testing.assert_array_equal(ooc_idx.store.caps, mem_idx.store.caps)
    np.testing.assert_array_equal(ooc_idx.store.ids, mem_idx.store.ids)
    np.testing.assert_array_equal(ooc_idx.store.codes, mem_idx.store.codes)
    np.testing.assert_array_equal(np.asarray(ooc_idx.coarse.centroids),
                                  np.asarray(mem_idx.coarse.centroids))
    i1, d1 = ooc_idx.search_padded(data[:8], 5, w=4)
    i2, d2 = mem_idx.search_padded(data[:8], 5, w=4)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(d1, d2, rtol=1e-6)


def test_out_of_core_consolidation_wide_dir(tmp_path, monkeypatch):
    """Wide-id directories stream-consolidate too: the uint64 translation
    folds into int64 host ids identical to the in-memory path."""
    from ivfadc_tpu.parallel.persistence import (
        consolidate_sharded_index, consolidate_sharded_to_file,
        save_sharded_index)
    from ivfadc_tpu import load_ivfadc_index
    from ivfadc_tpu.parallel.mesh import make_mesh
    from ivfadc_tpu.parallel.sharded import ShardedIVFADCIndex

    monkeypatch.setenv("IVFADC_DEVICE_ID_CAP", "1024")
    rng = np.random.RandomState(7)
    data = rng.rand(2000, 12).astype(np.float32)
    sidx = ShardedIVFADCIndex.build(
        data, make_mesh(n_shards=4, n_data=2), kc=32, m=2, k=16,
        index_dtype="uint64", seed=1)
    assert sidx.wide_ids
    d = str(tmp_path / "wdir")
    save_sharded_index(d, sidx)
    mem_idx = consolidate_sharded_index(d)
    out = str(tmp_path / "wflat.npz")
    consolidate_sharded_to_file(d, out)
    ooc_idx = load_ivfadc_index(out)
    np.testing.assert_array_equal(ooc_idx.store.ids, mem_idx.store.ids)
    np.testing.assert_array_equal(ooc_idx.store.codes, mem_idx.store.codes)
