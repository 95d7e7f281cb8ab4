"""Persistence round-trip tests (reference test/persistency.jl)."""

import os

import numpy as np
import pytest

from ivfadc_tpu import IVFADCIndex, load_ivfadc_index, save_ivfadc_index
from tests.conftest import build_random_index


@pytest.mark.parametrize("coarse_quantizer", ["naive", "hnsw"])
def test_save_load_field_for_field(tmp_path, random_data, coarse_quantizer):
    """Field-for-field equality after round trip — same contract as
    test/persistency.jl:13-29 (naive) and :50-83 (hnsw: the two-level
    grouping arrays play the role of the serialized HNSW graph)."""
    idx = build_random_index(random_data, coarse_quantizer=coarse_quantizer)
    path = str(tmp_path / "index.npz")
    save_ivfadc_index(path, idx)
    idx2 = load_ivfadc_index(path)

    assert type(idx.coarse) is type(idx2.coarse)
    np.testing.assert_array_equal(np.asarray(idx.coarse.centroids),
                                  np.asarray(idx2.coarse.centroids))
    if coarse_quantizer == "hnsw":
        np.testing.assert_array_equal(np.asarray(idx.coarse.group_centers),
                                      np.asarray(idx2.coarse.group_centers))
        np.testing.assert_array_equal(np.asarray(idx.coarse.members),
                                      np.asarray(idx2.coarse.members))
        assert idx.coarse.n_probe_groups == idx2.coarse.n_probe_groups
    # residual quantizer
    assert idx.quantizer.method == idx2.quantizer.method
    np.testing.assert_array_equal(np.asarray(idx.quantizer.codebooks),
                                  np.asarray(idx2.quantizer.codebooks))
    np.testing.assert_array_equal(np.asarray(idx.quantizer.rotation),
                                  np.asarray(idx2.quantizer.rotation))
    # config
    assert idx.config == idx2.config
    assert idx.data_dtype == idx2.data_dtype
    assert idx.dim == idx2.dim
    # postings: every cell identical
    np.testing.assert_array_equal(idx.store.offsets, idx2.store.offsets)
    np.testing.assert_array_equal(idx.store.sizes, idx2.store.sizes)
    np.testing.assert_array_equal(idx.store.ids, idx2.store.ids)
    np.testing.assert_array_equal(idx.store.codes, idx2.store.codes)


def test_search_identical_after_reload(tmp_path, random_data):
    idx = build_random_index(random_data)
    path = str(tmp_path / "index.npz")
    idx.save(path)
    idx2 = IVFADCIndex.load(path)
    q = random_data[:16]
    i1, d1 = idx.search_padded(q, 5, w=4)
    i2, d2 = idx2.search_padded(q, 5, w=4)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(d1, d2)


def test_reload_preserves_dynamic_state(tmp_path, random_data):
    idx = build_random_index(random_data)
    idx.push(np.random.RandomState(0).rand(10))
    idx.delete([3, 4])
    path = str(tmp_path / "index.npz")
    idx.save(path)
    idx2 = IVFADCIndex.load(path)
    assert len(idx2) == len(idx)
    np.testing.assert_array_equal(idx.store.ids, idx2.store.ids)
    # dynamic ops continue to work on the loaded index
    idx2.push(np.random.RandomState(1).rand(10))
    assert len(idx2) == len(idx) + 1


def test_future_version_rejected(tmp_path, random_data):
    import json
    idx = build_random_index(random_data)
    path = str(tmp_path / "index.npz")
    idx.save(path)
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    meta = json.loads(bytes(arrays["__meta__"]).decode())
    meta["format_version"] = 999
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(),
                                       dtype=np.uint8)
    with open(path, "wb") as f:
        np.savez(f, **arrays)
    with pytest.raises(ValueError):
        IVFADCIndex.load(path)


def test_opq_roundtrip(tmp_path):
    data = np.random.RandomState(2).randn(300, 8).astype(np.float32)
    idx = IVFADCIndex.build(data, kc=4, k=16, m=2,
                            quantization_method="opq", seed=3)
    path = str(tmp_path / "opq.npz")
    idx.save(path)
    idx2 = IVFADCIndex.load(path)
    assert idx2.quantizer.method == "opq"
    q = data[:4]
    np.testing.assert_array_equal(idx.search_padded(q, 3, w=2)[0],
                                  idx2.search_padded(q, 3, w=2)[0])


# config fields older saves carry; they tuned kernels that no longer exist
_REMOVED_FIELDS = dict(scan_pb=64, scan_chunk=1024, scan_fold_lanes=128,
                       scan_merge="auto", scan_gather_win=0, cell_align=128)


def _inject_old_fields_single(path):
    import json
    with np.load(path) as z:
        arrays = {name: z[name] for name in z.files}
    meta = json.loads(bytes(arrays["__meta__"]).decode("utf-8"))
    meta["config"].update(_REMOVED_FIELDS)
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode("utf-8"),
                                       dtype=np.uint8)
    with open(path, "wb") as f:
        np.savez(f, **arrays)


@pytest.mark.parametrize("fmt", ["single", "sharded"])
def test_load_saved_with_removed_config_fields(tmp_path, random_data, fmt):
    """Indexes saved with the removed kernel-tuning fields load unchanged:
    IVFADCConfig.from_dict ignores unknown keys, and search is identical."""
    import json
    idx = build_random_index(random_data)
    q = random_data[:16]
    ids0, d0 = idx.search_padded(q, 5, w=4)
    if fmt == "single":
        path = str(tmp_path / "old.npz")
        idx.save(path)
        _inject_old_fields_single(path)
        loaded = IVFADCIndex.load(path)
    else:
        from ivfadc_tpu.parallel import (ShardedIVFADCIndex,
                                         load_sharded_index, make_mesh,
                                         save_sharded_index)
        mesh = make_mesh(n_shards=4, n_data=2)
        path = str(tmp_path / "old_dir")
        save_sharded_index(path, ShardedIVFADCIndex(idx, mesh))
        man = os.path.join(path, "manifest.json")
        with open(man) as f:
            meta = json.load(f)
        meta["config"].update(_REMOVED_FIELDS)
        with open(man, "w") as f:
            json.dump(meta, f)
        loaded = load_sharded_index(path, mesh)
    cfg = loaded.config if fmt == "single" else loaded.index.config
    assert cfg == idx.config
    ids1, d1 = loaded.search_padded(q, 5, w=4)
    np.testing.assert_array_equal(ids1, ids0)
    np.testing.assert_allclose(d1, d0, rtol=1e-6)


@pytest.mark.parametrize("scan_mode", ["lut", "dense"])
def test_old_128_aligned_layout_serves_both_scans(tmp_path, random_data,
                                                  scan_mode):
    """Stores saved with 128-row cell alignment (the old default for
    kc <= 16384) keep their layout on load, search like a fresh 8-aligned
    build, and grow cells at their own alignment."""
    import dataclasses
    from ivfadc_tpu.models.inverted import PostingStore
    idx = build_random_index(random_data)
    st = idx.store
    live = st.ids >= 0
    assign = np.empty(len(idx), np.int64)
    codes = np.empty((len(idx), st.m), st.code_dtype)
    assign[st.ids[live]] = st._slots_to_cells(np.nonzero(live)[0])
    codes[st.ids[live]] = st.codes[live]
    old = IVFADCIndex(dataclasses.replace(idx.config, scan_mode=scan_mode),
                      idx.coarse, idx.quantizer,
                      PostingStore.build(assign, codes, st.kc, align=128),
                      idx.data_dtype, idx.dim)
    path = str(tmp_path / "aligned.npz")
    old.save(path)
    loaded = IVFADCIndex.load(path)
    assert loaded.store.align == 128
    fresh = IVFADCIndex(old.config, idx.coarse, idx.quantizer,
                        PostingStore.build(assign, codes, st.kc),
                        idx.data_dtype, idx.dim)
    q = random_data[:16]
    ids_a, d_a = loaded.search_padded(q, 5, w=4)
    ids_b, d_b = fresh.search_padded(q, 5, w=4)
    np.testing.assert_array_equal(ids_a, ids_b)
    np.testing.assert_allclose(d_a, d_b, rtol=1e-6)
    loaded.push_batch(np.repeat(random_data[:1], 300, axis=0))
    assert (loaded.store.caps % 128 == 0).all()
    ids, _ = loaded.search_padded(random_data[:1], 5, w=4)
    assert (ids[0] >= 0).all()
