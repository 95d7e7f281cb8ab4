"""Sharded IVFADC search: inverted lists partitioned across a device mesh.

Design (SURVEY §5 "Distributed communication backend"):
  * cells are assigned round-robin to S shards; each shard holds the full
    CSR arrays but with size 0 for non-local cells — so the single-card
    search program runs unchanged per shard;
  * centroids + codebooks are replicated (tiny);
  * queries are sharded over the "data" mesh axis (data parallelism) and
    replicated over "shard";
  * each shard computes a local top-k, then `all_gather` over the shard axis
    + a final top-k merge produces the exact global result — identical ids
    to the single-card path.

All collective logic lives in one `shard_map`-wrapped function; on GPUs XLA
hands the all-gather to NCCL.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from jax import shard_map

from ivfadc_tpu.models.index import IVFADCIndex, _bucket_batch, _dense_local
from ivfadc_tpu.ops.adc import build_adc_tables, scan_postings
from ivfadc_tpu.ops.metrics import Metric
from ivfadc_tpu.ops.topk import topk_lastdim
from ivfadc_tpu.parallel.mesh import DATA_AXIS, SHARD_AXIS, make_mesh

_LANE = 128

# wide-id mode: dead-slot sentinel in the host slot -> global-id translation
# (global ids live in [0, 2^63) — int64 host stores bound them — so the
# all-ones uint64 can never be a real id)
WIDE_NO_ID = np.uint64(0xFFFFFFFFFFFFFFFF)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def partition_store(store, n_shards: int, align: int = 0, wide: bool = False):
    """Split one PostingStore into S stacked per-shard CSR array sets.

    Cells are dealt round-robin (cell c -> shard c % S) so load is balanced
    in expectation. Every shard keeps (kc,) offset/size arrays — non-local
    cells have size 0 and scan as empty windows, exactly like the reference's
    empty-cell tolerance (SURVEY §2.3). Fully vectorized (no Python loop
    over kc — at Deep1B's kc=2^18 a Python loop takes minutes).

    `align` (default: the store's own alignment) sets per-shard cell-start
    alignment. Returns dict of np arrays with leading shard axis.

    `wide=True` builds WIDE-ID parts (external ids beyond the device int32
    cap, up to the index_dtype capacity — the reference's full UInt64 law,
    /root/reference/src/index.jl:124): the device id arrays hold per-shard
    SLOT indices (always < 2^31 by per-shard memory) and a host-side
    `trans` array (S, cap) uint64 maps slot -> global id (WIDE_NO_ID in
    dead slots). Search kernels run unchanged — they emit slots — and the
    serving view translates winners host-side.
    """
    kc, m = store.kc, store.m
    a = align or store.align
    cells = np.arange(kc)
    owners = cells % n_shards
    sizes_per = np.zeros((n_shards, kc), np.int64)
    sizes_per[owners, cells] = store.sizes
    # capacity only on the OWNER shard: ownership is fixed (c % S), so the
    # S-1 non-owner copies of a cell can never receive rows — giving them
    # the >= align floor would put kc*(S-1)/S permanently-dead aligned
    # blocks in every shard's codes/ids/decoded-cache arrays. Zero-cap
    # cells scan as empty windows (same tolerance as empty cells).
    owner_mask = np.zeros((n_shards, kc), bool)
    owner_mask[owners, cells] = True
    caps_per = np.where(
        owner_mask, np.maximum(a, ((sizes_per + 8 + a - 1) // a) * a), 0)
    offsets_per = np.zeros((n_shards, kc), np.int64)
    np.cumsum(caps_per[:, :-1], axis=1, out=offsets_per[:, 1:])
    totals = offsets_per[:, -1] + caps_per[:, -1]
    cap_shard = _round_up(int(totals.max()), _LANE)
    codes = np.zeros((n_shards, cap_shard, m), store.code_dtype)
    ids = np.full((n_shards, cap_shard), -1, np.int64)
    trans = np.full((n_shards, cap_shard), WIDE_NO_ID, np.uint64) \
        if wide else None
    # one gather/scatter pair over all live rows: row r of cell c goes from
    # base slot offsets[c]+r to shard-(c%S) slot offsets_per[c%S, c]+r
    from ivfadc_tpu.parallel.persistence import _row_moves
    sz = np.asarray(store.sizes, np.int64)
    tot = int(sz.sum())
    if tot:
        cell_rep, within = _row_moves(sz)
        src = np.asarray(store.offsets, np.int64)[cell_rep] + within
        shard_rep = owners[cell_rep]
        dst = offsets_per[shard_rep, cell_rep] + within
        codes[shard_rep, dst] = store.codes[src]
        if wide:
            ids[shard_rep, dst] = dst          # device ids = slot indices
            trans[shard_rep, dst] = store.ids[src].astype(np.uint64)
        else:
            ids[shard_rep, dst] = store.ids[src]
    window = _round_up(max(1, int(sizes_per.max())), _LANE)
    out = dict(offsets=offsets_per.astype(np.int32),
               sizes=sizes_per.astype(np.int32),
               codes=codes, ids=ids.astype(np.int32), window=window,
               align=a, max_cap=int(caps_per.max()), caps=caps_per)
    if wide:
        out["trans"] = trans
    return out


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "k", "w", "window", "metric", "include_base",
                     "apply_rot", "residual_based", "dense", "overlap",
                     "with_pos"))
def _sharded_search_impl(cq, codebooks, rotation, offsets, sizes, codes, ids,
                         dscale, queries, *, mesh, k: int, w: int,
                         window: int, metric: Metric, include_base: bool,
                         apply_rot: bool, residual_based: bool,
                         dense: bool = False, overlap: bool = True,
                         with_pos: bool = False):
    """Queries (B, d) replicated over shard / sharded over data; per-shard CSR
    arrays stacked on a leading shard axis. `codes` is the flat PQ-code array
    in LUT mode or the decoded residual cache in dense mode. Returns
    replicated-over-shard (B, k) global ids + dists.

    `overlap=True` double-buffers the cross-shard merge (SURVEY §7 "Hard
    parts" last bullet): the local batch is split into two waves and wave
    0's k-candidate all_gather is issued BEFORE wave 1's scan, so the
    collective can overlap the second scan's compute."""

    def local_search(cq_l, cb_l, rot_l, off_l, siz_l, cod_l, ids_l, scale_l,
                     q_l):
        # strip the leading per-shard axis added by shard_map
        off_l, siz_l = off_l[0], siz_l[0]
        cod_l, ids_l = cod_l[0], ids_l[0]
        kw = dict(k=k, w=w, window=window, metric=metric,
                  include_base=include_base, apply_rot=apply_rot,
                  residual_based=residual_based)

        def scan_block(q_b):
            """Shard-local top-k candidates for one query wave."""
            if dense:
                return _dense_local(cq_l, rot_l, off_l, siz_l, cod_l, ids_l,
                                    scale_l, q_b, **kw)
            cells, cdists = cq_l.search(q_b, w)
            cent = cq_l.centroids[cells]
            if residual_based:
                vecs = q_b[:, None, :] - cent
                base = cdists if include_base else jnp.zeros_like(cdists)
            else:
                vecs = jnp.broadcast_to(q_b[:, None, :],
                                        (q_b.shape[0], w, q_b.shape[1]))
                base = jax.vmap(metric.pairwise)(q_b[:, None, :],
                                                 cent)[:, 0, :]
            # padded probes (two-level coarse, dist inf) must stay dead
            base = jnp.where(jnp.isfinite(cdists), base, jnp.inf)
            dq = rot_l.shape[0]
            if vecs.shape[-1] != dq:    # ragged-subspace zero padding
                vecs = jnp.pad(vecs,
                               ((0, 0), (0, 0), (0, dq - vecs.shape[-1])))
            if apply_rot:
                vecs = jnp.matmul(vecs, rot_l,
                                  precision=jax.lax.Precision.HIGHEST)
            tables = build_adc_tables(metric, vecs, codebooks=cb_l)
            return scan_postings(tables, base, cells, off_l, siz_l,
                                 cod_l, ids_l, k=k, window=window)

        def gather(loc):
            # Cross-shard exact merge input: every shard's k candidates.
            # (S, Bw, k) stays tiny.
            return (jax.lax.all_gather(loc[0], SHARD_AXIS),
                    jax.lax.all_gather(loc[1], SHARD_AXIS))

        def rerank(all_ids, all_d):
            S, Bw, _ = all_ids.shape
            all_ids = jnp.moveaxis(all_ids, 0, 1).reshape(Bw, S * k)
            all_d = jnp.moveaxis(all_d, 0, 1).reshape(Bw, S * k)
            top_d, which = topk_lastdim(all_d, k)
            out_i = jnp.take_along_axis(all_ids, which, axis=1)
            if with_pos:
                # wide-id mode: each winner's source shard (merge position
                # // k in the (S*k)-flattened candidate row) so the host
                # can translate (shard, slot) -> uint64 global id
                return out_i, top_d, (which // k).astype(jnp.int32)
            return out_i, top_d

        B_l = q_l.shape[0]
        if overlap and B_l >= 16:
            # double-buffered: scan(w0); issue gather(w0); scan(w1) runs
            # while w0's collective is in flight; then both merges
            h = B_l // 2
            g0 = gather(scan_block(q_l[:h]))
            g1 = gather(scan_block(q_l[h:]))
            r0 = rerank(*g0)
            r1 = rerank(*g1)
            return tuple(jnp.concatenate([a, b], axis=0)
                         for a, b in zip(r0, r1))
        g = gather(scan_block(q_l))
        return rerank(*g)

    n_out = 3 if with_pos else 2
    fn = shard_map(
        local_search, mesh=mesh,
        in_specs=(P(), P(), P(), P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS),
                  P(SHARD_AXIS), P(), P(DATA_AXIS)),
        out_specs=tuple([P(DATA_AXIS)] * n_out),
        check_vma=False)
    out = fn(cq, codebooks, rotation, offsets, sizes, codes, ids,
             dscale, queries.astype(jnp.float32))
    if with_pos:
        return out[0], metric.finalize(out[1]), out[2]
    return out[0], metric.finalize(out[1])


@functools.partial(
    jax.jit, donate_argnums=(2, 3, 4, 5),
    static_argnames=("wide", "has_dec", "int8_cache"))
def _fused_append(codebooks, scale, ids, pq, dec, sizes, offsets, cells,
                  codes, new_ids, n_valid, *, wide: bool, has_dec: bool,
                  int8_cache: bool):
    """Single-dispatch append epilogue: owner/slot computation + row scatter
    (ids + PQ codes + decoded scan cache) + device-resident size update —
    the whole mutation after encode as ONE donated program, so a push_batch
    costs one host sync (the cells fetch for bookkeeping) instead of a
    fetch/re-upload chain.

    cells/codes/new_ids are bucket-padded to stable shapes; rows past
    `n_valid` (traced) scatter out of range and drop. In wide-id mode the
    stored id is the row's slot index (new_ids is ignored on device — the
    uint64 globals live in the host translation)."""
    from ivfadc_tpu.ops import pq as pq_ops

    S, kc = sizes.shape
    Bp = cells.shape[0]
    valid = jnp.arange(Bp) < n_valid
    a_eff = jnp.where(valid, cells, kc)           # pads sort last
    order = jnp.argsort(a_eff, stable=True)
    sc = a_eff[order]                             # sorted cells
    # rank among same-cell rows, in input order (stable sort keeps it)
    starts = jnp.searchsorted(sc, sc)             # first pos of own cell
    within = jnp.arange(Bp, dtype=jnp.int32) - starts.astype(jnp.int32)
    sc_safe = jnp.where(sc < kc, sc, 0)
    owner = (sc_safe % S).astype(jnp.int32)
    slot = (offsets[owner, sc_safe] + sizes[owner, sc_safe]
            + within).astype(jnp.int32)
    cap_pad = ids.shape[1]
    slot = jnp.where(sc < kc, slot, cap_pad)      # pads drop
    codes_s = codes[order]
    ids_val = slot.astype(ids.dtype) if wide \
        else new_ids[order].astype(ids.dtype)
    ids = ids.at[owner, slot].set(ids_val, mode="drop")
    pq = pq.at[owner, slot].set(codes_s, mode="drop")
    if has_dec:
        if int8_cache:
            m, _, dsub = codebooks.shape
            qcb = jnp.clip(jnp.round(
                codebooks / scale[:m * dsub].reshape(m, 1, dsub)), -127, 127)
            rows_d = pq_ops._decode_rotated_onehot(qcb, codes_s)
        else:
            rows_d = pq_ops._decode_rotated_onehot(codebooks, codes_s)
        dec = dec.at[owner, slot].set(rows_d.astype(dec.dtype), mode="drop")
    sizes = sizes.at[owner, sc_safe].add(
        jnp.where(sc < kc, 1, 0).astype(sizes.dtype), mode="drop")
    return ids, pq, dec, sizes


@functools.partial(
    jax.jit, donate_argnums=(0, 1, 2, 3),
    static_argnames=("has_dec", "wide"))
def _fused_delete(ids, pq, dec, sizes, src_s, src_r, dst_s, dst_r,
                  live, upd_s, upd_c, upd_val, dels, *, has_dec: bool,
                  wide: bool):
    """Single-dispatch delete epilogue: within-cell compaction (a row
    permutation whose coordinates the host derives from the locate result —
    no row data ever crosses to host), tail clearing, device size update,
    and the surviving-id rank shift, all as ONE donated program. Rows are
    gathered at (src_s, src_r) and scattered to (dst_s, dst_r); `live`
    False clears the destination (compacted tail). Index arrays are
    bucket-padded with dst_r = cap_pad, which drops. `dels` (sorted,
    sentinel-padded) drives the in-program rank shift in value mode; wide
    mode passes dels=None (the host translation renumbers instead) and
    stores slot indices as ids."""
    moved_pq = pq[src_s, src_r]
    pq = pq.at[dst_s, dst_r].set(
        jnp.where(live[:, None], moved_pq, 0), mode="drop")
    if has_dec:
        moved_dec = dec[src_s, src_r]
        dec = dec.at[dst_s, dst_r].set(
            jnp.where(live[:, None], moved_dec, 0), mode="drop")
    if wide:
        new_vals = jnp.where(live, dst_r.astype(ids.dtype), -1)
    else:
        new_vals = jnp.where(live, ids[src_s, src_r], -1)
    ids = ids.at[dst_s, dst_r].set(new_vals, mode="drop")
    if dels is not None:
        ids = jnp.where(ids >= 0, ids - jnp.searchsorted(dels, ids), ids)
    sizes = sizes.at[upd_s, upd_c].set(upd_val)
    return ids, pq, dec, sizes


@functools.partial(jax.jit, donate_argnums=(0,))
def _patch_rows(arr, s_idx, r_idx, vals):
    """In-place (donated) row scatter into a stacked per-shard array.
    Indices are bucket-padded by repeating entry 0 — duplicate writes of an
    identical value are deterministic, so padding is semantics-free."""
    return arr.at[s_idx, r_idx].set(vals)


@functools.partial(jax.jit, donate_argnums=(0,))
def _shift_rows(ids, threshold, delta):
    """Device-side id shift: every live id > threshold moves by delta.
    Padding slots are -1 and unaffected for threshold >= -1 (reference
    _shift_inverse_index!, /root/reference/src/utils.jl:2-20)."""
    return jnp.where(ids > threshold, ids + delta, ids)


@functools.partial(jax.jit, donate_argnums=(0,))
def _pushfront_renumber(ids, sentinel):
    """push_front's id renumbering in one pass: the freshly-appended row
    (tagged with the unused sentinel id n) becomes id 0 and every other
    live id moves up by one (reference pushfirst! shift,
    /root/reference/src/utils.jl:123,140-141)."""
    return jnp.where(ids == sentinel, 0,
                     jnp.where(ids >= 0, ids + 1, ids))


@functools.partial(jax.jit, donate_argnums=(0,))
def _rank_shift_rows(ids, dels):
    """Device-side rank shift after deletions: each surviving id drops by
    the number of deleted ids below it. `dels` is sorted, bucket-padded
    with an above-any-id sentinel (pads never affect the searchsorted)."""
    return jnp.where(ids >= 0, ids - jnp.searchsorted(dels, ids), ids)


@jax.jit
def _locate_rows(ids_arr, targets):
    """Flat positions of the rows holding the given external ids.
    `targets` is sorted + sentinel-padded; returns ONE array — positions
    ascending with -1 fill, then the found-count appended — so callers pay
    a single device->host sync. One device sweep, no host copy of the ids."""
    flat = ids_arr.reshape(-1)
    mask = jnp.isin(flat, targets)
    pos = jnp.nonzero(mask, size=targets.shape[0], fill_value=-1)[0]
    return jnp.concatenate([pos, mask.sum()[None].astype(pos.dtype)])


@jax.jit
def _gather_rows(ids_arr, codes_arr, s_idx, r_idx):
    """Fetch (ids, code rows) at the given per-shard coordinates."""
    return ids_arr[s_idx, r_idx], codes_arr[s_idx, r_idx]


@functools.partial(jax.jit, static_argnames=("mesh", "fill"))
def _regather(arr, gidx, mask, *, mesh, fill):
    """Shard-local CSR re-layout: out[s, j] = arr[s, gidx[s, j]] where
    mask, else fill. Cells never change owner (c % S is fixed), so a
    capacity regrow is a pure per-shard gather — no collectives."""
    def local(a, g, mk):
        out = jnp.take(a[0], g[0], axis=0)
        mexp = mk[0].reshape(mk[0].shape + (1,) * (out.ndim - 1))
        return jnp.where(mexp, out, fill)[None]
    return shard_map(local, mesh=mesh,
                     in_specs=(P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS)),
                     out_specs=P(SHARD_AXIS), check_vma=False)(arr, gidx, mask)


def _pad_bucket(n: int) -> int:
    p = 8
    while p < n:
        p *= 2
    return p


class ShardedIVFADCIndex:
    """Search-serving view of an IVFADCIndex with lists sharded over a mesh.

    Build once from a (host-built or loaded) index:
        mesh = make_mesh(n_shards=8)
        sidx = ShardedIVFADCIndex(idx, mesh)
        ids, dists = sidx.search_padded(queries, k=10, w=8)
    Results are exactly the single-card results (same top-k, merged).
    """

    def __repr__(self) -> str:
        return (f"ShardedIVFADCIndex({self.n_shards} shards x "
                f"{self.mesh.shape[DATA_AXIS]} data, scan_mode="
                f"{self.scan_mode}, {len(self.index)} vectors; "
                f"base: {self.index!r})")

    def memory_stats(self) -> dict:
        """Base-index accounting plus the per-shard device footprint: the
        stacked CSR arrays carry a leading shard axis, so bytes below are
        totals across shards (divide by n_shards for per-device)."""
        out = self.index.memory_stats()
        dev = 0
        for name in ("codes", "ids", "offsets", "sizes"):
            a = self.arrays.get(name)
            if a is not None:
                dev += int(a.size) * a.dtype.itemsize
        # LUT mode aliases arrays["codes"] to shard_pq_codes — don't count
        # the same buffer twice
        if (self.shard_pq_codes is not None
                and self.shard_pq_codes is not self.arrays.get("codes")):
            dev += int(self.shard_pq_codes.size) \
                * self.shard_pq_codes.dtype.itemsize
        out["sharded_device_bytes_total"] = dev
        out["n_shards"] = self.n_shards
        return out

    def __init__(self, index: IVFADCIndex, mesh=None):
        from ivfadc_tpu.config import device_id_cap
        mesh = mesh if mesh is not None else make_mesh()
        # wide-id mode once the index outgrows the device int32 id cap:
        # device arrays carry per-shard slot indices, host carries the
        # slot -> uint64 global-id translation (see partition_store)
        wide = len(index) > device_id_cap()
        parts = partition_store(index.store, mesh.shape[SHARD_AXIS],
                                wide=wide)
        parts["pq_codes"] = parts.pop("codes")
        self._wire(index, mesh, parts, distributed=False)
        # mutation log on the base store so refresh() can patch shard
        # arrays in place after dynamic ops on the host base
        self._mlog = index.store.attach_mutation_log()
        self._last_refresh = "init"

    # ------------------------------------------------------------------ build
    @classmethod
    def build(cls, data, mesh=None, config=None, **kwargs
              ) -> "ShardedIVFADCIndex":
        """Distributed end-to-end build: train + encode + shard WITHOUT ever
        materializing the full index on one host/device (SURVEY §5, §7 M4 —
        the regime where the flat arrays cannot fit a single card). Every
        stage is a shard_map program over the mesh; see parallel/build.py.

        The returned view serves search only; its `.index` is a metadata-only
        base (config + trained quantizers + cell histogram, no payload).
        """
        from ivfadc_tpu.config import IVFADCConfig
        from ivfadc_tpu.parallel.build import build_distributed_parts

        if config is None:
            config = IVFADCConfig(**kwargs)
        elif kwargs:
            raise TypeError("pass either a config or kwargs, not both")
        mesh = mesh if mesh is not None else make_mesh(n_data=1)
        parts, coarse, quantizer, glayout = \
            build_distributed_parts(data, mesh, config)
        base = cls._meta_base(config, coarse, quantizer, glayout,
                              int(data.shape[1]))
        return cls._assemble(base, mesh, parts)

    @classmethod
    def build_streaming(cls, chunks, mesh=None, config=None, *,
                        train_data=None, train_sample: int = 1 << 18,
                        **kwargs) -> "ShardedIVFADCIndex":
        """Out-of-core ingest straight into a sharded serving view: the
        Deep1B regime where the float data exceeds host memory AND the
        index exceeds one card. Composes `IVFADCIndex.build_streaming`
        (reservoir-sampled training + chunk-streamed device encode; only
        the compact (assignments, codes) pair is ever host-resident) with
        per-shard wiring: each device receives ONLY its shard's CSR block,
        and the decoded int8 scan caches are computed shard-wise on device
        from the already-sharded codes — the full decoded cache (the array
        that cannot fit one card) never exists on any single device.

        Unlike `build` (whose base is metadata-only), the compact host
        codes are retained on the base index, so the returned view keeps
        full dynamic-op support (`.index.push/delete` + `refresh()`) and
        single-file persistence. No reference counterpart: the reference
        needs the full d x n matrix resident and is single-process
        (/root/reference/src/index.jl:103, TODO.md:2).
        """
        idx = IVFADCIndex.build_streaming(
            chunks, config, train_data=train_data,
            train_sample=train_sample, _sharded=True, **kwargs)
        return cls(idx, mesh if mesh is not None else make_mesh())

    @classmethod
    def build_from_files(cls, paths, mesh=None, config=None, *,
                         chunk_rows: int = 262144, max_rows=None,
                         train_sample: int = 1 << 18,
                         **kwargs) -> "ShardedIVFADCIndex":
        """`build_streaming` over TEXMEX .fvecs/.bvecs files (multiple
        files concatenate in order, as Deep1B's numbered parts do)."""
        from ivfadc_tpu.utils.datasets import VecsChunks
        return cls.build_streaming(
            VecsChunks(paths, chunk_rows=chunk_rows, max_rows=max_rows),
            mesh, config, train_sample=train_sample, **kwargs)

    @staticmethod
    def _meta_base(config, coarse, quantizer, glayout, dim) -> IVFADCIndex:
        """Metadata-only base index: config + trained quantizers + the global
        cell layout/histogram; the posting payload lives sharded on the mesh."""
        from ivfadc_tpu.models.inverted import PostingStore
        store = PostingStore(
            config.kc, config.m, np.dtype(config.code_dtype),
            offsets=glayout["offsets"], caps=glayout["caps"],
            sizes=glayout["sizes"], codes=None, ids=None)
        return IVFADCIndex(config, coarse, quantizer, store,
                           np.dtype(np.float32), dim)

    @classmethod
    def _assemble(cls, base: IVFADCIndex, mesh, parts) -> "ShardedIVFADCIndex":
        """Assemble a serving view around a payload-free base (distributed
        build / sharded load)."""
        self = object.__new__(cls)
        self._wire(base, mesh, parts, distributed=True)
        return self

    def _wire(self, base: IVFADCIndex, mesh, parts, *, distributed: bool
              ) -> None:
        """Wire stacked per-shard CSR parts (device arrays from the
        distributed build, or host arrays from `partition_store` / a sharded
        load) into this serving view. Shared by `__init__`, `build`, and
        `load_sharded_index`."""
        from ivfadc_tpu.ops import pq as pq_ops
        from ivfadc_tpu.parallel.build import _decode_shard_caches

        quantizer = base.quantizer
        self.index = base
        self.mesh = mesh
        self.n_shards = mesh.shape[SHARD_AXIS]
        self._distributed_build = distributed
        self.scan_mode = base._resolve_scan_mode()
        self.window = parts["window"]
        self.align = parts["align"]
        self.max_cap = parts["max_cap"]
        self.scale = None
        # wide-id mode (ids beyond the device int32 cap): host-side
        # slot -> uint64 global-id translation; device ids are slot indices
        self._trans = parts.get("trans")
        self.wide_ids = self._trans is not None
        if self.wide_ids and jax.process_count() > 1:
            raise NotImplementedError(
                "wide-id mode (ids beyond the device int32 cap) is "
                "single-controller for now: the host-side slot->id "
                "translation would need a per-process exchange on a "
                "multi-host runtime")
        shard_sh = NamedSharding(mesh, P(SHARD_AXIS))
        repl = NamedSharding(mesh, P())

        def _put(arr):
            if isinstance(arr, jax.Array):
                return arr
            if jax.process_count() > 1:
                # per-host restores zero-fill rows of shards they don't
                # own, so the host copies legitimately DIFFER per process —
                # a global device_put would reject that (it asserts
                # cross-process equality). Transfer only the addressable
                # rows and assemble the global array from them.
                bufs = [jax.device_put(arr[idx], d)
                        for d, idx in shard_sh
                        .addressable_devices_indices_map(arr.shape).items()]
                return jax.make_array_from_single_device_arrays(
                    arr.shape, shard_sh, bufs)
            return jax.device_put(arr, shard_sh)

        arrays = {
            "offsets": _put(parts["offsets"]),
            "sizes": _put(parts["sizes"]),
            "ids": _put(parts["ids"]),
        }
        # PQ codes stay resident per shard: they are the LUT-mode scan input
        # and the compact payload for shard-aware persistence
        self.shard_pq_codes = _put(parts["pq_codes"])
        if self.scan_mode == "dense":
            cache = base._resolve_cache()
            scale = pq_ops.cache_scale(quantizer) if cache == "int8" else None
            arrays["codes"] = _decode_shard_caches(
                quantizer.codebooks, self.shard_pq_codes, scale,
                int8=cache == "int8")
            if scale is not None:
                self.scale = jax.device_put(np.asarray(scale), repl)
        else:
            arrays["codes"] = self.shard_pq_codes
        self.arrays = arrays
        self.codebooks = jax.device_put(
            np.asarray(quantizer.codebooks), repl)
        self.rotation = jax.device_put(
            np.asarray(quantizer.rotation), repl)
        self.coarse = jax.tree_util.tree_map(
            lambda a: jax.device_put(np.asarray(a), repl), base.coarse)
        # host snapshot of the per-shard layout, for refresh() patching and
        # the native dynamic ops. Caps come exact from partition_store;
        # otherwise (distributed build / sharded load) they are recovered
        # from the offsets diff — the cumsum layout makes off[c+1] - off[c]
        # the cell's capacity, with the array end bounding the last owner
        # cell.
        off = np.asarray(parts["offsets"], np.int64)
        sizes_h = np.asarray(parts["sizes"], np.int64).copy()
        if jax.process_count() > 1:
            # per-host restores zero-fill the rows of shards a process does
            # not address, but native dynamic ops need the FULL layout on
            # every process (the donated patch programs are SPMD — all
            # processes must compute identical scatter coordinates).
            # Repair by an elementwise max across processes: real entries
            # are >= 0 and zero-fill is 0, so max recovers the owner's
            # values everywhere (the device arrays were always complete —
            # _put assembles them from each process's addressable rows).
            from jax.experimental import multihost_utils
            off = np.asarray(multihost_utils.process_allgather(off)
                             ).max(axis=0)
            sizes_h = np.asarray(multihost_utils.process_allgather(sizes_h)
                                 ).max(axis=0)
        self._h_offsets = off
        self._h_sizes = sizes_h
        if "caps" in parts:
            self._h_caps = np.asarray(parts["caps"], np.int64)
        else:
            total = self.shard_pq_codes.shape[1]
            caps = np.diff(off, axis=1,
                           append=np.full((off.shape[0], 1), total))
            owner = (np.arange(base.config.kc) % self.n_shards)[None, :] \
                == np.arange(self.n_shards)[:, None]
            self._h_caps = np.where(owner, np.maximum(caps, 0), 0)

    def refresh(self) -> None:
        """Bring the shard arrays up to date after dynamic ops (push/delete)
        on the underlying IVFADCIndex.

        Incremental: the base PostingStore logs which cells changed and which
        global id renumberings happened (models/inverted.py mutation log);
        this replays the renumberings as device arithmetic and re-uploads
        only the dirty cells' rows — cost proportional to the touched slots,
        not the index. Falls back to a full re-partition when the log
        overflowed or a cell outgrew its per-shard capacity/window."""
        if self._distributed_build:
            # distributed-built views have no host base to re-snapshot from;
            # their dynamic ops (push/delete/... on THIS view) patch the
            # shard arrays directly and need no refresh
            self._last_refresh = "native"
            return
        store = self.index.store
        log = self._mlog.drain() if getattr(self, "_mlog", None) else None
        if log is None or log["overflow"]:
            self.__init__(self.index, self.mesh)
            self._last_refresh = "full"
            return
        cells, ops = sorted(log["cells"]), log["ops"]
        if not cells and not ops:
            self._last_refresh = "noop"
            return
        S = self.n_shards
        for c in cells:
            if int(store.sizes[c]) > int(self._h_caps[c % S, c]) or \
                    int(store.sizes[c]) > self.window:
                self.__init__(self.index, self.mesh)
                self._last_refresh = "full"
                return
        self._apply_incremental(store, cells, ops)
        self._last_refresh = "incremental"

    def fork(self) -> "ShardedIVFADCIndex":
        """Consistent-snapshot clone for epoch-swap serving (serving.py).

        The native mutation path patches the stacked CSR arrays with
        DONATED scatters (`_patch_rows`), which reuse the input buffers —
        so a reader still holding the pre-mutation arrays would race the
        in-place write. The fork device-copies those arrays (sharding
        preserved), clones the host bookkeeping, and forks the base index;
        replicated components (centroids, codebooks, mesh) are shared.
        Mutations on either side never touch the other's buffers."""
        new = object.__new__(type(self))
        new.__dict__.update(self.__dict__)
        lut_alias = self.shard_pq_codes is self.arrays.get("codes")
        new.arrays = {key: jnp.copy(a) for key, a in self.arrays.items()}
        new.shard_pq_codes = (new.arrays["codes"] if lut_alias
                              else jnp.copy(self.shard_pq_codes))
        new._h_offsets = self._h_offsets.copy()
        new._h_sizes = self._h_sizes.copy()
        new._h_caps = self._h_caps.copy()
        if self._trans is not None:
            new._trans = self._trans.copy()
        new.index = self.index.fork()
        if not self._distributed_build:
            # fresh per-fork mutation log; replay any entries the parent
            # had pending (mutations applied to the base but not yet
            # refreshed into the shard arrays) so the fork starts in sync
            old_log = getattr(self, "_mlog", None)
            new._mlog = new.index.store.attach_mutation_log()
            if old_log is not None and (old_log.overflow or old_log.cells
                                        or old_log.ops):
                new._mlog.cells = set(old_log.cells)
                new._mlog.ops = list(old_log.ops)
                new._mlog.overflow = old_log.overflow
                new.refresh()
        return new

    def _apply_incremental(self, store, cells, ops) -> None:
        S = self.n_shards
        # 1) global id renumberings, in op order (padding slots are -1 and
        #    unaffected: shift only moves ids > threshold >= -1, rank only
        #    ids >= 0) — exactly the base store's _dev_shift/_dev_rank
        #    logic. Wide-id mode replays them on the HOST translation
        #    instead: device ids are slot indices and never renumber.
        if self.wide_ids:
            t = self._trans
            for op in ops:
                live = t != WIDE_NO_ID
                if op[0] == "shift":
                    _, thr, delta = op
                    sel = live & (t.view(np.int64) > thr) if thr >= 0 \
                        else live
                    t[sel] = (t[sel].view(np.int64) + delta).view(np.uint64)
                else:
                    dels = np.asarray(op[1]).astype(np.uint64)
                    t[live] -= np.searchsorted(dels, t[live]) \
                        .astype(np.uint64)
        else:
            ids_arr = self.arrays["ids"]
            for op in ops:
                if op[0] == "shift":
                    _, t, delta = op
                    ids_arr = _shift_rows(ids_arr, jnp.int32(t),
                                          jnp.int32(delta))
                else:
                    dels = jnp.asarray(np.asarray(op[1]), ids_arr.dtype)
                    ids_arr = _rank_shift_rows(ids_arr, dels)
            self.arrays["ids"] = ids_arr
        # 2) dirty cells: scatter current host-truth rows into the owner
        #    shard's slots (covering the old extent so shrunk cells clear)
        s_idx, r_idx, id_vals, code_rows = [], [], [], []
        if cells:
            for c in cells:
                s = c % S
                o_dst = int(self._h_offsets[s, c])
                new_sz = int(store.sizes[c])
                span = max(new_sz, int(self._h_sizes[s, c]))
                if span == 0:    # was empty and still is: nothing to patch
                    continue
                o_src = int(store.offsets[c])
                rows = np.zeros((span, store.m), store.code_dtype)
                idv = np.full(span, -1, np.int64)
                if new_sz:
                    rows[:new_sz] = store._code_rows(
                        np.arange(o_src, o_src + new_sz))
                    if self.wide_ids:
                        # device gets slot indices; globals go to trans
                        idv[:new_sz] = np.arange(o_dst, o_dst + new_sz)
                        self._trans[s, o_dst:o_dst + new_sz] = \
                            store.ids[o_src:o_src + new_sz].astype(np.uint64)
                    else:
                        idv[:new_sz] = store.ids[o_src:o_src + new_sz]
                if self.wide_ids:
                    self._trans[s, o_dst + new_sz:o_dst + span] = WIDE_NO_ID
                s_idx.append(np.full(span, s, np.int32))
                r_idx.append(np.arange(o_dst, o_dst + span, dtype=np.int32))
                id_vals.append(idv)
                code_rows.append(rows)
                self._h_sizes[s, c] = new_sz
        if s_idx:
            self._patch_payload(np.concatenate(s_idx), np.concatenate(r_idx),
                                np.concatenate(id_vals),
                                np.concatenate(code_rows))
            self._upload_sizes()

    def _patch_payload(self, s_np, r_np, id_np, code_np) -> None:
        """Scatter (id, code) rows into the stacked shard arrays at
        coordinates (s_np, r_np), keeping the PQ codes and the dense decoded
        cache in sync. Rows with id -1 clear their slot.
        Bucket-padded so patch sizes hit a handful of jit shapes; the
        donated scatter then updates the big arrays in place instead of
        copying them (an eager .at[].set copies the whole array)."""
        from ivfadc_tpu.ops import pq as pq_ops

        m = self.index.store.m
        pad = _pad_bucket(len(s_np)) - len(s_np)
        if pad:
            s_np = np.concatenate([s_np, np.full(pad, s_np[0])])
            r_np = np.concatenate([r_np, np.full(pad, r_np[0])])
            id_np = np.concatenate([id_np, np.full(pad, id_np[0])])
            code_np = np.concatenate(
                [code_np, np.broadcast_to(code_np[0], (pad, m))])
        s_j = jnp.asarray(s_np, jnp.int32)
        r_j = jnp.asarray(r_np, jnp.int32)
        ids_arr = self.arrays["ids"]
        self.arrays["ids"] = _patch_rows(ids_arr, s_j, r_j,
                                         jnp.asarray(id_np, ids_arr.dtype))
        # PQ codes are the persistence payload for both scan modes
        self.shard_pq_codes = _patch_rows(self.shard_pq_codes, s_j, r_j,
                                          jnp.asarray(code_np))
        if self.scan_mode == "dense":
            quantizer = self.index.quantizer
            if self.scale is not None:
                rows_d = pq_ops.decode_rotated_int8(quantizer, code_np,
                                                    self.scale)
            else:
                rows_d = pq_ops.decode_rotated(quantizer, code_np)
            dec = self.arrays["codes"]
            live = jnp.asarray(id_np >= 0)[:, None]
            rows_d = jnp.where(live, rows_d, 0).astype(dec.dtype)
            self.arrays["codes"] = _patch_rows(dec, s_j, r_j, rows_d)
        else:
            self.arrays["codes"] = self.shard_pq_codes

    def _upload_sizes(self) -> None:
        self.arrays["sizes"] = jax.device_put(
            self._h_sizes.astype(np.int32),
            NamedSharding(self.mesh, P(SHARD_AXIS)))

    # -------------------------------------------------------- dynamic ops
    # The reference supports insertion/deletion on ANY index
    # (/root/reference/src/utils.jl:114,90-105). Host-based views delegate
    # to the base index + incremental refresh; distributed-built / sharded-
    # loaded views (payload-free base) patch the shard arrays natively:
    # encode on device (centroids/codebooks are replicated), scatter rows
    # into the owner shard's CSR block, replay id renumbering device-side.
    #
    # Multi-host: native ops follow the SPMD contract every other entry
    # point uses — EVERY process calls the same mutation with the same
    # data. Encoding runs on replicated components (identical results
    # everywhere), the host-side slot math is process-invariant, the
    # donated patch/renumber programs are global SPMD computations each
    # process enters identically, and every host fetch of device state
    # goes through `_host` (replicate-then-read). A 2-process gloo test
    # (tests/test_multiprocess.py::test_two_process_native_dynamic_ops)
    # pins this against a single-process twin.

    def _ensure_id_headroom(self, extra: int) -> None:
        """Before appending `extra` points: enforce the index_dtype capacity
        law (/root/reference/src/utils.jl:134-135), and switch to wide-id
        mode when the append would cross the device int32 id cap while the
        dtype still has headroom — the reference's full UInt64 capacity."""
        from ivfadc_tpu.config import DTYPE_TO_BITS, device_id_cap
        bits = DTYPE_TO_BITS[self.index.config.index_dtype]
        n_after = len(self.index) + extra
        if n_after > (1 << bits):
            raise AssertionError(
                f"Index would exceed capacity for dtype "
                f"{self.index.config.index_dtype} ({1 << bits} vectors)")
        if self.wide_ids or n_after <= device_id_cap():
            return
        if (1 << bits) <= device_id_cap():
            raise AssertionError(
                f"Index would exceed capacity for dtype "
                f"{self.index.config.index_dtype} "
                f"({device_id_cap()} vectors)")
        self._upgrade_to_wide()

    def _upgrade_to_wide(self) -> None:
        """Value-mode -> wide-id-mode switch: snapshot the current device
        global ids into the host slot -> uint64 translation and rewrite the
        device id arrays to per-shard slot indices. One-way (a wide view
        never narrows back; saving + loading preserves wideness)."""
        if jax.process_count() > 1:
            raise NotImplementedError(
                "wide-id upgrade is single-controller; on a multi-host "
                "runtime rebuild via ShardedIVFADCIndex.build")
        S, cap_pad = self.arrays["ids"].shape
        trans = np.full((S, cap_pad), WIDE_NO_ID, np.uint64)
        if self._distributed_build:
            ids_h = np.asarray(self.arrays["ids"])
            live = ids_h >= 0
            trans[live] = ids_h[live].astype(np.uint64)
        else:
            # host truth (the base store) carries the global ids; map them
            # through the same row-move math partition_store used
            from ivfadc_tpu.parallel.persistence import _row_moves
            store = self.index.store
            sz = np.asarray(store.sizes, np.int64)
            if sz.sum():
                cell_rep, within = _row_moves(sz)
                s_rep = (cell_rep % S).astype(np.int64)
                dst = self._h_offsets[s_rep, cell_rep] + within
                src = np.asarray(store.offsets, np.int64)[cell_rep] + within
                trans[s_rep, dst] = store.ids[src].astype(np.uint64)
            live = trans != WIDE_NO_ID
        slot_ids = np.where(
            live, np.arange(cap_pad, dtype=np.int64)[None, :], -1)
        self.arrays["ids"] = jax.device_put(
            slot_ids.astype(np.int32), NamedSharding(self.mesh,
                                                     P(SHARD_AXIS)))
        self._trans = trans
        self.wide_ids = True

    def _encode_device(self, points: np.ndarray):
        """Nearest cell + PQ codes for a batch, on device — the same
        assignment/encode the base index uses for push (reference
        _encode_point, /root/reference/src/utils.jl:148-161). Results STAY
        on device (the fused append consumes them there); only the caller
        fetches cells, once, for host bookkeeping."""
        from ivfadc_tpu.ops import pq as pq_ops
        q = jnp.asarray(points, jnp.float32)
        cells, _ = self.coarse.search(q, 1)
        cells = cells[:, 0].astype(jnp.int32)
        resid = q - self.coarse.centroids[cells]
        codes = pq_ops.encode(self.index.quantizer, resid,
                              metric=self.index.quant_metric)
        return cells, codes

    def push(self, point) -> None:
        """Append with id = n (reference push!,
        /root/reference/src/utils.jl:114). Works on host-based AND
        distributed-built views."""
        self._ensure_id_headroom(1)
        if not self._distributed_build:
            self.index.push(point)
            self.refresh()
            return
        self.index._check_push(np.asarray(point, np.float32))
        self._native_append(np.asarray(point, np.float32)[None],
                            np.asarray([len(self.index)], np.int64))

    def push_batch(self, points) -> None:
        """Append many points (ids n..n+B-1), like IVFADCIndex.push_batch."""
        points = np.asarray(points, np.float32)
        if points.ndim != 2 or points.shape[1] != self.index.dim:
            raise AssertionError(
                f"push_batch expects (B, {self.index.dim}) points, "
                f"got {points.shape}")
        self._ensure_id_headroom(len(points))
        if not self._distributed_build:
            self.index.push_batch(points)
            self.refresh()
            return
        if len(points) == 0:        # no-op, like the host-based path
            return
        n0 = len(self.index)
        self._native_append(
            points, np.arange(n0, n0 + len(points), dtype=np.int64))

    def push_front(self, point) -> None:
        """Insert with id = 0, shifting every live id up by one
        (reference pushfirst!, /root/reference/src/utils.jl:123,140-141)."""
        self._ensure_id_headroom(1)
        if not self._distributed_build:
            self.index.push_front(point)
            self.refresh()
            return
        self.index._check_push(np.asarray(point, np.float32))
        # append FIRST with the (unused) sentinel id n, then renumber in one
        # pass (sentinel -> 0, everyone else +1): if the append fails
        # mid-way (regrow OOM, device error) no id has shifted yet, so the
        # view stays usable — the advisor-flagged partial-state window
        n = len(self.index)
        self._native_append(np.asarray(point, np.float32)[None],
                            np.asarray([n], np.int64))
        if self.wide_ids:
            # device ids are slots — the renumber is pure host arithmetic
            live = self._trans != WIDE_NO_ID
            t = self._trans
            t[live] = np.where(t[live] == np.uint64(n), np.uint64(0),
                               t[live] + np.uint64(1))
        else:
            self.arrays["ids"] = _pushfront_renumber(self.arrays["ids"],
                                                     jnp.int32(n))

    def pop(self) -> np.ndarray:
        """Remove & reconstruct the last-inserted point (id n-1)
        (reference pop!, /root/reference/src/utils.jl:29,41-68)."""
        if not self._distributed_build:
            out = self.index.pop()
            self.refresh()
            return out
        n = len(self.index)
        if n == 0:
            raise IndexError("pop from empty index")
        cell, codes = self._fetch_by_id(n - 1)
        self._native_delete(np.asarray([n - 1], np.int64))
        return self.index._reconstruct_from(cell, codes)

    def pop_front(self) -> np.ndarray:
        """Remove & reconstruct id 0, shifting all ids down by one
        (reference popfirst!, /root/reference/src/utils.jl:37)."""
        if not self._distributed_build:
            out = self.index.pop_front()
            self.refresh()
            return out
        if len(self.index) == 0:
            raise IndexError("pop from empty index")
        cell, codes = self._fetch_by_id(0)
        # _native_delete's rank shift IS the popfirst shift: every id > 0
        # drops by exactly one
        self._native_delete(np.zeros(1, np.int64))
        return self.index._reconstruct_from(cell, codes)

    def delete(self, ids) -> None:
        """Delete by 0-based ids; surviving ids shift down to stay the
        contiguous range {0..n'-1} (reference delete_from_index!,
        /root/reference/src/utils.jl:90-105)."""
        if not self._distributed_build:
            self.index.delete(ids)
            self.refresh()
            return
        dels = np.unique(np.asarray(list(ids), np.int64))
        self._native_delete(dels)

    def reconstruct(self, ext_id: int) -> np.ndarray:
        """Decode the stored approximation of a point (non-destructive)."""
        if not self._distributed_build:
            return self.index.reconstruct(ext_id)
        cell, codes = self._fetch_by_id(int(ext_id))
        return self.index._reconstruct_from(cell, codes)

    def _slot_to_cell(self, shard: int, slot: int) -> int:
        """Owning cell of a per-shard slot: offsets are a cumsum layout,
        so the owner is the last cell whose offset is <= slot (zero-cap
        non-owner cells share boundaries and never win)."""
        return int(np.searchsorted(self._h_offsets[shard], slot,
                                   side="right") - 1)

    def _fetch_by_id(self, ext_id: int):
        """(cell, code row) for one external id, straight off the shards."""
        if self.wide_ids:
            hits = np.nonzero(self._trans == np.uint64(ext_id))
            if len(hits[0]) != 1:
                raise KeyError(f"id {ext_id} not present in the index")
            s, slot = int(hits[0][0]), int(hits[1][0])
        else:
            pad = 8
            targets = np.full(pad, 2**31 - 1, np.int64)
            targets[0] = ext_id
            loc = self._host(_locate_rows(
                self.arrays["ids"],
                jnp.asarray(targets, self.arrays["ids"].dtype)))
            if int(loc[-1]) != 1:
                raise KeyError(f"id {ext_id} not present in the index")
            p = int(loc[0])
            cap_pad = self.arrays["ids"].shape[1]
            s, slot = divmod(p, cap_pad)
        idx = jnp.full(8, s, jnp.int32), jnp.full(8, slot, jnp.int32)
        _, rows = _gather_rows(self.arrays["ids"], self.shard_pq_codes,
                               *idx)
        return self._slot_to_cell(s, slot), self._host(rows)[0].copy()

    def _native_append(self, points: np.ndarray,
                       new_ids: np.ndarray) -> None:
        """Encode + scatter freshly-pushed rows into the owner shards' CSR
        tails: device encode (async dispatches), ONE host sync (the cells
        fetch, needed for capacity checks and size bookkeeping), then one
        fused donated program doing slot computation + row scatter (ids,
        PQ codes, decoded cache) + device size update."""
        store = self.index.store
        kc, S = store.kc, self.n_shards
        B = len(points)
        Bp = _pad_bucket(B)
        pts = np.pad(np.asarray(points, np.float32), ((0, Bp - B), (0, 0)))
        cells_d, codes_d = self._encode_device(pts)
        cells = self._host(cells_d)[:B].astype(np.int64)   # the one sync
        counts = np.bincount(cells, minlength=kc).astype(np.int64)
        new_sizes = store.sizes + counts
        allc = np.arange(kc)
        owners = allc % S
        if (bool(np.any(new_sizes > self._h_caps[owners, allc]))
                or bool(np.any(new_sizes > store.caps))
                or int(new_sizes.max(initial=0)) > self.window):
            self._regrow_distributed(new_sizes)
        has_dec = self.scan_mode == "dense"
        int8_cache = self.scale is not None
        dec_in = self.arrays["codes"] if has_dec \
            else jnp.zeros((1, 1, 1), jnp.int8)
        scale_in = self.scale if int8_cache else jnp.zeros(1, jnp.float32)
        ids_pad = np.zeros(Bp, np.int64)
        ids_pad[:B] = new_ids
        ids_new, pq_new, dec_new, sizes_new = _fused_append(
            self.codebooks, scale_in, self.arrays["ids"],
            self.shard_pq_codes, dec_in, self.arrays["sizes"],
            self.arrays["offsets"], cells_d, codes_d,
            jnp.asarray(ids_pad, jnp.int32), jnp.int32(B),
            wide=self.wide_ids, has_dec=has_dec, int8_cache=int8_cache)
        self.arrays["ids"] = ids_new
        self.shard_pq_codes = pq_new
        self.arrays["codes"] = dec_new if has_dec else pq_new
        self.arrays["sizes"] = sizes_new
        if self.wide_ids:
            # host translation at the same coordinates the program used —
            # identical stable-sort slot math, replayed in numpy
            order = np.argsort(cells, kind="stable")
            sc = cells[order]
            within = np.arange(len(sc)) - np.searchsorted(sc, sc)
            s_idx = (sc % S).astype(np.int64)
            r_idx = self._h_offsets[s_idx, sc] + store.sizes[sc] + within
            self._trans[s_idx, r_idx] = new_ids[order].astype(np.uint64)
        store.sizes = new_sizes
        self._h_sizes[owners, allc] = new_sizes

    def _native_delete(self, dels: np.ndarray) -> None:
        """Remove rows by external id: compact each dirty cell in place
        (survivors keep order), then rank-shift every surviving id. In
        wide-id mode the locate and the rank shift are pure host work on
        the translation (device ids are slot indices and never renumber)."""
        store = self.index.store
        n = len(self.index)
        if dels.size == 0:
            return
        if int(dels[0]) < 0 or int(dels[-1]) >= n:
            raise IndexError(
                f"delete ids must be within [0, {n}), got "
                f"[{int(dels[0])}, {int(dels[-1])}]")
        D = len(dels)
        Dp = _pad_bucket(D)
        dels_p = np.concatenate(
            [dels, np.full(Dp - D, np.int64(2**31 - 1))])
        ids_dt = self.arrays["ids"].dtype
        cap_pad = self.arrays["ids"].shape[1]
        if self.wide_ids:
            dels_u = dels.astype(np.uint64)
            s_all, slot_all = np.nonzero(np.isin(self._trans, dels_u))
            if len(s_all) != D:
                raise KeyError(
                    f"only {len(s_all)}/{D} of the requested ids are present")
            s_all = s_all.astype(np.int64)
            slot_all = slot_all.astype(np.int64)
        else:
            loc = self._host(_locate_rows(self.arrays["ids"],
                                          jnp.asarray(dels_p, ids_dt)))
            found = int(loc[-1])
            if found != D:
                raise KeyError(
                    f"only {found}/{D} of the requested ids are present")
            pos = loc[:D].astype(np.int64)
            s_all = pos // cap_pad
            slot_all = pos % cap_pad
        cells_all = np.empty(D, np.int64)
        for s in np.unique(s_all):
            mk = s_all == s
            cells_all[mk] = np.searchsorted(
                self._h_offsets[s], slot_all[mk], side="right") - 1
        dirty = np.unique(cells_all)
        # host-derived within-cell compaction permutation: for each dirty
        # cell, survivors move to the front (order preserved) and the tail
        # clears — only COORDINATES are computed here; the row data moves
        # entirely on device in the fused program below
        src_l, dst_l, s_l, live_l = [], [], [], []
        upd_s, upd_c, upd_val = [], [], []
        for c in dirty:
            s, sz = int(c) % self.n_shards, int(store.sizes[c])
            off = int(self._h_offsets[s, c])
            span = np.arange(off, off + sz, dtype=np.int64)
            hit_here = slot_all[(s_all == s) & (cells_all == c)]
            deleted = np.isin(span, hit_here)
            keep = ~deleted
            kcnt = int(keep.sum())
            src_l.append(np.concatenate([span[keep], span[:sz - kcnt]]))
            dst_l.append(span)
            s_l.append(np.full(sz, s, np.int64))
            live_l.append(np.concatenate(
                [np.ones(kcnt, bool), np.zeros(sz - kcnt, bool)]))
            upd_s.append(s)
            upd_c.append(int(c))
            upd_val.append(kcnt)
            if self.wide_ids:
                span_gids = self._trans[s, span]
                self._trans[s, off:off + kcnt] = span_gids[keep]
                self._trans[s, off + kcnt:off + sz] = WIDE_NO_ID
            store.sizes[c] = kcnt
            self._h_sizes[s, c] = kcnt
        src = np.concatenate(src_l)
        dst = np.concatenate(dst_l)
        ss = np.concatenate(s_l)
        live = np.concatenate(live_l)
        n_rows = len(src)
        padN = _pad_bucket(n_rows) - n_rows
        if padN:
            # pads: gather row 0 (junk, dropped) and scatter out of range
            src = np.concatenate([src, np.zeros(padN, np.int64)])
            dst = np.concatenate([dst, np.full(padN, cap_pad, np.int64)])
            ss = np.concatenate([ss, np.zeros(padN, np.int64)])
            live = np.concatenate([live, np.zeros(padN, bool)])
        padU = _pad_bucket(len(upd_s)) - len(upd_s)
        upd_s += [upd_s[0]] * padU            # idempotent repeat
        upd_c += [upd_c[0]] * padU
        upd_val += [upd_val[0]] * padU
        has_dec = self.scan_mode == "dense"
        dec_in = self.arrays["codes"] if has_dec \
            else jnp.zeros((1, 1, 1), jnp.int8)
        ids_new, pq_new, dec_new, sizes_new = _fused_delete(
            self.arrays["ids"], self.shard_pq_codes, dec_in,
            self.arrays["sizes"],
            jnp.asarray(ss, jnp.int32), jnp.asarray(src, jnp.int32),
            jnp.asarray(ss, jnp.int32), jnp.asarray(dst, jnp.int32),
            jnp.asarray(live),
            jnp.asarray(np.asarray(upd_s), jnp.int32),
            jnp.asarray(np.asarray(upd_c), jnp.int32),
            jnp.asarray(np.asarray(upd_val), jnp.int32),
            None if self.wide_ids else jnp.asarray(dels_p, ids_dt),
            has_dec=has_dec, wide=self.wide_ids)
        self.arrays["ids"] = ids_new
        self.shard_pq_codes = pq_new
        self.arrays["codes"] = dec_new if has_dec else pq_new
        self.arrays["sizes"] = sizes_new
        if self.wide_ids:
            # surviving ids shift down past the deleted ranks — pure host
            # arithmetic on the translation
            t = self._trans
            live_t = t != WIDE_NO_ID
            t[live_t] -= np.searchsorted(dels_u, t[live_t]) \
                .astype(np.uint64)

    def _regrow_distributed(self, new_sizes: np.ndarray) -> None:
        """Re-layout the per-shard CSR blocks for a grown cell histogram.
        Ownership (c % S) never changes, so the move is a pure shard-local
        gather; the decoded scan caches are recomputed device-side by
        _wire. Amortized: caps grow by at least 1.5x the new sizes."""
        store = self.index.store
        cfg = self.index.config
        kc, S, a = store.kc, self.n_shards, max(int(self.align), 8)
        cells = np.arange(kc)
        owners = cells % S
        grow = max(float(cfg.cell_slack), 1.5)
        sizes_per_new = np.zeros((S, kc), np.int64)
        sizes_per_new[owners, cells] = new_sizes
        want = np.ceil(sizes_per_new * grow).astype(np.int64) + 8
        caps_per = np.where(sizes_per_new > 0,
                            np.maximum(a, ((want + a - 1) // a) * a), 0)
        offsets_per = np.zeros((S, kc), np.int64)
        np.cumsum(caps_per[:, :-1], axis=1, out=offsets_per[:, 1:])
        cap_pad = _round_up(
            int((offsets_per[:, -1] + caps_per[:, -1]).max()), _LANE)
        # gather maps for the CURRENT rows (pre-append truth)
        gidx = np.zeros((S, cap_pad), np.int32)
        mask = np.zeros((S, cap_pad), bool)
        from ivfadc_tpu.parallel.persistence import _row_moves
        cur_sizes = np.asarray(store.sizes, np.int64)
        tot = int(cur_sizes.sum())
        if tot:
            cell_rep, within = _row_moves(cur_sizes)
            s_rep = cell_rep % S
            src = self._h_offsets[s_rep, cell_rep] + within
            dst = offsets_per[s_rep, cell_rep] + within
            gidx[s_rep, dst] = src
            mask[s_rep, dst] = True
        shard_sh = NamedSharding(self.mesh, P(SHARD_AXIS))
        g = jax.device_put(gidx, shard_sh)
        mk = jax.device_put(mask, shard_sh)
        new_codes = _regather(self.shard_pq_codes, g, mk,
                              mesh=self.mesh, fill=0)
        trans_new = None
        if self.wide_ids:
            # device ids are slot indices: the re-laid-out pattern is known
            # host-side (mask == live rows), and the uint64 translation
            # moves with the rows — no device gather for either
            new_ids = jax.device_put(
                np.where(mask, np.arange(cap_pad, dtype=np.int64)[None, :],
                         -1).astype(np.int32), shard_sh)
            trans_new = np.full((S, cap_pad), WIDE_NO_ID, np.uint64)
            if tot:
                trans_new[s_rep, dst] = self._trans[s_rep, src]
        else:
            new_ids = _regather(self.arrays["ids"], g, mk,
                                mesh=self.mesh, fill=-1)
        # global single-store-equivalent layout must keep holding the grown
        # sizes too (save/consolidate/reshard derive from it)
        g_want = np.ceil(new_sizes * grow).astype(np.int64) + 8
        g_caps = np.maximum(a, ((g_want + a - 1) // a) * a)
        g_off = np.zeros(kc, np.int64)
        np.cumsum(g_caps[:-1], out=g_off[1:])
        store.caps = g_caps
        store.offsets = g_off
        sizes_per_cur = np.zeros((S, kc), np.int64)
        sizes_per_cur[owners, cells] = cur_sizes
        parts = dict(
            offsets=offsets_per.astype(np.int32),
            sizes=sizes_per_cur.astype(np.int32),
            caps=caps_per,
            pq_codes=new_codes,
            ids=new_ids,
            window=_round_up(max(1, int(new_sizes.max(initial=0))), _LANE),
            align=self.align,
            max_cap=int(caps_per.max(initial=0)),
        )
        if trans_new is not None:
            parts["trans"] = trans_new
        self._wire(self.index, self.mesh, parts, distributed=True)

    def _dispatch(self, queries, k: int, w: int, overlap: bool
                  ) -> Tuple[jax.Array, jax.Array, int]:
        """Pad + place one query wave and launch the sharded search; returns
        DEVICE arrays (async) so callers can pipeline waves."""
        if k < 1:
            raise AssertionError("k has to be >= 1")
        if w < 1:
            raise AssertionError("w has to be >= 1")
        dense = self.scan_mode == "dense"
        cfg = self.index.config
        w = min(w, cfg.kc)
        on_device = isinstance(queries, jax.Array)
        if not on_device:
            queries = np.asarray(queries, np.float32)
        B = queries.shape[0]
        n_data = self.mesh.shape[DATA_AXIS]
        Bp = _bucket_batch(max(B, n_data))
        Bp = ((Bp + n_data - 1) // n_data) * n_data
        if on_device:
            # keep device-resident queries on device (resharding is
            # device-side)
            q = jnp.pad(queries.astype(jnp.float32), ((0, Bp - B), (0, 0)))
        else:
            q = np.pad(queries, ((0, Bp - B), (0, 0)))
        q = jax.device_put(q, NamedSharding(self.mesh, P(DATA_AXIS)))
        include_base = (cfg.score_mode == "reference"
                        or not self.index.quant_metric.residual_based)
        out = _sharded_search_impl(
            self.coarse, self.codebooks, self.rotation,
            self.arrays["offsets"], self.arrays["sizes"],
            self.arrays["codes"] if dense else self.shard_pq_codes,
            self.arrays["ids"], self.scale, q,
            mesh=self.mesh, k=k, w=w, window=self.window,
            metric=self.index.quant_metric, include_base=include_base,
            apply_rot=self.index.quantizer.method == "opq",
            residual_based=self.index.quant_metric.residual_based,
            dense=dense, overlap=overlap, with_pos=self.wide_ids)
        if self.wide_ids:
            return out[0], out[2], out[1], B
        return out[0], None, out[1], B

    def _translate_wide(self, slots: np.ndarray, shards: np.ndarray
                        ) -> np.ndarray:
        """Wide-id epilogue: (per-shard slot, shard) winner coordinates ->
        uint64 global ids via the host translation. Empty results (slot -1)
        become WIDE_NO_ID pads (the uint64 analogue of the -1 pad)."""
        out = np.full(slots.shape, WIDE_NO_ID, np.uint64)
        valid = slots >= 0
        out[valid] = self._trans[shards[valid], slots[valid]]
        return out

    def _valid_rows(self, ids: np.ndarray) -> np.ndarray:
        """Pad mask for one padded result row (wide mode pads with
        WIDE_NO_ID instead of -1)."""
        return ids != WIDE_NO_ID if self.wide_ids else ids >= 0

    def search(self, points, k: int, w: int = 1):
        """knn_search parity over the sharded view — same contract as
        `IVFADCIndex.search` (/root/reference/src/index.jl:204-273): single
        point (d,) -> trimmed (ids, dists); batch -> lists per query. Makes
        the top-level `knn_search(index, ...)` free function work on plain
        and sharded indexes alike."""
        pts = np.asarray(points if not isinstance(points, (list, tuple))
                         else np.stack([np.asarray(p) for p in points]))
        single = pts.ndim == 1
        if single:
            pts = pts[None, :]
        if pts.shape[1] != self.index.dim:
            raise AssertionError(
                f"query dimension {pts.shape[1]} != index dimension "
                f"{self.index.dim}")
        out_dtype = pts.dtype if np.issubdtype(pts.dtype, np.floating) \
            else np.float32
        ids, dists = self.search_padded(pts, k, w=w)
        id_dtype = np.dtype(self.index.config.index_dtype)
        if single:
            m = self._valid_rows(ids[0])
            return ids[0][m].astype(id_dtype), dists[0][m].astype(out_dtype)
        out_i, out_d = [], []
        for row_i, row_d in zip(ids, dists):
            m = self._valid_rows(row_i)
            out_i.append(row_i[m].astype(id_dtype))
            out_d.append(row_d[m].astype(out_dtype))
        return out_i, out_d

    def search_padded(self, queries: np.ndarray, k: int, w: int = 1, *,
                      overlap: bool = False
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """One blocking wave. `overlap=False` (default) keeps bit-parity
        with the single-card path; `overlap=True` double-buffers the
        cross-shard merge, which changes float accumulation grouping and so
        drifts within cache-quantization noise (~1e-3 relative) — the
        throughput-oriented `search_stream` turns it on by default.

        Wide-id mode returns uint64 ids padded with WIDE_NO_ID (2^64-1);
        otherwise int32 ids padded with -1, like the single-card path."""
        ids, shards, dists, B = self._dispatch(queries, k, w, overlap)
        ids_h = self._host(ids)[:B]
        if self.wide_ids:
            ids_h = self._translate_wide(ids_h, self._host(shards)[:B])
        return ids_h, self._host(dists)[:B]

    def _host(self, arr: jax.Array) -> np.ndarray:
        """Host-fetch a search output. Under a real multi-process runtime
        the result is sharded over the data axis across processes, so a
        plain np.asarray would touch non-addressable shards — replicate
        first (one cross-process all_gather); single-process fetches
        directly."""
        if jax.process_count() > 1:
            rep = getattr(self, "_replicator", None)
            if rep is None:
                # one cached jitted identity per view — a fresh lambda per
                # fetch would recompile the all_gather on every call
                rep = jax.jit(lambda x: x,
                              out_shardings=NamedSharding(self.mesh, P()))
                self._replicator = rep
            arr = rep(arr)
        return np.asarray(arr)

    def search_stream(self, queries, k: int, w: int = 1, *,
                      batch: int = 16384, overlap: bool = True
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """Throughput search over a large query set: waves dispatched
        back-to-back WITHOUT blocking, so wave i+1's per-shard scan runs
        while wave i's cross-shard gather+merge completes — the Python-level
        half of the overlapped merge (the in-program half is `overlap`,
        see _sharded_search_impl). Mirrors IVFADCIndex.search_stream."""
        queries = np.asarray(queries, np.float32) \
            if not hasattr(queries, "devices") else queries
        n = queries.shape[0]
        if n == 0:
            return (np.empty((0, k), np.int32), np.empty((0, k), np.float32))
        outs = [self._dispatch(queries[s:s + batch], k, w, overlap)
                for s in range(0, n, batch)]
        if self.wide_ids:
            ids = np.concatenate([
                self._translate_wide(self._host(i)[:b], self._host(sh)[:b])
                for i, sh, _, b in outs])
        else:
            ids = np.concatenate([self._host(i)[:b]
                                  for i, _, _, b in outs])
        dists = np.concatenate([self._host(d)[:b] for _, _, d, b in outs])
        return ids, dists
