"""Flat padded-CSR posting storage.

The reference stores postings as `Vector{InvertedList}` — per-cell parallel
arrays of ids and per-point code vectors (/root/reference/src/index.jl:8-23).
Pointer-chasing structures don't map to an accelerator, so here all postings
live in two flat arrays:

    codes : (total_cap, m)  uint8/16/32 — PQ codes, cell-major
    ids   : (total_cap,)    int64       — external 0-based positional ids,
                                          -1 in unused (padding) slots

with cell c owning the slot range [offsets[c], offsets[c] + caps[c]) of which
the first sizes[c] slots are live. Per-cell slack (capacity > size) gives O(1)
dynamic `push`; a cell that fills up is regrown (amortized O(total)).

Mutation happens host-side in NumPy (dynamic ops are control-plane work); the
device view used by jitted search is cached and invalidated on mutation.
`window` — the static gather width used by search — is max(caps) rounded up
to a lane multiple so shape churn (recompiles) is rare.

Id semantics are positional, exactly like the reference (SURVEY §2.3): live
external ids always form {0..n-1}; delete/pushfirst shift neighbors
(/root/reference/src/utils.jl:2-20).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

_LANE = 128


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def jnp_where_shift(ids, threshold: int, delta: int):
    import jax.numpy as jnp
    return jnp.where(ids > threshold, ids + delta, ids)


class MutationLog:
    """Per-consumer record of store mutations since the last drain: dirty
    cells plus the ordered global-id renumbering ops. Once either bound is
    exceeded the log collapses to a bare overflow flag (a full re-partition
    is cheaper than replaying that much churn) and stops accumulating, so an
    undrained log costs O(1) however long the workload runs."""

    __slots__ = ("cells", "ops", "overflow", "_kc", "__weakref__")

    def __init__(self, kc: int):
        self._kc = kc
        self._reset()

    def _reset(self) -> None:
        self.cells: set = set()
        self.ops: list = []
        self.overflow = False

    def _overflowed(self) -> None:
        self.overflow = True
        self.cells = set()
        self.ops = []

    def log_cell(self, cell: int) -> None:
        if self.overflow:
            return
        self.cells.add(cell)
        if len(self.cells) > max(64, self._kc // 4):
            self._overflowed()   # beyond this a re-partition is cheaper

    def log_op(self, op) -> None:
        if self.overflow:
            return
        self.ops.append(op)
        if len(self.ops) > 1024:
            self._overflowed()

    def drain(self) -> dict:
        """-> {"cells": set, "ops": [("shift", t, d) | ("rank", dels)],
        "overflow": bool} and reset."""
        out = dict(cells=self.cells, ops=self.ops, overflow=self.overflow)
        self._reset()
        return out


class PostingStore:
    def __init__(self, kc: int, m: int, code_dtype: np.dtype, *,
                 offsets: np.ndarray, caps: np.ndarray, sizes: np.ndarray,
                 codes: Optional[np.ndarray], ids: Optional[np.ndarray],
                 codes_dev=None, ids_dev=None):
        self.kc = kc
        self.m = m
        self.code_dtype = np.dtype(code_dtype)
        self.offsets = offsets       # (kc,) int64
        self.caps = caps             # (kc,) int64
        self.sizes = sizes           # (kc,) int64
        # cell capacity/offset alignment in rows (8 for stores built here;
        # 128 in some older saves). Derived, so it survives save/load via
        # `caps`; `_grow_cell` keeps it.
        self.align = 128 if (len(caps) and (caps % 128 == 0).all()
                             and (offsets % 128 == 0).all()) else 8
        # host flat arrays — may start as None after a device-side build
        # (only dynamic ops and save need the host copy, so it hydrates
        # lazily)
        self._codes_h = codes        # (total_cap, m) code_dtype | None
        self._ids_h = ids            # (total_cap,) int64, -1 = empty | None
        self._codes_dev = codes_dev  # device arrays from build_device
        self._ids_dev = ids_dev
        self._codes_ov: Dict[int, np.ndarray] = {}  # slot -> written code row
                                                    # (device-truth mode only)
        self._device: Optional[Dict] = None
        self._device_dense: Optional[Dict] = None
        self._dirty_slots: set = set()
        # id -> slot map for O(1) find(); built lazily, maintained
        # incrementally by append/remove/shift, rebuilt after bulk renumbers
        self._slot_of: Optional[np.ndarray] = None
        # cells sorted by offset for slot -> cell lookup (offsets become
        # unsorted once a grown cell relocates to the end of the arrays)
        self._cell_order: Optional[np.ndarray] = None
        # mutation logs for incremental shard refresh (ShardedIVFADCIndex):
        # dirty cells re-extract from host truth; global id renumberings
        # (shift / rank-subtract) replay as device arithmetic. Each sharded
        # view attaches its OWN log (attach_mutation_log) so several views
        # over one store stay independently consistent; the store holds only
        # weak references, so a discarded view's log stops costing anything.
        import weakref
        self._mlogs: "weakref.WeakSet[MutationLog]" = weakref.WeakSet()

    # ---- host views ----
    # After a device-side build the flat arrays live on device only. Ids
    # hydrate on the first dynamic op (they're the id-semantics truth and
    # small); codes stay device-resident with a host-side OVERLAY of written
    # rows — full codes hydration happens only for save/introspection/bulk
    # deletes.
    @property
    def has_payload(self) -> bool:
        """False for a metadata-only store (distributed build): the cell
        layout/histogram exists but codes/ids live sharded on the mesh."""
        return not (self._codes_h is None and self._codes_dev is None)

    def __repr__(self) -> str:
        # InvertedList show parity (/root/reference/src/index.jl:12-15),
        # for the whole flat store; never hydrates device arrays
        return (f"PostingStore({self.kc} cells, m={self.m}, "
                f"{self.code_dtype.name} codes), {int(self.sizes.sum())} "
                f"vectors" + ("" if self.has_payload else " [metadata-only]"))

    @property
    def codes(self) -> np.ndarray:
        if self._codes_h is None:
            if self._codes_dev is None:
                raise RuntimeError(
                    "metadata-only PostingStore (distributed build) has no "
                    "host payload — search/save through the sharded view")
            # np.asarray of a device buffer is read-only — copy, mutators
            # write in place
            self._codes_h = np.array(self._codes_dev)
            if self._codes_ov:
                for slot, row in self._codes_ov.items():
                    self._codes_h[slot] = row
                self._codes_ov = {}
                self._codes_dev = None   # overlay applied: host is truth now
        return self._codes_h

    @property
    def ids(self) -> np.ndarray:
        if self._ids_h is None:
            if self._ids_dev is None:
                raise RuntimeError(
                    "metadata-only PostingStore (distributed build) has no "
                    "host payload — search/save through the sharded view")
            self._ids_h = np.asarray(self._ids_dev).astype(np.int64)
        return self._ids_h

    def _ids_mut(self) -> np.ndarray:
        """Host ids for writing — once written, the device build-time ids
        array is stale and must not seed future views."""
        out = self.ids
        self._ids_dev = None
        return out

    def _code_rows(self, slots: np.ndarray) -> np.ndarray:
        """Code rows for the given slots without full hydration: one device
        gather for the misses + overlay/host hits."""
        slots = np.asarray(slots, np.int64)
        if self._codes_h is not None:
            return self._codes_h[slots]
        rows = np.empty((len(slots), self.m), self.code_dtype)
        miss = []
        for i, s in enumerate(slots):
            row = self._codes_ov.get(int(s))
            if row is None:
                miss.append(i)
            else:
                rows[i] = row
        if miss:
            import jax.numpy as jnp
            midx = self._pad_shape_bucket(slots[miss])  # stable shapes
            rows[miss] = np.asarray(
                self._codes_dev[jnp.asarray(midx)])[:len(miss)]
        return rows

    def _prefetch_code_rows(self, slots: np.ndarray) -> None:
        """Pull the given rows into the overlay with ONE device gather so a
        following loop of single-row reads needs no device fetch."""
        if self._codes_h is not None:
            return
        need = [int(s) for s in np.unique(np.asarray(slots, np.int64))
                if int(s) not in self._codes_ov]
        if not need:
            return
        import jax.numpy as jnp
        idx = self._pad_shape_bucket(np.asarray(need, np.int64))
        got = np.asarray(self._codes_dev[jnp.asarray(idx)])[:len(need)]
        for s, row in zip(need, got):
            self._codes_ov[s] = row.copy()

    def _write_code_row(self, slot: int, row) -> None:
        if self._codes_h is not None:
            self._codes_h[slot] = row
            self._codes_dev = None    # host becomes truth on first write
        else:
            self._codes_ov[int(slot)] = np.asarray(row, self.code_dtype).copy()
            if len(self._codes_ov) > self._OVERLAY_LIMIT:
                _ = self.codes    # too many patched rows: hydrate for real

    _OVERLAY_LIMIT = 65536

    def _write_code_block(self, start: int, rows: np.ndarray) -> None:
        if self._codes_h is not None:
            self._codes_h[start:start + len(rows)] = rows
            self._codes_dev = None    # host becomes truth on first write
        else:
            for j, row in enumerate(rows):
                self._codes_ov[start + j] = np.asarray(
                    row, self.code_dtype).copy()
            if len(self._codes_ov) > self._OVERLAY_LIMIT:
                _ = self.codes

    def _materialize_for_mutation(self) -> None:
        _ = self.codes, self.ids
        self._codes_dev = None
        self._ids_dev = None

    def fork(self) -> "PostingStore":
        """Copy-on-write clone for epoch-swap serving (serving.py): host
        truth arrays are copied; device arrays are SHARED — every store
        mutation updates them functionally (eager `.at[].set` copies), so
        the parent's buffers are never written in place — and the cached
        view dicts are shallow-copied so per-fork reassignment stays
        private. Mutating parent and fork concurrently is safe; they
        diverge independently."""
        new = PostingStore(
            self.kc, self.m, self.code_dtype,
            offsets=self.offsets.copy(), caps=self.caps.copy(),
            sizes=self.sizes.copy(),
            codes=None if self._codes_h is None else self._codes_h.copy(),
            ids=None if self._ids_h is None else self._ids_h.copy(),
            codes_dev=self._codes_dev, ids_dev=self._ids_dev)
        new._codes_ov = dict(self._codes_ov)
        new._device = None if self._device is None else dict(self._device)
        new._device_dense = (None if self._device_dense is None
                             else dict(self._device_dense))
        new._dirty_slots = set(self._dirty_slots)
        new._slot_of = (None if self._slot_of is None
                        else self._slot_of.copy())
        new._cell_order = self._cell_order
        if hasattr(self, "_dense_quantizer"):
            new._dense_quantizer = self._dense_quantizer
        return new

    # ------------------------------------------------------------------ build
    @classmethod
    def build(cls, assignments: np.ndarray, codes: np.ndarray, kc: int,
              slack: float = 1.25, align: int = 8) -> "PostingStore":
        """Sort n points by cell into padded CSR. ids = insertion order 0..n-1
        (the reference's `idxs .- 1` 0-basing, /root/reference/src/index.jl:189)."""
        assignments = np.asarray(assignments, np.int64)
        codes = np.asarray(codes)
        n, m = codes.shape
        counts = np.bincount(assignments, minlength=kc).astype(np.int64)
        # capacities (and hence cell offsets) are `align`-row aligned
        caps = (counts.astype(np.float64) * slack).astype(np.int64) + 8
        caps = np.maximum(align, ((caps + align - 1) // align) * align)
        offsets = np.zeros(kc, np.int64)
        np.cumsum(caps[:-1], out=offsets[1:])
        total = int(offsets[-1] + caps[-1])
        flat_codes = np.zeros((total, m), codes.dtype)
        flat_ids = np.full(total, -1, np.int64)
        order = np.argsort(assignments, kind="stable")
        starts = np.zeros(kc, np.int64)
        np.cumsum(counts[:-1], out=starts[1:])
        # Position of each (sorted) point inside its cell + its cell's offset.
        within = np.arange(n, dtype=np.int64) - starts[assignments[order]]
        slots = offsets[assignments[order]] + within
        flat_codes[slots] = codes[order]
        flat_ids[slots] = order
        return cls(kc, m, codes.dtype, offsets=offsets, caps=caps,
                   sizes=counts, codes=flat_codes, ids=flat_ids)

    @classmethod
    def build_device(cls, assignments, codes, kc: int,
                     slack: float = 1.25, align: int = 8) -> "PostingStore":
        """`build` with the sort/scatter on device: only the (kc,) cell
        counts cross to host; the flat code/id arrays stay device-resident
        (search needs nothing else) and the host copy hydrates on first
        dynamic op / save."""
        import jax.numpy as jnp
        assignments = jnp.asarray(assignments, jnp.int32)
        codes = jnp.asarray(codes)
        n, m = codes.shape
        counts = np.asarray(jnp.bincount(assignments, length=kc)
                            ).astype(np.int64)
        caps = (counts.astype(np.float64) * slack).astype(np.int64) + 8
        caps = np.maximum(align, ((caps + align - 1) // align) * align)
        offsets = np.zeros(kc, np.int64)
        np.cumsum(caps[:-1], out=offsets[1:])
        total = int(offsets[-1] + caps[-1])
        starts = np.zeros(kc, np.int64)
        np.cumsum(counts[:-1], out=starts[1:])
        order = jnp.argsort(assignments, stable=True)
        a_sorted = assignments[order]
        # int32 slot math: total_cap beyond 2^31 would need x64 mode anyway
        within = jnp.arange(n, dtype=jnp.int32) - \
            jnp.asarray(starts, jnp.int32)[a_sorted]
        slots = jnp.asarray(offsets, jnp.int32)[a_sorted] + within
        flat_codes = jnp.zeros((total, m), codes.dtype).at[slots].set(
            codes[order], unique_indices=True)
        flat_ids = jnp.full(total, -1, jnp.int32).at[slots].set(
            order.astype(jnp.int32), unique_indices=True)
        return cls(kc, m, np.dtype(codes.dtype.name), offsets=offsets,
                   caps=caps, sizes=counts, codes=None, ids=None,
                   codes_dev=flat_codes, ids_dev=flat_ids)

    # ------------------------------------------------------------- properties
    @property
    def n(self) -> int:
        return int(self.sizes.sum())

    @property
    def total_cap(self) -> int:
        """Length of the flat arrays. Not sum(caps): a grown cell relocates
        to the end and leaves its old region dead."""
        if self.kc == 0:
            return 0
        return int((self.offsets + self.caps).max())

    def _slots_to_cells(self, slots) -> np.ndarray:
        """Map flat slot indices -> owning cells. Offsets stop being sorted
        once a grown cell relocates, so search the offset-sorted order.
        Callers pass live slots only (dead regions map to no cell)."""
        if self._cell_order is None:
            self._cell_order = np.argsort(self.offsets, kind="stable")
        order = self._cell_order
        pos = np.searchsorted(self.offsets[order], slots, side="right") - 1
        return order[pos]

    def _slot_map(self) -> np.ndarray:
        """id -> slot (-1 for dead entries), built lazily in one vectorized
        pass and maintained incrementally by append/remove."""
        if self._slot_of is None:
            ids = self.ids
            live = np.nonzero(ids >= 0)[0]
            smap = np.full(self.n, -1, np.int64)
            smap[ids[live]] = live
            self._slot_of = smap
        return self._slot_of

    def _note_slot(self, ext_id: int, slot: int) -> None:
        m = self._slot_of
        if m is None:
            return
        if ext_id >= len(m):
            self._slot_of = m = np.concatenate(
                [m, np.full(ext_id + 1 - len(m), -1, np.int64)])
        m[ext_id] = slot

    @property
    def window(self) -> int:
        """Static gather width for jitted search (>= every cell size)."""
        return _round_up(max(1, int(self.caps.max())), _LANE)

    def valid_mask(self) -> np.ndarray:
        return self.ids >= 0

    def cell_entries(self, cell: int) -> Tuple[np.ndarray, np.ndarray]:
        """(ids, codes) of one cell — introspection parity with the
        reference's `inverse_index[c].idxs/.codes` (test/utils.jl:79-81)."""
        o, s = int(self.offsets[cell]), int(self.sizes[cell])
        return self.ids[o:o + s].copy(), self.codes[o:o + s].copy()

    # ------------------------------------------------------- mutation logging
    # A sharded serving view is a partition-time snapshot; instead of a full
    # re-partition after every dynamic op (the reference has no analogue —
    # its index IS the only copy), the store records which cells changed and
    # which global id renumberings happened so ShardedIVFADCIndex.refresh()
    # can patch per-shard arrays in place.
    def attach_mutation_log(self) -> "MutationLog":
        """Create and attach a fresh per-consumer log. The caller must hold
        the returned object (the store keeps only a weak reference); call
        `log.drain()` to consume. Multiple views over one store each attach
        their own log and stay independently consistent."""
        log = MutationLog(self.kc)
        self._mlogs.add(log)
        return log

    def _log_cell(self, cell: int) -> None:
        for log in self._mlogs:
            log.log_cell(int(cell))

    def _log_op(self, op) -> None:
        for log in self._mlogs:
            log.log_op(op)

    # -------------------------------------------------------------- mutation
    def _invalidate(self):
        self._device = None
        self._device_dense = None
        self._dirty_slots = set()

    # Incremental device-cache maintenance: dynamic ops record dirty slots;
    # the next device_view() flushes them as ONE batched scatter from host
    # truth. (Eagerly patching per op would cost a full functional-update
    # array copy and a dispatch per slot.)
    _DIRTY_LIMIT = 8192   # beyond this a full rebuild is cheaper

    def _mark_dirty(self, slot: int) -> None:
        if self._device is None and self._device_dense is None:
            return
        dirty = getattr(self, "_dirty_slots", None)
        if dirty is None:
            dirty = self._dirty_slots = set()
        dirty.add(slot)
        if len(dirty) > self._DIRTY_LIMIT:
            self._invalidate()

    @staticmethod
    def _pad_shape_bucket(slots: np.ndarray) -> np.ndarray:
        """Pad a slot-index array to a power-of-two bucket by REPEATING the
        first entry: every distinct count would otherwise trace + compile a
        fresh scatter/gather program, which shows up as serving-tail spikes
        during mutation bursts (benchmarks/serving_bench.py phase 3).
        Duplicate scatter targets always carry identical values here, so
        padding is semantics-free (unique_indices is NOT claimed on padded
        calls)."""
        n = len(slots)
        p = 8
        while p < n:
            p *= 2
        if p == n:
            return slots
        return np.concatenate([slots, np.full(p - n, slots[0],
                                              slots.dtype)])

    def _flush_dirty(self) -> None:
        dirty = getattr(self, "_dirty_slots", None)
        if not dirty:
            return
        import jax.numpy as jnp
        slots = np.fromiter(dirty, np.int64, len(dirty))
        slots.sort()
        slots = self._pad_shape_bucket(slots)   # stable traced shapes
        sl = jnp.asarray(slots, jnp.int32)
        code_rows = self._code_rows(slots)
        if self._device is not None:
            d = self._device
            d["codes"] = d["codes"].at[sl].set(jnp.asarray(code_rows))
            d["ids"] = d["ids"].at[sl].set(
                jnp.asarray(self.ids[slots], jnp.int32))
            d["sizes"] = jnp.asarray(self.sizes, jnp.int32)
        if self._device_dense is not None:
            from ivfadc_tpu.ops import pq as pq_ops
            dd = self._device_dense
            if dd.get("scale") is not None:
                rows = pq_ops.decode_rotated_int8(
                    self._dense_quantizer, code_rows, dd["scale"])
            else:
                rows = pq_ops.decode_rotated(self._dense_quantizer, code_rows)
            live = jnp.asarray(self.ids[slots] >= 0)[:, None]
            rows = jnp.where(live, rows, 0).astype(dd["decoded"].dtype)
            dd["decoded"] = dd["decoded"].at[sl].set(rows)
            dd["ids"] = dd["ids"].at[sl].set(
                jnp.asarray(self.ids[slots], jnp.int32))
            dd["sizes"] = jnp.asarray(self.sizes, jnp.int32)
        self._dirty_slots = set()

    def _dev_shift_ids(self, threshold: int, delta: int) -> None:
        for view in (self._device, self._device_dense):
            if view is not None:
                ids = view["ids"]
                view["ids"] = jnp_where_shift(ids, threshold, delta)

    def append(self, cell: int, code_row: np.ndarray, ext_id: int) -> None:
        if self.sizes[cell] >= self.caps[cell]:
            self._grow_cell(cell)
        slot = int(self.offsets[cell] + self.sizes[cell])
        self._write_code_row(slot, code_row)
        self._ids_mut()[slot] = ext_id
        self.sizes[cell] += 1
        self._note_slot(ext_id, slot)
        self._mark_dirty(slot)
        self._log_cell(cell)

    def append_batch(self, cells: np.ndarray, code_rows: np.ndarray,
                     first_ext_id: int) -> None:
        """Bulk append: point i goes to cells[i] with id first_ext_id + i.
        Equivalent to len(cells) sequential `append` calls (the per-cell
        insertion order follows input order), but grouped into per-cell
        slice writes — O(B + distinct cells) host work instead of B Python
        round trips."""
        cells = np.asarray(cells, np.int64)
        code_rows = np.asarray(code_rows)
        ext = np.arange(first_ext_id, first_ext_id + len(cells), dtype=np.int64)
        need = np.bincount(cells, minlength=self.kc)
        for c in np.nonzero(self.sizes + need > self.caps)[0]:
            while self.sizes[c] + need[c] > self.caps[c]:
                self._grow_cell(int(c))
        self._slot_of = None          # bulk op: rebuild the map lazily
        order = np.argsort(cells, kind="stable")
        sorted_cells = cells[order]
        uniq, first = np.unique(sorted_cells, return_index=True)
        dirty = self._device is not None or self._device_dense is not None
        new_slots = []
        for j, c in enumerate(uniq):
            lo = first[j]
            hi = first[j + 1] if j + 1 < len(uniq) else len(cells)
            cnt = hi - lo
            o = int(self.offsets[c] + self.sizes[c])
            sel = order[lo:hi]
            self._write_code_block(o, code_rows[sel])
            self._ids_mut()[o:o + cnt] = ext[sel]
            self.sizes[c] += cnt
            if dirty:
                new_slots.append(np.arange(o, o + cnt))
        if dirty:
            slots = np.concatenate(new_slots) if new_slots else []
            self._dirty_slots.update(int(x) for x in slots)
            if len(self._dirty_slots) > self._DIRTY_LIMIT:
                self._invalidate()
        for c in uniq:
            self._log_cell(int(c))

    def _grow_cell(self, cell: int) -> None:
        """Double one cell's capacity by RELOCATING it to the end of the
        flat arrays. Offsets are per-cell pointers, not sorted ranges, so
        only this cell's rows move — O(cell + new_cap) instead of the full
        store rewrite + kc-iteration Python loop this replaced (which took
        minutes at Deep1B's kc=2^18). The old region goes dead until the
        next full rebuild; amortized slack stays bounded by doubling."""
        a = self.align
        old_off = int(self.offsets[cell])
        s = int(self.sizes[cell])
        new_cap = ((max(int(self.caps[cell]) * 2, 16) + a - 1) // a) * a
        new_off = self.total_cap          # aligned: every cap is an `a`-multiple
        new_total = new_off + new_cap
        # -- codes storage (host truth or device truth + overlay) --
        if self._codes_h is not None:
            self._codes_dev = None
            grow_rows = new_total - len(self._codes_h)
            self._codes_h = np.concatenate(
                [self._codes_h,
                 np.zeros((grow_rows, self.m), self.code_dtype)])
            if s:
                self._codes_h[new_off:new_off + s] = \
                    self._codes_h[old_off:old_off + s]
                self._codes_h[old_off:old_off + s] = 0
        else:
            import jax.numpy as jnp
            cd = self._codes_dev
            if cd.shape[0] < new_total:
                cd = jnp.pad(cd, ((0, new_total - cd.shape[0]), (0, 0)))
            if s:
                cd = cd.at[new_off:new_off + s].set(cd[old_off:old_off + s])
                cd = cd.at[old_off:old_off + s].set(0)
            self._codes_dev = cd
            if self._codes_ov:      # remap overlay rows that moved
                self._codes_ov = {
                    (key - old_off + new_off
                     if old_off <= key < old_off + s else key): row
                    for key, row in self._codes_ov.items()}
        # -- ids storage --
        if self._ids_h is not None:
            grow_rows = new_total - len(self._ids_h)
            self._ids_h = np.concatenate(
                [self._ids_h, np.full(grow_rows, -1, np.int64)])
            if s:
                self._ids_h[new_off:new_off + s] = \
                    self._ids_h[old_off:old_off + s]
                self._ids_h[old_off:old_off + s] = -1
        else:
            import jax.numpy as jnp
            di = self._ids_dev
            if di.shape[0] < new_total:
                di = jnp.pad(di, (0, new_total - di.shape[0]),
                             constant_values=-1)
            if s:
                di = di.at[new_off:new_off + s].set(di[old_off:old_off + s])
                di = di.at[old_off:old_off + s].set(-1)
            self._ids_dev = di
        if self._dirty_slots:         # remap pending patches that moved
            self._dirty_slots = {
                (d - old_off + new_off if old_off <= d < old_off + s else d)
                for d in self._dirty_slots}
        self.offsets[cell] = new_off
        self.caps[cell] = new_cap
        self._cell_order = None
        self._slot_of = None
        self._patch_views_after_grow(cell, old_off, new_off, s, new_total)

    def _patch_views_after_grow(self, cell: int, old_off: int, new_off: int,
                                s: int, new_total: int) -> None:
        """Move the grown cell's rows inside the cached device arrays when
        their bucketed row padding already covers the new end (the common
        case) — otherwise drop the caches for a full rebuild."""
        import jax.numpy as jnp
        for view in (self._device, self._device_dense):
            if view is None:
                continue
            key = "codes" if "codes" in view else "decoded"
            if (view[key].shape[0] < new_total
                    or view["ids"].shape[0] < new_total):
                self._invalidate()
                return
            arr, ids_a = view[key], view["ids"]
            if s:
                arr = arr.at[new_off:new_off + s].set(
                    arr[old_off:old_off + s])
                arr = arr.at[old_off:old_off + s].set(0)
                ids_a = ids_a.at[new_off:new_off + s].set(
                    ids_a[old_off:old_off + s])
                ids_a = ids_a.at[old_off:old_off + s].set(-1)
            view[key], view["ids"] = arr, ids_a
            view["offsets"] = jnp.asarray(self.offsets, jnp.int32)

    def find(self, ext_id: int) -> Tuple[int, int]:
        """-> (cell, slot), O(1) via the maintained id->slot map. (The
        reference walks every list, /root/reference/src/utils.jl:49-55; at
        scale that scan — and the full host hydration it forced —
        dominated dynamic ops.) Touches `ids` only, never `codes`."""
        ext_id = int(ext_id)
        smap = self._slot_map()
        if not (0 <= ext_id < len(smap)) or smap[ext_id] < 0:
            raise KeyError(f"id {ext_id} not in index")
        slot = int(smap[ext_id])
        cell = int(self._slots_to_cells(np.asarray([slot], np.int64))[0])
        return cell, slot

    def remove_slot(self, cell: int, slot: int) -> np.ndarray:
        """Swap-remove one posting; returns its code row. (Order within a cell
        is not part of the contract — the reference's delete test matches
        codes by id, not by position, test/utils.jl:84-104.)"""
        last = int(self.offsets[cell] + self.sizes[cell] - 1)
        pair = self._code_rows(np.asarray([slot, last]))
        code, moved_code = pair[0].copy(), pair[1].copy()
        ids = self._ids_mut()
        removed_id = int(ids[slot])
        moved_id = int(ids[last])
        self._write_code_row(slot, moved_code)
        ids[slot] = moved_id if slot != last else -1
        self._write_code_row(last, np.zeros(self.m, self.code_dtype))
        ids[last] = -1
        self.sizes[cell] -= 1
        if self._slot_of is not None:
            if 0 <= removed_id < len(self._slot_of):
                self._slot_of[removed_id] = -1
            if slot != last:
                self._note_slot(moved_id, slot)
        if slot != last:
            self._mark_dirty(slot)
        self._mark_dirty(last)
        self._log_cell(cell)
        return code

    def shift_ids(self, threshold: int, delta: int) -> None:
        """ids > threshold += delta over ALL cells — the reference's
        `_shift_inverse_index!` (/root/reference/src/utils.jl:16-20), here one
        vectorized masked add instead of an O(n) dict rebuild."""
        ids = self._ids_mut()
        mask = ids > threshold
        ids[mask] += delta
        self._slot_of = None          # wholesale renumber: rebuild lazily
        self._dev_shift_ids(threshold, delta)
        self._log_op(("shift", int(threshold), int(delta)))

    def delete_ids_incremental(self, dels: np.ndarray) -> int:
        """Small-batch delete that keeps the device caches patchable:
        swap-remove each hit posting (descending slot order per cell, so a
        moved last-row that is itself deleted is still pending), then
        renumber ids by rank-subtract — host side vectorized, device side
        one searchsorted op. Same observable semantics as `delete_ids`."""
        dels = np.unique(np.asarray(dels, np.int64))   # rank math needs sorted
        hit = np.isin(self.ids, dels) & (self.ids >= 0)
        hit_slots = np.nonzero(hit)[0]
        if hit_slots.size != dels.size:
            missing = np.setdiff1d(dels, self.ids[hit_slots])
            raise KeyError(f"ids not in index: {missing[:10].tolist()}")
        cells = self._slots_to_cells(hit_slots)
        if self._codes_h is None:
            # device-truth mode: prefetch every row the swap-remove loop can
            # touch (the hits + each cell's trailing rows) in ONE gather
            # instead of one device fetch per row
            pre = [hit_slots]
            for cell in np.unique(cells):
                cnt = int((cells == cell).sum())
                o, s = int(self.offsets[cell]), int(self.sizes[cell])
                pre.append(np.arange(o + s - cnt, o + s, dtype=np.int64))
            self._prefetch_code_rows(np.concatenate(pre))
        for cell in np.unique(cells):
            slots = hit_slots[cells == cell]
            for slot in np.sort(slots)[::-1]:
                # the row may have been moved by a previous swap in this
                # cell; only remove if it still holds a deleted id
                if self.ids[slot] >= 0 and \
                        np.searchsorted(dels, self.ids[slot]) < dels.size \
                        and dels[np.searchsorted(dels, self.ids[slot])] == \
                        self.ids[slot]:
                    self.remove_slot(int(cell), int(slot))
        ids = self._ids_mut()
        live = ids >= 0
        ids[live] -= np.searchsorted(dels, ids[live])
        self._slot_of = None
        self._dev_rank_shift(dels)
        self._log_op(("rank", dels.copy()))
        return int(dels.size)

    def _dev_rank_shift(self, dels: np.ndarray) -> None:
        """Device-side id renumbering after a batch delete: each live id
        drops by the count of deleted ids below it. The (sorted) delete
        list pads to a shape bucket with an above-any-id sentinel so
        varying delete counts reuse one compiled program."""
        import jax.numpy as jnp
        n = len(dels)
        p = 8
        while p < n:
            p *= 2
        if p != n:
            dels = np.concatenate(
                [dels, np.full(p - n, 2**31 - 1, dels.dtype)])
        dels_d = jnp.asarray(dels, jnp.int32)
        for view in (self._device, self._device_dense):
            if view is not None:
                ids = view["ids"]
                view["ids"] = jnp.where(
                    ids >= 0, ids - jnp.searchsorted(dels_d, ids), ids)

    def delete_ids(self, ext_ids: np.ndarray) -> int:
        """Batch delete + positional re-numbering: every surviving id drops by
        the number of deleted ids below it (reference semantics,
        /root/reference/src/utils.jl:90-105, but O(total log D) vectorized
        instead of O(D * total))."""
        dels = np.unique(np.asarray(ext_ids, np.int64))
        if dels.size == 0:
            return 0
        self._materialize_for_mutation()
        hit = np.isin(self.ids, dels) & (self.ids >= 0)
        hit_slots = np.nonzero(hit)[0]
        if hit_slots.size != dels.size:
            missing = np.setdiff1d(dels, self.ids[hit_slots])
            raise KeyError(f"ids not in index: {missing[:10].tolist()}")
        cells = self._slots_to_cells(hit_slots)
        for cell in np.unique(cells):
            o, s = int(self.offsets[cell]), int(self.sizes[cell])
            keep = ~hit[o:o + s]
            kept = int(keep.sum())
            self.codes[o:o + kept] = self.codes[o:o + s][keep]
            self.ids[o:o + kept] = self.ids[o:o + s][keep]
            self.codes[o + kept:o + s] = 0
            self.ids[o + kept:o + s] = -1
            self.sizes[cell] = kept
        live = self.ids >= 0
        self.ids[live] -= np.searchsorted(dels, self.ids[live])
        self._slot_of = None
        self._invalidate()
        for c in np.unique(cells):
            self._log_cell(int(c))
        self._log_op(("rank", dels.copy()))
        return int(dels.size)

    # ---------------------------------------------------------------- device
    def _bucket_rows(self, rows: int) -> int:
        """Pad device-array row counts to coarse buckets so cell growth
        (which changes total capacity) rarely changes traced shapes — a
        shape change forces a jit recompile of the search program."""
        b = 65536 if rows > 65536 else 1024
        return _round_up(rows, b)

    def _sync_overlay_to_dev(self) -> None:
        """Fold the written-row overlay into the device truth array (one
        batched scatter) so a fresh view can be built straight from it."""
        if not self._codes_ov or self._codes_dev is None:
            return
        import jax.numpy as jnp
        slots = np.fromiter(self._codes_ov.keys(), np.int64,
                            len(self._codes_ov))
        rows = np.stack([self._codes_ov[int(s)] for s in slots])
        self._codes_dev = self._codes_dev.at[jnp.asarray(slots)].set(
            jnp.asarray(rows), unique_indices=True)
        self._codes_ov = {}

    def device_view(self) -> Dict:
        """Cached jnp arrays for the jitted LUT search path."""
        self._flush_dirty()
        if self._device is None:
            import jax.numpy as jnp
            self._sync_overlay_to_dev()
            codes = self._codes_dev if self._codes_dev is not None \
                else jnp.asarray(self.codes)
            ids = self._ids_dev if self._ids_dev is not None \
                else jnp.asarray(self.ids, jnp.int32)
            pad = self._bucket_rows(codes.shape[0]) - codes.shape[0]
            if pad:
                codes = jnp.pad(codes, ((0, pad), (0, 0)))
                ids = jnp.pad(ids, (0, pad), constant_values=-1)
            self._device = dict(
                offsets=jnp.asarray(self.offsets, jnp.int32),
                sizes=jnp.asarray(self.sizes, jnp.int32),
                codes=codes,
                ids=ids,
            )
        return self._device

    def device_view_dense(self, quantizer, cache: str = "bf16") -> Dict:
        """Cached arrays for the dense scan (ops/gather_scan.py): resident
        decoded residuals in the rotated space, row-bucketed like
        `device_view`. Rebuilt lazily after a bulk mutation (the PQ codes
        remain the source of truth).

        cache="bf16" stores 2 bytes/dim; "int8" stores 1 byte/dim plus a
        per-column dequantization scale."""
        self._dense_quantizer = quantizer
        if (self._device_dense is not None
                and self._device_dense["cache"] != cache):
            self._device_dense = None       # dtype switch: rebuild
        self._flush_dirty()
        if self._device_dense is None:
            import jax.numpy as jnp
            from ivfadc_tpu.ops import pq as pq_ops
            self._sync_overlay_to_dev()
            src_codes = self._codes_dev if self._codes_dev is not None \
                else self.codes
            if cache == "int8":
                scale = pq_ops.cache_scale(quantizer)
                decoded = pq_ops.decode_rotated_int8(quantizer, src_codes,
                                                     scale)
            else:
                scale = None
                decoded = pq_ops.decode_rotated(quantizer, src_codes)
            total = decoded.shape[0]
            pad = self._bucket_rows(total) - total
            decoded = jnp.pad(decoded, ((0, pad), (0, 0)))
            if self._ids_dev is not None:
                ids = jnp.pad(self._ids_dev, (0, pad), constant_values=-1)
            else:
                ids = jnp.asarray(
                    np.pad(self.ids, (0, pad), constant_values=-1),
                    jnp.int32)
            self._device_dense = dict(
                offsets=jnp.asarray(self.offsets, jnp.int32),
                sizes=jnp.asarray(self.sizes, jnp.int32),
                decoded=decoded,
                ids=ids,
                scale=scale,
                cache=cache,
            )
        return self._device_dense
