"""Online-serving frontend: request coalescing over the batched search path.

The reference is a single-threaded library whose batch search is a serial
query loop (/root/reference/src/index.jl:261-273). On an accelerator the
economics invert: one padded (B, k) dispatch amortizes the fixed dispatch
cost over B queries, so a serving layer wants to COALESCE concurrent small
requests into shared device batches instead of dispatching each alone.

`BatchingSearcher` is that layer: callers `submit()` single queries (or
small arrays) from any thread and get a Future; a flusher thread groups
pending requests with the same (k, w) into one `search_padded` dispatch
when either `max_batch` queries are waiting or the oldest request has
waited `max_wait_ms`. Latency/throughput trade-off is explicit: max_wait
bounds added latency, max_batch bounds per-dispatch work.

Mutation model — epoch snapshots, readers never stall:

Dynamic index mutations go through the searcher (`push`/`push_batch`/
`push_front`/`pop`/`pop_front`/`delete`, or an arbitrary `mutate(fn)`).
A mutation forks a consistent read-only snapshot of the index
(`IVFADCIndex.fork` / `ShardedIVFADCIndex.fork`: copy-on-write host state;
device buffers copied exactly where the mutation path would donate them
in place), points new dispatches at the snapshot, waits only for the few
in-flight dispatches still holding the live index's buffers to drain
(~one batch), runs the mutation on the live index, then swaps dispatches
back. Searches therefore NEVER queue behind a mutation — they serve the
previous epoch while the next is being built — and every dispatch sees a
consistent index version. Mutations serialize with each other. Mutations
apply to the wrapped index object itself, so the caller's handle reflects
them once `mutate` returns.

Reentrancy: a search submitted while `fn` runs (including from inside
`fn`) dispatches against the snapshot epoch and resolves normally — but
`fn` itself must not BLOCK on such a future forever if the flusher is
saturated; ordinary submit-and-wait from other threads is always safe.
Mutating the wrapped index directly while submits are in flight is NOT
supported — route mutations through the searcher.

Indexes without a `fork()` method (duck-typed stand-ins) fall back to
stop-the-world: dispatches drain and queue while the mutation runs.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import List, Optional, Tuple

import numpy as np

from ivfadc_tpu.utils.profiling import SearchStats


class _Pending:
    __slots__ = ("queries", "future", "t_enq")

    def __init__(self, queries: np.ndarray, future: Future, t_enq: float):
        self.queries = queries
        self.future = future
        self.t_enq = t_enq


class BatchingSearcher:
    """Coalesce concurrent search requests into shared device dispatches.

    index:        an IVFADCIndex (or ShardedIVFADCIndex — anything with
                  `search_padded(queries, k, w)` and `.dim`).
    max_batch:    flush a (k, w) group once this many queries are pending.
    max_wait_ms:  flush once the group's oldest request has waited this long.
    pipeline:     dispatches resolved concurrently. `search_padded` blocks
                  on the device->host pull, so with pipeline=1 each flush
                  would serialize behind the previous batch's fetch; a small
                  pool lets wave i+1 dispatch while wave i drains (bounded —
                  it also caps in-flight device work).
    stats:        optional SearchStats to record (queries, seconds) into.
    """

    def __init__(self, index, *, max_batch: int = 1024,
                 max_wait_ms: float = 2.0, pipeline: int = 2,
                 stats: Optional[SearchStats] = None):
        assert max_batch >= 1 and max_wait_ms >= 0 and pipeline >= 1
        from concurrent.futures import ThreadPoolExecutor
        self._index = index                # the live (caller-owned) index
        self._max_batch = max_batch
        self._max_wait = max_wait_ms / 1e3
        self.stats = stats if stats is not None else SearchStats()
        self._lock = threading.Condition()
        self._groups: dict = {}            # (k, w) -> List[_Pending]
        self._closed = False
        self._pool = ThreadPoolExecutor(max_workers=pipeline,
                                        thread_name_prefix="ivfadc-dispatch")
        # epoch state: dispatches read `_epoch`; a mutation swaps it to a
        # forked snapshot while the live index is being written. `_inflight`
        # counts dispatches per epoch object so the mutation can drain just
        # the readers of the buffers it is about to invalidate.
        self._epoch_cond = threading.Condition()
        self._epoch = index
        self._inflight: dict = {}          # id(epoch) -> active dispatches
        self._mut_lock = threading.Lock()  # serializes mutations
        self._thread = threading.Thread(target=self._flusher, daemon=True,
                                        name="ivfadc-serving-flusher")
        self._thread.start()

    # ------------------------------------------------------------- client API
    def submit(self, query, k: int, w: int = 1) -> Future:
        """Enqueue one query (d,) or a small batch (b, d). Resolves to
        (ids, dists) padded arrays of shape (k,) / (b, k) (ids -1-padded),
        matching `search_padded` row semantics."""
        q = np.asarray(query, np.float32)
        single = q.ndim == 1
        if single:
            q = q[None, :]
        dim = getattr(self._index, "dim", None) or self._index.index.dim
        if q.ndim != 2 or q.shape[1] != dim:
            raise AssertionError(
                f"query shape {np.asarray(query).shape} does not match index "
                f"dimension {dim}")
        fut: Future = Future()
        fut._ivfadc_single = single        # sliced off at resolve time
        with self._lock:
            if self._closed:
                raise RuntimeError("searcher is closed")
            self._groups.setdefault((int(k), int(w)), []).append(
                _Pending(q, fut, time.perf_counter()))
            self._lock.notify()
        return fut

    def search(self, query, k: int, w: int = 1, timeout: float = None):
        """Blocking convenience around submit()."""
        return self.submit(query, k, w).result(timeout=timeout)

    # --------------------------------------------------------- mutation API
    def _wait_readers(self, obj) -> None:
        """Block until no dispatch holds `obj` (typically < one batch)."""
        with self._epoch_cond:
            while self._inflight.get(id(obj), 0):
                self._epoch_cond.wait()

    def mutate(self, fn):
        """Apply `fn(index)` to the live index under epoch isolation: new
        dispatches are redirected to a forked snapshot, the handful of
        dispatches still on the live buffers drain, fn runs, dispatches
        swap back. Searches keep flowing the whole time (they observe the
        pre-mutation epoch until the swap); dispatches submitted after
        mutate() returns see the new index version."""
        with self._mut_lock:
            live = self._index
            fork = getattr(live, "fork", None)
            if fork is None:
                # duck-typed index without snapshot support: stop-the-world
                # (drain every dispatch, block new ones on the epoch wait)
                with self._epoch_cond:
                    self._epoch = None
                self._wait_readers(live)
                try:
                    return fn(live)
                finally:
                    with self._epoch_cond:
                        self._epoch = live
                        self._epoch_cond.notify_all()
            snap = fork()
            with self._epoch_cond:
                self._epoch = snap
            self._wait_readers(live)
            try:
                return fn(live)
            finally:
                with self._epoch_cond:
                    self._epoch = live
                    self._epoch_cond.notify_all()

    def push(self, point) -> None:
        self.mutate(lambda ix: ix.push(point))

    def push_batch(self, points) -> None:
        self.mutate(lambda ix: ix.push_batch(points))

    def push_front(self, point) -> None:
        self.mutate(lambda ix: ix.push_front(point))

    def pop(self) -> np.ndarray:
        return self.mutate(lambda ix: ix.pop())

    def pop_front(self) -> np.ndarray:
        return self.mutate(lambda ix: ix.pop_front())

    def delete(self, ids) -> None:
        self.mutate(lambda ix: ix.delete(ids))

    def close(self, drain: bool = True) -> None:
        """Stop the flusher. drain=True (default) serves whatever is queued
        first; drain=False fails pending futures with RuntimeError."""
        with self._lock:
            self._closed = True
            if not drain:
                for group in self._groups.values():
                    for p in group:
                        p.future.set_exception(
                            RuntimeError("searcher closed before dispatch"))
                self._groups.clear()
            self._lock.notify()
        self._thread.join()
        self._pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # ---------------------------------------------------------------- flusher
    def _ready_group(self, now: float):
        """The (k, w) group that must flush now (full, overdue, or closing),
        else the earliest future deadline to sleep toward. Called under lock."""
        next_deadline = None
        for key, group in self._groups.items():
            if not group:
                continue
            n = sum(p.queries.shape[0] for p in group)
            deadline = group[0].t_enq + self._max_wait
            if self._closed or n >= self._max_batch or now >= deadline:
                return key, None
            next_deadline = deadline if next_deadline is None \
                else min(next_deadline, deadline)
        return None, next_deadline

    def _flusher(self) -> None:
        while True:
            with self._lock:
                while True:
                    key, deadline = self._ready_group(time.perf_counter())
                    if key is not None:
                        break
                    if self._closed:      # closed + nothing ready => drained
                        return
                    self._lock.wait(
                        None if deadline is None
                        else max(1e-4, deadline - time.perf_counter()))
                group = self._groups.pop(key)
                # respect max_batch: requeue the tail (whole requests only;
                # a submitted array is never split across dispatches)
                take: List[_Pending] = []
                n = 0
                while group and (n == 0 or
                                 n + group[0].queries.shape[0]
                                 <= self._max_batch):
                    p = group.pop(0)
                    take.append(p)
                    n += p.queries.shape[0]
                if group:
                    self._groups[key] = group
            # hand off to the dispatch pool: the blocking device->host pull
            # happens there, so the next group can flush immediately
            self._pool.submit(self._dispatch, key, take)

    def _acquire_epoch(self):
        """Current epoch + in-flight lease. Blocks only in the no-fork
        stop-the-world fallback (epoch is None while a mutation runs)."""
        with self._epoch_cond:
            while self._epoch is None:
                self._epoch_cond.wait()
            epoch = self._epoch
            self._inflight[id(epoch)] = self._inflight.get(id(epoch), 0) + 1
            return epoch

    def _release_epoch(self, epoch) -> None:
        with self._epoch_cond:
            left = self._inflight.get(id(epoch), 1) - 1
            if left:
                self._inflight[id(epoch)] = left
            else:
                self._inflight.pop(id(epoch), None)
                self._epoch_cond.notify_all()

    def _dispatch(self, key: Tuple[int, int], take: List[_Pending]) -> None:
        k, w = key
        queries = np.concatenate([p.queries for p in take])
        t0 = time.perf_counter()
        try:
            # lease the current epoch: its device buffers stay valid for
            # the whole dispatch (a concurrent mutation redirects newer
            # dispatches to a snapshot and waits for this lease to drop
            # before donating the live buffers)
            epoch = self._acquire_epoch()
            try:
                ids, dists = epoch.search_padded(queries, k, w)
            finally:
                self._release_epoch(epoch)
        except Exception as e:              # propagate to every caller
            for p in take:
                p.future.set_exception(e)
            return
        self.stats.record(queries.shape[0], time.perf_counter() - t0)
        row = 0
        for p in take:
            b = p.queries.shape[0]
            i, d = ids[row:row + b], dists[row:row + b]
            row += b
            if getattr(p.future, "_ivfadc_single", False):
                i, d = i[0], d[0]
            p.future.set_result((i, d))
