"""Request-coalescing serving frontend (ivfadc_tpu/serving.py)."""

import numpy as np
import pytest

from ivfadc_tpu.serving import BatchingSearcher
from tests.conftest import build_random_index


@pytest.fixture(scope="module")
def served_index():
    rng = np.random.RandomState(0)
    data = rng.rand(400, 10).astype(np.float32)
    return data, build_random_index(data)


def test_results_match_direct_search(served_index):
    data, idx = served_index
    with BatchingSearcher(idx, max_batch=64, max_wait_ms=5) as s:
        futs = [s.submit(data[i], 5, w=4) for i in range(32)]
        got = [f.result(timeout=30) for f in futs]
    ids_d, dists_d = idx.search_padded(data[:32], 5, w=4)
    for i, (gi, gd) in enumerate(got):
        np.testing.assert_array_equal(gi, ids_d[i])
        np.testing.assert_allclose(gd, dists_d[i], rtol=1e-6)


def test_requests_coalesce_into_shared_dispatches(served_index):
    data, idx = served_index
    with BatchingSearcher(idx, max_batch=256, max_wait_ms=200) as s:
        futs = [s.submit(data[i], 3, w=2) for i in range(64)]
        for f in futs:
            f.result(timeout=30)
        assert s.stats.queries == 64
        # 64 near-simultaneous requests must share dispatches, not go 1:1
        assert s.stats.batches <= 4, s.stats.batches


def test_mixed_k_w_groups_resolve_independently(served_index):
    data, idx = served_index
    with BatchingSearcher(idx, max_batch=32, max_wait_ms=5) as s:
        f1 = s.submit(data[0], 3, w=1)
        f2 = s.submit(data[1], 7, w=4)
        f3 = s.submit(data[2], 3, w=1)
        (i1, _), (i2, _), (i3, _) = (f.result(timeout=30)
                                     for f in (f1, f2, f3))
    assert i1.shape == (3,) and i3.shape == (3,)
    assert i2.shape == (7,)
    ids_d, _ = idx.search_padded(data[1:2], 7, w=4)
    np.testing.assert_array_equal(i2, ids_d[0])


def test_array_submissions_and_max_batch_splitting(served_index):
    data, idx = served_index
    # max_batch=8 forces the 3 x 6-row submissions across >= 3 dispatches,
    # with whole requests never split
    with BatchingSearcher(idx, max_batch=8, max_wait_ms=1) as s:
        futs = [s.submit(data[j * 6:(j + 1) * 6], 4, w=3) for j in range(3)]
        got = [f.result(timeout=30) for f in futs]
    ids_d, _ = idx.search_padded(data[:18], 4, w=3)
    for j, (gi, gd) in enumerate(got):
        assert gi.shape == (6, 4)
        np.testing.assert_array_equal(gi, ids_d[j * 6:(j + 1) * 6])


def test_submit_validation_and_closed_searcher(served_index):
    data, idx = served_index
    s = BatchingSearcher(idx, max_wait_ms=1)
    with pytest.raises(AssertionError):
        s.submit(np.zeros(3, np.float32), 5)      # wrong dim
    s.close()
    with pytest.raises(RuntimeError):
        s.submit(data[0], 5)


def test_dispatch_exception_propagates_to_futures(served_index):
    data, idx = served_index
    with BatchingSearcher(idx, max_wait_ms=1) as s:
        fut = s.submit(data[0], 0, w=1)           # k=0: search-path assert
        with pytest.raises(Exception):
            fut.result(timeout=30)


def test_close_without_drain_fails_pending(served_index):
    data, idx = served_index
    s = BatchingSearcher(idx, max_batch=4096, max_wait_ms=60_000)
    futs = [s.submit(data[i], 3, w=1) for i in range(4)]
    s.close(drain=False)
    failed = sum(1 for f in futs
                 if isinstance(f.exception(timeout=5), RuntimeError))
    # the flusher may have raced a dispatch in before close(); every future
    # must still be resolved one way or the other
    assert failed == 4 or all(f.done() for f in futs)


def test_serving_over_sharded_index(served_index):
    """BatchingSearcher drives a ShardedIVFADCIndex the same way (the docs
    promise this); results match the sharded index's own search_padded."""
    from ivfadc_tpu.parallel.mesh import make_mesh
    from ivfadc_tpu.parallel.sharded import ShardedIVFADCIndex
    data, idx = served_index
    sidx = ShardedIVFADCIndex(idx, make_mesh(n_shards=4, n_data=2))
    with BatchingSearcher(sidx, max_batch=64, max_wait_ms=5) as s:
        futs = [s.submit(data[i], 5, w=4) for i in range(16)]
        got = [f.result(timeout=60) for f in futs]
    ids_d, dists_d = sidx.search_padded(data[:16], 5, w=4)
    for i, (gi, gd) in enumerate(got):
        np.testing.assert_array_equal(gi, ids_d[i])
        np.testing.assert_allclose(gd, dists_d[i], rtol=1e-6)


def test_searches_do_not_stall_during_slow_mutation(served_index):
    """Epoch-swap contract (serving.py module docstring): while a mutation
    runs, searches keep dispatching against the pre-mutation snapshot —
    they must complete well within the mutation's runtime, and observe the
    pre-mutation index size. Dispatches after mutate() see the new epoch."""
    import threading
    import time

    data, _ = served_index
    idx = build_random_index(data)
    n0 = len(idx)

    with BatchingSearcher(idx, max_batch=32, max_wait_ms=1) as s:
        # warm the dispatch path so in-mutation latency isn't compile time
        s.submit(data[0], 5, w=4).result(timeout=30)

        entered = threading.Event()
        release = threading.Event()
        mut_done = threading.Event()

        def slow_push(ix):
            entered.set()
            assert release.wait(timeout=30)
            ix.push(data[0] * 1.01)

        t = threading.Thread(target=lambda: (s.mutate(slow_push),
                                             mut_done.set()))
        t.start()
        assert entered.wait(timeout=30)
        # the mutation is now holding the live index; searches must flow
        lat = []
        for i in range(5):
            t0 = time.perf_counter()
            ids, dists = s.submit(data[i], 5, w=4).result(timeout=10)
            lat.append(time.perf_counter() - t0)
            assert ids.shape == (5,)
            # snapshot epoch: the pushed point (id n0) is not visible yet
            assert not (ids == n0).any()
        assert not mut_done.is_set()      # mutation still in progress
        release.set()
        t.join(timeout=30)
        assert mut_done.is_set()
        # post-mutation dispatches see the new epoch (n0+1 points; the
        # near-duplicate pushed point must now be findable)
        ids, _ = s.submit(data[0] * 1.01, 5, w=8).result(timeout=30)
        assert (ids == n0).any()
    assert len(idx) == n0 + 1
    # every in-mutation search resolved promptly (vs. the mutation's
    # multi-second hold, which the old RW lock would have imposed)
    assert max(lat) < 5.0


def test_search_inside_mutate_does_not_deadlock(served_index):
    """A search submitted from within mutate(fn) resolves against the
    snapshot epoch instead of deadlocking (the old writer-preference RW
    lock hazard)."""
    data, _ = served_index
    idx = build_random_index(data)
    seen = {}

    with BatchingSearcher(idx, max_batch=8, max_wait_ms=1) as s:
        s.submit(data[0], 3, w=2).result(timeout=30)   # warm

        def fn(ix):
            fut = s.submit(data[1], 3, w=2)
            seen["ids"] = fut.result(timeout=30)[0]
            ix.push(data[1] * 1.02)

        s.mutate(fn)
    assert seen["ids"].shape == (3,)


def test_sharded_mutations_race_submits(served_index):
    """Concurrent submits racing native mutations on a sharded serving
    view: every future resolves, and the final state matches a serially
    mutated twin (the sharded analogue of the plain fuzz below)."""
    import threading

    from ivfadc_tpu.parallel.mesh import make_mesh
    from ivfadc_tpu.parallel.sharded import ShardedIVFADCIndex

    data, _ = served_index
    rng = np.random.RandomState(11)
    idx = build_random_index(data)
    twin = build_random_index(data)
    sidx = ShardedIVFADCIndex(idx, make_mesh(n_shards=4, n_data=2))
    extra = rng.rand(5, 10).astype(np.float32)
    stop = threading.Event()
    errors = []

    with BatchingSearcher(sidx, max_batch=16, max_wait_ms=1) as s:
        def searcher_thread(seed):
            r = np.random.RandomState(seed)
            while not stop.is_set():
                try:
                    f = s.submit(data[r.randint(len(data))], 5, w=4)
                    ids, _ = f.result(timeout=60)
                    assert ids.shape == (5,)
                except Exception as e:     # pragma: no cover - failure path
                    errors.append(e)
                    return

        threads = [threading.Thread(target=searcher_thread, args=(t,))
                   for t in range(2)]
        for t in threads:
            t.start()
        for round_ in range(3):
            s.push_batch(extra)
            dels = sorted(rng.choice(len(data), 2, replace=False).tolist())
            s.delete(dels)
        stop.set()
        for t in threads:
            t.join(timeout=60)
    assert not errors, errors

    rng2 = np.random.RandomState(11)
    extra2 = rng2.rand(5, 10).astype(np.float32)
    for round_ in range(3):
        twin.push_batch(extra2)
        dels = sorted(rng2.choice(len(data), 2, replace=False).tolist())
        twin.delete(dels)
    assert len(idx) == len(twin)
    qi, _ = sidx.search_padded(data[:8], 5, w=4)
    ti, _ = twin.search_padded(data[:8], 5, w=4)
    np.testing.assert_array_equal(qi, ti)


def test_concurrent_mutations_race_submits(served_index):
    """Mutation-safety contract (serving.py module docstring): submit()
    threads racing push_batch/delete through the searcher must neither
    crash nor corrupt — every future resolves, and after quiescing the
    served index matches a twin that applied the same mutations serially."""
    import threading

    data, _ = served_index
    rng = np.random.RandomState(7)
    idx = build_random_index(data)        # fresh clone (mutated below)
    twin = build_random_index(data)       # serial-reference twin

    extra = rng.rand(6, 10).astype(np.float32)
    stop = threading.Event()
    errors = []

    with BatchingSearcher(idx, max_batch=16, max_wait_ms=1) as s:
        def searcher_thread(seed):
            r = np.random.RandomState(seed)
            while not stop.is_set():
                try:
                    f = s.submit(data[r.randint(len(data))], 5, w=4)
                    ids, dists = f.result(timeout=60)
                    assert ids.shape == (5,)
                    assert np.isfinite(dists[ids >= 0]).all()
                except Exception as e:     # pragma: no cover - failure path
                    errors.append(e)
                    return

        threads = [threading.Thread(target=searcher_thread, args=(t,))
                   for t in range(4)]
        for t in threads:
            t.start()
        # interleave mutation bursts with the query storm
        for round_ in range(5):
            s.push_batch(extra)
            dels = sorted(rng.choice(len(data), 3, replace=False).tolist())
            s.delete(dels)
            s.push(extra[0] * 1.01)
            popped = s.pop()
            assert popped.shape == (10,)
        stop.set()
        for t in threads:
            t.join(timeout=60)
    assert not errors, errors

    # post-quiesce parity vs the serially-mutated twin
    rng2 = np.random.RandomState(7)
    extra2 = rng2.rand(6, 10).astype(np.float32)
    for round_ in range(5):
        twin.push_batch(extra2)
        dels = sorted(rng2.choice(len(data), 3, replace=False).tolist())
        twin.delete(dels)
        twin.push(extra2[0] * 1.01)
        twin.pop()
    assert len(idx) == len(twin)
    np.testing.assert_array_equal(idx.store.sizes, twin.store.sizes)
    qi, qd = idx.search_padded(data[:16], 5, w=4)
    ti, td = twin.search_padded(data[:16], 5, w=4)
    np.testing.assert_array_equal(qi, ti)
    np.testing.assert_allclose(qd, td, rtol=1e-5)
