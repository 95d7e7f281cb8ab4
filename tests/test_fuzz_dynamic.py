"""Randomized dynamic-op fuzzing against a model of the reference semantics.

A shadow model tracks the list of stored items by positional id, applying
the reference's id rules (/root/reference/src/utils.jl):
  push      -> new id = n
  push_front-> new id = 0, all ids += 1
  pop       -> removes id n-1
  pop_front -> removes id 0, all ids -= 1
  delete(S) -> survivors renumber by rank

After every op the index's live ids must be exactly {0..n-1}. Every stored
item's identity is pinned by its RECONSTRUCTION (centroid + decoded codes —
fixed at insertion time), so at the end `reconstruct(id)` must equal the
recorded reconstruction of whichever token the model says lives at that id,
and every pop must return the reconstruction of the model's last/first
token. This verifies the full id permutation under arbitrary op
interleavings, not just set membership.
"""

import numpy as np

from tests.conftest import build_random_index


def _apply(model, op, arg=None):
    """model: list of tokens ordered by current id."""
    if op == "push":
        model.append(arg)
    elif op == "push_front":
        model.insert(0, arg)
    elif op == "pop":
        return model.pop()
    elif op == "pop_front":
        return model.pop(0)
    elif op == "delete":
        for i in sorted(arg, reverse=True):
            del model[i]


def test_fuzzed_op_sequences_match_shadow_model(random_data):
    for seed in range(3):
        r = np.random.RandomState(seed)
        idx = build_random_index(random_data)
        n0 = len(idx)
        pool = np.concatenate([
            np.asarray(random_data, np.float32),
            r.rand(64, 10).astype(np.float32)])
        model = list(range(n0))
        recon = {t: idx.reconstruct(t) for t in range(n0)}
        next_tok = n0
        for step in range(12):
            op = r.choice(["push", "push_front", "pop", "pop_front",
                           "delete", "noop"])
            if op == "push" and next_tok < len(pool):
                idx.push(pool[next_tok])
                _apply(model, "push", next_tok)
                recon[next_tok] = idx.reconstruct(len(idx) - 1)
                next_tok += 1
            elif op == "push_front" and next_tok < len(pool):
                idx.push_front(pool[next_tok])
                _apply(model, "push_front", next_tok)
                recon[next_tok] = idx.reconstruct(0)
                next_tok += 1
            elif op == "pop" and len(model) > 5:
                v = idx.pop()
                tok = _apply(model, "pop")
                np.testing.assert_allclose(v, recon[tok], rtol=1e-5,
                                           err_msg=f"{seed}/{step} pop")
            elif op == "pop_front" and len(model) > 5:
                v = idx.pop_front()
                tok = _apply(model, "pop_front")
                np.testing.assert_allclose(v, recon[tok], rtol=1e-5,
                                           err_msg=f"{seed}/{step} pop_front")
            elif op == "delete" and len(model) > 8:
                dels = sorted(set(r.randint(0, len(model), 4).tolist()))
                idx.delete(dels)
                _apply(model, "delete", dels)
            assert len(idx) == len(model), (seed, step, op)
            live = np.sort(idx.store.ids[idx.store.ids >= 0])
            assert np.array_equal(live, np.arange(len(model))), (seed, step, op)
        # full permutation check: whoever the model says lives at id i must
        # reconstruct to that token's recorded vector
        sample = range(0, len(model), max(1, len(model) // 40))
        for cur_id in sample:
            np.testing.assert_allclose(
                idx.reconstruct(cur_id), recon[model[cur_id]], rtol=1e-5,
                err_msg=f"seed {seed} id {cur_id} token {model[cur_id]}")


def test_append_heavy_growth_kc4096_wallclock():
    """Cell growth must not rewrite the whole store: at kc=4096, appends
    that overflow many cells should complete in seconds, not minutes
    (the pre-relocation _grow_cell copied every cell per overflow)."""
    import time

    from ivfadc_tpu.models.inverted import PostingStore

    kc, m, n0 = 4096, 8, 4096          # 1 point/cell, tiny slack
    rng = np.random.RandomState(0)
    assignments = np.arange(n0) % kc
    codes = rng.randint(0, 256, (n0, m)).astype(np.uint8)
    store = PostingStore.build(assignments, codes, kc, slack=1.0, align=8)
    t0 = time.perf_counter()
    n_app = 20000                      # ~5 appends/cell -> hundreds of grows
    cells = rng.randint(0, kc, n_app)
    rows = rng.randint(0, 256, (n_app, m)).astype(np.uint8)
    for i in range(0, n_app, 500):
        store.append_batch(cells[i:i + 500], rows[i:i + 500], n0 + i)
    elapsed = time.perf_counter() - t0
    assert store.n == n0 + n_app
    assert elapsed < 20.0, f"append-heavy growth took {elapsed:.1f}s"
    # integrity after many relocations: every id findable, cells consistent
    live = np.sort(store.ids[store.ids >= 0])
    assert np.array_equal(live, np.arange(store.n))
    for ext in rng.randint(0, store.n, 50):
        cell, slot = store.find(int(ext))
        assert store.ids[slot] == ext
        o, c = int(store.offsets[cell]), int(store.caps[cell])
        assert o <= slot < o + c


def test_find_does_not_hydrate_codes():
    """find() must touch only `ids` — hydrating `codes` after a device-side
    build copies the whole code array to host."""
    from ivfadc_tpu.models.inverted import PostingStore

    rng = np.random.RandomState(1)
    n, m, kc = 2048, 4, 32
    assignments = rng.randint(0, kc, n)
    codes = rng.randint(0, 256, (n, m)).astype(np.uint8)
    store = PostingStore.build_device(assignments, codes, kc)
    cell, slot = store.find(777)
    assert store._codes_h is None, "find() hydrated the codes array"
    assert int(store.ids[slot]) == 777
