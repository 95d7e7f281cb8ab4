#!/usr/bin/env python
"""Smoke run of the whole system on an NVIDIA GPU, through its public API.

    python chip_smoke.py              # one card: every phase below
    python chip_smoke.py --chips 4    # four cards: the sharded phase only

Data is synthetic, generated on the card from `--seed`, at the shape of
ANN-Benchmarks `sift-128-euclidean`: 1,000,000 x 128 float32, L2. The index
is IVFADC with kc=1024 coarse cells and PQ m=8, k=256.

Phases (each prints its result and tolerance; any failure raises, so the
script exits non-zero and prints no result line):
  device      JAX must find a GPU (no CPU fallback); prints the card's name
              and power limit, the JAX version and XLA_FLAGS.
  build       IVFADCIndex.build; BuildTimer phases; memory_analysis() of
              the compiled search program.
  search      search_padded over 16,384 perturbed base points at k=10, w=8;
              recall@10 against exact brute force; parity with the NumPy
              reference oracle (benchmarks/oracle.py); self-query.
  dense       the same index with scan_mode="dense" (gathered decoded-
              residual scan): recall@10 within 0.01 of the LUT scan; both
              timed on the card.
  mutations   push_batch 10,000 / delete 1,000 with the reference's
              positional id shift; save/load round trip; BatchingSearcher
              with 64 concurrent requests vs search_padded.
  hnsw        the two-level (":hnsw") coarse quantizer at kc=16,384: probed
              cells equal a float64 NumPy top-w within the probed groups.
  sharded     (--chips 4 only) ShardedIVFADCIndex over a (data=1, shard=4)
              mesh vs the one-card index; ShardedIVFADCIndex.build and
              native push_batch/delete across the cards.

The last line of standard output is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))


@dataclasses.dataclass(frozen=True)
class Shape:
    """Sizes of one smoke run. The defaults are the full-size run; the
    tests use a tiny instance on the CPU."""
    n: int = 1_000_000          # base vectors (sift-128-euclidean: 1M)
    d: int = 128
    n_clusters: int = 256       # mixture components of the synthetic base
    noise: float = 1.0          # their spread (centers are unit normal):
                                # overlapping components, so PQ codes do
                                # not collapse into exact score ties
    kc: int = 1024
    m: int = 8
    k: int = 256
    coarse_maxiter: int = 25
    quantization_maxiter: int = 25
    nq: int = 16_384            # queries per search batch
    n_gt: int = 4096            # of which scored against exact brute force
    topk: int = 10
    w: int = 8
    n_oracle: int = 200
    n_push: int = 10_000
    n_delete: int = 1_000
    n_serve: int = 64
    hnsw_n: int = 262_144       # base slice the kc=16,384 index is built on
    hnsw_kc: int = 16_384
    hnsw_maxiter: int = 2
    hnsw_nq: int = 1024
    shard_maxiter: int = 8      # Lloyd iterations of the four-card builds


FULL = Shape()


def log(*parts) -> None:
    print(*parts, flush=True)


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ------------------------------------------------------------------ checks
def boundary_parity(ids_a, d_a, ids_b, d_b, rtol: float):
    """Row-wise agreement of two top-k answers up to ties at the k-th
    boundary (the rule of tests/test_oracle_parity.py): every id of `a`
    is in `b`'s row or scores within rtol of `b`'s k-th distance, and the
    sorted distances agree to rtol. Returns the fraction of rows whose id
    sets are identical."""
    same = 0
    for ia, da, ib, db in zip(ids_a, d_a, ids_b, d_b):
        la, lb = ia >= 0, ib >= 0
        ia, da, ib, db = ia[la], da[la], ib[lb], db[lb]
        _require(len(ia) == len(ib), f"row lengths differ: {ia} vs {ib}")
        if len(ib) == 0:
            same += 1
            continue
        kth = float(db[-1])
        bset = set(ib.tolist())
        for cand, cd in zip(ia.tolist(), da.tolist()):
            _require(cand in bset or abs(cd - kth) <= rtol * max(1.0,
                                                                 abs(kth)),
                     f"id {cand} (dist {cd}) absent, k-th {kth}")
        np.testing.assert_allclose(np.sort(da), np.sort(db), rtol=rtol,
                                   atol=rtol)
        same += set(ia.tolist()) == bset
    return same / max(len(ids_a), 1)


def self_query_ok(ids, dists, expect) -> np.ndarray:
    """Per row: the expected id ranks first, or ties the first distance
    (two postings with identical PQ codes score identically)."""
    ok = []
    for row_i, row_d, e in zip(ids, dists, expect):
        hit = np.nonzero(row_i == e)[0]
        ok.append(len(hit) > 0 and (hit[0] == 0 or np.isclose(
            row_d[hit[0]], row_d[0], rtol=1e-6, atol=0)))
    return np.asarray(ok)


# ------------------------------------------------------------------ phases
def device_phase(chips: int) -> dict:
    """Fail unless JAX's devices are GPUs; print the card, JAX, XLA_FLAGS."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: needs an NVIDIA GPU, JAX found "
            f"{devs[0].platform!r} ({devs[0].device_kind})")
    if len(devs) < chips:
        raise SystemExit(f"chip_smoke: --chips {chips} needs {chips} GPUs, "
                         f"JAX found {len(devs)}")
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        smi = f"unavailable ({type(e).__name__})"
    for line in smi.splitlines() or [smi]:
        log(f"[device] nvidia-smi: {line}")
    log(f"[device] jax {jax.__version__}; devices: {len(devs)} x "
        f"{devs[0].device_kind}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def make_data(shape: Shape, seed: int):
    """(base (n, d) f32, queries (nq, d) f32, query source rows), generated
    on the default device: a Gaussian mixture at the benchmark's shape,
    queries = base points plus small noise."""
    import jax
    import jax.numpy as jnp
    from ivfadc_tpu.utils.datasets import synthetic_clustered_device
    base = synthetic_clustered_device(shape.n, shape.d,
                                      n_clusters=shape.n_clusters,
                                      noise=shape.noise, seed=seed)
    src = np.random.RandomState(seed).choice(shape.n, shape.nq,
                                             replace=False)
    noise = 0.05 * jax.random.normal(jax.random.PRNGKey(seed + 1),
                                     (shape.nq, shape.d), jnp.float32)
    queries = base[jnp.asarray(src)] + noise
    return base, queries, src


def _config(shape: Shape, seed: int, **over):
    from ivfadc_tpu import IVFADCConfig
    kw = dict(kc=shape.kc, m=shape.m, k=shape.k, seed=seed,
              coarse_maxiter=shape.coarse_maxiter,
              quantization_maxiter=shape.quantization_maxiter)
    kw.update(over)
    return IVFADCConfig(**kw)


def build_phase(base, queries, shape: Shape, seed: int):
    from ivfadc_tpu import IVFADCIndex
    t0 = time.perf_counter()
    idx = IVFADCIndex.build(base, _config(shape, seed))
    log(f"[build] {idx!r} in {time.perf_counter() - t0:.2f} s")
    for name, sec in idx.build_timings.items():
        log(f"[build]   {name}: {sec:.3f} s")
    fn, args, kw = idx._search_call(queries, shape.topk, shape.w)
    mem = fn.lower(*args, **kw).compile().memory_analysis()
    if mem is None:
        log("[build] search memory_analysis: not available on this backend")
    else:
        fields = ("argument_size_in_bytes", "output_size_in_bytes",
                  "temp_size_in_bytes", "generated_code_size_in_bytes")
        log("[build] search memory_analysis (B=%d): " % shape.nq + ", ".join(
            f"{f}={getattr(mem, f, 'n/a')}" for f in fields))
    stats = idx.memory_stats()
    log(f"[build] cells: {stats['cells']}; bytes/vector "
        f"{stats['bytes_per_vector']}")
    _require(len(idx) == shape.n, f"index holds {len(idx)} != {shape.n}")
    return idx


def search_phase(idx, base, queries, src, shape: Shape) -> dict:
    from benchmarks.oracle import ReferenceOracle
    from ivfadc_tpu.utils.evaluation import brute_force_topk, recall_at_r
    from ivfadc_tpu.utils.timing import mean_time
    k, w = shape.topk, shape.w
    ids, dists = idx.search_padded(queries, k, w=w)
    _require(ids.shape == (shape.nq, k) and dists.shape == (shape.nq, k),
             f"search shapes {ids.shape} {dists.shape}")
    live = ids >= 0
    _require(bool(np.isfinite(dists[live]).all()), "non-finite distances")
    _require(bool((np.diff(np.where(live, dists, np.inf), axis=1)
                   >= 0).all()), "distances not ascending")
    sec = mean_time(lambda: idx._device_search(queries, k, w), reps=5)
    log(f"[search] B={shape.nq} k={k} w={w}: {sec * 1e3:.3f} ms/batch "
        f"({shape.nq / sec:.0f} queries/s, host clock, LUT scan)")
    n_gt = min(shape.n_gt, shape.nq)
    _, gt = brute_force_topk(base, queries[:n_gt], k)
    recall = recall_at_r(ids[:n_gt], gt, k)
    log(f"[search] recall@{k} vs exact brute force ({n_gt} queries): "
        f"{recall:.4f}")
    _require(recall > 0.1, f"recall@{k} {recall} implausibly low")

    # parity with the NumPy oracle of the reference algorithm, same index
    no = min(shape.n_oracle, n_gt)
    oracle = ReferenceOracle.from_index(idx)
    qn = np.asarray(queries[:no])
    o_ids, o_d = oracle.search_batch(qn, k, w)
    o_ids = np.stack([np.pad(i, (0, k - len(i)), constant_values=-1)
                      for i in o_ids])
    o_d = np.stack([np.pad(d, (0, k - len(d)), constant_values=np.inf)
                    for d in o_d])
    overlap = np.mean([len(set(a[a >= 0]) & set(b[b >= 0])) / k
                       for a, b in zip(ids[:no], o_ids)])
    r_ours = recall_at_r(ids[:no], gt[:no], k)
    r_oracle = recall_at_r(o_ids, gt[:no], k)
    log(f"[search] oracle parity ({no} queries): id overlap@{k} "
        f"{overlap:.4f} (>= 0.99), recall@{k} {r_ours:.4f} vs oracle "
        f"{r_oracle:.4f} (within 0.005)")
    _require(overlap >= 0.99, f"oracle id overlap {overlap}")
    _require(abs(r_ours - r_oracle) <= 0.005,
             f"recall {r_ours} vs oracle {r_oracle}")
    # distances: both at full float32 precision -> relative 1e-4
    boundary_parity(ids[:no], dists[:no], o_ids, o_d, rtol=1e-4)
    log("[search] oracle distances match to relative 1e-4")

    i = int(src[0])
    s_ids, s_d = idx.search(np.asarray(base[i]), 5, w=w)
    _require(bool(self_query_ok(s_ids[None], s_d[None], [i])[0]),
             f"self-query of base point {i} returned {s_ids}")
    log(f"[search] self-query of base point {i}: first = {int(s_ids[0])}")
    return {"ids": ids, "dists": dists, "gt": gt, "recall": recall,
            "seconds": sec}


def dense_phase(idx, queries, ref: dict, shape: Shape) -> dict:
    """The same index through the dense scan engine, against the LUT."""
    from ivfadc_tpu import IVFADCIndex
    from ivfadc_tpu.utils.evaluation import recall_at_r
    from ivfadc_tpu.utils.timing import mean_time
    k, w = shape.topk, shape.w
    dense = IVFADCIndex(dataclasses.replace(idx.config, scan_mode="dense"),
                        idx.coarse, idx.quantizer, idx.store.fork(),
                        idx.data_dtype, idx.dim)
    ids, _ = dense.search_padded(queries, k, w=w)
    n_gt = ref["gt"].shape[0]
    recall = recall_at_r(ids[:n_gt], ref["gt"], k)
    sec = mean_time(lambda: dense._device_search(queries, k, w), reps=5)
    log(f"[dense] B={shape.nq}: {sec * 1e3:.3f} ms/batch vs LUT "
        f"{ref['seconds'] * 1e3:.3f} ms (host clock)")
    log(f"[dense] recall@{k} {recall:.4f} vs LUT {ref['recall']:.4f} "
        f"(within 0.01: int8 decoded cache)")
    _require(abs(recall - ref["recall"]) <= 0.01,
             f"dense recall {recall} vs LUT {ref['recall']}")
    return {"recall": recall, "seconds": sec}


def mutation_phase(idx, base, shape: Shape, seed: int) -> None:
    """push_batch + delete with the positional id shift, save/load, and
    the batching server."""
    import jax.numpy as jnp
    from ivfadc_tpu import IVFADCIndex, BatchingSearcher
    k, w = shape.topk, shape.w
    rng = np.random.RandomState(seed + 7)
    n0 = len(idx)
    src = rng.choice(n0, shape.n_push, replace=False)
    pushed = np.asarray(base[jnp.asarray(src)]) + 0.02 * rng.randn(
        shape.n_push, shape.d).astype(np.float32)
    t0 = time.perf_counter()
    idx.push_batch(pushed)
    t_push = time.perf_counter() - t0
    dels = np.sort(rng.choice(n0 + shape.n_push, shape.n_delete,
                              replace=False))
    t0 = time.perf_counter()
    idx.delete(dels)
    t_del = time.perf_counter() - t0
    _require(len(idx) == n0 + shape.n_push - shape.n_delete,
             f"len {len(idx)} after push/delete")
    log(f"[mutations] push_batch {shape.n_push}: {t_push:.3f} s; delete "
        f"{shape.n_delete}: {t_del:.3f} s; n = {len(idx)}")

    # reference semantics: every surviving id drops by the number of
    # deleted ids below it (delete_from_index!, src/utils.jl:90-105)
    old = n0 + np.arange(shape.n_push)
    keep = ~np.isin(old, dels)
    probe = np.nonzero(keep)[0][:256]
    want = old[probe] - np.searchsorted(dels, old[probe])
    ids, dists = idx.search_padded(pushed[probe], 5, w=w)
    ok = self_query_ok(ids, dists, want)
    log(f"[mutations] pushed points found at their shifted ids: "
        f"{ok.sum()}/{len(ok)}")
    _require(ok.mean() >= 0.99, f"shifted-id self-queries {ok.mean()}")
    deleted_pushed = old[~keep] - n0
    if len(deleted_pushed):
        ids_d, _ = idx.search_padded(pushed[deleted_pushed[:64]], 5, w=w)
        # a deleted point's old id now names another point; what must not
        # happen is a result beyond the live range
        _require(bool((ids_d < len(idx)).all()), "id beyond live range")

    q = np.asarray(base[:shape.n_serve]) + 0.01
    ids_a, d_a = idx.search_padded(q, k, w=w)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "index.npz")
        idx.save(path)
        size = os.path.getsize(path)
        loaded = IVFADCIndex.load(path)
    ids_b, d_b = loaded.search_padded(q, k, w=w)
    _require(bool((ids_a == ids_b).all()), "ids differ after save/load")
    _require(bool((d_a == d_b).all()), "distances differ after save/load")
    log(f"[mutations] save/load ({size} bytes): identical results")

    from concurrent.futures import wait
    with BatchingSearcher(idx, max_batch=shape.n_serve,
                          max_wait_ms=200.0) as srv:
        futs = [srv.submit(q[i], k, w) for i in range(shape.n_serve)]
        done, _ = wait(futs, timeout=600)
        _require(len(done) == len(futs), "serving requests timed out")
        got = [f.result() for f in futs]
    ids_s = np.stack([g[0] for g in got])
    d_s = np.stack([g[1] for g in got])
    same = boundary_parity(ids_s, d_s, ids_a, d_a, rtol=1e-6)
    log(f"[mutations] BatchingSearcher, {shape.n_serve} concurrent submits: "
        f"rows identical to search_padded {same:.4f}")
    _require(same == 1.0, f"served rows differ: {same}")


def hnsw_phase(base, queries, shape: Shape, seed: int) -> None:
    """Two-level coarse quantizer above 4,096 cells: the probed cells are
    the exact top-w of the members of the probed groups."""
    import jax.numpy as jnp
    from ivfadc_tpu import IVFADCIndex
    w = shape.w
    sub = base[:shape.hnsw_n]
    t0 = time.perf_counter()
    idx = IVFADCIndex.build(sub, _config(
        shape, seed, kc=shape.hnsw_kc, coarse_quantizer="hnsw",
        coarse_maxiter=shape.hnsw_maxiter, quantization_maxiter=4))
    cq = idx.coarse
    log(f"[hnsw] {cq!r} on {shape.hnsw_n} points "
        f"({shape.hnsw_maxiter} Lloyd iterations) in "
        f"{time.perf_counter() - t0:.2f} s")
    q = queries[:shape.hnsw_nq]
    cells, dists = cq.search(q, w)
    cells, dists = np.asarray(cells), np.asarray(dists)
    q64 = np.asarray(q, np.float64)
    cents = np.asarray(cq.centroids, np.float64)
    gcen = np.asarray(cq.group_centers, np.float64)
    members = np.asarray(cq.members)
    gp = min(cq.n_probe_groups, gcen.shape[0])
    eps = np.finfo(np.float32).eps
    checked = exact = 0
    for b in range(len(q64)):
        gd = ((q64[b] - gcen) ** 2).sum(-1)
        order = np.argsort(gd)
        tol_g = 32 * eps * gd.max()
        if gp < len(gd) and gd[order[gp]] - gd[order[gp - 1]] <= tol_g:
            continue        # float32 may pick either group at the boundary
        cand = members[order[:gp]].reshape(-1)
        cand = cand[cand >= 0]
        cd = ((q64[b] - cents[cand]) ** 2).sum(-1)
        want = np.sort(cd)[:w]
        got = np.sort(((q64[b] - cents[cells[b]]) ** 2).sum(-1))
        checked += 1
        tol = 32 * eps * cd.max()
        _require(bool(np.isin(cells[b], cand).all()),
                 f"query {b}: a probed cell lies outside the probed groups")
        _require(bool(np.allclose(got, want, rtol=0, atol=tol)),
                 f"query {b}: probed cells are not the top-{w}")
        exact += set(cells[b].tolist()) == set(
            cand[np.argsort(cd)[:w]].tolist())
    _require(checked >= 0.9 * len(q64), f"only {checked} rows separable")
    np.testing.assert_allclose(
        np.sort(dists, axis=1),
        np.sort(((q64[:, None, :] - cents[cells]) ** 2).sum(-1), axis=1),
        rtol=1e-4, atol=1e-3)
    log(f"[hnsw] probed cells = float64 top-{w} within the {gp} probed "
        f"groups: {checked}/{len(q64)} rows checked (32-ulp ties), "
        f"{exact} identical sets")
    ids, _ = idx.search_padded(q, shape.topk, w=w)
    _require(bool((ids[:, 0] >= 0).all()), "hnsw search returned no ids")


def sharded_phase(base, queries, shape: Shape, seed: int, chips: int
                  ) -> None:
    """Sharded serving over `chips` cards vs the one-card index, then the
    distributed build and native mutations across the cards."""
    import jax.numpy as jnp
    from ivfadc_tpu import IVFADCIndex, ShardedIVFADCIndex, make_mesh
    k, w = shape.topk, shape.w
    cfg = _config(shape, seed, coarse_maxiter=shape.shard_maxiter,
                  quantization_maxiter=shape.shard_maxiter)
    mesh = make_mesh(n_shards=chips, n_data=1)
    t0 = time.perf_counter()
    idx = IVFADCIndex.build(base, cfg)
    log(f"[sharded] one-card index ({cfg.coarse_maxiter} Lloyd iterations)"
        f" built in {time.perf_counter() - t0:.2f} s")
    sidx = ShardedIVFADCIndex(idx, mesh)
    ids1, d1 = idx.search_padded(queries, k, w=w)
    ids4, d4 = sidx.search_padded(queries, k, w=w)
    rows = float((ids1 == ids4).all(axis=1).mean())
    log(f"[sharded] {sidx!r}")
    log(f"[sharded] {chips}-card vs one-card: rows with equal ids {rows:.4f}"
        f" (>= 0.99), distances rtol 1e-4")
    _require(rows >= 0.99, f"sharded rows equal {rows}")
    np.testing.assert_allclose(d4, d1, rtol=1e-4, atol=1e-4)

    t0 = time.perf_counter()
    sb = ShardedIVFADCIndex.build(base, mesh, cfg)
    log(f"[sharded] ShardedIVFADCIndex.build in "
        f"{time.perf_counter() - t0:.2f} s: {len(sb.index)} vectors")
    rng = np.random.RandomState(seed + 11)
    n0 = len(sb.index)
    src = rng.choice(n0, shape.n_push, replace=False)
    pushed = np.asarray(base[jnp.asarray(src)]) + 0.02 * rng.randn(
        shape.n_push, shape.d).astype(np.float32)
    t0 = time.perf_counter()
    sb.push_batch(pushed)
    dels = np.sort(rng.choice(n0 + shape.n_push, shape.n_delete,
                              replace=False))
    sb.delete(dels)
    log(f"[sharded] native push_batch {shape.n_push} + delete "
        f"{shape.n_delete}: {time.perf_counter() - t0:.3f} s")
    _require(len(sb.index) == n0 + shape.n_push - shape.n_delete,
             f"sharded len {len(sb.index)}")
    live = np.asarray(sb.arrays["ids"])
    live = np.sort(live[live >= 0])
    _require(bool((live == np.arange(len(sb.index))).all()),
             "sharded ids are not the contiguous range 0..n-1")
    old = n0 + np.arange(shape.n_push)
    probe = np.nonzero(~np.isin(old, dels))[0][:256]
    want = old[probe] - np.searchsorted(dels, old[probe])
    ids, dists = sb.search_padded(pushed[probe], 5, w=w)
    ok = self_query_ok(ids, dists, want)
    log(f"[sharded] pushed points found at their shifted ids: "
        f"{ok.sum()}/{len(ok)}")
    _require(ok.mean() >= 0.99, f"sharded shifted-id self-queries {ok}")


def run(shape: Shape, seed: int, chips: int) -> None:
    """Every phase of one run, on whatever devices JAX has (the tests call
    this on the CPU at a tiny shape)."""
    base, queries, src = make_data(shape, seed)
    if chips > 1:
        sharded_phase(base, queries, shape, seed, chips)
        return
    idx = build_phase(base, queries, shape, seed)
    ref = search_phase(idx, base, queries, src, shape)
    dense_phase(idx, queries, ref, shape)
    mutation_phase(idx, base, shape, seed)
    hnsw_phase(base, queries, shape, seed)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4),
                    help="4: run only the sharded phase, across four cards")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = device_phase(args.chips)
    sys.path.insert(0, ROOT)
    from ivfadc_tpu.utils.compile_cache import enable_compile_cache
    log(f"[device] compilation cache: {enable_compile_cache()}")
    t0 = time.perf_counter()
    run(FULL, args.seed, args.chips)
    log(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
