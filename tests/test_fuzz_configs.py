"""Config-space fuzz: random (d, kc, m, k, metric, method, dtype, coarse)
combinations through build -> search on BOTH scan engines.

Motivation: shape handling (ragged-subspace padding, candidate supply
below k, two-level probe padding, query chunking) breaks only at untested
shape combinations; fixed-config tests never see those, so this fuzz walks
the config lattice every run.

Invariants checked per config (reference contracts, src/index.jl:204-258):
ascending distances, 0-based ids in range, <= k results; dense and LUT
engines agree up to the int8 decoded cache's quantization noise (same
boundary-tie rule as tests/test_oracle_parity.py — every neighbor from one
engine is in the other's set or scores within tolerance of its k-th best).
"""

import numpy as np
import pytest

pytestmark = pytest.mark.heavy    # full gate-lattice walk, ~70 s total

from ivfadc_tpu import IVFADCIndex

_RT = 2e-2          # int8 decoded-cache tolerance (test_oracle_parity.py)


def _rand_config(rng):
    d = int(rng.choice([7, 16, 30, 64, 128, 200]))
    kc = int(rng.choice([2, 5, 17, 32, 128]))
    m = min(int(rng.choice([1, 2, 3, 4, 8])), d)
    k = int(rng.choice([2, 16, 64]))
    n = int(rng.randint(kc + 60, 400))
    method = rng.choice(["pq", "opq"])
    coarse_metric = rng.choice(["sqeuclidean", "euclidean", "cityblock"])
    quant_metric = rng.choice(["sqeuclidean", "inner_product"])
    dtype = rng.choice(["uint16", "uint32"])
    coarse = rng.choice(["naive", "hnsw"])
    w = int(rng.randint(1, min(kc, 8) + 1))
    topk = int(rng.randint(1, 11))
    return dict(n=n, d=d, kc=kc, m=m, k=k, method=method,
                coarse_metric=coarse_metric, quant_metric=quant_metric,
                dtype=dtype, coarse=coarse, w=w, topk=topk)


def _agree_up_to_boundary_ties(ids_a, dist_a, ids_b, dist_b, c):
    """Every live neighbor of engine A appears in engine B's set, or its
    distance ties B's k-th best within the cache tolerance."""
    live_b = ids_b >= 0
    if not live_b.any():
        assert not (ids_a >= 0).any(), c
        return
    kth = float(dist_b[live_b].max())
    tol = _RT * max(1.0, abs(kth))
    bset = set(ids_b[live_b].tolist())
    for cand, cd in zip(ids_a.tolist(), dist_a.tolist()):
        if cand < 0:
            continue
        assert cand in bset or abs(cd - kth) <= tol, (c, cand, cd, kth)


@pytest.mark.parametrize("trial", range(10))
def test_random_config_build_search(trial):
    rng = np.random.RandomState(1000 + trial)
    c = _rand_config(rng)
    rng.rand()           # keep each trial's draws (and config) as before
    data = rng.randn(c["n"], c["d"]).astype(np.float32)

    def build(scan_mode):
        return IVFADCIndex.build(
            data, kc=c["kc"], k=min(c["k"], c["n"]), m=c["m"], seed=trial,
            quantization_method=c["method"],
            coarse_metric=c["coarse_metric"],
            quantization_metric=c["quant_metric"],
            index_dtype=c["dtype"], coarse_quantizer=c["coarse"],
            coarse_maxiter=4, quantization_maxiter=4, scan_mode=scan_mode)

    dense = build("dense")
    lut = build("lut")
    queries = data[rng.randint(0, c["n"], 6)] \
        + 0.01 * rng.randn(6, c["d"]).astype(np.float32)

    ids_d, dist_d = dense.search_padded(queries, c["topk"], w=c["w"])
    ids_l, dist_l = lut.search_padded(queries, c["topk"], w=c["w"])
    for row_i, row_dist in ((ids_d, dist_d), (ids_l, dist_l)):
        live = row_i >= 0
        assert row_i[live].min(initial=0) >= 0
        assert row_i[live].max(initial=0) < c["n"]
        if c["quant_metric"] != "inner_product":   # IP scores can descend
            for i in range(len(queries)):          # ascending among live
                dd = row_dist[i][row_i[i] >= 0]
                assert (np.diff(dd) >= -1e-4 * max(
                    1.0, abs(float(dd[0])) if dd.size else 1.0)).all(), (c, dd)
    for i in range(len(queries)):
        _agree_up_to_boundary_ties(ids_d[i], dist_d[i], ids_l[i], dist_l[i], (trial, c, i))
        _agree_up_to_boundary_ties(ids_l[i], dist_l[i], ids_d[i], dist_d[i], (trial, c, i))


@pytest.mark.parametrize("w", [64, 128])
def test_large_w_times_d_takes_fallback_not_crash(w):
    """Large w*d: the dense scan's (chunk, w, win, d) gather block must
    shrink its query chunk to fit the byte budget; results must stay
    correct (every returned id valid, ascending distances)."""
    rng = np.random.RandomState(3)
    d, kc, n = 256, 128, 600
    data = rng.randn(n, d).astype(np.float32)
    idx = IVFADCIndex.build(data, kc=kc, k=32, m=8, seed=0,
                            coarse_maxiter=4, quantization_maxiter=4,
                            scan_mode="dense")
    ids, dists = idx.search_padded(data[:4], 10, w=w)
    live = ids >= 0
    assert live.any()
    assert ids[live].max() < n and ids[live].min() >= 0
    for i in range(4):
        dd = dists[i][ids[i] >= 0]
        assert (np.diff(dd) >= -1e-4).all()
    # self-neighbors: each query is a base row
    assert (ids[:, 0] == np.arange(4)).mean() >= 0.75


@pytest.mark.parametrize("trial", range(6))
def test_random_config_streaming_matches_build(trial):
    """The streamed build must reproduce `build` EXACTLY (same seed,
    train_data = the full stream) at every point of the config lattice —
    opq rotation applied during chunk encode, two-level coarse, every
    metric pair, ragged m∤d, odd chunk boundaries."""
    rng = np.random.RandomState(7000 + trial)
    c = _rand_config(rng)
    data = rng.randn(c["n"], c["d"]).astype(np.float32)
    kw = dict(kc=c["kc"], k=min(c["k"], c["n"]), m=c["m"], seed=trial,
              quantization_method=c["method"],
              coarse_metric=c["coarse_metric"],
              quantization_metric=c["quant_metric"],
              index_dtype=c["dtype"], coarse_quantizer=c["coarse"],
              coarse_maxiter=4, quantization_maxiter=4)
    ref = IVFADCIndex.build(data, **kw)
    rows = int(rng.randint(40, c["n"] + 1))          # odd chunk boundaries
    chunks = [data[i:i + rows] for i in range(0, c["n"], rows)]
    strm = IVFADCIndex.build_streaming(chunks, train_data=data, **kw)
    assert len(strm) == len(ref) == c["n"]
    queries = data[rng.randint(0, c["n"], 6)]
    ri, rd = ref.search_padded(queries, c["topk"], w=c["w"])
    si, sd = strm.search_padded(queries, c["topk"], w=c["w"])
    np.testing.assert_array_equal(np.asarray(si), np.asarray(ri), err_msg=str(c))
    np.testing.assert_allclose(np.asarray(sd), np.asarray(rd),
                               rtol=1e-5, atol=1e-5, err_msg=str(c))
