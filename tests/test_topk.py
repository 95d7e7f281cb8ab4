"""Smallest-k selection (ops/topk.py) and the coarse quantizers built on it:
exactness vs lax.top_k and vs float64 NumPy references."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ivfadc_tpu.ops.topk import topk_lastdim


@pytest.mark.parametrize("shape,k", [
    ((64, 1024), 10),
    ((8, 128), 8),
    ((128, 2048), 128),
    ((1000, 1024), 10),   # B divisible by 8 only
])
def test_topk_matches_lax(shape, k):
    rng = np.random.RandomState(0)
    x = jnp.asarray(rng.randn(*shape).astype(np.float32))
    vals, idx = topk_lastdim(x, k)
    neg, _ = jax.lax.top_k(-x, k)
    np.testing.assert_allclose(np.asarray(vals), -np.asarray(neg), rtol=0)
    # indices must actually point at the returned values
    got = np.take_along_axis(np.asarray(x), np.asarray(idx), axis=1)
    np.testing.assert_allclose(got, np.asarray(vals), rtol=0)


@pytest.mark.parametrize("shape,k", [
    ((7, 1000), 5),      # falls back: B % 8 != 0, N % 128 != 0
    ((4, 96), 96),       # k > 128 not needed; N tiny
])
def test_topk_fallback_shapes(shape, k):
    rng = np.random.RandomState(1)
    x = jnp.asarray(rng.randn(*shape).astype(np.float32))
    vals, idx = topk_lastdim(x, k)
    neg, _ = jax.lax.top_k(-x, k)
    np.testing.assert_allclose(np.asarray(vals), -np.asarray(neg), rtol=0)


def test_topk_with_inf_padding():
    x = np.full((8, 256), np.inf, np.float32)
    x[:, :5] = np.arange(5, dtype=np.float32)
    vals, idx = topk_lastdim(jnp.asarray(x), 10)
    v = np.asarray(vals)
    assert (v[:, :5] == np.arange(5)).all()
    assert np.isinf(v[:, 5:]).all()


@pytest.mark.heavy                # ~9 s: kc=2^14 two-level coarse stress
def test_two_level_scan_stage2_large_kc():
    """Large kc: the chunked exact stage 2 must return (approximately) the
    true nearest cells — measured as top-w recall vs the exact brute-force
    coarse scan — with exact float32 distances."""
    from ivfadc_tpu.models.coarse import NaiveCoarseQuantizer, build_two_level
    from ivfadc_tpu.ops.metrics import SQEUCLIDEAN
    rng = np.random.RandomState(0)
    kc, d = 8192, 32
    cents = jnp.asarray(rng.randn(kc, d).astype(np.float32))
    tl = build_two_level(jax.random.PRNGKey(0), cents, SQEUCLIDEAN,
                         maxiter=8)
    naive = NaiveCoarseQuantizer(cents, SQEUCLIDEAN)
    q = jnp.asarray(rng.randn(64, d).astype(np.float32))
    cells_tl, dists_tl = tl.search(q, 4)
    cells_ex, _ = naive.search(q, 4)
    hit = np.mean([len(set(a.tolist()) & set(b.tolist())) / 4
                   for a, b in zip(np.asarray(cells_tl),
                                   np.asarray(cells_ex))])
    # uniform random centroids are the worst case for group pruning (no
    # cluster structure to exploit); real coarse centroids do much better
    assert hit >= 0.8, hit
    # distances are the true squared distances: float32 rounding of the
    # |q|^2 + |c|^2 - 2 q.c decomposition at |q|^2 ~ d
    true_d = np.asarray(
        jnp.sum((q[:, None, :] - cents[cells_tl]) ** 2, axis=-1))
    np.testing.assert_allclose(np.asarray(dists_tl), true_d,
                               rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("shape,k", [((16, 300), 7), ((5, 64), 64)])
def test_topk_payload_matches_gather(shape, k):
    """The payload variant returns each winner's payload entry."""
    from ivfadc_tpu.ops.topk import topk_lastdim_payload
    rng = np.random.RandomState(2)
    x = rng.randn(*shape).astype(np.float32)
    p = rng.randint(0, 1 << 30, shape).astype(np.int32)
    vals, pay = topk_lastdim_payload(jnp.asarray(x), jnp.asarray(p), k)
    order = np.argsort(x, axis=1, kind="stable")[:, :k]
    np.testing.assert_array_equal(np.asarray(vals),
                                  np.take_along_axis(x, order, axis=1))
    np.testing.assert_array_equal(np.asarray(pay),
                                  np.take_along_axis(p, order, axis=1))


@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
@pytest.mark.parametrize("seed", [0, 1])
def test_coarse_search_exact_on_near_ties(metric, seed):
    """The brute-force coarse probe is contracted as exact: on centroids
    whose distances to a query differ only in the 5th significant digit,
    it must rank them like a float64 NumPy scan. A TF32 matmul (10-bit
    mantissa) would scramble these rankings."""
    from ivfadc_tpu.models.coarse import NaiveCoarseQuantizer
    from ivfadc_tpu.ops.metrics import get_metric
    rng = np.random.RandomState(seed)
    d, kc, B, w = 64, 256, 32, 8
    q = rng.randn(B, d).astype(np.float32)
    base = rng.randn(d).astype(np.float32)
    # centroids = one shared point + tiny distinct perturbations: every
    # query sees kc near-tied distances
    cents = (base[None, :]
             + 1e-3 * rng.randn(kc, d).astype(np.float32)).astype(np.float32)
    cq = NaiveCoarseQuantizer(jnp.asarray(cents), get_metric(metric))
    cells, dists = cq.search(jnp.asarray(q), w)
    q64, c64 = q.astype(np.float64), cents.astype(np.float64)
    if metric == "sqeuclidean":
        ref = ((q64[:, None, :] - c64[None, :, :]) ** 2).sum(-1)
    else:
        ref = -(q64 @ c64.T)
    got = np.asarray(cells)
    # float32 can still swap two centroids whose float64 distances differ
    # by less than its own rounding (a few ulps of the distance magnitude);
    # so the chosen cells must be a top-w set to within 32 ulps: their
    # float64 distances, sorted, equal the true top-w distances. TF32 errors
    # (~5e-4 relative) break this bound many times over.
    tol = 32 * np.finfo(np.float32).eps * np.abs(ref).max()
    chosen = np.sort(np.take_along_axis(ref, got, axis=1), axis=1)
    np.testing.assert_allclose(chosen, np.sort(ref, axis=1)[:, :w],
                               rtol=0, atol=tol)
    np.testing.assert_allclose(np.asarray(dists),
                               np.take_along_axis(ref, got, axis=1),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("kc,gp", [(512, 4), (2048, 8)])
def test_two_level_stage2_exact_within_probed_groups(kc, gp):
    """Stage 2 returns the exact top-w of the members of the probed groups,
    as a float64 NumPy reference computes it (at any kc — there is no
    approximate large-kc engine)."""
    from ivfadc_tpu.models.coarse import build_two_level
    from ivfadc_tpu.ops.metrics import SQEUCLIDEAN
    rng = np.random.RandomState(kc)
    d, w, B = 16, 8, 24
    cents = rng.randn(kc, d).astype(np.float32)
    tl = build_two_level(jax.random.PRNGKey(1), jnp.asarray(cents),
                         SQEUCLIDEAN, n_probe_groups=gp, maxiter=4)
    q = rng.randn(B, d).astype(np.float32)
    cells, dists = tl.search(jnp.asarray(q), w)
    gc = np.asarray(tl.group_centers, np.float64)
    mem = np.asarray(tl.members)
    q64, c64 = q.astype(np.float64), cents.astype(np.float64)
    gd = ((q64[:, None, :] - gc[None]) ** 2).sum(-1)
    for b in range(B):
        groups = np.argsort(gd[b], kind="stable")[:gp]
        cand = mem[groups].reshape(-1)
        cand = cand[cand >= 0]
        cd = ((q64[b] - c64[cand]) ** 2).sum(-1)
        want = np.sort(cd)[:w]
        got_d = ((q64[b] - c64[np.asarray(cells)[b]]) ** 2).sum(-1)
        np.testing.assert_allclose(np.sort(got_d), want, rtol=1e-6)
        assert set(np.asarray(cells)[b].tolist()) <= set(cand.tolist())


def _interpreted(x, k):
    """ops/topk.py's CUDA path, with the Pallas kernel run by Pallas's
    interpreter (the CPU has no Triton)."""
    import functools
    from ivfadc_tpu.ops import topk as tk
    return tk.chunked_smallest(
        x, k, call=functools.partial(tk.extract_call, interpret=True))


@pytest.mark.parametrize("shape,k", [
    ((8, 1024), 8),        # coarse-probe shape, one slice per row
    ((4, 5000), 10),       # ragged width: +inf padding, 3 slices, 2 stages
    ((3, 40), 1),          # narrow row, k = 1
    ((2, 4096), 32),       # the largest k the kernel serves
])
def test_triton_topk_interpreted_matches_lax(shape, k):
    """The GPU smallest-k (slice-wise min-extract, then a second stage)
    returns lax.top_k's values and indices exactly."""
    rng = np.random.RandomState(sum(shape) + k)
    x = rng.randn(*shape).astype(np.float32)
    vals, idx = _interpreted(jnp.asarray(x), k)
    order = np.argsort(x, axis=1, kind="stable")[:, :k]
    np.testing.assert_array_equal(np.asarray(vals),
                                  np.take_along_axis(x, order, axis=1))
    np.testing.assert_array_equal(np.asarray(idx), order)


def test_triton_topk_interpreted_ties_and_inf_tail():
    """Ties resolve to the lowest index (like lax.top_k); rows with fewer
    than k finite entries put their finite ones first, +inf after."""
    x = np.full((2, 3000), np.inf, np.float32)
    x[0, [5, 2500, 7]] = [1.0, 1.0, 0.5]
    x[1, :] = 2.0
    vals, idx = _interpreted(jnp.asarray(x), 4)
    vals, idx = np.asarray(vals), np.asarray(idx)
    np.testing.assert_array_equal(vals[0, :3], [0.5, 1.0, 1.0])
    np.testing.assert_array_equal(idx[0, :3], [7, 5, 2500])
    assert np.isinf(vals[0, 3])
    np.testing.assert_array_equal(idx[1], [0, 1, 2, 3])


def test_topk_lastdim_large_k_takes_xla_path():
    """k above the kernel's limit goes to lax.top_k on every platform."""
    from ivfadc_tpu.ops.topk import _MAX_K
    x = jnp.asarray(np.random.RandomState(5).randn(3, 500), jnp.float32)
    vals, idx = topk_lastdim(x, _MAX_K + 8)
    np.testing.assert_array_equal(
        np.asarray(vals), np.sort(np.asarray(x), axis=1)[:, :_MAX_K + 8])
