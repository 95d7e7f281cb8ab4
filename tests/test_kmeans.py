"""M0 unit tests: k-means vs a NumPy oracle (SURVEY §7 M0)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ivfadc_tpu.ops.kmeans import kmeans, kmeans_plus_plus
from ivfadc_tpu.ops.metrics import SQEUCLIDEAN, get_metric


def _np_assign(x, centers):
    d = ((x[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
    return d.argmin(1), d.min(1)


def test_kmeans_shapes_and_types():
    x = np.random.RandomState(0).rand(300, 8).astype(np.float32)
    res = kmeans(jax.random.PRNGKey(0), jnp.asarray(x), 10, maxiter=10)
    assert res.centers.shape == (10, 8)
    assert res.assignments.shape == (300,)
    assert res.assignments.dtype == jnp.int32
    assert int(res.assignments.max()) < 10


def test_kmeans_assignments_are_nearest_center():
    x = np.random.RandomState(1).rand(500, 6).astype(np.float32)
    res = kmeans(jax.random.PRNGKey(1), jnp.asarray(x), 8, maxiter=15)
    a_np, _ = _np_assign(x, np.asarray(res.centers))
    assert np.array_equal(a_np, np.asarray(res.assignments))


def test_kmeans_recovers_separated_clusters():
    rng = np.random.RandomState(2)
    centers_true = rng.randn(5, 4) * 20
    x = np.concatenate([c + 0.1 * rng.randn(50, 4) for c in centers_true])
    res = kmeans(jax.random.PRNGKey(2), jnp.asarray(x, jnp.float32), 5,
                 maxiter=20)
    # every found center must be within noise distance of a true center
    d = ((np.asarray(res.centers)[:, None] - centers_true[None]) ** 2).sum(-1)
    assert (d.min(1) < 1.0).all()
    # objective: mean intra-cluster distance tiny vs data scale
    _, mind = _np_assign(x, np.asarray(res.centers))
    assert mind.mean() < 1.0


def test_kmeans_objective_decreases_vs_random_centers():
    rng = np.random.RandomState(3)
    x = rng.rand(400, 10).astype(np.float32)
    res = kmeans(jax.random.PRNGKey(3), jnp.asarray(x), 16, maxiter=25)
    _, mind = _np_assign(x, np.asarray(res.centers))
    _, mind0 = _np_assign(x, x[rng.choice(400, 16, replace=False)])
    assert mind.mean() < mind0.mean()


def test_kmeanspp_centers_are_data_points():
    x = np.random.RandomState(4).rand(100, 3).astype(np.float32)
    c = np.asarray(kmeans_plus_plus(jax.random.PRNGKey(4), jnp.asarray(x), 7))
    d = ((c[:, None] - x[None]) ** 2).sum(-1).min(1)
    assert (d < 1e-9).all()
    # no duplicate seeds on well-spread data
    assert len({tuple(np.round(r, 6)) for r in c}) == 7


def test_kmeans_k_greater_than_n_raises():
    x = np.random.RandomState(5).rand(10, 3)
    with pytest.raises(AssertionError):
        kmeans(jax.random.PRNGKey(0), jnp.asarray(x), 11)


def test_kmeans_handles_k_close_to_n():
    # reference tests build kc=100 cells from 243 points (test/index.jl:1-8)
    x = np.random.RandomState(6).rand(243, 10).astype(np.float32)
    res = kmeans(jax.random.PRNGKey(6), jnp.asarray(x), 100, maxiter=25)
    assert np.isfinite(np.asarray(res.centers)).all()
    # empty cells are allowed (SURVEY §2.3) but most should be populated
    used = len(np.unique(np.asarray(res.assignments)))
    assert used > 50


def test_kmeans_deterministic_given_key():
    x = np.random.RandomState(7).rand(200, 5).astype(np.float32)
    r1 = kmeans(jax.random.PRNGKey(9), jnp.asarray(x), 6, maxiter=10)
    r2 = kmeans(jax.random.PRNGKey(9), jnp.asarray(x), 6, maxiter=10)
    assert np.array_equal(np.asarray(r1.centers), np.asarray(r2.centers))


def test_kmeans_cosine_recovers_directional_clusters():
    """coarse k-means under cosine: assignment under the metric, mean
    update — the Clustering.jl-parity policy
    (/root/reference/src/index.jl:129-134 passes any coarse_distance)."""
    rng = np.random.RandomState(8)
    # 4 directional clusters: same direction, wildly different norms
    dirs = rng.randn(4, 8)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    pts = []
    for dvec in dirs:
        v = dvec[None, :] + 0.05 * rng.randn(60, 8)
        v *= rng.uniform(0.5, 20.0, (60, 1))        # scale noise
        pts.append(v)
    x = np.concatenate(pts).astype(np.float32)
    cos = get_metric("cosine")
    res = kmeans(jax.random.PRNGKey(8), jnp.asarray(x), 4, maxiter=20,
                 metric=cos)
    a = np.asarray(res.assignments)
    # each true directional cluster maps to exactly one found cluster
    labels = [np.bincount(a[i * 60:(i + 1) * 60], minlength=4).argmax()
              for i in range(4)]
    assert len(set(labels)) == 4
    purity = np.mean([
        (a[i * 60:(i + 1) * 60] == labels[i]).mean() for i in range(4)])
    assert purity > 0.95
    # assignments are nearest-center under COSINE (not sqeuclidean)
    c = np.asarray(res.centers)
    cn = c / np.maximum(np.linalg.norm(c, axis=1, keepdims=True), 1e-30)
    xn = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-30)
    assert np.array_equal(a, (1.0 - xn @ cn.T).argmin(1))


def test_kmeans_inner_product_trains():
    """inner_product k-means is the same assign-under-metric heuristic the
    reference inherits from Clustering.jl — it must run and produce finite
    centers with nearest-center (max dot) assignments."""
    rng = np.random.RandomState(9)
    x = rng.rand(300, 6).astype(np.float32) + 0.1
    ip = get_metric("inner_product")
    res = kmeans(jax.random.PRNGKey(9), jnp.asarray(x), 5, maxiter=10,
                 metric=ip)
    c = np.asarray(res.centers)
    assert np.isfinite(c).all()
    a = np.asarray(res.assignments)
    assert np.array_equal(a, (-(x @ c.T)).argmin(1))


def test_kmeans_parallel_seeding_quality():
    """k-means|| seeding (used automatically for k > _PP_MAX_K instead of
    the old silent random downgrade): seeds are real data points, spread
    by D^2 weighting — on well-separated clusters the seeding alone covers
    nearly every true cluster, where uniform random seeding reliably
    misses some."""
    import jax
    import jax.numpy as jnp
    from ivfadc_tpu.ops.kmeans import kmeans_parallel

    rng = np.random.RandomState(0)
    k = 48
    centers_true = rng.randn(k, 8).astype(np.float32) * 30
    data = np.concatenate(
        [c + 0.1 * rng.randn(50, 8).astype(np.float32)
         for c in centers_true])
    seeds = np.asarray(kmeans_parallel(jax.random.PRNGKey(0),
                                       jnp.asarray(data), k))
    assert seeds.shape == (k, 8)
    # every seed is an actual data point
    d2 = ((seeds[:, None, :] - data[None, :500:7, :]) ** 2).sum(-1)
    # coverage: how many TRUE clusters got at least one seed
    owner = ((seeds[:, None, :] - centers_true[None]) ** 2).sum(-1).argmin(1)
    cov_pp = len(np.unique(owner))
    rand_sel = rng.choice(len(data), k, replace=False)
    owner_r = ((data[rand_sel][:, None, :] - centers_true[None]) ** 2
               ).sum(-1).argmin(1)
    cov_rand = len(np.unique(owner_r))
    # rounds=16 leaves some within-round redundancy (rounds == k would be
    # exact k-means++); the bar is near-complete coverage and a clear win
    # over the uniform seeding this replaced
    assert cov_pp >= int(0.9 * k), (cov_pp, k)
    assert cov_pp > cov_rand + 5, (cov_pp, cov_rand)


def test_kmeans_plus_plus_auto_switches_to_parallel(monkeypatch):
    """init='kmeans++' beyond _PP_MAX_K transparently runs k-means|| (no
    silent random downgrade); results are deterministic given the key."""
    import jax
    from ivfadc_tpu.ops import kmeans as km

    monkeypatch.setattr(km, "_PP_MAX_K", 8)
    rng = np.random.RandomState(1)
    data = rng.rand(600, 6).astype(np.float32)
    r1 = km.kmeans(jax.random.PRNGKey(3), data, 32, maxiter=4)
    r2 = km.kmeans(jax.random.PRNGKey(3), data, 32, maxiter=4)
    np.testing.assert_array_equal(np.asarray(r1.centers),
                                  np.asarray(r2.centers))
    assert np.asarray(r1.assignments).max() < 32
    # all 32 clusters live (seeding spread + reseeding keep them occupied)
    assert len(np.unique(np.asarray(r1.assignments))) >= 28
