"""Test environment: CPU with 8 virtual devices, so the multi-device
sharding logic is exercised without accelerators. Set JAX_PLATFORMS to
run on a card instead (the `gpu`-marked tests need one)."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax

# Persistent compilation cache (ivfadc_tpu.utils.compile_cache): repeat
# runs skip XLA recompiles. 0.0 caches every executable, however small.
from ivfadc_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)

import numpy as np
import pytest

_INDEX_CACHE = {}


@pytest.fixture
def gpu():
    """Skip the requesting test unless JAX's default backend is a GPU.
    Decided here, at run time — never at import or collection time, so
    every xdist worker collects the same tests."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (JAX found "
                    f"{jax.devices()[0].platform})")
    return jax.devices()[0]


@pytest.fixture(scope="session")
def random_data():
    """Shared fixture mirroring the reference's build_index_random_data
    (test/index.jl:1-28): n=243, d=10 uniform random."""
    rng = np.random.RandomState(42)
    return rng.rand(243, 10)


def build_random_index(data, coarse_quantizer="naive", index_dtype="uint32",
                       **overrides):
    """Build (or clone from cache) the shared 243x10 test index. Builds are
    deterministic given the seed, so tests that mutate get a fresh clone of
    one cached build instead of paying a full rebuild."""
    from ivfadc_tpu import IVFADCIndex
    kwargs = dict(kc=100, k=16, m=2, coarse_quantizer=coarse_quantizer,
                  index_dtype=index_dtype, coarse_maxiter=25,
                  quantization_maxiter=25, seed=7)
    kwargs.update(overrides)
    cache_key = (data.tobytes()[:64], data.shape,
                 tuple(sorted(kwargs.items())))
    if cache_key not in _INDEX_CACHE:
        _INDEX_CACHE[cache_key] = IVFADCIndex.build(data, **kwargs)
    return _clone_index(_INDEX_CACHE[cache_key])


def _clone_index(idx):
    """Independent mutable copy: host-side store arrays are copied; immutable
    device arrays (centroids, codebooks) are shared."""
    from ivfadc_tpu.models.index import IVFADCIndex
    from ivfadc_tpu.models.inverted import PostingStore
    store = PostingStore(
        idx.store.kc, idx.store.m, idx.store.code_dtype,
        offsets=idx.store.offsets.copy(), caps=idx.store.caps.copy(),
        sizes=idx.store.sizes.copy(), codes=idx.store.codes.copy(),
        ids=idx.store.ids.copy())
    return IVFADCIndex(idx.config, idx.coarse, idx.quantizer, store,
                       idx.data_dtype, idx.dim)
