"""Host-clock timing helpers and the compile-cache location."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env", [None, "custom"])
def test_compile_cache_dir(tmp_path, env):
    """$JAX_COMPILATION_CACHE_DIR when set, else <checkout>/.jax_cache —
    checked in a fresh interpreter, since JAX reads the variable itself."""
    code = ("from ivfadc_tpu.utils.compile_cache import enable_compile_cache;"
            "import jax; p = enable_compile_cache();"
            "print(p); print(jax.config.jax_compilation_cache_dir)")
    e = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
    e.pop("JAX_COMPILATION_CACHE_DIR", None)
    want = os.path.join(ROOT, ".jax_cache")
    if env:
        want = str(tmp_path / env)
        e["JAX_COMPILATION_CACHE_DIR"] = want
    out = subprocess.run([sys.executable, "-c", code], env=e, cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == [want, want]


def test_call_times_blocks_each_call():
    """One sample per rep, each ending in block_until_ready, after warm-up
    calls that are not sampled."""
    from ivfadc_tpu.utils.timing import call_times
    seen = []
    f = jax.jit(lambda x: x @ x)
    x = jnp.ones((64, 64))

    def fn():
        seen.append(1)
        return f(x)
    times = call_times(fn, reps=5, warm=2)
    assert len(times) == 5 and len(seen) == 7
    assert all(t > 0 for t in times)


def test_mean_time_back_to_back():
    from ivfadc_tpu.utils.timing import mean_time
    f = jax.jit(lambda x: jnp.sin(x).sum())
    x = jnp.ones((256,))
    t = mean_time(lambda: f(x), reps=4, warm=1)
    assert 0 < t < 10


def test_require_gpu_refuses_cpu():
    """Measurements never fall back to the CPU."""
    from ivfadc_tpu.utils.timing import require_gpu
    with pytest.raises(SystemExit, match="needs an NVIDIA GPU"):
        require_gpu("bench")


@pytest.mark.parametrize("script", ["bench.py", "benchmarks/kernel_timings.py",
                                    "benchmarks/search_profile.py"])
def test_measurement_scripts_refuse_cpu(script):
    """bench.py and the layer timers exit non-zero on a CPU-only JAX and
    print no result."""
    e = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, os.path.join(ROOT, script)],
                         env=e, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "needs an NVIDIA GPU" in out.stderr
    assert "{" not in out.stdout
