"""chip_smoke.py rehearsed on the CPU at a tiny shape: every phase of the
on-card smoke run, its checks, and its refusal to run without a GPU."""

import dataclasses
import io
import json
import os
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

TINY = chip_smoke.Shape(
    n=4096, d=32, n_clusters=16, kc=32, m=4, k=64, coarse_maxiter=8,
    quantization_maxiter=8, nq=64, n_gt=64, topk=10, w=8, n_oracle=32,
    n_push=200, n_delete=50, n_serve=16, hnsw_n=4096, hnsw_kc=512,
    hnsw_maxiter=2, hnsw_nq=32, shard_maxiter=4)


@pytest.fixture(scope="module")
def built():
    base, queries, src = chip_smoke.make_data(TINY, seed=0)
    out = io.StringIO()
    with redirect_stdout(out):
        idx = chip_smoke.build_phase(base, queries, TINY, seed=0)
    return base, queries, src, idx, out.getvalue()


def test_build_phase_reports_timer_and_memory(built):
    _, _, _, idx, text = built
    assert len(idx) == TINY.n
    for phase in ("coarse_kmeans", "train_quantizer", "encode",
                  "build_lists"):
        assert f"[build]   {phase}:" in text
    assert "memory_analysis" in text


def test_search_phase_checks_pass(built):
    base, queries, src, idx, _ = built
    out = io.StringIO()
    with redirect_stdout(out):
        ref = chip_smoke.search_phase(idx, base, queries, src, TINY)
    text = out.getvalue()
    assert "oracle parity" in text and "self-query" in text
    assert ref["ids"].shape == (TINY.nq, TINY.topk)
    assert 0.1 < ref["recall"] <= 1.0


def test_dense_phase_matches_lut(built):
    base, queries, src, idx, _ = built
    with redirect_stdout(io.StringIO()):
        ref = chip_smoke.search_phase(idx, base, queries, src, TINY)
        got = chip_smoke.dense_phase(idx, queries, ref, TINY)
    assert abs(got["recall"] - ref["recall"]) <= 0.01
    assert idx.config.scan_mode == "auto"     # the LUT index is untouched


def test_mutation_phase_on_fresh_index():
    base, queries, _ = chip_smoke.make_data(TINY, seed=1)
    with redirect_stdout(io.StringIO()):
        idx = chip_smoke.build_phase(base, queries, TINY, seed=1)
        chip_smoke.mutation_phase(idx, base, TINY, seed=1)
    assert len(idx) == TINY.n + TINY.n_push - TINY.n_delete


def test_hnsw_phase_above_old_switch():
    base, queries, _ = chip_smoke.make_data(TINY, seed=2)
    out = io.StringIO()
    with redirect_stdout(out):
        chip_smoke.hnsw_phase(base, queries, TINY, seed=2)
    assert "TwoLevelCoarseQuantizer" in out.getvalue()


def test_sharded_phase_on_four_virtual_devices():
    base, queries, _ = chip_smoke.make_data(TINY, seed=3)
    out = io.StringIO()
    with redirect_stdout(out):
        chip_smoke.sharded_phase(base, queries, TINY, seed=3, chips=4)
    assert "4-card vs one-card" in out.getvalue()


@pytest.mark.parametrize("argv", [[], ["--chips", "4"]])
def test_main_refuses_cpu_backend(argv):
    """No GPU: non-zero exit and no result line — never a CPU fallback."""
    out = io.StringIO()
    with redirect_stdout(out), pytest.raises(SystemExit) as exc:
        chip_smoke.main(argv)
    assert exc.value.code not in (0, None)
    assert "needs an NVIDIA GPU" in str(exc.value.code)
    assert '"ok"' not in out.getvalue()


def test_boundary_parity_rule():
    """Tie at the k-th boundary is tolerated; a real miss is not."""
    ids_b = np.array([[1, 2, 3]])
    d_b = np.array([[0.1, 0.2, 0.3]], np.float32)
    same = chip_smoke.boundary_parity(
        np.array([[1, 2, 4]]), np.array([[0.1, 0.2, 0.3]], np.float32),
        ids_b, d_b, rtol=1e-6)
    assert same == 0.0
    with pytest.raises(AssertionError):
        chip_smoke.boundary_parity(
            np.array([[1, 2, 4]]), np.array([[0.1, 0.2, 0.25]], np.float32),
            ids_b, d_b, rtol=1e-6)


def test_self_query_tie_rule():
    ids = np.array([[7, 3, 1], [3, 7, 1], [1, 2, 9]])
    d = np.array([[0.5, 0.5, 1.0], [0.1, 0.5, 1.0], [0.0, 0.1, 0.2]])
    ok = chip_smoke.self_query_ok(ids, d, [3, 7, 9])
    np.testing.assert_array_equal(ok, [True, False, False])


def test_full_shape_is_the_benchmark_shape():
    """The no-argument run is sift-128-euclidean-shaped: 1M x 128, kc=1024,
    PQ m=8 k=256, 16,384 queries at k=10, w=8; kc=16,384 for :hnsw."""
    f = chip_smoke.FULL
    assert (f.n, f.d, f.kc, f.m, f.k) == (1_000_000, 128, 1024, 8, 256)
    assert (f.nq, f.topk, f.w, f.hnsw_kc) == (16_384, 10, 8, 16_384)
    assert (f.n_push, f.n_delete, f.n_serve, f.n_oracle) == (
        10_000, 1_000, 64, 200)
    assert dataclasses.replace(f) == f


@pytest.mark.gpu
def test_every_phase_on_the_card(gpu):
    """The whole smoke run at the tiny shape on a real card, the Triton
    top-k included (skips without a GPU; `JAX_PLATFORMS=cuda pytest -m gpu`)."""
    with redirect_stdout(io.StringIO()):
        chip_smoke.run(TINY, seed=0, chips=1)
