"""IVFADCIndex — the top-level index.

API parity with the reference's 12 user-facing entry points (SURVEY §1):
  IVFADCIndex(data; kwargs)        -> IVFADCIndex.build(data, config|kwargs)
  knn_search(idx, point, k; w)     -> idx.search(point, k, w=...)   (single)
  knn_search(idx, points, k; w)    -> idx.search(points, k, w=...)  (batch)
  push! / pushfirst!               -> idx.push / idx.push_front
  pop! / popfirst!                 -> idx.pop / idx.pop_front
  delete_from_index!(idx, pts)     -> idx.delete(ids)  (NOTE: 0-based ids;
      the reference takes 1-based positions and converts at
      /root/reference/src/utils.jl:93 — Python is natively 0-based)
  length / size / show             -> len(idx) / idx.shape / repr(idx)
  save/load_ivfadc_index           -> idx.save / IVFADCIndex.load

Search returns 0-based ids (parity: /root/reference/src/index.jl:189) and at
most k results when the probed cells hold fewer than k points
(/root/reference/src/index.jl:200).
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ivfadc_tpu.config import (DTYPE_TO_BITS, IVFADCConfig, device_id_cap)
from ivfadc_tpu.ops import pq as pq_ops
from ivfadc_tpu.ops.adc import build_adc_tables, scan_postings
from ivfadc_tpu.ops.gather_scan import gathered_scan
from ivfadc_tpu.ops.metrics import Metric, get_metric
from ivfadc_tpu.models.coarse import make_coarse_quantizer
from ivfadc_tpu.models.inverted import PostingStore
from ivfadc_tpu.utils.profiling import BuildTimer

# The OPQ rotation is applied at full float32 precision: the GPU would
# otherwise run it in TF32, and the ADC tables built from the rotated
# residuals are contracted as exact.
_HIGHEST = jax.lax.Precision.HIGHEST

# auto-cap for PQ codebook training when quantization_sample is unset (0)
_PQ_TRAIN_AUTOCAP = 1 << 20


def _train_components(k_coarse, k_quant, xd, config, cmetric, qmetric, timer):
    """Coarse k-means + residual-quantizer training on device data `xd`.

    ONE copy of the key-discipline block shared by `IVFADCIndex.build` and
    `IVFADCIndex.build_streaming`: the streamed build's exact-reproduction
    guarantee (train_data == full stream => identical index) holds only
    while both paths split/fold the PRNG keys and subsample identically,
    so the logic must not be duplicated. Returns (cres, residuals,
    quantizer); `residuals` is the full (len(xd), d) device array — the
    caller owns freeing it.
    """
    from ivfadc_tpu.ops import pq as pq_ops
    from ivfadc_tpu.ops.kmeans import kmeans

    if config.kc > xd.shape[0]:
        raise AssertionError(
            f"kc={config.kc} coarse cells need at least that many training "
            f"points, got {xd.shape[0]} (streamed builds: raise "
            f"train_sample above kc)")
    with timer.phase("coarse_kmeans"):
        cres = kmeans(k_coarse, xd, config.kc,
                      maxiter=config.coarse_maxiter, metric=cmetric,
                      block=config.kmeans_block,
                      pp_sample=config.kmeanspp_sample)
        jax.block_until_ready(cres)
    with timer.phase("residuals"):
        residuals = xd - cres.centers[cres.assignments]
        jax.block_until_ready(residuals)
    with timer.phase("train_quantizer"):
        n = xd.shape[0]
        train_res = residuals
        qs = config.quantization_sample
        if qs == 0 and n > _PQ_TRAIN_AUTOCAP:
            # PQ codebooks estimated from 2^20 residuals are statistically
            # indistinguishable from full-n ones, and training memory and
            # time stay bounded; encoding still covers every point.
            qs = _PQ_TRAIN_AUTOCAP
        if qs and qs < n:
            sel = jax.random.choice(jax.random.fold_in(k_quant, 1), n,
                                    (qs,), replace=False)
            train_res = residuals[sel]
        quantizer = pq_ops.train_quantizer(
            k_quant, train_res, m=config.m, k=config.k,
            method=config.quantization_method,
            maxiter=config.quantization_maxiter, metric=qmetric,
            opq_iters=config.opq_iters, block=config.kmeans_block)
        del train_res
        jax.block_until_ready(quantizer.codebooks)
    return cres, residuals, quantizer


@functools.partial(
    jax.jit,
    static_argnames=("k", "w", "window", "metric", "include_base",
                     "apply_rot", "residual_based"))
def _search_impl(cq, codebooks, rotation, offsets, sizes, codes, ids, queries,
                 *, k: int, w: int, window: int, metric: Metric,
                 include_base: bool, apply_rot: bool, residual_based: bool):
    """Fused batched search: coarse probe -> ADC tables -> posting scan -> top-k."""
    queries = queries.astype(jnp.float32)
    cells, cdists = cq.search(queries, w)                     # (B, w)
    cent = cq.centroids[cells]                                # (B, w, d)
    dq = rotation.shape[0]                                    # quantizer dim
    if residual_based:
        vecs = queries[:, None, :] - cent                     # residuals (B, w, d)
        base = cdists if include_base else jnp.zeros_like(cdists)
    else:
        # Inner-product family: q.x_hat = q.c + q.decode -> tables from the
        # query itself, and the coarse term (under the QUANT metric, the
        # coarse probe may use a different one) completes the exact score.
        vecs = jnp.broadcast_to(queries[:, None, :],
                                (queries.shape[0], w, queries.shape[1]))
        base = jax.vmap(metric.pairwise)(queries[:, None, :], cent)[:, 0, :]
    # kill PADDED probes (two-level coarse pads with cell 0 + dist inf
    # past its candidate supply): a finite recomputed base would re-scan
    # cell 0 and duplicate its neighbors in the final top-k
    base = jnp.where(jnp.isfinite(cdists), base, jnp.inf)
    if vecs.shape[-1] != dq:            # ragged-subspace zero padding
        vecs = jnp.pad(vecs, ((0, 0), (0, 0), (0, dq - vecs.shape[-1])))
    if apply_rot:
        vecs = jnp.matmul(vecs, rotation, precision=_HIGHEST)
    tables = build_adc_tables(metric, vecs, codebooks)        # (B, w, m, kq)
    out_ids, out_dists = scan_postings(
        tables, base, cells, offsets, sizes, codes, ids, k=k, window=window)
    return out_ids, metric.finalize(out_dists)


def _dense_probe(cq, rotation, queries, *, w: int, metric: Metric,
                 include_base: bool, apply_rot: bool, residual_based: bool):
    """Coarse probe + scan-vector prep shared by the single-card and sharded
    dense paths. Returns (cells (B,w), v (B,w,dq), base (B,w), norm_coef)."""
    queries = queries.astype(jnp.float32)
    B = queries.shape[0]
    dq = rotation.shape[0]                                    # quantizer dim
    cells, cdists = cq.search(queries, w)
    cent = cq.centroids[cells]
    if residual_based:
        r = queries[:, None, :] - cent
        if r.shape[-1] != dq:           # ragged-subspace zero padding
            r = jnp.pad(r, ((0, 0), (0, 0), (0, dq - r.shape[-1])))
        if apply_rot:
            r = jnp.matmul(r, rotation, precision=_HIGHEST)
        v = -2.0 * r
        base = jnp.sum(r * r, axis=-1)
        if include_base:
            base = base + cdists
        norm_coef = 1.0
    else:
        qv = queries
        if qv.shape[-1] != dq:
            qv = jnp.pad(qv, ((0, 0), (0, dq - qv.shape[-1])))
        q = jnp.matmul(qv, rotation, precision=_HIGHEST) if apply_rot else qv
        v = jnp.broadcast_to(-q[:, None, :], (B, w, q.shape[-1]))
        base = jax.vmap(metric.pairwise)(queries[:, None, :], cent)[:, 0, :]
        norm_coef = 0.0
    # A quantizer may PAD probes past its candidate supply (the two-level
    # coarse pads with cell 0 + dist inf, coarse.py). Recomputed bases are
    # finite for those probes, so without this mask a padded probe re-scans
    # cell 0 and duplicates its neighbors in the final top-k.
    base = jnp.where(jnp.isfinite(cdists), base, jnp.inf)
    return cells, v, base, norm_coef


def _dense_local(cq, rotation, offsets, sizes, decoded, ids, dscale, queries,
                 *, k: int, w: int, window: int, metric: Metric,
                 include_base: bool, apply_rot: bool, residual_based: bool):
    """Dense search on one set of CSR arrays -> raw (ids, dists) — callers
    apply `metric.finalize` once (the sharded path merges across shards
    first). Shared by single-card and shard-local search."""
    cells, v, base, norm_coef = _dense_probe(
        cq, rotation, queries, w=w, metric=metric,
        include_base=include_base, apply_rot=apply_rot,
        residual_based=residual_based)
    return gathered_scan(offsets[cells], sizes[cells], v, base, decoded,
                         dscale, ids, k=k, win=window, norm_coef=norm_coef)


@functools.partial(
    jax.jit,
    static_argnames=("k", "w", "window", "metric", "include_base",
                     "apply_rot", "residual_based"))
def _dense_search_impl(cq, rotation, offsets, sizes, decoded, ids, dscale,
                       queries, *, k: int, w: int, window: int,
                       metric: Metric, include_base: bool, apply_rot: bool,
                       residual_based: bool):
    """Dense search: coarse probe -> gathered decoded-residual scan with a
    per-query top-k (ops/gather_scan.py). Same scores as the LUT path up to
    the cache's bf16/int8 rounding."""
    out_ids, out_dists = _dense_local(
        cq, rotation, offsets, sizes, decoded, ids, dscale, queries, k=k,
        w=w, window=window, metric=metric, include_base=include_base,
        apply_rot=apply_rot, residual_based=residual_based)
    return out_ids, metric.finalize(out_dists)


def _bucket_batch(b: int) -> int:
    """Pad batch sizes to a small set of buckets to bound jit recompiles."""
    if b <= 8:
        return 8
    p = 8
    while p < b and p < 1024:
        p *= 2
    if p >= b:
        return p
    return ((b + 1023) // 1024) * 1024


class IVFADCIndex:
    """Two-level IVFADC ANN index (coarse k-means cells + PQ-coded residuals)."""

    def __init__(self, config: IVFADCConfig, coarse, quantizer, store,
                 data_dtype: np.dtype, dim: int):
        self.config = config
        self.coarse = coarse                  # NaiveCoarseQuantizer | TwoLevel...
        self.quantizer = quantizer            # ProductQuantizer
        self.store = store                    # PostingStore
        self.data_dtype = np.dtype(data_dtype)
        self.dim = dim
        self.coarse_metric = get_metric(config.coarse_metric)
        self.quant_metric = get_metric(config.quantization_metric)
        if not self.quant_metric.additive:
            raise ValueError(
                f"quantization metric {self.quant_metric.name!r} is not "
                "additive over subspaces — ADC search would be meaningless")
        if config.scan_mode == "dense":
            # fail fast; _resolve_scan_mode owns the dense-metric allowlist
            self._resolve_scan_mode()

    # ------------------------------------------------------------------ build
    @classmethod
    def build(cls, data, config: Optional[IVFADCConfig] = None,
              **kwargs) -> "IVFADCIndex":
        """Build the index. `data` is (n, d) row-major points.

        (The reference takes column-major d x n Julia matrices; numpy
        convention here is (n, d).)
        """
        if config is None:
            config = IVFADCConfig(**kwargs)
        elif kwargs:
            raise TypeError("pass either a config or kwargs, not both")
        # Device-resident input (e.g. data generated on device) skips the
        # host round trip.
        on_device = isinstance(data, jax.Array)
        if not on_device:
            data = np.ascontiguousarray(data)
        if data.ndim != 2:
            raise AssertionError("data must be a 2-D (n, d) array")
        n, d = data.shape
        if on_device:
            try:
                data_dtype = np.dtype(str(data.dtype))   # e.g. 'float16'
            except TypeError:                            # bfloat16 etc.
                data_dtype = np.dtype(np.float32)
        else:
            data_dtype = data.dtype
        config.validate_for_data(n, d)
        cmetric = get_metric(config.coarse_metric)
        qmetric = get_metric(config.quantization_metric)
        key = jax.random.PRNGKey(config.seed)
        k_coarse, k_quant, k_cq = jax.random.split(key, 3)
        timer = BuildTimer()

        xd = data.astype(jnp.float32) if on_device \
            else jnp.asarray(data, jnp.float32)
        cres, residuals, quantizer = _train_components(
            k_coarse, k_quant, xd, config, cmetric, qmetric, timer)
        with timer.phase("encode"):
            codes = pq_ops.encode(quantizer, residuals, metric=qmetric)
            jax.block_until_ready(codes)
            del residuals, xd      # free the two big f32 temporaries
        with timer.phase("build_lists"):
            store = PostingStore.build_device(cres.assignments, codes,
                                              config.kc,
                                              slack=config.cell_slack)
        with timer.phase("coarse_quantizer"):
            coarse = make_coarse_quantizer(
                config.coarse_quantizer, k_cq, cres.centers, cmetric,
                n_groups=config.coarse_n_groups,
                n_probe_groups=config.coarse_probe_groups)
        idx = cls(config, coarse, quantizer, store, data_dtype, d)
        idx.build_timings = timer.timings
        return idx

    @classmethod
    def build_streaming(cls, chunks, config: Optional[IVFADCConfig] = None,
                        *, train_data=None, train_sample: int = 1 << 18,
                        _sharded: bool = False, **kwargs) -> "IVFADCIndex":
        """Out-of-core build: index data that never fits in memory at once.

        `chunks` is a RE-ITERABLE of (b, d) float arrays — e.g. a
        `ivfadc_tpu.utils.datasets.VecsChunks` over TEXMEX files, or a list
        of arrays. (A one-shot generator is rejected: two passes are needed.)

        Pass 1 reservoir-samples up to `train_sample` points (uniformly over
        the whole stream, seeded by `config.seed`) and trains the coarse
        k-means and PQ/OPQ codebooks on the sample — or on `train_data` when
        given, which skips pass 1 entirely. Pass 2 re-streams the chunks,
        assigning + PQ-encoding each on device, and accumulates only the
        (assignments, codes) pair — n * (m * codebytes + 4) bytes — before
        one CSR layout pass. Peak host memory is one chunk of floats plus
        the code arrays; the full float dataset is never resident.

        With `train_data` equal to the concatenated stream, the result is
        identical to `IVFADCIndex.build` on that data (same seed): the same
        key split drives k-means and quantizer training, and per-chunk
        encoding is row-deterministic.

        No reference counterpart — the reference requires the full d x n
        matrix in memory (/root/reference/src/index.jl:103).
        """
        from ivfadc_tpu.ops.kmeans import assign as kmeans_assign

        if config is None:
            config = IVFADCConfig(**kwargs)
        elif kwargs:
            raise TypeError("pass either a config or kwargs, not both")
        cmetric = get_metric(config.coarse_metric)
        qmetric = get_metric(config.quantization_metric)
        key = jax.random.PRNGKey(config.seed)
        k_coarse, k_quant, k_cq = jax.random.split(key, 3)
        timer = BuildTimer()

        # --- pass 1: reservoir sample for training (Algorithm R, vectorized
        # per chunk: item t>=S replaces slot r~U[0,t] iff r<S — within-chunk
        # independent draws replay the sequential algorithm exactly) ---
        d = None
        if train_data is None:
            rng = np.random.RandomState(config.seed)
            sample = None
            seen = 0
            with timer.phase("sample"):
                for chunk in chunks:
                    chunk = np.asarray(chunk)
                    if chunk.ndim != 2:
                        raise AssertionError(
                            "chunks must be 2-D (b, d) arrays")
                    if d is None:
                        d = chunk.shape[1]
                        sample = np.empty((train_sample, d), np.float32)
                    elif chunk.shape[1] != d:
                        raise AssertionError(
                            f"chunk dim {chunk.shape[1]} != {d}")
                    b = chunk.shape[0]
                    fill = min(b, max(0, train_sample - seen))
                    if fill:
                        sample[seen:seen + fill] = chunk[:fill]
                    if b > fill:
                        draws = rng.randint(
                            0, seen + fill + np.arange(b - fill) + 1)
                        hit = draws < train_sample
                        sample[draws[hit]] = chunk[fill:][hit]
                    seen += b
            if seen == 0:
                raise AssertionError("empty chunk stream")
            train = sample[:min(seen, train_sample)]
            # every validate_for_data check is decidable now (pass 2 only
            # re-streams the same rows) — fail BEFORE the expensive
            # training + encode passes, not after them
            config.validate_for_data(seen, d, sharded=_sharded)
        else:
            train = np.asarray(train_data, np.float32)
            if train.ndim != 2:
                raise AssertionError("train_data must be 2-D (n, d)")
            d = train.shape[1]
            # sized sources (VecsChunks) expose the stream length — use it
            # to fail fast here too; the exact n is re-validated after
            # pass 2 either way
            n_hint = getattr(chunks, "n_rows", None)
            if n_hint:
                config.validate_for_data(int(n_hint), d,
                                         sharded=_sharded)
        if config.k > train.shape[0]:
            raise AssertionError(
                f"training sample ({train.shape[0]}) must hold at least "
                f"k={config.k} points (streamed builds: raise train_sample)")

        # --- train coarse + quantizer on the sample: the ONE shared
        # key-discipline block, so train_data == full data reproduces
        # `build` exactly ---
        xt = jnp.asarray(train, jnp.float32)
        cres, residuals, quantizer = _train_components(
            k_coarse, k_quant, xt, config, cmetric, qmetric, timer)
        del residuals, xt            # the stream re-encodes every point

        # --- pass 2: stream chunks through device assign + encode ---
        enc_align = 2048             # pad chunks to a multiple: few retraces
        centers = cres.centers
        all_assign: List[np.ndarray] = []
        all_codes: List[np.ndarray] = []
        n = 0
        data_dtype = None
        # One-deep software pipeline: chunk i's device->host fetch happens
        # only AFTER chunk i+1's upload + compute are dispatched (JAX
        # dispatch is async), so the transfers overlap with compute instead
        # of serializing per chunk. At most two chunks' results are in
        # flight on device.
        pending = None                       # (assignments, codes, rows)

        def _collect(p):
            a_p, codes_p, b_p = p
            all_assign.append(np.asarray(a_p[:b_p]))
            all_codes.append(np.asarray(codes_p[:b_p]))

        with timer.phase("encode"):
            for chunk in chunks:
                chunk = np.asarray(chunk)
                if chunk.ndim != 2:
                    raise AssertionError("chunks must be 2-D (b, d) arrays")
                if chunk.shape[0] == 0:
                    continue
                if data_dtype is None:
                    data_dtype = chunk.dtype if np.issubdtype(
                        chunk.dtype, np.floating) else np.dtype(np.float32)
                if chunk.shape[1] != d:
                    raise AssertionError(f"chunk dim {chunk.shape[1]} != {d}")
                b = chunk.shape[0]
                bp = -(-b // enc_align) * enc_align
                x = jnp.asarray(
                    np.pad(np.asarray(chunk, np.float32),
                           ((0, bp - b), (0, 0))))
                a = kmeans_assign(x, centers, metric=cmetric,
                                  block=config.kmeans_block)
                codes = pq_ops.encode(quantizer, x - centers[a],
                                      metric=qmetric)
                if pending is not None:
                    _collect(pending)
                pending = (a, codes, b)
                n += b
            if pending is not None:
                _collect(pending)
        if train_data is None and n != seen:
            raise AssertionError(
                f"chunk stream yielded {seen} rows on pass 1 but {n} on "
                f"pass 2 — build_streaming needs a re-iterable source, "
                f"not a one-shot generator")
        if n == 0:
            raise AssertionError("empty chunk stream")
        config.validate_for_data(n, d, sharded=_sharded)

        with timer.phase("build_lists"):
            store = PostingStore.build(
                np.concatenate(all_assign), np.concatenate(all_codes),
                config.kc, slack=config.cell_slack)
        with timer.phase("coarse_quantizer"):
            coarse = make_coarse_quantizer(
                config.coarse_quantizer, k_cq, centers, cmetric,
                n_groups=config.coarse_n_groups,
                n_probe_groups=config.coarse_probe_groups)
        idx = cls(config, coarse, quantizer, store, data_dtype, d)
        idx.build_timings = timer.timings
        return idx

    @classmethod
    def build_from_files(cls, paths, config: Optional[IVFADCConfig] = None,
                         *, chunk_rows: int = 262144,
                         max_rows: Optional[int] = None,
                         train_sample: int = 1 << 18,
                         **kwargs) -> "IVFADCIndex":
        """`build_streaming` over TEXMEX .fvecs/.bvecs files (multiple files
        concatenate in order, as Deep1B's numbered parts do). Streams
        `chunk_rows`-row chunks; the float data is never fully resident."""
        from ivfadc_tpu.utils.datasets import VecsChunks
        return cls.build_streaming(
            VecsChunks(paths, chunk_rows=chunk_rows, max_rows=max_rows),
            config, train_sample=train_sample, **kwargs)

    # ----------------------------------------------------------------- search
    def _search_call(self, q: jax.Array, k: int, w: int):
        """(jitted search program, args, static kwargs) for one padded
        device batch `q` — what `_device_search` runs, exposed so callers
        can also lower and compile it (e.g. for `memory_analysis()`)."""
        include_base = (self.config.score_mode == "reference"
                        or not self.quant_metric.residual_based)
        kw = dict(k=k, w=w, window=self.store.window,
                  metric=self.quant_metric, include_base=include_base,
                  apply_rot=self.quantizer.method == "opq",
                  residual_based=self.quant_metric.residual_based)
        if self._resolve_scan_mode() == "dense":
            dev = self.store.device_view_dense(self.quantizer,
                                               cache=self._resolve_cache())
            return _dense_search_impl, (
                self.coarse, self.quantizer.rotation, dev["offsets"],
                dev["sizes"], dev["decoded"], dev["ids"], dev["scale"],
                q), kw
        dev = self.store.device_view()
        return _search_impl, (
            self.coarse, self.quantizer.codebooks, self.quantizer.rotation,
            dev["offsets"], dev["sizes"], dev["codes"], dev["ids"], q), kw

    def _device_search(self, queries: np.ndarray, k: int, w: int
                       ) -> Tuple[jax.Array, jax.Array]:
        """Padded fixed-shape search on device. queries (B, d) -> (B, k)."""
        if k < 1:
            raise AssertionError("k has to be >= 1")  # src/index.jl:210
        if w < 1:
            raise AssertionError("w has to be >= 1")  # src/index.jl:211
        if len(self) > device_id_cap():
            # pushes may legally grow a host index past the device int32 id
            # representation (dtype capacity law), but the plain device
            # search would wrap those ids negative — fail loudly instead
            raise AssertionError(
                f"{len(self)} vectors exceed the device int32 id cap "
                f"({device_id_cap()}); serve this index through a "
                f"ShardedIVFADCIndex view (wide-id mode)")
        w = min(w, self.config.kc)                    # src/index.jl:216
        B = queries.shape[0]
        Bp = _bucket_batch(B)
        if isinstance(queries, jax.Array) and Bp == B:
            q = queries              # device-resident bucket-size batch
        elif isinstance(queries, jax.Array):
            # device-resident but off-bucket (e.g. B=1): pad on device
            q = jnp.pad(queries.astype(jnp.float32), ((0, Bp - B), (0, 0)))
        else:
            q = jnp.asarray(
                np.pad(np.asarray(queries, np.float32), ((0, Bp - B), (0, 0))))
        fn, args, kw = self._search_call(q, k, w)
        out_ids, out_dists = fn(*args, **kw)
        if Bp == B:
            return out_ids, out_dists
        return out_ids[:B], out_dists[:B]

    def _resolve_cache(self) -> str:
        cache = self.config.scan_cache
        return "int8" if cache == "auto" else cache

    def _resolve_scan_mode(self) -> str:
        """"dense" only when asked for: on the H100 the LUT scan is faster
        at the SIFT1M shape (PERF.md), so "auto" resolves to "lut"."""
        mode = self.config.scan_mode
        if mode == "dense":
            if self.quant_metric.name not in ("sqeuclidean", "euclidean",
                                              "inner_product"):
                raise ValueError(
                    f"scan_mode='dense' does not support metric "
                    f"{self.quant_metric.name!r} (needs a dot-product "
                    f"decomposition); use 'lut'")
            return "dense"
        return "lut"

    def search(self, points, k: int, w: int = 1):
        """knn_search parity (/root/reference/src/index.jl:204-273).

        Single point (d,) -> (ids, dists) trimmed to the valid (<= k) results.
        Batch (B, d) array or list of points -> (list_of_ids, list_of_dists).
        Returned ids are 0-based, dtype = config.index_dtype; distances have
        the query's float dtype.
        """
        pts = np.asarray(points)
        single = pts.ndim == 1
        if single:
            pts = pts[None, :]
        if pts.shape[1] != self.dim:
            raise AssertionError(
                f"query dimension {pts.shape[1]} != index dimension {self.dim}")
        out_dtype = pts.dtype if np.issubdtype(pts.dtype, np.floating) \
            else np.float32
        ids, dists = self._device_search(pts, k, w)
        ids = np.asarray(ids)
        dists = np.asarray(dists)
        id_dtype = np.dtype(self.config.index_dtype)
        if single:
            m = ids[0] >= 0
            return ids[0][m].astype(id_dtype), dists[0][m].astype(out_dtype)
        out_i, out_d = [], []
        for row_i, row_d in zip(ids, dists):
            m = row_i >= 0
            out_i.append(row_i[m].astype(id_dtype))
            out_d.append(row_d[m].astype(out_dtype))
        return out_i, out_d

    def search_padded(self, points: np.ndarray, k: int, w: int = 1
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """Batch search with fixed (B, k) outputs, -1/-inf padding.
        No host-side trimming — use this for throughput benchmarking.
        Device-resident query arrays pass through without a host round trip."""
        if not hasattr(points, "devices"):        # np/posix input
            points = np.asarray(points)
        ids, dists = self._device_search(points, k, w)
        return np.asarray(ids), np.asarray(dists)

    def search_stream(self, points, k: int, w: int = 1, *,
                      batch: int = 16384, stats=None
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """Throughput-oriented search over a large query set: dispatches
        fixed-size batches back-to-back (the device pipeline overlaps
        compute with dispatch; nothing blocks until the final pull), then
        returns stacked padded (N, k) results. `stats`, if given, is a
        `utils.profiling.SearchStats` to record into."""
        import time as _time
        points = np.asarray(points) if not hasattr(points, "devices") \
            else points
        n = points.shape[0]
        if n == 0:
            return (np.empty((0, k), np.int32), np.empty((0, k), np.float32))
        t0 = _time.perf_counter()
        outs = [self._device_search(points[s:s + batch], k, w)
                for s in range(0, n, batch)]
        ids = np.concatenate([np.asarray(i) for i, _ in outs])
        dists = np.concatenate([np.asarray(d) for _, d in outs])
        if stats is not None:
            stats.record(n, _time.perf_counter() - t0)
        return ids, dists

    # ------------------------------------------------------------ dynamic ops
    def _encode_point(self, point: np.ndarray) -> Tuple[int, np.ndarray]:
        """Nearest cell + PQ codes (reference `_encode_point`,
        /root/reference/src/utils.jl:148-161)."""
        q = jnp.asarray(point, jnp.float32)[None, :]
        cells, _ = self.coarse.search(q, 1)
        cell = int(cells[0, 0])
        residual = q - self.coarse.centroids[cell][None, :]
        codes = pq_ops.encode(self.quantizer, residual, metric=self.quant_metric)
        return cell, np.asarray(codes)[0]

    def _check_push(self, point: np.ndarray) -> None:
        point = np.asarray(point)
        if point.shape != (self.dim,):
            raise AssertionError(
                f"Wrong point dimension {point.shape}, expected ({self.dim},)")
        # dtype capacity law only (/root/reference/src/utils.jl:134-135):
        # host ids are int64, so pushes beyond the device int32 cap succeed
        # like the reference's; the plain DEVICE search path guards itself
        # (_device_search) and points at the sharded wide-id views
        bits = DTYPE_TO_BITS[self.config.index_dtype]
        cap = 1 << bits
        if len(self) >= cap:
            raise AssertionError(
                f"Index is full for dtype {self.config.index_dtype} "
                f"({cap} vectors)")

    def push(self, point) -> None:
        """Append with id = n (reference push!, /root/reference/src/utils.jl:114)."""
        self._check_push(point)
        cell, codes = self._encode_point(np.asarray(point, np.float32))
        self.store.append(cell, codes, len(self))

    def push_batch(self, points) -> None:
        """Append many points at once (ids n..n+B-1, equivalent to B pushes).

        No reference counterpart (the reference only has scalar push!): one batched
        coarse probe + one batched PQ encode, then host-side appends.
        """
        points = np.asarray(points, np.float32)
        if points.ndim != 2 or points.shape[1] != self.dim:
            raise AssertionError(
                f"push_batch expects (B, {self.dim}) points, got {points.shape}")
        bits = DTYPE_TO_BITS[self.config.index_dtype]
        cap = 1 << bits                       # dtype capacity law only
        if len(self) + len(points) > cap:
            raise AssertionError(
                f"Index would exceed capacity for dtype "
                f"{self.config.index_dtype} ({cap} vectors)")
        q = jnp.asarray(points)
        cells, _ = self.coarse.search(q, 1)
        cells = np.asarray(cells)[:, 0]
        residuals = q - self.coarse.centroids[jnp.asarray(cells)]
        codes = np.asarray(pq_ops.encode(self.quantizer, residuals,
                                         metric=self.quant_metric))
        self.store.append_batch(cells, codes, len(self))

    def push_front(self, point) -> None:
        """Insert with id = 0, shifting every live id up by one
        (reference pushfirst!, /root/reference/src/utils.jl:123,140-141)."""
        self._check_push(point)
        cell, codes = self._encode_point(np.asarray(point, np.float32))
        self.store.shift_ids(-1, +1)
        self.store.append(cell, codes, 0)

    def _reconstruct_from(self, cell: int, codes: np.ndarray) -> np.ndarray:
        centroid = np.asarray(self.coarse.centroids[cell])
        resid = np.asarray(pq_ops.decode(self.quantizer, codes[None, :]))[0]
        return (centroid + resid[:self.dim]).astype(self.data_dtype)

    def pop(self) -> np.ndarray:
        """Remove & reconstruct the last-inserted point (id n-1)
        (reference pop!, /root/reference/src/utils.jl:29,41-68)."""
        n = len(self)
        if n == 0:
            raise IndexError("pop from empty index")
        cell, slot = self.store.find(n - 1)
        codes = self.store.remove_slot(cell, slot)
        return self._reconstruct_from(cell, codes)

    def pop_front(self) -> np.ndarray:
        """Remove & reconstruct id 0, shifting all ids down by one
        (reference popfirst!, /root/reference/src/utils.jl:37)."""
        if len(self) == 0:
            raise IndexError("pop from empty index")
        cell, slot = self.store.find(0)
        codes = self.store.remove_slot(cell, slot)
        self.store.shift_ids(0, -1)
        return self._reconstruct_from(cell, codes)

    def delete(self, ids: Sequence[int]) -> None:
        """Delete by 0-based ids; surviving ids shift down to stay the
        contiguous range {0..n'-1} (reference delete_from_index!,
        /root/reference/src/utils.jl:90-105 — which takes 1-based positions)."""
        id_list = np.unique(np.asarray(list(ids), np.int64))
        if id_list.size == 1:
            # single delete: incremental swap-remove + shift keeps the device
            # caches patched in place (no full re-upload/re-decode)
            target = int(id_list[0])
            cell, slot = self.store.find(target)
            self.store.remove_slot(cell, slot)
            self.store.shift_ids(target, -1)
        elif id_list.size <= 2048:
            # small batch: swap-removes + one device-side rank shift —
            # avoids rebuilding/re-decoding the whole device cache
            self.store.delete_ids_incremental(id_list)
        else:
            self.store.delete_ids(id_list)

    def reconstruct(self, ext_id: int) -> np.ndarray:
        """Decode the stored approximation of a point (non-destructive)."""
        cell, slot = self.store.find(int(ext_id))
        # _code_rows fetches just this row — the .codes property would
        # copy the whole flat array from device for one reconstruction
        row = self.store._code_rows(np.asarray([slot]))[0]
        return self._reconstruct_from(cell, row.copy())

    def fork(self) -> "IVFADCIndex":
        """Consistent-snapshot clone for epoch-swap serving (serving.py):
        shares the immutable trained components (coarse, quantizer, config)
        and clones the posting store copy-on-write — mutations on either
        side never write into buffers the other still reads, so a serving
        layer can keep dispatching searches against one epoch while the
        next is being mutated. O(host payload) memcpy; device scan caches
        are shared (the plain store never donates device buffers)."""
        new = IVFADCIndex(self.config, self.coarse, self.quantizer,
                          self.store.fork(), self.data_dtype, self.dim)
        if hasattr(self, "build_timings"):
            new.build_timings = self.build_timings
        return new

    # ------------------------------------------------------------- inspection
    def __len__(self) -> int:
        return self.store.n                    # src/index.jl:56-57

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.dim, len(self))           # size(ivfadc) at src/index.jl:65-66

    def bytes_per_vector(self) -> int:
        id_bytes = DTYPE_TO_BITS[self.config.index_dtype] // 8
        code_bytes = np.dtype(self.store.code_dtype).itemsize * self.config.m
        return id_bytes + code_bytes           # README.md:47 "12-byte encoding"

    def __repr__(self) -> str:
        cq = type(self.coarse).__name__
        return (f"IVFADCIndex ({cq}, {self.config.quantization_method}), "
                f"dim={self.dim}, kc={self.config.kc}, m={self.config.m}, "
                f"k={self.config.k}, {self.bytes_per_vector()}-byte encoding, "
                f"{len(self)} vectors")

    def memory_stats(self) -> dict:
        """Operator-facing size accounting (SURVEY §5 observability row).

        Reports the encoded payload, CSR capacity overhead, cell-size
        distribution, coarse-structure footprint, and — when a device view
        exists — the bytes resident on device (decoded scan cache, id
        streams). Never forces hydration or device materialization."""
        st = self.store
        sizes = np.asarray(st.sizes)
        live = sizes[sizes > 0]
        id_bytes = DTYPE_TO_BITS[self.config.index_dtype] // 8
        code_bytes = np.dtype(st.code_dtype).itemsize * self.config.m
        out = {
            "n": int(len(self)),
            "bytes_per_vector": self.bytes_per_vector(),
            "encoded_bytes": int(len(self)) * self.bytes_per_vector(),
            "capacity_slots": int(st.total_cap),
            "capacity_bytes": int(st.total_cap) * (id_bytes + code_bytes),
            "fill_ratio": float(len(self) / max(st.total_cap, 1)),
            "cells": {
                "kc": int(self.config.kc),
                "live": int((sizes > 0).sum()),
                "p50": int(np.percentile(live, 50)) if live.size else 0,
                "p95": int(np.percentile(live, 95)) if live.size else 0,
                "max": int(sizes.max(initial=0)),
            },
            # .nbytes on the array objects directly — np.asarray on a
            # device array would copy a (possibly huge) table to host just to
            # read a size
            "coarse_bytes": int(self.coarse.centroids.nbytes),
            "codebook_bytes": int(self.quantizer.codebooks.nbytes),
        }
        if getattr(self.coarse, "kind", "") == "two_level":
            out["coarse_bytes"] += int(self.coarse.group_centers.nbytes
                                       + self.coarse.members.nbytes)
        dev = st._device_dense
        if dev is not None:
            dec = dev.get("decoded")
            out["device_scan_cache_bytes"] = (
                int(dec.size) * dec.dtype.itemsize if dec is not None else 0)
        if st._device is not None:
            v = st._device
            out["device_lut_bytes"] = sum(
                int(a.size) * a.dtype.itemsize
                for kk in ("codes", "ids") if (a := v.get(kk)) is not None)
        return out

    # ------------------------------------------------------------ persistence
    def save(self, path: str) -> None:
        from ivfadc_tpu.utils.persistence import save_index
        save_index(path, self)

    @classmethod
    def load(cls, path: str) -> "IVFADCIndex":
        from ivfadc_tpu.utils.persistence import load_index
        return load_index(path)
