"""Product quantization (PQ) and optimized PQ (OPQ).

Replaces QuantizedArrays.jl as used by the reference:
  * `build_quantizer(residuals; k, m, method, distance, maxiter)`
    (/root/reference/src/index.jl:142-147) -> `train_quantizer`
  * `quantize_data(rq, X)` (/root/reference/src/index.jl:187,
    /root/reference/src/utils.jl:158) -> `encode`
  * reconstruction used by `_decode_point` (/root/reference/src/utils.jl:71-81)
    -> `decode`. NOTE divergence (deliberate fix, SURVEY §2.3): the reference
    forgets to apply the inverse OPQ rotation when reconstructing; we apply
    `rot^T` so OPQ decode is correct.
  * `rowrange(d, m, i)` contiguous subspace slices -> a plain (n, m, dsub)
    reshape (we require m | d; the reference allows ragged subspaces).

Design: the m per-subspace k-means trainings are one `vmap` over the leading
subspace axis (identical shapes -> one compiled program, subspaces run as
one batched matmul pipeline). Encoding is a batched distance matmul +
argmin. OPQ learns the d x d rotation by alternating encode / orthogonal
Procrustes (SVD), per Ge et al. 2013. Rotations run at full float32
precision (`_HIGHEST`): codes and ADC tables are contracted as exact.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ivfadc_tpu.config import code_dtype_for_k
from ivfadc_tpu.ops.metrics import Metric, SQEUCLIDEAN
from ivfadc_tpu.ops import kmeans as kmeans_ops

_HIGHEST = jax.lax.Precision.HIGHEST


class ProductQuantizer(NamedTuple):
    """Trained residual quantizer.

    codebooks: (m, k, dsub) float32 — per-subspace codeword tables
               (QuantizedArrays' `codebooks[i].vectors`, transposed layout).
    rotation:  (d, d) float32 orthogonal — identity for method="pq"
               (QuantizedArrays' `.rot`).
    method:    "pq" | "opq".
    """
    codebooks: jax.Array
    rotation: jax.Array
    method: str

    @property
    def m(self) -> int:
        return self.codebooks.shape[0]

    @property
    def k(self) -> int:
        return self.codebooks.shape[1]

    @property
    def dsub(self) -> int:
        return self.codebooks.shape[2]

    @property
    def d(self) -> int:
        return self.m * self.dsub

    @property
    def code_dtype(self):
        return jnp.dtype(code_dtype_for_k(self.k))


def _to_subspaces(x: jax.Array, m: int) -> jax.Array:
    """(n, d) -> (m, n, dsub) contiguous-rows split (rowrange parity)."""
    n, d = x.shape
    return jnp.moveaxis(x.reshape(n, m, d // m), 1, 0)


@functools.partial(jax.jit, static_argnames=("k", "maxiter", "metric", "block"))
def _train_codebooks(key, subspaces, k, maxiter, metric, block):
    """vmapped k-means over the m subspaces. subspaces: (m, n, dsub)."""
    m = subspaces.shape[0]
    keys = jax.random.split(key, m)

    def train_one(kk, xs):
        res = kmeans_ops._kmeans_impl(
            xs, k, maxiter, block,
            metric, kmeans_ops.kmeans_plus_plus(kk, xs, k, metric))
        return res[0]

    return jax.vmap(train_one)(keys, subspaces)


def _train_codebooks_seq(key, residuals, m, k, maxiter, metric, block):
    """Per-subspace sequential training for large inputs.

    The vmapped `_train_codebooks` needs a materialized (m, n, dsub)
    transpose copy plus a padded-blocks copy of it — ~2x the residual bytes
    of EXTRA resident device memory at GIST scale (1M x 960). Slicing one
    (n, dsub) subspace at a time keeps the peak at residuals + one
    subspace; the jitted k-means program is compiled once
    (identical shapes) and dispatched m times, so only the vmap's batched-
    dispatch win is lost (negligible: each subspace k-means is
    matmul-bound at these n). Same per-subspace keys as the vmap path."""
    n, d = residuals.shape
    dsub = d // m
    keys = jax.random.split(key, m)
    cbs = []
    for i in range(m):
        xs = jax.lax.slice_in_dim(residuals, i * dsub, (i + 1) * dsub, axis=1)
        res = kmeans_ops._kmeans_impl(
            xs, k, maxiter, block, metric,
            kmeans_ops.kmeans_plus_plus(keys[i], xs, k, metric))
        cbs.append(res[0])
    return jnp.stack(cbs)


# subspace tensors bigger than this train sequentially (see
# _train_codebooks_seq); tests shrink it to cover the path cheaply
_SEQ_TRAIN_BYTES = 2 << 30


@functools.partial(jax.jit, static_argnames=("metric",))
def _encode_subspaces(codebooks, subspaces, metric):
    """subspaces (m, n, dsub) x codebooks (m, k, dsub) -> codes (n, m) int32."""
    def enc_one(xs, cb):
        return jnp.argmin(metric.pairwise(xs, cb), axis=1).astype(jnp.int32)
    return jax.vmap(enc_one)(subspaces, codebooks).T


def _encode_chunked(codebooks, x, metric, block: int = 65536):
    """Chunked-over-n encode of already-rotated (n, d) data: the full-n
    (m, n, k) distance tensor would be ~16 GB at GIST scale."""
    n = x.shape[0]
    outs = [_encode_impl(codebooks, None, x[s:s + block], metric, False)
            for s in range(0, max(n, 1), block)]
    return outs[0] if len(outs) == 1 else jnp.concatenate(outs, axis=0)


def train_quantizer(key: jax.Array, residuals: jax.Array, *, m: int, k: int,
                    method: str = "pq", maxiter: int = 25,
                    metric: Metric = SQEUCLIDEAN, opq_iters: int = 4,
                    block: int = 16384) -> ProductQuantizer:
    """Train a PQ/OPQ quantizer on (n, d) residual vectors.

    When m does not divide d (the reference allows ragged `rowrange`
    subspaces), the quantizer space is zero-padded to m * ceil(d/m):
    padded dims carry zero residual mass, so distances are unchanged;
    `encode` pads inputs and decoding callers slice back to d.
    """
    n, d = residuals.shape
    residuals = jnp.asarray(residuals, jnp.float32)
    dq = -(-d // m) * m
    if dq != d:
        residuals = jnp.pad(residuals, ((0, 0), (0, dq - d)))
        d = dq
    block = min(block, max(256, n))
    eye = jnp.eye(d, dtype=jnp.float32)

    seq = residuals.size * 4 > _SEQ_TRAIN_BYTES

    if method == "pq":
        cb = _train_codebooks_seq(key, residuals, m, k, maxiter, metric,
                                  block) if seq else \
            _train_codebooks(key, _to_subspaces(residuals, m), k, maxiter,
                             metric, block)
        return ProductQuantizer(cb, eye, "pq")

    if method != "opq":
        raise ValueError(f"unknown quantization method {method!r}")

    # OPQ (Ge et al. 2013, non-parametric): alternate
    #   (1) train/refresh codebooks on rotated data,
    #   (2) rotation <- argmin_R ||X R - X_hat||_F  s.t. R orthogonal
    #       == Procrustes: R = U V^T from SVD(X^T X_hat).
    rot = eye
    cb = None
    for it in range(max(1, opq_iters)):
        xr = jnp.matmul(residuals, rot, precision=_HIGHEST)
        kit = jax.random.fold_in(key, it)
        cb = _train_codebooks_seq(kit, xr, m, k, maxiter, metric, block) \
            if seq else _train_codebooks(kit, _to_subspaces(xr, m), k,
                                         maxiter, metric, block)
        codes = _encode_chunked(cb, xr, metric)
        recon = _reconstruct_rotated(cb, codes)          # (n, d) in rotated space
        # The Procrustes SVD is a tiny (d, d) problem solved once per outer
        # iteration — do it on host in float64 so the rotation stays orthogonal
        # to machine precision (JAX's f32 SVD drifts ~1e-3).
        cov = np.asarray(jnp.matmul(residuals.T, recon, precision=_HIGHEST),
                         dtype=np.float64)
        u, _, vt = np.linalg.svd(cov, full_matrices=False)
        rot = jnp.asarray(u @ vt, jnp.float32)
    return ProductQuantizer(cb, rot, "opq")


@jax.jit
def _reconstruct_rotated(codebooks, codes):
    """codes (n, m) -> (n, d) reconstruction in the *rotated* space."""
    m, k, dsub = codebooks.shape
    gathered = jnp.take_along_axis(
        codebooks[None],                       # (1, m, k, dsub)
        codes.astype(jnp.int32)[:, :, None, None],  # (n, m, 1, 1)
        axis=2,
    )[:, :, 0, :]                              # (n, m, dsub)
    return gathered.reshape(codes.shape[0], m * dsub)


@functools.partial(jax.jit, static_argnames=("metric", "apply_rotation"))
def _encode_impl(codebooks, rotation, x, metric, apply_rotation):
    if apply_rotation:
        x = jnp.matmul(x, rotation, precision=_HIGHEST)
    m = codebooks.shape[0]
    return _encode_subspaces(codebooks, _to_subspaces(x, m), metric)


def encode(pq: ProductQuantizer, residuals: jax.Array,
           metric: Metric = SQEUCLIDEAN, block: int = 262144) -> jax.Array:
    """Encode (n, d) residuals -> (n, m) codes (smallest uint dtype for k).

    Chunked over n so the (block, k) distance matrices stay modest.
    """
    residuals = jnp.asarray(residuals, jnp.float32)
    if residuals.shape[1] != pq.d:      # ragged-subspace zero padding
        residuals = jnp.pad(
            residuals, ((0, 0), (0, pq.d - residuals.shape[1])))
    n = residuals.shape[0]
    apply_rot = pq.method == "opq"
    outs = []
    # cap the (m, block, k) distance tensor at ~1 GB f32: the default block
    # is sized for SIFT-shape m*k; GIST-scale m=16+ would transiently
    # allocate 4+ GB per chunk otherwise
    block = max(4096, min(block, (1 << 28) // max(pq.m * pq.k, 1)))
    # max(n, 1): an empty batch must encode to an empty (0, m) array, not
    # crash jnp.concatenate (same guard as decode_rotated below)
    for start in range(0, max(n, 1), block):
        chunk = residuals[start:start + block]
        outs.append(_encode_impl(pq.codebooks, pq.rotation, chunk, metric,
                                 apply_rot))
    codes = outs[0] if len(outs) == 1 else jnp.concatenate(outs, axis=0)
    return codes.astype(pq.code_dtype)


@functools.partial(jax.jit, static_argnames=("apply_rotation",))
def _decode_impl(codebooks, rotation, codes, apply_rotation):
    recon = _reconstruct_rotated(codebooks, codes)
    if apply_rotation:
        # inverse of the orthogonal rotation
        recon = jnp.matmul(recon, rotation.T, precision=_HIGHEST)
    return recon


@jax.jit
def _decode_rotated_onehot(codebooks, codes):
    """Chunk decode via one-hot matmul (no element gathers).

    codes (n, m) uint -> (n, d) bf16 reconstruction in the rotated space.
    Used to materialize the resident decoded-residual cache for the dense
    scan. The one-hot operand is exact in bf16 and the output is bf16, so
    the default precision loses nothing.
    """
    m, k, dsub = codebooks.shape
    onehot = (codes.astype(jnp.int32)[:, :, None] ==
              jnp.arange(k, dtype=jnp.int32)[None, None, :]
              ).astype(jnp.bfloat16)                      # (n, m, k)
    out = jnp.einsum("nmk,mks->nms", onehot,
                     codebooks.astype(jnp.bfloat16),
                     precision=jax.lax.Precision.DEFAULT,
                     preferred_element_type=jnp.bfloat16)
    return out.reshape(codes.shape[0], m * dsub)


def decode_rotated(pq: ProductQuantizer, codes, block: int = 65536):
    """(n, m) codes -> (n, d) bf16 decoded residuals in the ROTATED space
    (i.e. without the inverse OPQ rotation — pair with rotated queries)."""
    codes = jnp.asarray(codes)
    n = codes.shape[0]
    outs = [_decode_rotated_onehot(pq.codebooks, codes[s:s + block])
            for s in range(0, max(n, 1), block)]
    return outs[0] if len(outs) == 1 else jnp.concatenate(outs, axis=0)


def cache_scale(pq: ProductQuantizer) -> jax.Array:
    """Per-column int8 dequantization scale for the decoded-residual cache.

    Column j of any decoded (rotated-space) residual is one of the k entries
    of codebook[j // dsub][:, j % dsub], so max |codebook| per column bounds
    every cache value — the scale is exact, independent of which codes are
    stored, and therefore stable under all dynamic ops (codebooks never
    change after build)."""
    amax = jnp.max(jnp.abs(pq.codebooks), axis=1)        # (m, dsub)
    return jnp.maximum(amax.reshape(-1) / 127.0, 1e-12).astype(jnp.float32)


def decode_rotated_int8(pq: ProductQuantizer, codes, scale,
                        block: int = 65536):
    """(n, m) codes -> (n, d) int8 cache rows: round(codeword / scale).

    int8 halves the dense-scan gather traffic vs bf16; with the codebook-derived
    per-column `scale` (see cache_scale) the quantization error is <= scale/2
    per element — the same order as bf16's 8-bit mantissa rounding.

    The CODEBOOKS are quantized once and the one-hot decode matmul runs on
    the int8 entries (integers <= 127 are exact in bf16), so every cache row
    is bit-identical to quantizing its exact f32 decoded value."""
    m, k, dsub = pq.codebooks.shape
    scale = scale[:m * dsub]     # callers may hold a lane-padded scale
    qcb = jnp.clip(
        jnp.round(pq.codebooks / scale.reshape(m, 1, dsub)), -127, 127)
    codes = jnp.asarray(codes)
    n = codes.shape[0]
    outs = [_decode_rotated_onehot(qcb, codes[s:s + block]).astype(jnp.int8)
            for s in range(0, max(n, 1), block)]
    return outs[0] if len(outs) == 1 else jnp.concatenate(outs, axis=0)


def decode(pq: ProductQuantizer, codes: jax.Array) -> jax.Array:
    """Decode (n, m) codes -> (n, d) approximate residuals.

    Applies rot^T for OPQ — fixing the reference's `_decode_point`
    (/root/reference/src/utils.jl:71-81), which skips the inverse rotation.
    """
    return _decode_impl(pq.codebooks, pq.rotation,
                        jnp.asarray(codes), pq.method == "opq")
