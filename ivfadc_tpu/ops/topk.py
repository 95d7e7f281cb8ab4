"""Smallest-k along the last dim: the coarse probe's selection, the scan's
candidate merge and the ground truth's running top-k.

Two implementations of the same contract, chosen while lowering by the
platform (`lax.platform_dependent`), never by a flag:
  * CUDA: a Pallas kernel through the Triton route. Each program holds one
    `_CHUNK`-wide slice of a row in registers and runs k min-extract passes
    (min, first index of the min, mask it); rows wider than one slice are
    reduced in two stages — each slice's k smallest, then the k smallest of
    those — which is exact, since every row winner is among its slice's k
    smallest. Measured on an H100 at the search shapes it is several times
    faster than XLA's `lax.top_k` (PERF.md).
  * everywhere else, and for k > _MAX_K: `lax.top_k` on the negated values.

Ties resolve to the lowest index in both. Caveat shared by both: when a row
holds fewer than k finite entries, the indices/payloads of the +inf tail
are arbitrary (and may repeat) — callers mask results by `isfinite(vals)`.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltr

# widest row slice one program holds (a power of two), and the largest k
# the min-extract passes serve (each pass is a full reduction of the slice)
_CHUNK = 2048
_MAX_K = 32


def _xla_smallest(x, k: int):
    neg, idx = jax.lax.top_k(-x, k)
    return -neg, idx


def _extract_kernel(x_ref, v_ref, i_ref, *, k: int):
    """k smallest of each row of the (1, n) block, ascending."""
    xs = x_ref[...]
    rows, n = xs.shape
    kp = v_ref.shape[1]
    lane = jax.lax.broadcasted_iota(jnp.int32, (rows, n), 1)
    kio = jax.lax.broadcasted_iota(jnp.int32, (rows, kp), 1)

    def body(j, carry):
        xs, vals, idxs = carry
        m = jnp.min(xs, axis=1, keepdims=True)
        a = jnp.min(jnp.where(xs == m, lane, n), axis=1, keepdims=True)
        vals = jnp.where(kio == j, m, vals)
        idxs = jnp.where(kio == j, a, idxs)
        return jnp.where(lane == a, jnp.inf, xs), vals, idxs

    _, vals, idxs = jax.lax.fori_loop(
        0, k, body, (xs, jnp.full((rows, kp), jnp.inf, jnp.float32),
                     jnp.full((rows, kp), -1, jnp.int32)))
    v_ref[...] = vals
    i_ref[...] = idxs


def extract_call(x, k: int, **pallas_options):
    """Pallas min-extract over rows of x (R, n), n a power of two:
    returns (vals (R, kp), idx (R, kp)), the first k columns being the k
    smallest ascending (kp = k rounded up to a power of two >= 16).
    `pallas_options` go to `pl.pallas_call` (the CPU tests use them to
    run the kernel body without a GPU)."""
    R, n = x.shape
    kp = max(16, pl.next_power_of_2(k))
    return pl.pallas_call(
        functools.partial(_extract_kernel, k=k), grid=(R,),
        in_specs=[pl.BlockSpec((1, n), lambda i: (i, 0))],
        out_specs=[pl.BlockSpec((1, kp), lambda i: (i, 0)),
                   pl.BlockSpec((1, kp), lambda i: (i, 0))],
        out_shape=[jax.ShapeDtypeStruct((R, kp), jnp.float32),
                   jax.ShapeDtypeStruct((R, kp), jnp.int32)],
        compiler_params=pltr.CompilerParams(num_warps=4),
        **pallas_options)(x)


def chunked_smallest(x, k: int, call=extract_call):
    """Exact smallest-k of x (B, N) through `call` on row slices of at most
    _CHUNK lanes: per-slice k smallest, then the k smallest of those."""
    B, N = x.shape
    x = x.astype(jnp.float32)
    width = min(_CHUNK, pl.next_power_of_2(max(N, k)))
    n_pad = -(-N // width) * width
    if n_pad != N:
        x = jnp.pad(x, ((0, 0), (0, n_pad - N)), constant_values=jnp.inf)
    nch = n_pad // width
    vals, idx = call(x.reshape(B * nch, width), k)
    vals = vals[:, :k].reshape(B, nch * k)
    idx = (idx[:, :k].reshape(B, nch, k)
           + (jnp.arange(nch, dtype=jnp.int32) * width)[None, :, None])
    idx = idx.reshape(B, nch * k)
    if nch == 1:
        return vals, idx
    vals, pos = chunked_smallest(vals, k, call)
    return vals, jnp.take_along_axis(idx, pos, axis=1)


def topk_lastdim(x: jax.Array, k: int):
    """x (B, N) -> (vals (B, k) ascending, idx (B, k) int32)."""
    x = x.astype(jnp.float32)
    if k > _MAX_K or k > x.shape[1]:
        return _xla_smallest(x, k)
    return jax.lax.platform_dependent(
        x, cuda=functools.partial(chunked_smallest, k=k),
        default=functools.partial(_xla_smallest, k=k))


def topk_lastdim_payload(x: jax.Array, payload: jax.Array, k: int):
    """Smallest-k of x, carrying the (B, N) `payload` of each winner:
    returns (vals (B, k) ascending, payload (B, k))."""
    vals, idx = topk_lastdim(x, k)
    return vals, jnp.take_along_axis(payload, idx, axis=1)
