"""Distributed end-to-end index build — no single-host materialization.

The reference's build is a single-threaded loop over all points
(/root/reference/src/index.jl:103-194). At Deep1B scale the flat posting
arrays (and especially the decoded-residual scan cache) cannot exist on one
host or card, so the build itself must be distributed (SURVEY §5 "Distributed
communication backend", §7 M4). Pipeline — every stage device-side, points
sharded over ALL mesh devices, only O(kc + S^2) metadata on host:

  A. data-parallel k-means over the full (data, shard) mesh
     (`distributed_kmeans` with axes=both — psum'd Lloyd sufficient stats);
  B. PQ training on a replicated residual subsample (same auto-cap as the
     single-card build), then one blocked shard_map pass computing each
     device's assignments + PQ codes + the global per-cell histogram;
  C. host computes the per-shard CSR layout from the (kc,) histogram —
     cells dealt round-robin (cell c -> shard c % S), identical to
     `partition_store`'s layout so search runs unchanged;
  D. redistribution: each device routes its (code, id, slot) rows to the
     owner shard with ONE `all_to_all` over the shard axis + an
     `all_gather` over the data axis, then scatters into its local CSR
     block. The full flat arrays never exist on any single device — each
     device only ever holds its input slice plus its own shard's CSR.

Global ids are insertion-order positions (0-based), exactly matching the
single-host `PostingStore.build` semantics: rank-within-cell is derived from
a psum'd per-device cell-histogram prefix, so the sharded index is
bit-compatible with a single-host build from the same trained components.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from jax import shard_map

from ivfadc_tpu.ops.metrics import Metric
from ivfadc_tpu.parallel.mesh import DATA_AXIS, SHARD_AXIS

_LANE = 128
BOTH_AXES = (DATA_AXIS, SHARD_AXIS)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# --------------------------------------------------------------------- stage B
@functools.partial(
    jax.jit,
    static_argnames=("mesh", "metric", "qmetric", "apply_rot", "kc", "n_shards",
                     "block"))
def _assign_encode_stats(centers, codebooks, rotation, x, mask, *, mesh,
                         metric: Metric, qmetric: Metric, apply_rot: bool,
                         kc: int, n_shards: int, block: int):
    """Per-device: blocked coarse assignment + PQ encode + histograms.

    x/mask sharded over BOTH mesh axes; centers/codebooks/rotation replicated.
    Returns (assignments sharded, codes sharded, global cell counts (kc,)
    replicated, per-(device, owner-shard) send counts (n_dev, S) replicated).
    """
    from ivfadc_tpu.ops.pq import _encode_subspaces, _to_subspaces

    def local(centers_l, cb_l, rot_l, x_l, mask_l):
        nl, d = x_l.shape
        dq = rot_l.shape[0]
        m = cb_l.shape[0]
        nb = -(-nl // block)
        xp = jnp.pad(x_l, ((0, nb * block - nl), (0, 0))
                     ).reshape(nb, block, d)

        def per_block(xb):
            dist = metric.pairwise(xb, centers_l)           # (b, kc)
            a = jnp.argmin(dist, axis=1).astype(jnp.int32)
            resid = xb - centers_l[a]
            if dq != d:                  # ragged-subspace zero padding
                resid = jnp.pad(resid, ((0, 0), (0, dq - d)))
            if apply_rot:     # full precision: codes are contracted exact
                resid = jnp.matmul(resid, rot_l,
                                   precision=jax.lax.Precision.HIGHEST)
            codes = _encode_subspaces(cb_l, _to_subspaces(resid, m), qmetric)
            return a, codes

        a_b, codes_b = jax.lax.map(per_block, xp)
        a_l = a_b.reshape(-1)[:nl]
        codes_l = codes_b.reshape(-1, m)[:nl]
        # padded rows -> sentinel bucket kc / S (dropped by the slice)
        a_eff = jnp.where(mask_l > 0, a_l, kc)
        counts = jnp.bincount(a_eff, length=kc + 1)[:kc]
        counts = jax.lax.psum(counts, BOTH_AXES)
        owner = jnp.where(mask_l > 0, a_l % n_shards, n_shards)
        send = jnp.bincount(owner, length=n_shards + 1)[:n_shards]
        send_all = jax.lax.all_gather(send, BOTH_AXES)      # (n_dev, S)
        return a_l, codes_l, counts, send_all

    fn = shard_map(
        local, mesh=mesh,
        in_specs=(P(), P(), P(), P(BOTH_AXES), P(BOTH_AXES)),
        out_specs=(P(BOTH_AXES), P(BOTH_AXES), P(), P()),
        check_vma=False)
    return fn(centers, codebooks, rotation, x, mask)


# --------------------------------------------------------------------- stage D
@functools.partial(
    jax.jit,
    static_argnames=("mesh", "kc", "n_shards", "send_cap", "cap_pad",
                     "code_dtype", "wide"))
def _redistribute_to_shards(a, codes, mask, offsets_per, *gids, mesh,
                            kc: int, n_shards: int, send_cap: int,
                            cap_pad: int, code_dtype, wide: bool = False):
    """Route every point's (code row, global id) to its owner shard's CSR.

    a/codes/mask sharded over BOTH axes; offsets_per (S, kc) replicated.
    Returns (codes (S, cap_pad, m), ids (S, cap_pad) int32) sharded over the
    shard axis — each device constructs ONLY its own shard's block.

    `wide=True` (ids beyond the device int32 cap): `gids` carries the
    host-precomputed (lo, hi) int32 limbs of each row's uint64 insertion id
    (lo = gid & (2^31-1), hi = gid >> 31 — device arithmetic alone cannot
    form a 64-bit id without x64 mode). Both limbs route through the same
    all_to_all; the returned ids are per-shard SLOT indices and two extra
    (S, cap_pad) limb arrays come back for the host-side translation.
    """
    S = n_shards

    def local(a_l, codes_l, mask_l, offs_l, *g_l):
        nl = a_l.shape[0]
        m = codes_l.shape[1]
        di = jax.lax.axis_index(DATA_AXIS)
        si = jax.lax.axis_index(SHARD_AXIS)
        dev = di * S + si                    # data-major device order matches
        # the P((data, shard)) layout: global insertion id = flat position
        if wide:
            g_list = list(g_l)               # (lo, hi) precomputed limbs
        else:
            g_list = [dev * nl + jnp.arange(nl, dtype=jnp.int32)]
        a_eff = jnp.where(mask_l > 0, a_l, kc)
        # global rank of each point within its cell = (postings of this cell
        # on earlier devices) + (rank among same-cell points locally)
        lc = jnp.bincount(a_eff, length=kc + 1)[:kc]         # (kc,)
        ag = jax.lax.all_gather(lc, BOTH_AXES)               # (n_dev, kc)
        base = jnp.cumsum(ag, axis=0)[dev] - lc              # exclusive prefix
        order = jnp.argsort(a_eff, stable=True)
        starts = jnp.concatenate(
            [jnp.zeros(1, lc.dtype), jnp.cumsum(lc)])        # (kc+1,)
        within = jnp.arange(nl, dtype=jnp.int32) - \
            starts[a_eff[order]].astype(jnp.int32)
        rank = jnp.zeros(nl, jnp.int32).at[order].set(within)
        a_safe = jnp.where(mask_l > 0, a_l, 0)
        owner = a_safe % S
        slot = (offs_l[owner, a_safe].astype(jnp.int32)
                + base[a_safe].astype(jnp.int32) + rank)
        slot = jnp.where(mask_l > 0, slot, -1)
        # ---- pack per-owner send buffers (<= send_cap rows each) ----
        owner_s = jnp.where(mask_l > 0, owner, S)            # sentinel last
        sorder = jnp.argsort(owner_s, stable=True)
        oc = jnp.bincount(owner_s, length=S + 1)
        ostart = jnp.cumsum(oc) - oc                         # (S+1,)
        o_sorted = owner_s[sorder]
        opos = jnp.arange(nl, dtype=jnp.int32) - \
            ostart[o_sorted].astype(jnp.int32)
        dst = (o_sorted, opos)                               # row S drops
        send_codes = jnp.zeros((S, send_cap, m), codes_l.dtype
                               ).at[dst].set(codes_l[sorder], mode="drop")
        send_slot = jnp.full((S, send_cap), -1, jnp.int32
                             ).at[dst].set(slot[sorder], mode="drop")
        send_g = [jnp.full((S, send_cap), -1, jnp.int32
                           ).at[dst].set(g[sorder], mode="drop")
                  for g in g_list]
        # ---- shard-axis all_to_all + data-axis gather ----
        rc = jax.lax.all_to_all(send_codes, SHARD_AXIS, 0, 0, tiled=True)
        rs = jax.lax.all_to_all(send_slot, SHARD_AXIS, 0, 0, tiled=True)
        rg_list = [jax.lax.all_gather(
                       jax.lax.all_to_all(sg, SHARD_AXIS, 0, 0, tiled=True),
                       DATA_AXIS).reshape(-1)
                   for sg in send_g]
        rc = jax.lax.all_gather(rc, DATA_AXIS).reshape(-1, m)
        rs = jax.lax.all_gather(rs, DATA_AXIS).reshape(-1)
        # ---- scatter into this shard's CSR block (invalid rows drop) ----
        tgt = jnp.where(rs >= 0, rs, cap_pad)
        codes_sh = jnp.zeros((cap_pad, m), code_dtype
                             ).at[tgt].set(rc.astype(code_dtype), mode="drop")
        g_sh = [jnp.full((cap_pad,), -1, jnp.int32
                         ).at[tgt].set(rg, mode="drop")
                for rg in rg_list]
        if wide:
            lo_sh, hi_sh = g_sh
            ids_sh = jnp.where(lo_sh >= 0,
                               jnp.arange(cap_pad, dtype=jnp.int32), -1)
            return codes_sh[None], ids_sh[None], lo_sh[None], hi_sh[None]
        return codes_sh[None], g_sh[0][None]

    n_out = 4 if wide else 2
    fn = shard_map(
        local, mesh=mesh,
        in_specs=(P(BOTH_AXES), P(BOTH_AXES), P(BOTH_AXES), P())
        + tuple([P(BOTH_AXES)] * len(gids)),
        out_specs=tuple([P(SHARD_AXIS)] * n_out),
        check_vma=False)
    return fn(a, codes, mask, offsets_per, *gids)


# --------------------------------------------------------------------- stage E
@functools.partial(jax.jit, static_argnames=("int8", "block"))
def _decode_shard_caches(codebooks, codes, scale, *, int8: bool,
                         block: int = 65536):
    """Per-shard decoded-residual caches for the dense scan.

    codes (S, cap_pad, m) sharded over the shard axis; the one-hot decode is
    elementwise per shard so XLA keeps the output sharded — no collectives,
    no single-device materialization of the full cache."""
    from ivfadc_tpu.ops.pq import _decode_rotated_onehot

    if int8:
        m, k, dsub = codebooks.shape
        cb = jnp.clip(jnp.round(
            codebooks / scale[:m * dsub].reshape(m, 1, dsub)), -127, 127)
    else:
        cb = codebooks

    def one_shard(c):
        cap = c.shape[0]
        nb = -(-cap // block)
        cp = c if nb * block == cap else \
            jnp.pad(c, ((0, nb * block - cap), (0, 0)))
        out = jax.lax.map(
            lambda blk: _decode_rotated_onehot(cb, blk),
            cp.reshape(nb, block, -1))
        out = out.reshape(nb * block, -1)[:cap]
        return out.astype(jnp.int8) if int8 else out

    return jax.vmap(one_shard)(codes)


# ------------------------------------------------------------------- pipeline
def build_distributed_parts(data, mesh, config):
    """Run the distributed build pipeline. Returns
    (parts dict for ShardedIVFADCIndex, coarse, quantizer, global_layout).

    `parts` arrays are DEVICE arrays already sharded over the shard axis
    (codes/ids/decoded) or small host arrays (offsets/sizes); `global_layout`
    is the (kc,)-metadata equivalent of a single-host PostingStore layout
    (offsets/caps/sizes) for the payload-free base index.
    """
    from ivfadc_tpu.models.index import _PQ_TRAIN_AUTOCAP
    from ivfadc_tpu.ops import pq as pq_ops
    from ivfadc_tpu.ops.metrics import get_metric
    from ivfadc_tpu.parallel.distributed import distributed_kmeans

    cmetric = get_metric(config.coarse_metric)
    qmetric = get_metric(config.quantization_metric)
    S = mesh.shape[SHARD_AXIS]
    D = mesh.shape[DATA_AXIS]
    n_dev = D * S
    key = jax.random.PRNGKey(config.seed)
    k_coarse, k_quant, k_cq = jax.random.split(key, 3)

    on_device = isinstance(data, jax.Array)
    if not on_device:
        data = np.ascontiguousarray(np.asarray(data, np.float32))
    n, d = data.shape
    config.validate_for_data(n, d, sharded=True)
    from ivfadc_tpu.config import device_id_cap
    wide = n > device_id_cap()       # ids beyond the device int32 cap:
    if wide and jax.process_count() > 1:     # see sharded.WIDE_NO_ID
        raise NotImplementedError(
            "wide-id distributed builds are single-controller for now "
            "(the host-side slot->id translation needs a per-process "
            "exchange on a multi-host runtime)")
    n_pad = _round_up(n, n_dev)
    both = NamedSharding(mesh, P(BOTH_AXES))
    if on_device:
        xd = jax.device_put(
            jnp.pad(data.astype(jnp.float32), ((0, n_pad - n), (0, 0))), both)
    else:
        xd = jax.device_put(
            np.pad(data, ((0, n_pad - n), (0, 0))), both)
    maskd = jax.device_put(
        np.pad(np.ones(n, np.float32), (0, n_pad - n)), both)

    # A. coarse k-means over every device
    centers, _ = distributed_kmeans(
        k_coarse, xd, config.kc, mesh, maxiter=config.coarse_maxiter,
        metric=cmetric, mask=maskd, n_valid=n, axes=BOTH_AXES)

    # B1. PQ training on a replicated residual subsample (auto-capped like
    # the single-card build — codebooks from 2^20 residuals are statistically
    # indistinguishable; encoding still covers every point)
    qs = config.quantization_sample or min(n, _PQ_TRAIN_AUTOCAP)
    qs = min(qs, n)
    from ivfadc_tpu.utils.datasets import sample_indices
    sel = sample_indices(config.seed, n, qs)   # O(qs), not an O(n) permutation
    # cross-shard device gather of just the sample rows (replicated result)
    sample = jnp.asarray(data[sel]) if not on_device \
        else xd[jnp.asarray(sel)]
    s_cells = jnp.argmin(cmetric.pairwise(sample, centers), axis=1)
    s_resid = sample - centers[s_cells]
    quantizer = pq_ops.train_quantizer(
        k_quant, s_resid, m=config.m, k=config.k,
        method=config.quantization_method,
        maxiter=config.quantization_maxiter, metric=qmetric,
        opq_iters=config.opq_iters, block=config.kmeans_block)
    del sample, s_resid

    # B2. sharded assignment + encode + histograms
    a, codes, counts, send_all = _assign_encode_stats(
        centers, quantizer.codebooks, quantizer.rotation, xd, maskd,
        mesh=mesh, metric=cmetric, qmetric=qmetric,
        apply_rot=quantizer.method == "opq", kc=config.kc, n_shards=S,
        block=min(8192, n_pad // n_dev))
    counts = np.asarray(counts).astype(np.int64)          # (kc,) tiny
    send_cap = int(np.asarray(send_all).max())            # (n_dev, S) tiny
    send_cap = max(8, _round_up(send_cap, 8))

    # C. per-shard CSR layout from the global histogram (host, O(kc))
    align = 8
    cells_idx = np.arange(config.kc)
    owners = cells_idx % S
    sizes_per = np.zeros((S, config.kc), np.int64)
    sizes_per[owners, cells_idx] = counts
    slack_rows = np.ceil(sizes_per * (config.cell_slack - 1.0)).astype(np.int64)
    caps_per = np.where(
        sizes_per > 0,
        np.maximum(align, _round_up(sizes_per + slack_rows + 8, align)),
        0)                                      # non-local cells: zero extent
    offsets_per = np.zeros((S, config.kc), np.int64)
    np.cumsum(caps_per[:, :-1], axis=1, out=offsets_per[:, 1:])
    cap_shard = _round_up(
        int((offsets_per[:, -1] + caps_per[:, -1]).max()), _LANE)
    cap_pad = cap_shard

    # D. all_to_all redistribution -> per-shard CSR blocks (device-side)
    offs_rep = jax.device_put(offsets_per.astype(np.int32),
                              NamedSharding(mesh, P()))
    trans = None
    if wide:
        # 64-bit insertion ids ride the redistribution as two int32 limbs
        # (host-precomputed: global id == flat padded-row position); the
        # scattered limb blocks come back to host as the slot -> uint64
        # translation. Device id arrays hold per-shard slot indices.
        gid = np.arange(n_pad, dtype=np.uint64)
        gl = jax.device_put((gid & np.uint64(0x7FFFFFFF)).astype(np.int32),
                            both)
        gh = jax.device_put((gid >> np.uint64(31)).astype(np.int32), both)
        codes_sh, ids_sh, lo_sh, hi_sh = _redistribute_to_shards(
            a, codes, maskd, offs_rep, gl, gh, mesh=mesh, kc=config.kc,
            n_shards=S, send_cap=send_cap, cap_pad=cap_pad,
            code_dtype=jnp.dtype(quantizer.code_dtype), wide=True)
        lo_h = np.asarray(lo_sh).astype(np.int64)
        hi_h = np.asarray(hi_sh).astype(np.int64)
        trans = np.where(
            lo_h >= 0,
            ((hi_h.astype(np.uint64) << np.uint64(31))
             | lo_h.astype(np.uint64)),
            np.uint64(0xFFFFFFFFFFFFFFFF))
    else:
        codes_sh, ids_sh = _redistribute_to_shards(
            a, codes, maskd, offs_rep, mesh=mesh, kc=config.kc, n_shards=S,
            send_cap=send_cap, cap_pad=cap_pad,
            code_dtype=jnp.dtype(quantizer.code_dtype))

    parts = dict(
        offsets=offsets_per.astype(np.int32),
        sizes=sizes_per.astype(np.int32),
        pq_codes=codes_sh,                    # (S, cap_pad, m) device
        ids=ids_sh,                           # (S, cap_pad) int32 device
        window=_round_up(max(1, int(sizes_per.max())), _LANE),
        align=align,
        max_cap=int(caps_per.max(initial=0)),
        cap_shard=cap_shard,
    )
    if trans is not None:
        parts["trans"] = trans

    # global single-host-equivalent layout for the payload-free base index
    g_slack = np.ceil(counts * (config.cell_slack - 1.0)).astype(np.int64)
    g_caps = np.maximum(align, _round_up(counts + g_slack + 8, align))
    g_offsets = np.zeros(config.kc, np.int64)
    np.cumsum(g_caps[:-1], out=g_offsets[1:])
    global_layout = dict(offsets=g_offsets, caps=g_caps, sizes=counts)

    from ivfadc_tpu.models.coarse import make_coarse_quantizer
    coarse = make_coarse_quantizer(
        config.coarse_quantizer, k_cq, centers, cmetric,
        n_groups=config.coarse_n_groups,
        n_probe_groups=config.coarse_probe_groups)
    return parts, coarse, quantizer, global_layout
