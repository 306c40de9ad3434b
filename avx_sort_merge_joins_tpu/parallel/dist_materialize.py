"""Distributed materializing join: payload-carrying sort, equi-depth
splitters, exchange, and streaming persist.

The reference's threads materialize the matching S tuple per match pair
inside the same engine that counts (reference: src/joins/joincommon.c:266-289
under JOIN_MATERIALIZE).  This path mirrors the distributed m-way count
pipeline tuple-for-tuple, with payloads riding along:

  phase 1+2  — per-card sorts: R keys only (the output is <S-key,
               S-payload>; R payloads never travel), S keys carrying their
               payloads (one key, one value — the library sort's shape),
  splitters  — the SAME pooled-quantile equi-depth splitters as the count
               path (dist_mway._equidepth_bounds), so Zipf-skewed
               workloads balance without overflow retries,
  exchange   — contiguous sorted-slice range exchange of key AND payload
               buckets (all_to_all; hierarchical two-stage form on 2-D
               ('host','chip') meshes),
  phase 3    — per-card re-sort of the received (key, payload) runs,
  phase 4    — per-card <S-key, S-payload> materialization with physical
               dup-R expansion (ops.materialize),
  persist    — optional STREAMING append: each card's bounded output
               chunk flushes through csrc/tblio.cc ``tbl_append`` before
               the next card's is fetched, so the full join output never
               exists in host memory (the reference writes whole buffers,
               generator.c:200-213).

Cards own disjoint key ranges, so per-card outputs concatenate to the
exact multiset of reference output tuples.
"""

from __future__ import annotations

import functools

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding

from ..ops import materialize as mat
from ..ops.sort import sort_keys, sort_pairs
from ..types import KEY_SENTINEL
from . import exchange as ex
from .dist_mway import _equidepth_bounds, _slice_buckets
from .mesh import (AXIS, HOST_AXIS, flat_axes, flat_spec, host_shape,
                   is_2d, make_mesh)

# retries taken by the most recent dist_join_materialize call (0 = the
# equi-depth splitters balanced the workload on the first attempt — the
# observable for the no-overflow-retry acceptance test)
LAST_RETRIES = 0


@functools.lru_cache(maxsize=4)
def _materialize_fn(mesh: Mesh, n_chips: int, cap_r: int, cap_s: int,
                    cap_out: int, hier):
    """Cached jitted shard_map pipeline for dist_join_materialize."""
    axes = flat_axes(mesh)
    spec = flat_spec(mesh)

    def exch(bflat, cap):
        if hier is not None:
            H, C = hier
            return ex.exchange_hier(bflat, cap, H, C, HOST_AXIS, AXIS)
        return jax.lax.all_to_all(bflat, AXIS, 0, 0, tiled=True)

    def shard_fn(rk, sk, sp, nvr, nvs):
        rk, sk, sp = rk[0], sk[0], sp[0]
        nvr, nvs = nvr[0], nvs[0]
        with jax.named_scope("sort_r"):
            rs = sort_keys(rk)
        with jax.named_scope("sort_s"):
            ss, sps = sort_pairs(sk, sp)
        with jax.named_scope("exchange"):
            bounds = _equidepth_bounds(rs, ss, nvr, nvs, n_chips, axes)
            brk, _, _, ovr = _slice_buckets(rs, nvr, bounds, n_chips, cap_r)
            bsk, bsp, sc, ovs = _slice_buckets(ss, nvs, bounds, n_chips,
                                               cap_s, vs=sps)
            grk = exch(brk, cap_r)
            gsk, gsp = exch(bsk, cap_s), exch(bsp, cap_s)
            ts = jnp.sum(exch(sc, 1))
        # re-sort the received runs; pads are KEY_SENTINEL and sort last,
        # so R is fully sorted and the live S tuples come first
        with jax.named_scope("merge_r"):
            rks = sort_keys(grk)
        with jax.named_scope("merge_s"):
            sks, sps = sort_pairs(gsk, gsp)
        # S pad slots take the S pad sentinel, so they can never match R's
        # KEY_SENTINEL pads
        sidx = jnp.arange(sks.shape[0], dtype=jnp.int32)
        sks = jnp.where(sidx < ts, sks, ex.S_PAD_KEY)
        with jax.named_scope("materialize"):
            ok, op, om, nm = mat.materialize_matches(
                rks, rks.shape[0], sks, sps, sks.shape[0])
            ek, ep, total = mat.expand_matches(ok, op, om, nm, cap_out)
        out_ov = jnp.maximum(total - cap_out, 0)
        return (ek.reshape(1, -1), ep.reshape(1, -1),
                total.reshape(1), (ovr + ovs + out_ov).reshape(1))

    return jax.jit(shard_map(
        shard_fn, mesh=mesh,
        in_specs=(spec,) * 5,
        out_specs=(spec,) * 4,
    ))


def dist_join_materialize(rkeys, rpayloads, skeys, spayloads,
                          n_r: int, n_s: int,
                          mesh: Optional[Mesh] = None, slack: float = 2.0,
                          out_slack: float = 2.0,
                          stream_to: Optional[str] = None,
                          _retries: int = 0):
    """Materialized distributed equi-join over a chip mesh.

    Returns ``(out_keys, out_payloads, count, overflow)``: host numpy
    columns of all matched <S-key, S-payload> tuples (one row per match
    pair, physical dup-R expansion), the match count, and the
    exchange/output overflow (0 when slack sufficed; auto-retried with
    doubled slack otherwise).

    ``stream_to``: path of an Out.tbl to STREAM per-chip chunks into
    (appended in chip order); the returned columns are then None and host
    memory stays bounded by one chip's padded output.
    """
    global LAST_RETRIES
    mesh = mesh or make_mesh()
    n_chips = int(np.prod(list(mesh.shape.values())))
    hier = host_shape(mesh) if is_2d(mesh) else None
    spec = flat_spec(mesh)
    shard_r = -(-n_r // n_chips)
    shard_s = -(-n_s // n_chips)
    cap_r = ex.bucket_cap(shard_r, n_chips, slack, 128)
    cap_s = ex.bucket_cap(shard_s, n_chips, slack, 128)
    # static per-chip output capacity: received-S capacity × expansion slack
    cap_out = max(128, int(np.ceil(n_chips * cap_s * out_slack / 128)) * 128)

    # R payloads are never shipped: the output is <S-key, S-payload>
    # rows, so only R keys participate
    rk = ex.pad_column(rkeys[:n_r], shard_r * n_chips, KEY_SENTINEL)
    sk = ex.pad_column(skeys[:n_s], shard_s * n_chips, KEY_SENTINEL)
    sp = ex.pad_column(spayloads[:n_s], shard_s * n_chips, 0)
    nv_r = ex.valid_counts(n_r, shard_r, n_chips)
    nv_s = ex.valid_counts(n_s, shard_s, n_chips)

    sharded = NamedSharding(mesh, spec)
    fn = _materialize_fn(mesh, n_chips, cap_r, cap_s, cap_out, hier)
    ek, ep, totals, overflow = fn(
        jax.device_put(rk.reshape(n_chips, shard_r), sharded),
        jax.device_put(sk.reshape(n_chips, shard_s), sharded),
        jax.device_put(sp.reshape(n_chips, shard_s), sharded),
        jax.device_put(jnp.asarray(nv_r), sharded),
        jax.device_put(jnp.asarray(nv_s), sharded),
    )
    ov = int(np.asarray(overflow).sum())
    if ov > 0 and slack < 16.0:
        return dist_join_materialize(rkeys, rpayloads, skeys, spayloads,
                                     n_r, n_s, mesh, slack * 2,
                                     out_slack * 2, stream_to,
                                     _retries + 1)
    LAST_RETRIES = _retries
    totals = np.asarray(totals)
    if stream_to is not None:
        # streaming persist: fetch + flush ONE card's chunk at a time —
        # host memory stays O(cap_out), not O(total output)
        from ..datagen import append_rows

        open(stream_to, "w").close()  # truncate
        for c in range(n_chips):
            t = int(totals[c])
            if t == 0:
                continue
            append_rows(stream_to, np.asarray(ek[c])[:t],
                        np.asarray(ep[c])[:t])
        return None, None, int(totals.sum()), ov
    ek = np.asarray(ek)
    ep = np.asarray(ep)
    ks = np.concatenate([ek[c, : totals[c]] for c in range(n_chips)])
    ps = np.concatenate([ep[c, : totals[c]] for c in range(n_chips)])
    return ks, ps, int(totals.sum()), ov
