"""Distributed m-way join: sort-first exchange of sorted runs.

The multi-card realization of the reference's m-way phases (reference:
src/joins/sortmergejoin_multiway.c): each thread sorts its local
partitions, then every thread gathers one partition's sorted runs from ALL
threads (the cross-NUMA remote reads of threadrelchunks, :504-518) and
merges them.  Here:

  phase 1+2  — per-card ``lax.sort`` of the local shard (partition+sort of
               the reference collapse: the sorted run IS
               range-partitionable by slicing),
  exchange   — every card's contribution to card d is one CONTIGUOUS slice
               of its sorted run (equi-depth range splitters), so the
               exchange is dynamic-slice → pad → ``all_to_all`` under
               ``shard_map``, which XLA hands to the collective library,
  phase 3    — per-card re-sort of the n_cards received runs (the
               reference's multiway merge; a receiver k-way merge is a
               later optimization),
  phase 4    — plain count over the owned key range; the global count is
               the host sum of per-card counts (disjoint key ranges).

Skew note: the splitters are pooled quantiles of both relations, so Zipf
foreign keys balance; the padded bucket capacity carries a slack factor
and overflow is detected and retried with more slack, never silent.
"""

from __future__ import annotations

import functools
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding

from ..ops import mergejoin
from ..ops.sort import sort_keys
from ..types import KEY_SENTINEL, NumaStrategy
from . import exchange as ex
from .exchange import exchange_hier
from .mesh import (AXIS, HOST_AXIS, chips_per_host_of, flat_axes, flat_spec,
                   host_shape, is_2d, make_mesh, shuffle_order)


def _bucket_starts(ks, bounds, n_valid):
    """Start of each destination's slice in a sorted column: the rank of
    every splitter (#keys < bound), then the live length at the end."""
    inner = jnp.searchsorted(ks, jnp.stack(bounds[1:]), side="left") \
        if len(bounds) > 1 else jnp.zeros((0,), jnp.int32)
    inner = jnp.minimum(inner.astype(jnp.int32), n_valid)
    return jnp.concatenate([jnp.zeros((1,), jnp.int32), inner,
                            n_valid.astype(jnp.int32).reshape(1)])


def _slice_buckets(ks, n_valid, bounds, n_chips: int, cap: int, vs=None):
    """Cut a sorted column (and optionally a value column riding with it)
    into per-destination contiguous buckets of ``cap`` slots.

    Bucket d = keys in [bounds[d], bounds[d+1]), padded with KEY_SENTINEL
    (values with 0).  Returns (bkeys, bvalues_or_None, counts, overflow)
    in the (n_chips*cap,) layout the exchange consumes.
    """
    idx = jnp.arange(ks.shape[0], dtype=jnp.int32)
    kv = jnp.where(idx < n_valid, ks, KEY_SENTINEL)
    # tail padding so dynamic_slice never clamps (start <= n_valid <= size)
    kv = jnp.concatenate([kv, jnp.full((cap,), KEY_SENTINEL, jnp.int32)])
    if vs is not None:
        vv = jnp.concatenate([jnp.where(idx < n_valid, vs, 0),
                              jnp.zeros((cap,), vs.dtype)])
    starts = _bucket_starts(kv, bounds, n_valid)
    lane = jnp.arange(cap, dtype=jnp.int32)
    bk, bv, counts = [], [], []
    overflow = jnp.int32(0)
    for d in range(n_chips):
        ln = starts[d + 1] - starts[d]
        overflow = overflow + jnp.maximum(ln - cap, 0)
        keep = lane < ln
        bk.append(jnp.where(keep, jax.lax.dynamic_slice(kv, (starts[d],),
                                                        (cap,)), KEY_SENTINEL))
        if vs is not None:
            bv.append(jnp.where(keep, jax.lax.dynamic_slice(
                vv, (starts[d],), (cap,)), 0))
        counts.append(jnp.minimum(ln, cap))
    return (jnp.concatenate(bk), jnp.concatenate(bv) if vs is not None
            else None, jnp.stack(counts), overflow)


def _equidepth_bounds(rs, ss, nvr, nvs, n_chips: int, axes=AXIS):
    """Skew-aware equi-depth splitters: each card contributes local
    quantiles of its sorted runs; the pooled, sorted samples yield
    balanced bounds even under Zipf skew (heavy single keys still land
    whole on one card; the slack factor + overflow check guard).
    ``axes`` is the flat collective spec (axis name, or the
    ('host','chip') tuple on hierarchical meshes)."""
    nq = 16  # quantiles per relation per card
    qs = []
    for j in range(nq):
        # divide BEFORE multiplying: nvr * j wraps int32 for shards
        # >= ~143M, and dynamic_slice wraps negative starts
        pos_r = jnp.minimum((nvr // nq) * j, jnp.maximum(nvr - 1, 0))
        pos_s = jnp.minimum((nvs // nq) * j, jnp.maximum(nvs - 1, 0))
        qs.append(jax.lax.dynamic_slice(rs, (pos_r,), (1,)))
        qs.append(jax.lax.dynamic_slice(ss, (pos_s,), (1,)))
    samples = jax.lax.all_gather(jnp.concatenate(qs), axes).reshape(-1)
    samples = sort_keys(samples)
    ns = samples.shape[0]
    bounds = [jnp.int32(-(2**31) + 1)]
    for d in range(1, n_chips):
        bounds.append(samples[(ns * d) // n_chips])
    return bounds


def _exchange(bflat, n_chips: int, cap: int, schedule, hier=None):
    """Deliver bucket d of every card to card d.

    ``schedule=None`` uses one fused all_to_all; otherwise it is a host
    list of rotation offsets (from :func:`..parallel.mesh.shuffle_order` —
    the NEXT/RING/RANDOM orders of numa_shuffle.c:55-85) realized as
    collective_permute rounds.

    ``hier=(n_hosts, chips_per_host)`` routes through the two-stage
    exchange of a 2-D ('host','chip') mesh (with ``schedule`` applied at
    the host tier as permute rounds).
    """
    if hier is not None:
        H, C = hier
        return exchange_hier(bflat, cap, H, C, HOST_AXIS, AXIS,
                             host_schedule=schedule)
    if schedule is None:
        return jax.lax.all_to_all(bflat, AXIS, 0, 0, tiled=True)
    b2 = bflat.reshape(n_chips, cap)
    me = jax.lax.axis_index(AXIS)
    out = jnp.zeros_like(b2)
    for off in schedule:
        off = int(off)
        if off == 0:
            piece = jnp.take(b2, me % n_chips, axis=0)  # own bucket stays
            src = me
        else:
            # card x sends bucket[(x+off) mod n] to card (x+off) mod n
            perm = [(x, (x + off) % n_chips) for x in range(n_chips)]
            piece = jax.lax.ppermute(
                jnp.take(b2, (me + off) % n_chips, axis=0), AXIS, perm)
            src = (me - off) % n_chips
        out = jax.lax.dynamic_update_slice(out, piece[None, :],
                                           (src, jnp.int32(0)))
    return out.reshape(-1)


def _exchange_counts(counts, n_chips: int, hier):
    if hier is not None:
        return _exchange(counts, n_chips, 1, None, hier)
    return jax.lax.all_to_all(counts, AXIS, 0, 0, tiled=True)


def _sort_local(rk, sk):
    with jax.named_scope("sort_r"):
        rs = sort_keys(rk)
    with jax.named_scope("sort_s"):
        ss = sort_keys(sk)
    return rs, ss


def _exchange_and_merge(rs, ss, nvr, nvs, n_chips, cap_r, cap_s, axes,
                        schedule, hier):
    """Splitters → bucket slices → exchange → re-sort of the received
    runs.  Returns (merged R, merged S, live S count, overflow)."""
    with jax.named_scope("exchange"):
        bounds = _equidepth_bounds(rs, ss, nvr, nvs, n_chips, axes)
        brk, _, _, ovr = _slice_buckets(rs, nvr, bounds, n_chips, cap_r)
        bsk, _, sc, ovs = _slice_buckets(ss, nvs, bounds, n_chips, cap_s)
        grk = _exchange(brk, n_chips, cap_r, schedule, hier)
        gsk = _exchange(bsk, n_chips, cap_s, schedule, hier)
        gsc = _exchange_counts(sc, n_chips, hier)
    # pads are KEY_SENTINEL, so the live keys sort to the front
    with jax.named_scope("merge_r"):
        mr = sort_keys(grk)
    with jax.named_scope("merge_s"):
        ms = sort_keys(gsk)
    return mr, ms, jnp.sum(gsc), ovr + ovs


def _count_owned(mr, ms, ts):
    with jax.named_scope("count"):
        return mergejoin.count_sorted(mr, ms, ts)


class _Plan:
    """Static layout of one distributed call: mesh shape, exchange
    schedule, bucket capacities and the sharded inputs."""

    def __init__(self, rkeys, skeys, n_r, n_s, mesh, slack, numa_strategy,
                 pre_sharded):
        self.mesh = mesh
        self.n_chips = int(np.prod(list(mesh.shape.values())))
        self.hier = host_shape(mesh) if is_2d(mesh) else None
        self.axes = flat_axes(mesh)
        self.spec = flat_spec(mesh)
        self.schedule = _schedule(mesh, self.n_chips, self.hier,
                                  numa_strategy)
        shard_r = -(-n_r // self.n_chips)
        shard_s = -(-n_s // self.n_chips)
        self.cap_r = ex.bucket_cap(shard_r, self.n_chips, slack, 128)
        self.cap_s = ex.bucket_cap(shard_s, self.n_chips, slack, 128)
        sharded = NamedSharding(mesh, self.spec)
        if pre_sharded:
            assert rkeys.shape == (self.n_chips, shard_r), rkeys.shape
            assert skeys.shape == (self.n_chips, shard_s), skeys.shape
            self.rk, self.sk = rkeys, skeys
        else:
            self.rk = jax.device_put(ex.pad_column(
                rkeys[:n_r], shard_r * self.n_chips, KEY_SENTINEL).reshape(
                    self.n_chips, shard_r), sharded)
            self.sk = jax.device_put(ex.pad_column(
                skeys[:n_s], shard_s * self.n_chips, KEY_SENTINEL).reshape(
                    self.n_chips, shard_s), sharded)
        self.nvr = jax.device_put(jnp.asarray(
            ex.valid_counts(n_r, shard_r, self.n_chips)), sharded)
        self.nvs = jax.device_put(jnp.asarray(
            ex.valid_counts(n_s, shard_s, self.n_chips)), sharded)

    @property
    def key(self):
        return (self.mesh, self.n_chips, self.cap_r, self.cap_s,
                self.schedule, self.hier)


def _schedule(mesh, n_chips, hier, numa_strategy):
    """Exchange schedule as a hashable tuple of offsets, or None for the
    one fused all_to_all."""
    if hier is not None:
        # hierarchical mesh: the shuffle knob schedules the host tier
        if numa_strategy is None:
            return None
        return tuple(shuffle_order(numa_strategy, hier[0], 1).tolist())
    if numa_strategy is None:
        return None
    if numa_strategy == NumaStrategy.NEXT:
        return tuple(range(n_chips))
    # RING strides by the mesh's host granularity (the reference derives
    # threads-per-region from libnuma, numa_shuffle.c:80)
    return tuple(shuffle_order(numa_strategy, n_chips,
                               chips_per_host_of(mesh)).tolist())


def _smap(mesh, spec, f, n_in, n_out):
    return jax.jit(shard_map(
        f, mesh=mesh, in_specs=(spec,) * n_in,
        out_specs=tuple([spec] * n_out) if n_out > 1 else spec))


@functools.lru_cache(maxsize=4)
def _count_fn(mesh: Mesh, n_chips: int, cap_r: int, cap_s: int, schedule,
              hier):
    """Cached jitted shard_map pipeline for :func:`dist_mway_join_count`
    (rebuilding it per call re-traces the whole distributed program)."""
    axes = flat_axes(mesh)

    def shard_fn(rk, sk, nvr, nvs):
        rs, ss = _sort_local(rk[0], sk[0])
        mr, ms, ts, ov = _exchange_and_merge(
            rs, ss, nvr[0], nvs[0], n_chips, cap_r, cap_s, axes, schedule,
            hier)
        return _count_owned(mr, ms, ts).reshape(1), ov.reshape(1)

    return _smap(mesh, flat_spec(mesh), shard_fn, 4, 2)


def dist_mway_join_count(rkeys, skeys, n_r: int, n_s: int,
                         mesh: Optional[Mesh] = None, slack: float = 2.0,
                         numa_strategy: Optional[str] = None,
                         pre_sharded: bool = False):
    """Distributed m-way equi-join match count over a device mesh.

    Returns (count, overflow) host ints; overflow must be 0 (it is retried
    with doubled slack up to 16x).

    A 2-D ('host','chip') mesh (mesh.make_mesh2d) switches the exchange to
    the hierarchical two-stage form (with the NEXT/RING/RANDOM schedule
    applied to hosts).

    ``pre_sharded``: rkeys/skeys are already (n_chips, shard) device
    arrays laid out with this mesh's sharding (the workload-A scale tier,
    parallel.scale); sizes must then divide evenly by n_chips.
    """
    mesh = mesh or make_mesh()
    plan = _Plan(rkeys, skeys, n_r, n_s, mesh, slack, numa_strategy,
                 pre_sharded)
    counts, overflow = _count_fn(*plan.key)(plan.rk, plan.sk, plan.nvr,
                                            plan.nvs)
    ov = int(np.asarray(overflow).sum())
    if ov > 0 and slack < 16.0:
        # extreme skew overflowed a bucket: retry with doubled capacity
        # (the reference's fixed RELATION_PADDING has no such safety net)
        return dist_mway_join_count(rkeys, skeys, n_r, n_s, mesh, slack * 2,
                                    numa_strategy, pre_sharded)
    return int(np.asarray(counts).sum()), ov


@functools.lru_cache(maxsize=4)
def _phased_fns(mesh: Mesh, n_chips: int, cap_r: int, cap_s: int, schedule,
                hier):
    """Cached jitted programs for the three phase dispatches of
    :func:`dist_mway_join_phased`."""
    axes = flat_axes(mesh)
    spec = flat_spec(mesh)

    def sort_fn(rk, sk):
        rs, ss = _sort_local(rk[0], sk[0])
        return rs[None], ss[None]

    def exmerge_fn(rs, ss, nvr, nvs):
        mr, ms, ts, ov = _exchange_and_merge(
            rs[0], ss[0], nvr[0], nvs[0], n_chips, cap_r, cap_s, axes,
            schedule, hier)
        return mr[None], ms[None], ts.reshape(1), ov.reshape(1)

    def count_fn(mr, ms, ts):
        return _count_owned(mr[0], ms[0], ts[0]).reshape(1)

    return (_smap(mesh, spec, sort_fn, 2, 2),
            _smap(mesh, spec, exmerge_fn, 4, 4),
            _smap(mesh, spec, count_fn, 3, 1))


def dist_mway_join_phased(rkeys, skeys, n_r: int, n_s: int,
                          mesh: Optional[Mesh] = None, slack: float = 2.0,
                          numa_strategy: Optional[str] = None,
                          pre_sharded: bool = False):
    """Distributed m-way count with PER-PHASE timing: three separately
    dispatched shard_map programs (local sort | exchange + merge | count),
    each waited for, so multi-card runs report the reference's SORT /
    MERGE1 / MJOIN record columns (joincommon.c:175-196).

    Returns ``(count, overflow, phases)`` where phases maps
    sort/merge1/mergejoin/total to seconds.  :func:`dist_mway_join_count`
    is the same work in one dispatch.
    """
    mesh = mesh or make_mesh()
    plan = _Plan(rkeys, skeys, n_r, n_s, mesh, slack, numa_strategy,
                 pre_sharded)
    sort_p, exmerge_p, count_p = _phased_fns(*plan.key)
    phases = {}
    t0 = time.perf_counter()
    rs, ss = jax.block_until_ready(sort_p(plan.rk, plan.sk))
    phases["sort"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    mr, ms, ts, overflow = jax.block_until_ready(
        exmerge_p(rs, ss, plan.nvr, plan.nvs))
    phases["merge1"] = time.perf_counter() - t1
    t2 = time.perf_counter()
    counts = jax.block_until_ready(count_p(mr, ms, ts))
    phases["mergejoin"] = time.perf_counter() - t2
    phases["total"] = phases["sort"] + phases["merge1"] + phases["mergejoin"]
    ov = int(np.asarray(overflow).sum())
    if ov > 0 and slack < 16.0:
        return dist_mway_join_phased(rkeys, skeys, n_r, n_s, mesh, slack * 2,
                                     numa_strategy, pre_sharded)
    return int(np.asarray(counts).sum()), ov, phases

