"""Distributed sort-merge join over a device mesh, partition-first.

The multi-card realization of the reference's multi-threaded join phases
(reference: src/joins/sortmergejoin_multiway.c, joincommon.c): pthreads over
NUMA sockets become `shard_map` over a 1-D device mesh; the barrier-phased
shared-memory run exchange becomes an ``all_to_all`` (:mod:`.exchange`);
NUMA-local output buffers become per-shard arrays; the per-card counts are
summed on the host.

Per-chip program (SPMD):

  1. key-range statistics     — pmin/pmax over live keys,
  2. partition                — range-bucketize the local R and S shards by
                                destination chip (phase 1 of the reference,
                                sortmergejoin_multiway.c:331-386),
  3. exchange                 — all_to_all of the padded buckets,
  4. local sort + merge-join  — each chip now owns a disjoint key range, so
                                local match counts sum to the global count
                                (phases 2-4 of the reference collapsed into
                                the single-chip engine).

Pad sentinels (R=+2^31-1, S=-2^31) can never join, so counting over the
padded arrays is exact with no dynamic-shape handling.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..ops import mergejoin
from ..ops.sort import sort_keys
from . import exchange as ex
from .mesh import AXIS, is_2d, make_mesh


def _local_join_count(rk, sk):
    """Exact equi-match count between two padded local columns: R pads
    (+2^31-1) sort last and S pads (-2^31) match nothing, so both
    columns count whole."""
    with jax.named_scope("sort_r"):
        rks = sort_keys(rk)
    with jax.named_scope("sort_s"):
        sks = sort_keys(sk)
    with jax.named_scope("count"):
        return mergejoin.count_sorted(rks, sks)


def _shard_fn(rk, rp, sk, sp, nvalid_r, nvalid_s, *, n_chips: int,
              cap_r: int, cap_s: int):
    rk, rp, sk, sp = rk[0], rp[0], sk[0], sp[0]
    nr = nvalid_r[0]
    ns = nvalid_s[0]
    # 1. global key range over live tuples
    idx_r = jnp.arange(rk.shape[0], dtype=jnp.int32)
    idx_s = jnp.arange(sk.shape[0], dtype=jnp.int32)
    live_r = idx_r < nr
    live_s = idx_s < ns
    big = jnp.int32(2**31 - 1)
    lo = jnp.minimum(jnp.min(jnp.where(live_r, rk, big)),
                     jnp.min(jnp.where(live_s, sk, big)))
    hi = jnp.maximum(jnp.max(jnp.where(live_r, rk, -big)),
                     jnp.max(jnp.where(live_s, sk, -big)))
    lo = jax.lax.pmin(lo, AXIS)
    hi = jax.lax.pmax(hi, AXIS)
    # 2. partition by destination chip
    dest_r = ex.dest_of_keys(rk, n_chips, lo, hi)
    dest_s = ex.dest_of_keys(sk, n_chips, lo, hi)
    brk, brp, rc, ovr = ex.bucketize_by(dest_r, rk, rp, nr, n_chips, cap_r,
                                        ex.R_PAD_KEY)
    bsk, bsp, sc, ovs = ex.bucketize_by(dest_s, sk, sp, ns, n_chips, cap_s,
                                        ex.S_PAD_KEY)
    # 3. all_to_all of the padded buckets
    grk, grp, _ = ex.exchange(brk, brp, rc, AXIS, n_chips, cap_r)
    gsk, gsp, _ = ex.exchange(bsk, bsp, sc, AXIS, n_chips, cap_s)
    # 4. local count over the owned key range
    cnt = _local_join_count(grk, gsk)
    overflow = ovr + ovs
    return cnt.reshape(1), overflow.reshape(1)


@functools.lru_cache(maxsize=2)
def _count_fn(mesh: Mesh, n_chips: int, cap_r: int, cap_s: int):
    """Cached jitted pipeline (rebuilding it per call re-traces the whole
    distributed program on every invocation)."""
    return jax.jit(shard_map(
        functools.partial(_shard_fn, n_chips=n_chips, cap_r=cap_r,
                          cap_s=cap_s),
        mesh=mesh,
        in_specs=(P(AXIS),) * 6,
        out_specs=(P(AXIS), P(AXIS)),
    ))


def dist_join_count(rkeys, rpayloads, skeys, spayloads, n_r: int, n_s: int,
                    mesh: Optional[Mesh] = None, slack: float = 2.0):
    """Equi-join match count of R ⋈ S distributed over ``mesh``.

    Inputs are 1-D global columns (host or device arrays) of logical sizes
    ``n_r`` / ``n_s``.  Returns ``(count, overflow)`` as host ints —
    ``overflow`` must be 0 for the count to be exact (raise slack otherwise).
    """
    mesh = mesh or make_mesh()
    if is_2d(mesh):
        raise ValueError(
            "dist_join_count requires a flat mesh; the range exchange "
            "addresses only the chip axis — use dist_mway_join_count for "
            "2-D ('host','chip') meshes")
    n_chips = int(np.prod(list(mesh.shape.values())))
    shard_r = -(-n_r // n_chips)
    shard_s = -(-n_s // n_chips)
    # per-destination bucket capacity, aligned up to whole 128-key rows
    cap_r = ex.bucket_cap(shard_r, n_chips, slack, 128)
    cap_s = ex.bucket_cap(shard_s, n_chips, slack, 128)

    rk = ex.pad_column(rkeys[:n_r], shard_r * n_chips, ex.R_PAD_KEY)
    rp = ex.pad_column(rpayloads[:n_r], shard_r * n_chips, 0)
    sk = ex.pad_column(skeys[:n_s], shard_s * n_chips, ex.S_PAD_KEY)
    sp = ex.pad_column(spayloads[:n_s], shard_s * n_chips, 0)
    nv_r = ex.valid_counts(n_r, shard_r, n_chips)
    nv_s = ex.valid_counts(n_s, shard_s, n_chips)

    sharded = NamedSharding(mesh, P(AXIS))
    fn = _count_fn(mesh, n_chips, cap_r, cap_s)
    counts, overflow = fn(
        jax.device_put(rk.reshape(n_chips, shard_r), sharded),
        jax.device_put(rp.reshape(n_chips, shard_r), sharded),
        jax.device_put(sk.reshape(n_chips, shard_s), sharded),
        jax.device_put(sp.reshape(n_chips, shard_s), sharded),
        jax.device_put(jnp.asarray(nv_r), sharded),
        jax.device_put(jnp.asarray(nv_s), sharded),
    )
    return int(np.asarray(counts).sum()), int(np.asarray(overflow).sum())
