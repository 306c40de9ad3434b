"""Distributed MPSM join (Albutiu et al. PVLDB'12) over a device mesh.

MPSM's defining asymmetry: **R is globally range-partitioned, S is only
sorted locally and never repartitioned** — every worker instead scans all
workers' S runs for its own key range.  On a shared-memory NUMA machine the
scan is a remote read; across cards it is a ring: the per-card sorted S
runs circulate via ``ppermute`` for n-1 rounds, and each card counts its
owned R range against the run passing through — S moves once around the
ring ((n-1)/n of |S| in total), R never moves after its one range
exchange, matching the paper's communication shape.

Skew: R's range splitters come from pooled equi-depth quantile samples of
both relations (same scheme as dist_mway), so Zipf-heavy S regions spread
the matching R ranges evenly.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import mergejoin
from ..ops.sort import sort_keys
from ..types import KEY_SENTINEL
from . import exchange as ex
from .dist_mway import _equidepth_bounds, _slice_buckets, _sort_local
from .mesh import AXIS, is_2d, make_mesh


@functools.lru_cache(maxsize=4)
def _count_fn(mesh: Mesh, n_chips: int, cap_r: int):
    """Cached jitted shard_map pipeline for dist_mpsm_join_count."""
    def shard_fn(rk, sk, nvr, nvs):
        nvr, nvs = nvr[0], nvs[0]
        # phase 1: local sorts (S runs stay local forever)
        rs, ss = _sort_local(rk[0], sk[0])
        # phase 2: exchange R only (contiguous sorted slices), then one
        # sort of the received runs: this card's owned R range
        with jax.named_scope("exchange"):
            bounds = _equidepth_bounds(rs, ss, nvr, nvs, n_chips)
            brk, _, _, ovr = _slice_buckets(rs, nvr, bounds, n_chips, cap_r)
            grk = jax.lax.all_to_all(brk, AXIS, 0, 0, tiled=True)
        with jax.named_scope("merge_r"):
            r_mine = sort_keys(grk)
        # phase 3: ring the S runs; every S key outside the owned range
        # finds no match in r_mine, so no range mask is needed — only the
        # live prefix of each run counts
        perm = [(x, (x + 1) % n_chips) for x in range(n_chips)]
        total = None
        s_cur, s_cnt = ss, nvs
        for rnd in range(n_chips):
            with jax.named_scope("count"):
                c = mergejoin.count_sorted(r_mine, s_cur, s_cnt)
            total = c if total is None else total + c
            if rnd != n_chips - 1:
                with jax.named_scope("ring"):
                    s_cur = jax.lax.ppermute(s_cur, AXIS, perm)
                    s_cnt = jax.lax.ppermute(s_cnt, AXIS, perm)
        return total.reshape(1), ovr.reshape(1)

    return jax.jit(shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(AXIS),) * 4,
        out_specs=(P(AXIS), P(AXIS)),
    ))


def dist_mpsm_join_count(rkeys, skeys, n_r: int, n_s: int,
                         mesh: Optional[Mesh] = None, slack: float = 2.0):
    """MPSM equi-join match count.  Returns (count, overflow) host ints."""
    mesh = mesh or make_mesh()
    if is_2d(mesh):
        raise ValueError(
            "dist_mpsm_join_count requires a flat mesh (the S ring and R "
            "range exchange address only the chip axis)")
    n_chips = int(np.prod(list(mesh.shape.values())))
    shard_r = -(-n_r // n_chips)
    shard_s = -(-n_s // n_chips)
    cap_r = ex.bucket_cap(shard_r, n_chips, slack, 128)

    rk = ex.pad_column(rkeys[:n_r], shard_r * n_chips, KEY_SENTINEL)
    sk = ex.pad_column(skeys[:n_s], shard_s * n_chips, KEY_SENTINEL)
    nv_r = ex.valid_counts(n_r, shard_r, n_chips)
    nv_s = ex.valid_counts(n_s, shard_s, n_chips)

    sharded = NamedSharding(mesh, P(AXIS))
    counts, overflow = _count_fn(mesh, n_chips, cap_r)(
        jax.device_put(rk.reshape(n_chips, shard_r), sharded),
        jax.device_put(sk.reshape(n_chips, shard_s), sharded),
        jax.device_put(jnp.asarray(nv_r), sharded),
        jax.device_put(jnp.asarray(nv_s), sharded),
    )
    ov = int(np.asarray(overflow).sum())
    if ov > 0 and slack < 16.0:
        # extreme skew overflowed a bucket: retry with doubled capacity
        return dist_mpsm_join_count(rkeys, skeys, n_r, n_s, mesh, slack * 2)
    return int(np.asarray(counts).sum()), ov
