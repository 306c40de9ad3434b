"""Cross-card partition + exchange of relation shards.

The replacement for the reference's `threadrelchunks` shared exchange
matrix, through which every thread reads every other thread's sorted runs
during the merge phase (reference: src/joins/joincommon.h:129, writes
sortmergejoin_multiway.c:423-453, remote reads :504-518).  Here the
exchange is an ``all_to_all``: each card range-partitions its local shard
into one bucket per destination card, and the collective delivers to every
card all tuples whose keys fall in its owned range.

Padding discipline: buckets are padded to a static per-destination capacity
(the analog of RELATION_PADDING/ALIGN_NUMTUPLES, reference: src/params.h:41-72);
pad slots carry sentinel keys that can never match across R and S
(R pads = +2^31-1, S pads = -2^31; generated keys lie in [0, 2^31-2]).
Bucket overflow (possible under extreme skew with insufficient slack) is
detected and reported, never silently dropped.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.sort import sort_pairs

R_PAD_KEY = jnp.int32(2**31 - 1)
S_PAD_KEY = jnp.int32(-(2**31))


def valid_counts(n: int, shard: int, n_chips: int) -> np.ndarray:
    """Per-chip live-tuple counts for an even leading-axis split.

    Chip i owns rows [i*shard, (i+1)*shard) of the padded global column, so
    its live prefix is clip(n - i*shard, 0, shard).  The clip matters when
    n < shard*(n_chips-1) (tiny relations on wide meshes): a naive
    "all-but-last full" split would claim pad slots as valid and let
    pad-vs-pad sentinel matches inflate counts.
    """
    return np.clip(n - shard * np.arange(n_chips, dtype=np.int64),
                   0, shard).astype(np.int32)


def dest_of_keys(keys, n_buckets: int, minkey, maxkey):
    """Range-partition bucket of each key: floor((k - minkey) * B / span).

    The distributed analog of the reference's top-bits radix partition with
    bitshift chosen from the key range (sortmergejoin_multiway.c:372-376) —
    range partitioning generalizes it to non-power-of-two key spaces.

    Arithmetic note: a key domain spanning >= 2^31 (full-range keys) wraps
    int32 subtraction, so offsets are taken in uint32 (exact mod 2^32 —
    the true span always fits) and scaled in float32.  f32 rounding shifts
    a boundary by at most a few hundred keys, which only nudges bucket
    balance: monotonicity (contiguous ranges) and R/S consistency — the
    correctness requirements — are preserved because rounding is monotone.
    """
    rel = keys.astype(jnp.uint32) - minkey.astype(jnp.uint32)
    span = (maxkey.astype(jnp.uint32) - minkey.astype(jnp.uint32))\
        .astype(jnp.float32) + 1.0
    d = jnp.floor(rel.astype(jnp.float32) *
                  (jnp.float32(n_buckets) / span)).astype(jnp.int32)
    return jnp.clip(d, 0, n_buckets - 1)


def bucketize_by(dest, keys, payloads, n_valid, n_buckets: int, cap: int,
                 pad_key):
    """Group a local shard into ``n_buckets`` padded buckets of ``cap`` slots.

    ``keys``/``payloads`` are 1-D local arrays whose first ``n_valid``
    (traced scalar) entries are live; ``dest`` gives each tuple's bucket
    (computed by the caller so the same routine serves range- and
    radix-destinations).

    Returns ``(bkeys, bpayloads, counts, overflow)`` where ``bkeys`` has
    shape ``(n_buckets * cap,)`` with bucket d in slots
    [d*cap, d*cap+counts[d]) and sentinel ``pad_key`` elsewhere; ``overflow``
    counts tuples that did not fit (0 under adequate slack).
    """
    n = keys.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    valid = idx < n_valid
    dest = jnp.where(valid, dest, n_buckets)  # invalid → virtual bucket B
    # group by destination: one key (dest) carrying one value (the row),
    # then gather the columns — the sort shape the library sort takes
    dsort, rows = sort_pairs(dest, idx)
    ksort, psort = keys[rows], payloads[rows]
    counts_all = jnp.sum(
        dsort[None, :] == jnp.arange(n_buckets + 1, dtype=jnp.int32)[:, None],
        axis=1, dtype=jnp.int32,
    )
    counts = counts_all[:n_buckets]
    offsets = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(counts_all)[:-1].astype(jnp.int32)]
    )
    within = idx - offsets[dsort]
    fits = (within < cap) & (dsort < n_buckets)
    target = jnp.where(fits, dsort * cap + within, n_buckets * cap)
    bk = jnp.full((n_buckets * cap,), pad_key, keys.dtype)
    bp = jnp.zeros((n_buckets * cap,), payloads.dtype)
    bk = bk.at[target].set(ksort, mode="drop")
    bp = bp.at[target].set(psort, mode="drop")
    overflow = jnp.sum(((within >= cap) & (dsort < n_buckets)).astype(jnp.int32))
    return bk, bp, jnp.minimum(counts, cap), overflow


def exchange_hier(bflat, cap: int, n_hosts: int, chips_per_host: int,
                  host_axis: str, chip_axis: str, host_schedule=None):
    """Hierarchical two-stage all-to-all over a 2-D ('host','chip') mesh.

    ``bflat`` is the (n*cap,) padded bucket layout with bucket d destined
    to flat device d = h*C + c (same layout the 1-D exchange consumes).
    Stage 1 exchanges destination-chip groups WITHIN each host over the
    'chip' axis, so each device aggregates every co-hosted chip's traffic
    for its own chip index; stage 2 then moves whole host-groups across
    the 'host' tier — fewer, C×-bigger cross-host messages, the analog of
    the reference's region-strided RING schedule (numa_shuffle.c:80)
    aggregating cross-NUMA reads.

    ``host_schedule`` (offsets from mesh.shuffle_order over n_hosts)
    realizes stage 2 as collective_permute rounds instead of one fused
    all_to_all — the host-tier NEXT/RING/RANDOM shuffle knob.

    Returns the (n*cap,) received layout: run from source device s at
    slots [s*cap, s*cap + ...), bit-identical to the flat exchange's.
    """
    H, C = n_hosts, chips_per_host
    x = bflat.reshape(H, C, cap)            # [h_dest, c_dest, :]
    # stage 1: deliver destination-chip groups within the host
    x = jnp.swapaxes(x, 0, 1)               # [c_dest, h_dest, :]
    x = jax.lax.all_to_all(x, chip_axis, 0, 0, tiled=True)
    # now [c_src, h_dest, :]: co-hosted chip c_src's bucket for (h_dest, me_c)
    x = jnp.swapaxes(x, 0, 1)               # [h_dest, c_src, :]
    # stage 2: deliver host groups
    if host_schedule is None:
        x = jax.lax.all_to_all(x, host_axis, 0, 0, tiled=True)
    else:
        me_h = jax.lax.axis_index(host_axis)
        out = jnp.zeros_like(x)
        for off in host_schedule:
            off = int(off)
            dest = (me_h + off) % H
            piece = jnp.take(x, dest, axis=0)
            if off != 0:
                perm = [(h, (h + off) % H) for h in range(H)]
                piece = jax.lax.ppermute(piece, host_axis, perm)
            src = (me_h - off) % H
            out = jax.lax.dynamic_update_slice(
                out, piece[None], (src, jnp.int32(0), jnp.int32(0)))
        x = out
    # now [h_src, c_src, :] = the flat source-major received layout
    return x.reshape(-1)


def exchange(bkeys, bpayloads, counts, axis_name: str, n_buckets: int, cap: int):
    """All-to-all the padded buckets: bucket d of chip s lands on chip d.

    Returns the received ``(keys, payloads, counts)`` — ``counts[s]`` is how
    many live tuples chip s sent us (received run s occupies
    slots [s*cap, s*cap + counts[s])).  This is the collective form of the
    reference's cross-NUMA remote reads of threadrelchunks
    (sortmergejoin_multiway.c:504-518).
    """
    rk = jax.lax.all_to_all(bkeys, axis_name, split_axis=0, concat_axis=0,
                            tiled=True)
    rp = jax.lax.all_to_all(bpayloads, axis_name, split_axis=0, concat_axis=0,
                            tiled=True)
    rc = jax.lax.all_to_all(counts, axis_name, split_axis=0, concat_axis=0,
                            tiled=True)
    return rk, rp, rc


def bucket_cap(shard: int, n_chips: int, slack: float,
               align_elems: int) -> int:
    """Per-(chip, destination) bucket capacity: average bucket size times
    the slack factor, rounded up to ``align_elems``.  One formula for
    every dist pipeline — the capacity/overflow semantics must never
    diverge between them."""
    want = int(shard / n_chips * slack)
    return max(align_elems, -(-want // align_elems) * align_elems)


def pad_column(x, total: int, fill: int):
    """Pad/truncate a 1-D int32 column to ``total`` elements with the
    given sentinel — the host→device staging layout of every dist path."""
    x = jnp.asarray(x, jnp.int32)
    out = jnp.full((total,), fill, jnp.int32)
    return out.at[: x.shape[0]].set(x)
