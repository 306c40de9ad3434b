"""Merge-join match count over sorted relations — the plain analog of the
reference's scalar merge_join (reference: src/joins/joincommon.c:239-312),
whose result is ``sum over keys k of cntR(k) * cntS(k)``.

Every S tuple contributes cntR(its key), so the count needs R sorted and
one lookup per S tuple; S is sorted too so that neighbouring lookups walk
the same part of R.  :func:`count_sorted` does ONE binary search per S
tuple (its lower bound in R) and reads cntR from a run-length table of R
built by one reverse ``cummin`` scan.  (Two binary searches, lower and
upper bound, took 1.9x as long on an H100: see PERF.md.)

The count is exact for every input: per-tuple counts are < 2^31 (they are
bounded by |R|), and their sum is taken in int64 with x64 enabled for the
reduction alone, so totals past 2^31 (hot keys on both sides) need no
host recount.

Contract of the sorted inputs: ``rks`` is ascending over its WHOLE length,
so padding must sort last (KEY_SENTINEL = INT32_MAX, which no live key may
equal); only the first ``n_s`` entries of ``sks`` are live.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def _live_mask(m: int, n_s):
    if n_s is None:
        return None
    return jnp.arange(m, dtype=jnp.int32) < n_s


def _sum64(cnt):
    """Exact total of int32 per-tuple counts."""
    with jax.enable_x64(True):
        return jnp.sum(cnt.astype(jnp.int64))


def count_sorted(rks, sks, n_s=None):
    """Match count as sum over S of the length of R's run of equal keys
    that starts at S's lower bound (0 when that run holds another key)."""
    n, m = rks.shape[0], sks.shape[0]
    if n == 0 or m == 0:
        return _sum64(jnp.zeros((0,), jnp.int32))
    idx = jnp.arange(n, dtype=jnp.int32)
    last = jnp.concatenate([rks[1:] != rks[:-1], jnp.ones((1,), bool)])
    # exclusive end of the run holding each position
    run_end = jax.lax.cummin(jnp.where(last, idx + 1, n), reverse=True)
    lo = jnp.searchsorted(rks, sks, side="left").astype(jnp.int32)
    at = jnp.minimum(lo, n - 1)
    hit = (lo < n) & (rks[at] == sks)
    live = _live_mask(m, n_s)
    if live is not None:
        hit = hit & live
    return _sum64(jnp.where(hit, run_end[at] - lo, 0))


def merge_join_count_numpy(rkeys: np.ndarray, skeys: np.ndarray) -> int:
    """NumPy reference oracle: sum_k cntR(k)*cntS(k), for keys of any
    integer width."""
    rk, rc = np.unique(rkeys, return_counts=True)
    sk, sc = np.unique(skeys, return_counts=True)
    _, ri, si = np.intersect1d(rk, sk, assume_unique=True,
                               return_indices=True)
    return int(np.sum(rc[ri].astype(np.int64) * sc[si].astype(np.int64)))
