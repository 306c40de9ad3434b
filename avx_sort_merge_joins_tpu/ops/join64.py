"""64-bit-key joins — the KEY_8B mode.

The reference's --enable-key8B switches to 16-byte tuples with int64 keys
(reference: src/types.h:23-29) and forces the scalar sort/merge paths
because its AVX kernels only handle 8-byte tuples (main.c:871-877).  Here
the keys are plain int64 columns: one int64 ``lax.sort`` per side and the
same plain count as the 32-bit path, traced with x64 enabled for the
KEY_8B program alone.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import mergejoin
from .sort import sort_keys


def sort64(keys64):
    """Ascending sort of int64 keys (host or device array)."""
    with jax.enable_x64(True):
        return _sort64(jnp.asarray(keys64, jnp.int64))


@jax.jit
def _sort64(k):
    return sort_keys(k)


@functools.partial(jax.jit, static_argnums=(2, 3))
def _count64(rkeys, skeys, nR: int, nS: int):
    rk = rkeys[:nR].astype(jnp.int64)
    sk = skeys[:nS].astype(jnp.int64)
    with jax.named_scope("sort_r"):
        rks = sort_keys(rk)
    with jax.named_scope("sort_s"):
        sks = sort_keys(sk)
    with jax.named_scope("count"):
        return mergejoin.count_sorted(rks, sks)


def key8b_join_count(rkeys, skeys, nR: int, nS: int):
    """End-to-end KEY_8B count join: keys (int32 streams from the
    reference's generators, or genuine int64 columns) widened to int64,
    sorted, counted.  Returns the exact count as a device int64 scalar."""
    with jax.enable_x64(True):
        return _count64(jnp.asarray(rkeys), jnp.asarray(skeys), nR, nS)


def count64(rkeys64, skeys64) -> int:
    """Exact match count of two int64 key columns (any order)."""
    r = np.asarray(rkeys64, np.int64)
    s = np.asarray(skeys64, np.int64)
    return int(key8b_join_count(r, s, r.shape[0], s.shape[0]))
