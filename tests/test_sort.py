"""Sort tests — randomized property tests against oracles, the strategy of
the reference's check_avxsort suite (reference: tests/check_avxsort.c:
random + pre-sorted inputs, is_sorted postcondition); pair sorts are
checked for the exact (key, value) multiset per key."""

import numpy as np
import pytest
import jax.numpy as jnp

from avx_sort_merge_joins_tpu.models import common
from avx_sort_merge_joins_tpu.ops import sort as S
from avx_sort_merge_joins_tpu.types import KEY_SENTINEL


def _check(k):
    got = np.asarray(S.sort_keys(jnp.asarray(k)))
    np.testing.assert_array_equal(got, np.sort(k))


def _check_pairs(k, v):
    gk, gv = (np.asarray(a) for a in S.sort_pairs(jnp.asarray(k),
                                                  jnp.asarray(v)))
    np.testing.assert_array_equal(gk, np.sort(k))
    # values ride with their keys: same (key, value) multiset
    order = np.lexsort((gv, gk))
    want = np.lexsort((v, k))
    np.testing.assert_array_equal(gv[order], v[want])


@pytest.mark.parametrize("n", [1, 2, 127, 128, 129, 1024, 5000, 16384,
                               33000])
def test_sort_random(rng, n):
    _check(rng.integers(-(2**31) + 2, 2**31 - 2, n).astype(np.int32))


def test_sort_presorted_and_reverse(rng):
    n = 12000
    k = np.sort(rng.integers(0, 1 << 20, n)).astype(np.int32)
    _check(k)
    _check(k[::-1].copy())


def test_sort_many_duplicates(rng):
    n = 16000
    k = rng.integers(0, 8, n).astype(np.int32)  # heavy duplication
    _check_pairs(k, rng.permutation(n).astype(np.int32))


def test_sort_all_equal():
    n = 8192
    _check_pairs(np.full(n, 7, np.int32),
                 np.arange(n, dtype=np.int32)[::-1].copy())


@pytest.mark.parametrize("n", [0, 1, 3])
def test_sort_single_block(n):
    """Degenerate sizes: empty, one key, a few keys."""
    rng = np.random.default_rng(3)
    k = rng.integers(-100, 100, n).astype(np.int32)
    _check(k)
    _check_pairs(k, np.arange(n, dtype=np.int32))


def test_sort_negative_keys(rng):
    # the fork's motivating failure: negative keys under double-compare
    # (reference src/run.log:531-551) — int32 compares must be exact
    _check(rng.integers(-(2**31) + 2, 0, 12345).astype(np.int32))


def test_sort_sentinels_sort_last_and_first(rng):
    """Pad sentinels: KEY_SENTINEL (+2^31-1) must sort after every live
    key and -2^31 before, so padded columns keep their live prefix."""
    k = np.concatenate([rng.integers(-1000, 1000, 3000),
                        np.full(50, KEY_SENTINEL), np.full(7, -(2**31))])
    k = rng.permutation(k.astype(np.int32))
    got = np.asarray(S.sort_keys(jnp.asarray(k)))
    assert (got[:7] == -(2**31)).all() and (got[-50:] == KEY_SENTINEL).all()
    _check(k)


@pytest.mark.parametrize("domain", [4, 1000])
def test_sort_pairs_keeps_rows(rng, domain):
    """sort_pairs (one key carrying one value, the library-sort shape):
    every value stays with its key, under heavy and light duplication."""
    n = 20000
    _check_pairs(rng.integers(-domain, domain, n).astype(np.int32),
                 rng.integers(0, 10**6, n).astype(np.int32))


@pytest.mark.parametrize("lo,hi", [(0, 5000), (1000, 4000), (4999, 5000)])
def test_sort_side_slice(rng, lo, hi):
    """models.common.sort_side sorts exactly keys[lo:hi] (mpsm's chunks
    and the live prefix of padded relations)."""
    k = rng.integers(-50, 50, 5000).astype(np.int32)
    got = np.asarray(common.sort_side(jnp.asarray(k), lo, hi, "sort_s"))
    np.testing.assert_array_equal(got, np.sort(k[lo:hi]))
