"""Merge-join count tests: match counts validated against the NumPy oracle
sum_k cntR(k)*cntS(k) — the semantics of the reference's duplicate-aware
merge_join (reference: src/joins/joincommon.c:239-312)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from avx_sort_merge_joins_tpu.ops import mergejoin as MJ
from avx_sort_merge_joins_tpu.types import KEY_SENTINEL


def _count(rk, sk, n_s=None):
    rks = jnp.sort(jnp.asarray(rk))
    sks = jnp.sort(jnp.asarray(sk))
    return int(jax.jit(MJ.count_sorted)(rks, sks, n_s))


@pytest.mark.parametrize("nR,nS,lo,hi", [
    (5000, 8000, 0, 500),      # many duplicates both sides
    (4096, 4096, 0, 10**6),    # sparse matches
    (3000, 9000, 0, 10),       # extreme duplication
    (1000, 1000, -500, 500),   # negative keys
])
def test_count_vs_oracle(rng, nR, nS, lo, hi):
    rk = rng.integers(lo, hi, nR).astype(np.int32)
    sk = rng.integers(lo, hi, nS).astype(np.int32)
    assert _count(rk, sk) == MJ.merge_join_count_numpy(rk, sk)


def test_count_pk_fk(rng):
    # default-workload invariant: R = unique 1..n, S fk -> matches == |S|
    n = 10000
    rk = rng.permutation(np.arange(1, n + 1)).astype(np.int32)
    sk = rng.integers(1, n + 1, 3 * n).astype(np.int32)
    assert _count(rk, sk) == 3 * n


def test_count_no_matches(rng):
    rk = rng.integers(0, 1000, 2000).astype(np.int32)
    sk = rng.integers(5000, 6000, 2000).astype(np.int32)
    assert _count(rk, sk) == 0


def test_count_all_equal():
    assert _count(np.full(300, 42, np.int32),
                  np.full(500, 42, np.int32)) == 300 * 500


@pytest.mark.parametrize("nR,nS", [(0, 5), (5, 0), (0, 0)])
def test_count_empty_sides(nR, nS):
    assert _count(np.ones(nR, np.int32), np.ones(nS, np.int32)) == 0


@pytest.mark.parametrize("nR,nS", [(10, 50000), (50000, 10)])
def test_count_lopsided(rng, nR, nS):
    rk = rng.integers(0, 64, nR).astype(np.int32)
    sk = rng.integers(0, 64, nS).astype(np.int32)
    assert _count(rk, sk) == MJ.merge_join_count_numpy(rk, sk)


def test_count_live_prefix(rng):
    """Only the first n_s S keys count: S pad slots hold KEY_SENTINEL,
    the same value as R's pads, and must not match them."""
    rk = np.concatenate([rng.integers(0, 100, 900),
                         np.full(100, KEY_SENTINEL)]).astype(np.int32)
    live = rng.integers(0, 100, 700).astype(np.int32)
    sk = np.concatenate([np.sort(live),
                         np.full(300, KEY_SENTINEL, np.int32)])
    got = int(jax.jit(MJ.count_sorted)(jnp.sort(jnp.asarray(rk)),
                                       jnp.asarray(sk), jnp.int32(700)))
    assert got == MJ.merge_join_count_numpy(rk[:900], live)


def test_count_sentinel_pads_never_match(rng):
    """R padded with KEY_SENTINEL at the end (the distributed layouts):
    live S keys never reach the pads."""
    rk = np.concatenate([rng.integers(-50, 50, 4000),
                         np.full(1000, KEY_SENTINEL)]).astype(np.int32)
    sk = rng.integers(-60, 60, 6000).astype(np.int32)
    assert _count(rk, sk) == MJ.merge_join_count_numpy(rk[:4000], sk)


def test_count_past_2_31():
    """A hot key on both sides: 50K x 50K = 2.5e9 matches > 2^31 must come
    back exact (int64 total, no host recount)."""
    n = 50_000
    got = _count(np.full(n, 7, np.int32), np.full(n, 7, np.int32))
    assert got == n * n


def test_count_int64_keys(rng):
    """The same counts over genuine 64-bit keys (KEY_8B), traced with x64:
    keys that differ only above bit 31 must not match."""
    base = rng.integers(0, 1000, 3000).astype(np.int64)
    rk = base + (rng.integers(0, 3, 3000).astype(np.int64) << 40)
    sk = base[rng.integers(0, 3000, 5000)] + \
        (rng.integers(0, 3, 5000).astype(np.int64) << 40)
    with jax.enable_x64(True):
        got = int(jax.jit(MJ.count_sorted)(jnp.sort(jnp.asarray(rk)),
                                           jnp.sort(jnp.asarray(sk)), None))
    assert got == MJ.merge_join_count_numpy(rk, sk)


def test_count_result_is_int64():
    out = jax.jit(MJ.count_sorted)(jnp.arange(10, dtype=jnp.int32),
                                   jnp.arange(10, dtype=jnp.int32))
    assert out.dtype == np.int64 and int(out) == 10


def test_mway_model_overflow_fallback():
    """The m-way model counts a both-sides-hot key past 2^31 exactly on
    the device (the old fused kernel needed a host recount here)."""
    from avx_sort_merge_joins_tpu.models.mway import sortmergejoin_multiway
    from avx_sort_merge_joins_tpu.types import Relation

    n = 1 << 16
    R = Relation.from_numpy(np.full(n, 7, np.int32))
    Sr = Relation.from_numpy(np.full(n, 7, np.int32))
    assert sortmergejoin_multiway(R, Sr).totalresults == n * n
