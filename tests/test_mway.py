"""m-way join tests (the reference validates joins via Results = |S| on
pk/fk workloads plus sortedness checks; we add a numpy count oracle —
reference: src/joins/sortmergejoin_multiway.c, joincommon.c:487-501)."""

import numpy as np
import pytest

from avx_sort_merge_joins_tpu.types import Relation
from avx_sort_merge_joins_tpu.models.mway import sortmergejoin_multiway
from avx_sort_merge_joins_tpu.ops.mergejoin import merge_join_count_numpy


def _rel(keys, rng):
    return Relation.from_numpy(
        keys, rng.integers(0, 1000, len(keys)).astype(np.int32))


def test_mway_pk_fk(rng):
    nR, nS = 50_000, 70_000
    rk = rng.permutation(np.arange(1, nR + 1)).astype(np.int32)
    sk = rng.integers(1, nR + 1, nS).astype(np.int32)
    res = sortmergejoin_multiway(_rel(rk, rng), _rel(sk, rng))
    assert res.totalresults == merge_join_count_numpy(rk, sk) == nS


def test_mway_nonunique(rng):
    nR, nS = 30_000, 30_000
    rk = rng.integers(1, 5_000, nR).astype(np.int32)
    sk = rng.integers(1, 5_000, nS).astype(np.int32)
    res = sortmergejoin_multiway(_rel(rk, rng), _rel(sk, rng))
    assert res.totalresults == merge_join_count_numpy(rk, sk)


def test_mway_negative_keys(rng):
    """The fork's motivating bug: negative keys mis-sorted under double
    compare (reference: src/run.log:531-551).  Native int32 compares must
    handle them exactly."""
    nR = nS = 20_000
    rk = rng.integers(-(2**28), 2**28, nR).astype(np.int32)
    sk = rng.integers(-(2**28), 2**28, nS).astype(np.int32)
    res = sortmergejoin_multiway(_rel(rk, rng), _rel(sk, rng))
    assert res.totalresults == merge_join_count_numpy(rk, sk)


@pytest.mark.parametrize("nR,nS", [(1, 1), (3, 1000), (1000, 3),
                                   (4097, 8191)])
def test_mway_sizes(rng, nR, nS):
    """Tiny, lopsided and non-power-of-two sides."""
    rk = rng.integers(1, 50, nR).astype(np.int32)
    sk = rng.integers(1, 50, nS).astype(np.int32)
    res = sortmergejoin_multiway(_rel(rk, rng), _rel(sk, rng))
    assert res.totalresults == merge_join_count_numpy(rk, sk)


@pytest.mark.parametrize("nchunks", [1, 2, 5])
def test_mpsm_chunks_agree_with_mway(rng, nchunks):
    """mpsm's independent S runs count exactly what one sorted S does."""
    from avx_sort_merge_joins_tpu.models.mpsm import sortmergejoin_mpsm

    rk = rng.integers(1, 3000, 20000).astype(np.int32)
    sk = rng.integers(1, 3000, 30001).astype(np.int32)
    res = sortmergejoin_mpsm(_rel(rk, rng), _rel(sk, rng), nchunks=nchunks)
    assert res.totalresults == merge_join_count_numpy(rk, sk)
    assert set(res.phases) == {"sort", "mergejoin", "total"}
