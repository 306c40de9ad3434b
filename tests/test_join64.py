"""KEY_8B (int64 key) mode tests — the reference's --enable-key8B
(types.h:23-29) widens tuples to 16 bytes; here the keys are int64
columns sorted by one int64 lax.sort and counted by the plain count, with
x64 enabled for the KEY_8B program alone."""

import jax.numpy as jnp
import numpy as np
import pytest

from avx_sort_merge_joins_tpu.ops import join64
from avx_sort_merge_joins_tpu.ops.mergejoin import merge_join_count_numpy


def test_sort64(rng):
    n = 50000
    k = rng.integers(-(2**62), 2**62, n).astype(np.int64)
    got = np.asarray(join64.sort64(k))
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, np.sort(k))


def test_sort64_extremes(rng):
    """int64 extremes and keys equal in their low 32 bits sort as int64."""
    k = np.concatenate([
        np.array([np.iinfo(np.int64).min, np.iinfo(np.int64).max, 0, -1]),
        (rng.integers(-4, 4, 1000).astype(np.int64) << 32) + 5,
    ])
    k = rng.permutation(k)
    np.testing.assert_array_equal(np.asarray(join64.sort64(k)), np.sort(k))


def test_x64_stays_scoped():
    """The KEY_8B program enables x64 for itself only."""
    join64.count64(np.arange(5), np.arange(5))
    assert jnp.asarray(np.arange(3, dtype=np.int64)).dtype == np.int32


def test_key8b_join_count_end_to_end(rng):
    """The KEY_8B pipeline (widen -> int64 sort -> count) on int32 key
    streams against the numpy oracle, nonunique keys."""
    nR, nS = 30000, 45000
    rk = rng.integers(1, 8000, nR).astype(np.int32)
    sk = rng.integers(1, 8000, nS).astype(np.int32)
    got = int(join64.key8b_join_count(jnp.asarray(rk), jnp.asarray(sk),
                                      nR, nS))
    assert got == merge_join_count_numpy(rk, sk)


def test_key8b_scalar_sort_path(rng):
    """pk-fk workload through KEY_8B: count == |S|."""
    nR, nS = 10000, 15000
    rk = rng.permutation(np.arange(1, nR + 1)).astype(np.int32)
    sk = rng.integers(1, nR + 1, nS).astype(np.int32)
    assert int(join64.key8b_join_count(rk, sk, nR, nS)) == nS


def test_fused64_wide_keys_vs_oracle(rng):
    """Genuinely 64-bit keys: the high word carries entropy and
    duplicates repeat across the whole range."""
    nR, nS = 40000, 50000
    pool = rng.integers(-(2**40), 2**40, 5000).astype(np.int64)
    rk = pool[rng.integers(0, 5000, nR)]
    sk = pool[rng.integers(0, 5000, nS)]
    assert join64.count64(rk, sk) == merge_join_count_numpy(rk, sk)


def test_count64_vs_oracle(rng):
    nR, nS = 20000, 30000
    rk = rng.integers(0, 2**40, nR).astype(np.int64)
    sk = np.concatenate([rk[rng.integers(0, nR, nS - 1000)],
                         rng.integers(0, 2**40, 1000)]).astype(np.int64)
    assert join64.count64(rk, sk) == merge_join_count_numpy(rk, sk)


def test_count64_high_word_distinguishes(rng):
    """Keys equal in their low 32 bits but not above must not match."""
    low = rng.integers(0, 100, 2000).astype(np.int64)
    rk = low
    sk = low + (1 << 32)
    assert join64.count64(rk, sk) == 0
    assert join64.count64(rk, np.concatenate([sk, low[:10]])) == \
        merge_join_count_numpy(rk, low[:10])


def test_finish_count64_no_int32_wrap():
    """Counts >= 2^31 come back exact: a 50K x 50K hot key."""
    n = 50_000
    assert join64.count64(np.full(n, 3), np.full(n, 3)) == n * n


@pytest.mark.parametrize("nR,nS", [(1, 1), (5, 3), (0, 4), (129, 7)])
def test_fused64_edge_sizes(rng, nR, nS):
    """Tiny and odd sizes through the int64 pipeline, empty R included."""
    rk = rng.integers(0, 5, nR).astype(np.int64)
    sk = rng.integers(0, 5, nS).astype(np.int64)
    assert join64.count64(rk, sk) == merge_join_count_numpy(rk, sk)


@pytest.mark.parametrize("flags", [["--non-unique"], ["--full-range"]])
def test_key8b_cli_matches_int32_path(capsys, flags):
    """--key8b counts the same workload exactly like the 32-bit path
    (identical key values, wider storage: types.h:23-29)."""
    from avx_sort_merge_joins_tpu.cli import main

    argv = ["-r", "20000", "-s", "30000", "-x", "4", "-y", "5"] + flags
    assert main(argv) == 0
    want = capsys.readouterr().out.split("Results = ")[1].split()[0]
    assert main(["--key8b"] + argv) == 0
    assert capsys.readouterr().out.split("Results = ")[1].split()[0] == want
