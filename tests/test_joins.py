"""End-to-end join tests on reference workloads — validated by the
`Results = |S|` invariant of the default pk-fk workloads (reference:
README:246-258) and by the NumPy oracle for skewed/nonunique ones."""

import numpy as np
import pytest

from avx_sort_merge_joins_tpu.datagen import (
    create_relation_fk,
    create_relation_nonunique,
    create_relation_zipf,
    parallel_create_relation,
    seed_generator,
)
from avx_sort_merge_joins_tpu.models.mpass import sortmergejoin_multipass
from avx_sort_merge_joins_tpu.ops import mergejoin as MJ


def test_mpass_pk_fk_equal_sizes():
    seed_generator(42)
    R = parallel_create_relation(16384, 16384, 2)
    S = create_relation_fk(16384, 16384)
    res = sortmergejoin_multipass(R, S)
    assert res.totalresults == 16384


def test_mpass_pk_fk_larger_s():
    seed_generator(7)
    R = parallel_create_relation(6000, 6000, 4)
    S = create_relation_fk(20000, 6000)
    res = sortmergejoin_multipass(R, S)
    assert res.totalresults == 20000


def test_mpass_zipf_skew():
    seed_generator(9)
    R = parallel_create_relation(5000, 5000, 1)
    S = create_relation_zipf(12000, 5000, 0.75)
    res = sortmergejoin_multipass(R, S)
    # R is a full permutation of 1..5000 and zipf keys are in [1,5000]
    assert res.totalresults == 12000


def test_mpass_nonunique_oracle():
    seed_generator(11)
    R = create_relation_nonunique(8000, 2000)
    S = create_relation_nonunique(12000, 2000)
    res = sortmergejoin_multipass(R, S)
    rk, _ = R.to_numpy()
    sk, _ = S.to_numpy()
    assert res.totalresults == MJ.merge_join_count_numpy(rk, sk)


def test_mpass_phase_stats_present():
    seed_generator(1)
    R = parallel_create_relation(4096, 4096, 1)
    S = create_relation_fk(4096, 4096)
    res = sortmergejoin_multipass(R, S)
    assert "total" in res.phases and res.throughput > 0


# --- property sweep: m-way-grade coverage for the single-chip m-pass
# model (VERDICT r4 #7) — non-pow2 sizes × duplicate densities vs the
# numpy oracle, exercising ragged tails in every pairwise merge level
# (the reference's merge16_varlen tail handling,
# sortmergejoin_multipass.c:137-292 / avxsort_core.h:486-501)

from avx_sort_merge_joins_tpu.types import Relation


def _rel(keys, rng):
    return Relation.from_numpy(
        np.asarray(keys, np.int32),
        rng.integers(0, 1000, len(keys)).astype(np.int32))


@pytest.mark.parametrize("nR,nS", [(3_001, 4_999), (17_000, 9_500),
                                   (65_537, 40_000)])
@pytest.mark.parametrize("domain", [500, 100_000])
def test_mpass_property_sizes_dups(rng, nR, nS, domain):
    """Non-pow2 sizes × dup densities (domain 500 = heavy duplicate runs
    crossing block boundaries; 100_000 = mostly-unique)."""
    rk = rng.integers(1, domain + 1, nR).astype(np.int32)
    sk = rng.integers(1, domain + 1, nS).astype(np.int32)
    res = sortmergejoin_multipass(_rel(rk, rng), _rel(sk, rng))
    assert res.totalresults == MJ.merge_join_count_numpy(rk, sk)


def test_mpass_negative_keys(rng):
    """The fork's motivating bug (reference: src/run.log:531-551) on the
    m-pass path: negative keys through every pairwise merge level."""
    nR, nS = 20_000, 15_000
    rk = rng.integers(-(2**28), 2**28, nR).astype(np.int32)
    sk = rng.integers(-(2**28), 2**28, nS).astype(np.int32)
    res = sortmergejoin_multipass(_rel(rk, rng), _rel(sk, rng))
    assert res.totalresults == MJ.merge_join_count_numpy(rk, sk)


_SCALAR_FLAGS = [["--scalarsort"], ["--scalarmerge"],
                 ["--scalarsort", "--scalarmerge"]]


@pytest.mark.parametrize("flags", _SCALAR_FLAGS)
def test_mpass_scalar_flags(capsys, flags):
    """--scalarsort/--scalarmerge stay accepted for flag parity with the
    reference (main.c:727-728) and select nothing: every path is the
    plain sort and count, and it stays exact on nonunique keys."""
    from avx_sort_merge_joins_tpu import cli

    argv = ["-a", "m-pass", "-r", "9000", "-s", "11000", "--non-unique",
            "-x", "3", "-y", "4"]
    assert cli.main(argv + flags) == 0
    cap = capsys.readouterr()
    assert "has no effect" in cap.err
    R, S = cli.make_relations(cli.build_parser().parse_args(argv))
    want = MJ.merge_join_count_numpy(R.to_numpy()[0], S.to_numpy()[0])
    assert f"Results = {want}" in cap.out


@pytest.mark.parametrize("flags", _SCALAR_FLAGS)
def test_mpsm_scalar_flags(capsys, flags):
    """Same flag-parity contract for single-card mpsm with S chunks."""
    from avx_sort_merge_joins_tpu import cli

    argv = ["-a", "mpsm", "--nchunks", "3", "-r", "7000", "-s", "10001",
            "--non-unique", "-x", "5", "-y", "6"]
    assert cli.main(argv + flags) == 0
    cap = capsys.readouterr()
    assert "has no effect" in cap.err
    R, S = cli.make_relations(cli.build_parser().parse_args(argv))
    want = MJ.merge_join_count_numpy(R.to_numpy()[0], S.to_numpy()[0])
    assert f"Results = {want}" in cap.out
