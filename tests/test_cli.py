"""CLI driver tests — flag surface and output conventions of the
sortmergejoins binary (reference: src/main.c:605-607 prints Results = N;
stats go to stderr so scripts can split streams)."""

import numpy as np
import pytest

from avx_sort_merge_joins_tpu.cli import build_parser, main
from avx_sort_merge_joins_tpu.models.mpsm import sortmergejoin_mpsm
from avx_sort_merge_joins_tpu.ops.mergejoin import merge_join_count_numpy
from avx_sort_merge_joins_tpu.types import Relation


def test_parser_defaults():
    args = build_parser().parse_args([])
    assert args.algo == "m-way"
    assert args.r_size == 128_000_000 and args.s_size == 128_000_000
    assert args.partfanout == 16 and args.numastrategy == "NEXT"


@pytest.mark.parametrize("algo", ["m-way", "m-pass"])
def test_cli_join_results(capsys, algo):
    rc = main(["-a", algo, "-r", "30000", "-s", "30000",
               "-x", "42", "-y", "43"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Results = 30000" in out


def test_cli_record_and_roofline_rows(capsys):
    """Every run must emit the reference scripts' record row
    (tput-scalability.sh:28: ALGO NTHREADS NUMR NUMS RUNNO PARTCYC SORTCYC
    MERGE1CYC MERGERESTCYC MJOINCYC NUMTUP USECS TPUT — usecs standing in
    for cycles); the grid scripts grep this row, so its structure is
    pinned here.  No roofline rows: a peak rate belongs to the benchmark's
    per-device table, not to the CLI."""
    rc = main(["-a", "m-way", "-r", "20000", "-s", "20000",
               "-x", "42", "-y", "43"])
    assert rc == 0
    err = capsys.readouterr().err
    rec = [ln for ln in err.splitlines() if ln.startswith("[RECORD]")]
    assert len(rec) == 1
    cols = rec[0].split()
    # [RECORD] ALGO NTHREADS NUMR NUMS RUNNO 5xPHASE NUMTUP USECS TPUT
    assert len(cols) == 14
    assert cols[0] == "[RECORD]" and cols[1] == "m-way"
    assert int(cols[2]) == 1
    assert int(cols[3]) == 20000 and int(cols[4]) == 20000
    nums = [float(c) for c in cols[5:]]  # every later column is numeric
    assert int(cols[11]) == 40000       # NUMTUP
    assert nums[-2] > 0                 # USECS
    assert nums[-1] > 0                 # TPUT
    assert nums[2] > 0 and nums[5] > 0  # SORT and MJOIN columns timed
    assert nums[1] == nums[3] == nums[4] == 0  # no separate part/merge
    assert not [ln for ln in err.splitlines()
                if ln.startswith("[ROOFLINE]")]


def test_cli_nonunique(capsys):
    rc = main(["-a", "m-way", "-r", "20000", "-s", "20000", "--non-unique",
               "-x", "7", "-y", "8"])
    assert rc == 0
    n = int(capsys.readouterr().out.split("Results = ")[1].split()[0])
    assert n > 0  # oracle-checked in test_joins/test_mway; here: plumbing


def test_mpsm_vs_oracle(rng):
    nR, nS = 30_000, 45_000
    rk = rng.permutation(np.arange(1, nR + 1)).astype(np.int32)
    sk = rng.integers(1, nR + 1, nS).astype(np.int32)
    R = Relation.from_numpy(rk, np.arange(nR, dtype=np.int32))
    S = Relation.from_numpy(sk, np.arange(nS, dtype=np.int32))
    res = sortmergejoin_mpsm(R, S, nchunks=3)
    assert res.totalresults == merge_join_count_numpy(rk, sk)


def test_cli_materialize_persist(tmp_path, capsys):
    """--materialize + --persist write R.tbl/S.tbl/Out.tbl (the reference's
    --enable-materialize/--enable-persist flow, main.c:609-614)."""
    rc = main(["-a", "m-way", "-r", "8000", "-s", "12000",
               "--materialize", "--persist", str(tmp_path),
               "-x", "5", "-y", "6"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Results = 12000" in out
    for name, rows in [("R.tbl", 8000), ("S.tbl", 12000),
                       ("Out.tbl", 12000)]:
        lines = (tmp_path / name).read_text().strip().splitlines()
        assert len(lines) == rows, name
        k, p = lines[0].split()
        int(k), int(p)


def test_cli_dist_materialize_persist(tmp_path, capsys):
    """--materialize -n 8 --persist: the distributed payload-carrying
    exchange writes an Out.tbl equal to the numpy join output on a
    nonunique-R workload."""
    rc = main(["-a", "m-way", "-n", "8", "-r", "6000", "-s", "9000",
               "--non-unique", "--materialize", "--persist", str(tmp_path),
               "-x", "11", "-y", "12"])
    assert rc == 0
    out = capsys.readouterr().out
    results = int(out.split("Results = ")[1].split()[0])
    rows = [ln.split() for ln in
            (tmp_path / "Out.tbl").read_text().strip().splitlines()]
    assert len(rows) == results
    # oracle: rebuild the same workload and compare the output multiset
    r_rows = [ln.split() for ln in
              (tmp_path / "R.tbl").read_text().strip().splitlines()]
    s_rows = [ln.split() for ln in
              (tmp_path / "S.tbl").read_text().strip().splitlines()]
    rk = np.asarray([int(k) for k, _ in r_rows], np.int32)
    sk = np.asarray([int(k) for k, _ in s_rows], np.int32)
    sp = np.asarray([int(p) for _, p in s_rows], np.int32)
    ru, rc_ = np.unique(rk, return_counts=True)
    pos = np.clip(np.searchsorted(ru, sk), 0, len(ru) - 1)
    mult = np.where(ru[pos] == sk, rc_[pos], 0)
    ek, ep = np.repeat(sk, mult), np.repeat(sp, mult)
    gk = np.asarray([int(k) for k, _ in rows], np.int32)
    gp = np.asarray([int(p) for _, p in rows], np.int32)
    assert results == len(ek)
    np.testing.assert_array_equal(gk[np.lexsort((gp, gk))],
                                  ek[np.lexsort((ep, ek))])
    np.testing.assert_array_equal(gp[np.lexsort((gp, gk))],
                                  ep[np.lexsort((ep, ek))])


@pytest.mark.parametrize("z", [0.75, 1.0])
def test_mpsm_zipf_skew(z):
    """BASELINE config 4: mpsm under Zipf z=0.75/1.0 foreign keys."""
    from avx_sort_merge_joins_tpu.datagen import (create_relation_pk,
                                                  create_relation_zipf,
                                                  seed_generator)

    nR, nS = 20_000, 30_000
    seed_generator(42)
    R = create_relation_pk(nR)
    seed_generator(43)
    S = create_relation_zipf(nS, nR, z)
    res = sortmergejoin_mpsm(R, S, nchunks=4)
    rk, _ = R.to_numpy()
    sk, _ = S.to_numpy()
    assert res.totalresults == merge_join_count_numpy(rk, sk)


def test_workload_a_runbook_entry(capsys, monkeypatch):
    """The scripts/workload-a.sh entry (BASELINE config #5's one-command
    runbook), scaled down to CI size: the SAME CLI path the literal
    1.6B⋈1.6B 8-chip command takes — scale-tier auto-route, sharded
    on-device generation, pre-sharded dist m-way, Results == |S|, a
    [RECORD] row.  (tput-scalability.sh:15-16 analog.)"""
    from avx_sort_merge_joins_tpu import cli

    monkeypatch.setenv("SMJ_SHARDED_GEN_MIN", "1000000")
    n = 4_000_000
    rc = cli.main(["-a", "m-way", "-n", "8", "-r", str(n), "-s", str(n)])
    cap = capsys.readouterr()
    assert rc == 0
    assert f"Results = {n}" in cap.out
    assert "[RECORD] m-way 8" in cap.err
    assert "scale tier" in cap.err


def test_workload_a_runbook_entry_fused(capsys, monkeypatch):
    """SMJ_SCALE_PHASED=0 routes the scale tier through the fused
    single-dispatch pipeline (no per-phase sync points): same Results,
    [RECORD] phase columns zero, total column real."""
    from avx_sort_merge_joins_tpu import cli

    monkeypatch.setenv("SMJ_SHARDED_GEN_MIN", "1000000")
    monkeypatch.setenv("SMJ_SCALE_PHASED", "0")
    n = 2_000_000
    rc = cli.main(["-a", "m-way", "-n", "8", "-r", str(n), "-s", str(n)])
    cap = capsys.readouterr()
    assert rc == 0
    assert f"Results = {n}" in cap.out
    rec = [l for l in cap.err.splitlines() if l.startswith("[RECORD]")]
    assert len(rec) == 1
    cols = rec[0].split()
    # [RECORD] algo nthreads nR nS run SORT MERGE1 ... total tput
    assert cols[1:5] == ["m-way", "8", str(n), str(n)]
    assert float(cols[-2]) > 0  # total usecs is wall clock, not zero


@pytest.mark.parametrize("flag", [["-m", "1048576"], ["-f", "64"]])
def test_cli_no_effect_flags(capsys, flag):
    """The reference's merge-buffer and fan-out flags stay accepted for
    flag parity and say that they select nothing."""
    rc = main(["-a", "m-way", "-r", "5000", "-s", "5000", "-x", "1",
               "-y", "2"] + flag)
    cap = capsys.readouterr()
    assert rc == 0 and "Results = 5000" in cap.out
    assert f"{flag[0]} has no effect" in cap.err


def test_cli_partfanout_must_be_pow2():
    with pytest.raises(SystemExit):
        main(["-r", "100", "-s", "100", "-f", "6"])
