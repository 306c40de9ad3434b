"""Materialization tests — the reference emits <S-key, S-RID> per match
(joincommon.c:272-284) and persists R.tbl/S.tbl/Out.tbl under
--enable-materialize/--enable-persist (generator.c:200-213)."""

import numpy as np
import jax.numpy as jnp

from avx_sort_merge_joins_tpu.ops import materialize as mat
from avx_sort_merge_joins_tpu.models.mway import sortmergejoin_multiway
from avx_sort_merge_joins_tpu.types import JoinConfig, Relation


def test_materialize_matches_oracle(rng):
    nR, nS = 5000, 8000
    rk = np.sort(rng.choice(20000, nR, replace=False).astype(np.int32))
    sk = np.sort(rng.integers(0, 20000, nS).astype(np.int32))
    sp = rng.integers(0, 10**6, nS).astype(np.int32)
    ok, op, om, nm = mat.materialize_matches(
        jnp.asarray(rk), nR, jnp.asarray(sk), jnp.asarray(sp), nS)
    nm = int(nm)
    mask = np.isin(sk, rk)
    np.testing.assert_array_equal(np.asarray(ok)[:nm], sk[mask])
    np.testing.assert_array_equal(np.asarray(op)[:nm], sp[mask])
    assert np.all(np.asarray(om)[:nm] == 1)  # pk R


def test_mway_materialize_join(rng):
    nR, nS = 20000, 30000
    rk = rng.permutation(np.arange(1, nR + 1)).astype(np.int32)
    sk = rng.integers(1, nR + 1, nS).astype(np.int32)
    sp = np.arange(5, 5 + nS, dtype=np.int32)
    R = Relation.from_numpy(rk, np.arange(nR, dtype=np.int32))
    S = Relation.from_numpy(sk, sp)
    res = sortmergejoin_multiway(R, S, JoinConfig(materialize=True))
    assert res.totalresults == nS  # fk S: every tuple matches
    out = res.resultlist[0].results
    gk, gp = out.to_numpy()
    order = np.lexsort((sp, sk))
    np.testing.assert_array_equal(gk, sk[order])
    np.testing.assert_array_equal(gp, sp[order])


def _expected_pairs(rk, sk, sp):
    """One output <S-key, S-payload> per match PAIR (dup-R expansion)."""
    ru, rc = np.unique(rk, return_counts=True)
    pos = np.searchsorted(ru, sk)
    pos = np.clip(pos, 0, len(ru) - 1)
    mult = np.where(ru[pos] == sk, rc[pos], 0)
    return np.repeat(sk, mult), np.repeat(sp, mult)


def test_expand_matches_dup_r(rng):
    """Physical dup-R expansion: one output tuple per match pair
    (joincommon.c:266-289 nested duplicate loops)."""
    nR, nS = 4000, 6000
    rk = rng.integers(0, 800, nR).astype(np.int32)   # heavy R duplication
    sk = rng.integers(0, 1000, nS).astype(np.int32)
    sp = rng.integers(0, 10**6, nS).astype(np.int32)
    R = Relation.from_numpy(rk)
    S = Relation.from_numpy(sk, sp)
    res = sortmergejoin_multiway(R, S, JoinConfig(materialize=True))
    ek, ep = _expected_pairs(rk, sk, sp)
    assert res.totalresults == len(ek)
    out = res.resultlist[0].results
    gk, gp = out.to_numpy()
    got = np.lexsort((gp, gk))
    exp = np.lexsort((ep, ek))
    np.testing.assert_array_equal(gk[got], ek[exp])
    np.testing.assert_array_equal(gp[got], ep[exp])


def test_dist_materialize_nonunique_r(rng):
    """--materialize -n 8 semantics: distributed payload-carrying exchange
    + physical dup-R expansion equals the numpy join output."""
    from avx_sort_merge_joins_tpu.parallel import dist_materialize

    nR, nS = 8000, 12000
    rk = rng.integers(0, 1500, nR).astype(np.int32)
    sk = rng.integers(0, 2000, nS).astype(np.int32)
    rp = np.arange(nR, dtype=np.int32)
    sp = rng.integers(0, 10**6, nS).astype(np.int32)
    ks, ps, cnt, ov = dist_materialize.dist_join_materialize(
        rk, rp, sk, sp, nR, nS)
    assert ov == 0
    ek, ep = _expected_pairs(rk, sk, sp)
    assert cnt == len(ek)
    got = np.lexsort((ps, ks))
    exp = np.lexsort((ep, ek))
    np.testing.assert_array_equal(ks[got], ek[exp])
    np.testing.assert_array_equal(ps[got], ep[exp])


def test_dist_materialize_engine_zipf_no_retry(rng):
    """zipf z=1 S + nonunique R through the distributed materialize
    pipeline (pair sort + equi-depth splitters + exchange), exact WITHOUT
    an overflow retry: the splitters balance the skew."""
    from avx_sort_merge_joins_tpu.datagen import (create_relation_zipf,
                                                  seed_generator)
    from avx_sort_merge_joins_tpu.parallel import dist_materialize

    nR, nS = 12000, 18000
    rk = rng.integers(1, 4000, nR).astype(np.int32)
    rp = np.arange(nR, dtype=np.int32)
    seed_generator(31)
    S = create_relation_zipf(nS, 4000, 1.0)
    sk, _ = S.to_numpy()
    sp = rng.integers(0, 10**6, nS).astype(np.int32)
    ks, ps, cnt, ov = dist_materialize.dist_join_materialize(
        rk, rp, sk, sp, nR, nS, out_slack=8.0)
    assert ov == 0
    assert dist_materialize.LAST_RETRIES == 0, "splitters should balance"
    ek, ep = _expected_pairs(rk, sk, sp)
    assert cnt == len(ek)
    got = np.lexsort((ps, ks))
    exp = np.lexsort((ep, ek))
    np.testing.assert_array_equal(ks[got], ek[exp])
    np.testing.assert_array_equal(ps[got], ep[exp])


def test_dist_materialize_streaming_persist(tmp_path, rng):
    """stream_to flushes per-chip chunks through the tbl appender; the
    streamed file must equal the gathered output multiset."""
    from avx_sort_merge_joins_tpu.parallel import dist_materialize

    nR, nS = 6000, 9000
    rk = rng.integers(0, 1200, nR).astype(np.int32)
    sk = rng.integers(0, 1500, nS).astype(np.int32)
    rp = np.arange(nR, dtype=np.int32)
    sp = rng.integers(0, 10**6, nS).astype(np.int32)
    out = tmp_path / "Out.tbl"
    k0, p0, cnt, ov = dist_materialize.dist_join_materialize(
        rk, rp, sk, sp, nR, nS)
    ks, ps, cnt2, ov2 = dist_materialize.dist_join_materialize(
        rk, rp, sk, sp, nR, nS, stream_to=str(out))
    assert ks is None and ps is None
    assert (cnt2, ov2) == (cnt, ov)
    rows = [ln.split() for ln in out.read_text().strip().splitlines()]
    assert len(rows) == cnt
    gk = np.asarray([int(k) for k, _ in rows], np.int32)
    gp = np.asarray([int(p) for _, p in rows], np.int32)
    np.testing.assert_array_equal(gk[np.lexsort((gp, gk))],
                                  k0[np.lexsort((p0, k0))])
    np.testing.assert_array_equal(gp[np.lexsort((gp, gk))],
                                  p0[np.lexsort((p0, k0))])


def test_dist_materialize_pk_fk(rng):
    from avx_sort_merge_joins_tpu.parallel import dist_materialize

    nR, nS = 10000, 15000
    rk = rng.permutation(np.arange(1, nR + 1)).astype(np.int32)
    sk = rng.integers(1, nR + 1, nS).astype(np.int32)
    rp = np.arange(nR, dtype=np.int32)
    sp = np.arange(7, 7 + nS, dtype=np.int32)
    ks, ps, cnt, ov = dist_materialize.dist_join_materialize(
        rk, rp, sk, sp, nR, nS)
    assert ov == 0
    assert cnt == nS
    order = np.lexsort((sp, sk))
    got = np.lexsort((ps, ks))
    np.testing.assert_array_equal(ks[got], sk[order])
    np.testing.assert_array_equal(ps[got], sp[order])


def test_expand_matches_reports_capacity_overflow():
    """A static output capacity below the match total is reported through
    ``total`` (callers size the output and retry), not silently cut."""
    ok = jnp.asarray([3, 5], jnp.int32)
    op = jnp.asarray([30, 50], jnp.int32)
    om = jnp.asarray([2, 3], jnp.int32)
    ek, ep, total = mat.expand_matches(ok, op, om, 2, 4)
    assert int(total) == 5
    assert np.asarray(ek).tolist() == [3, 3, 5, 5]
    assert np.asarray(ep).tolist() == [30, 30, 50, 50]


def test_materialize_no_matches(rng):
    """Disjoint key ranges: nothing matches, nothing is emitted."""
    R = Relation.from_numpy(np.arange(100, dtype=np.int32))
    S = Relation.from_numpy(np.arange(1000, 1100, dtype=np.int32))
    res = sortmergejoin_multiway(R, S, JoinConfig(materialize=True))
    assert res.totalresults == 0
    assert res.resultlist[0].results.num_tuples == 0
