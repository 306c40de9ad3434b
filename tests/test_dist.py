"""Distributed join tests on the simulated 8-device CPU mesh — the
multi-card realization of the reference's cross-NUMA exchange
(threadrelchunks all-to-all, sortmergejoin_multiway.c:504-518)."""

import numpy as np
import pytest

from avx_sort_merge_joins_tpu.ops.mergejoin import merge_join_count_numpy
from avx_sort_merge_joins_tpu.parallel import dist_join, dist_mway
from avx_sort_merge_joins_tpu.parallel.mesh import make_mesh, shuffle_order
from avx_sort_merge_joins_tpu.types import NumaStrategy


def _workload(rng, nR, nS):
    rk = rng.permutation(np.arange(1, nR + 1)).astype(np.int32)
    sk = rng.integers(1, nR + 1, nS).astype(np.int32)
    return rk, sk


def test_dist_join_count(rng):
    nR, nS = 5000, 9000
    rk, sk = _workload(rng, nR, nS)
    rp = np.arange(nR, dtype=np.int32)
    sp = np.arange(nS, dtype=np.int32)
    cnt, ov = dist_join.dist_join_count(rk, rp, sk, sp, nR, nS)
    assert ov == 0
    assert cnt == merge_join_count_numpy(rk, sk)


def test_dist_mway_join_count(rng):
    nR, nS = 20000, 30000
    rk, sk = _workload(rng, nR, nS)
    cnt, ov = dist_mway.dist_mway_join_count(rk, sk, nR, nS)
    assert ov == 0
    assert cnt == merge_join_count_numpy(rk, sk)


def test_dist_mway_nonuniform_sizes(rng):
    """Ragged final shard + nonunique keys."""
    nR, nS = 10007, 14013
    rk = rng.integers(1, 3000, nR).astype(np.int32)
    sk = rng.integers(1, 3000, nS).astype(np.int32)
    cnt, ov = dist_mway.dist_mway_join_count(rk, sk, nR, nS, slack=3.0)
    assert ov == 0
    assert cnt == merge_join_count_numpy(rk, sk)


def test_shuffle_orders():
    for strat in (NumaStrategy.NEXT, NumaStrategy.RING, NumaStrategy.RANDOM):
        order = shuffle_order(strat, 8)
        assert sorted(order.tolist()) == list(range(8)), strat
    assert shuffle_order(NumaStrategy.NEXT, 8).tolist() == list(range(8))


@pytest.mark.parametrize("z,slack", [(0.75, 3.0), (1.0, 4.0)])
def test_dist_mway_zipf_skew(z, slack):
    """Skew-aware equi-depth splitters under Zipf foreign keys — the
    BASELINE mpsm/dist skew configs (genzipf z=0.75/1.0)."""
    from avx_sort_merge_joins_tpu.datagen import (create_relation_pk,
                                                  create_relation_zipf,
                                                  seed_generator)

    nR, nS = 20_000, 30_000
    seed_generator(42)
    R = create_relation_pk(nR)
    seed_generator(43)
    S = create_relation_zipf(nS, nR, z)
    rk, _ = R.to_numpy()
    sk, _ = S.to_numpy()
    cnt, ov = dist_mway.dist_mway_join_count(rk, sk, nR, nS, slack=slack)
    assert ov == 0
    assert cnt == merge_join_count_numpy(rk, sk)


@pytest.mark.parametrize("strategy", ["NEXT", "RING", "RANDOM"])
def test_dist_mway_permute_schedules(rng, strategy):
    """collective_permute-round exchange under each shuffle order
    (numa_shuffle.c:55-85 -> exchange schedules)."""
    nR, nS = 10_000, 15_000
    rk = rng.permutation(np.arange(1, nR + 1)).astype(np.int32)
    sk = rng.integers(1, nR + 1, nS).astype(np.int32)
    cnt, ov = dist_mway.dist_mway_join_count(
        rk, sk, nR, nS, numa_strategy=strategy)
    assert ov == 0
    assert cnt == merge_join_count_numpy(rk, sk)


def test_dist_mpsm_vs_oracle(rng):
    """Distributed MPSM: R range-exchanged, S rung around the mesh —
    counts must be exact (the paper's no-S-repartition structure)."""
    from avx_sort_merge_joins_tpu.parallel import dist_mpsm

    nR, nS = 12_000, 18_000
    rk = rng.integers(1, 4_000, nR).astype(np.int32)
    sk = rng.integers(1, 4_000, nS).astype(np.int32)
    cnt, ov = dist_mpsm.dist_mpsm_join_count(rk, sk, nR, nS, slack=3.0)
    assert ov == 0
    assert cnt == merge_join_count_numpy(rk, sk)


def test_dist_mpsm_zipf(rng):
    from avx_sort_merge_joins_tpu.datagen import (create_relation_pk,
                                                  create_relation_zipf,
                                                  seed_generator)
    from avx_sort_merge_joins_tpu.parallel import dist_mpsm

    nR, nS = 12_000, 18_000
    seed_generator(42)
    R = create_relation_pk(nR)
    seed_generator(43)
    S = create_relation_zipf(nS, nR, 1.0)
    rk, _ = R.to_numpy()
    sk, _ = S.to_numpy()
    cnt, ov = dist_mpsm.dist_mpsm_join_count(rk, sk, nR, nS, slack=4.0)
    assert ov == 0
    assert cnt == merge_join_count_numpy(rk, sk)


def test_dist_mpass_vs_oracle(rng):
    """Distributed m-pass: exchange + log-halving pairwise merge passes
    (sortmergejoin_multipass.c:410-708 analog)."""
    from avx_sort_merge_joins_tpu.parallel import dist_mpass

    nR, nS = 20000, 30000
    rk, sk = _workload(rng, nR, nS)
    cnt, ov = dist_mpass.dist_mpass_join_count(rk, sk, nR, nS)
    assert ov == 0
    assert cnt == merge_join_count_numpy(rk, sk)


def test_dist_mpass_ragged_nonunique(rng):
    from avx_sort_merge_joins_tpu.parallel import dist_mpass

    nR, nS = 10007, 14013
    rk = rng.integers(1, 3000, nR).astype(np.int32)
    sk = rng.integers(1, 3000, nS).astype(np.int32)
    cnt, ov = dist_mpass.dist_mpass_join_count(rk, sk, nR, nS, slack=3.0)
    assert ov == 0
    assert cnt == merge_join_count_numpy(rk, sk)


def test_dist_mpass_zipf(rng):
    from avx_sort_merge_joins_tpu.datagen import (create_relation_pk,
                                                  create_relation_zipf,
                                                  seed_generator)
    from avx_sort_merge_joins_tpu.parallel import dist_mpass

    nR, nS = 20_000, 30_000
    seed_generator(42)
    R = create_relation_pk(nR)
    seed_generator(43)
    S = create_relation_zipf(nS, nR, 1.0)
    rk, _ = R.to_numpy()
    sk, _ = S.to_numpy()
    cnt, ov = dist_mpass.dist_mpass_join_count(rk, sk, nR, nS, slack=4.0)
    assert ov == 0
    assert cnt == merge_join_count_numpy(rk, sk)


def test_dist_join_full_range_span(rng):
    """Key domain spanning >= 2^31 (negative + positive keys): the uint32
    range-partition arithmetic must not wrap (int32 subtraction would
    funnel every tuple into the last bucket)."""
    nR, nS = 6000, 6000
    rk = rng.integers(-(2**31) + 2, 2**31 - 2, nR,
                      dtype=np.int64).astype(np.int32)
    sk = np.concatenate([rk[: nS // 2],
                         rng.integers(-(2**31) + 2, 2**31 - 2, nS - nS // 2,
                                      dtype=np.int64).astype(np.int32)])
    rp = np.arange(nR, dtype=np.int32)
    sp = np.arange(nS, dtype=np.int32)
    cnt, ov = dist_join.dist_join_count(rk, rp, sk, sp, nR, nS)
    assert ov == 0
    assert cnt == merge_join_count_numpy(rk, sk)


def test_dist_tiny_relation_wide_mesh(rng):
    """n < shard*(n_chips-1): per-chip valid counts must clip to zero so
    pad-vs-pad sentinel matches never inflate the count."""
    nR, nS = 5, 2000  # R occupies only the first chip's shard
    rk = rng.permutation(np.arange(1, nR + 1)).astype(np.int32)
    sk = rng.integers(1, nR + 1, nS).astype(np.int32)
    cnt, ov = dist_mway.dist_mway_join_count(rk, sk, nR, nS)
    assert ov == 0
    assert cnt == merge_join_count_numpy(rk, sk)


def test_dist_mway_heavy_hitter(rng):
    """90%-duplicate foreign keys (harder than zipf z=1): equi-depth
    splitters + per-source buckets + overflow auto-retry keep counts exact."""
    nR, nS = 20_000, 20_000
    rk = rng.permutation(np.arange(1, nR + 1)).astype(np.int32)
    sk = np.where(rng.random(nS) < 0.9, 7,
                  rng.integers(1, nR + 1, nS)).astype(np.int32)
    cnt, ov = dist_mway.dist_mway_join_count(rk, sk, nR, nS)
    assert ov == 0
    assert cnt == merge_join_count_numpy(rk, sk)


def test_workload_a_scale_tier_scaled_down():
    """The 1.6B workload-A code path (sharded on-device generation ->
    pre-sharded dist m-way) at a mesh-friendly scaled size: count == |S|
    with no host-side relation ever materialized."""
    from avx_sort_merge_joins_tpu.parallel import scale

    nR = nS = 1 << 20
    cnt, ov = scale.workload_a_join_count(nR, nS)
    assert ov == 0
    assert cnt == nS


def test_workload_a_sharded_generation_unique():
    """Strided per-chip key sets partition 1..n exactly."""
    import numpy as np

    from avx_sort_merge_joins_tpu.parallel import scale
    from avx_sort_merge_joins_tpu.parallel.mesh import make_mesh

    n = 1 << 16
    mesh = make_mesh()
    rk, sk = scale.make_workload_a_sharded(n, n, mesh)
    keys = np.asarray(rk).reshape(-1)
    assert sorted(keys.tolist()) == list(range(1, n + 1))
    s = np.asarray(sk).reshape(-1)
    assert s.min() >= 1 and s.max() <= n


def test_mesh_topology_ring():
    """Host-granularity plumbing: the mapping file's trailing host count
    (the cpu-mapping.txt #numa annotation analog) reaches the RING
    schedule's stride."""
    import tempfile

    from avx_sort_merge_joins_tpu.parallel.mesh import (
        chips_per_host_of, make_mesh, mesh_from_mapping_file)

    from avx_sort_merge_joins_tpu.parallel import mesh as mesh_mod

    with tempfile.NamedTemporaryFile("w", suffix=".txt", delete=False) as f:
        f.write("8 0 1 2 3 4 5 6 7 2\n")  # 8 devices over 2 hosts
        path = f.name
    old_gran = mesh_mod.HOST_GRANULARITY
    try:
        mesh = mesh_from_mapping_file(path)
        assert chips_per_host_of(mesh) == 4
        order = shuffle_order(NumaStrategy.RING, 8, chips_per_host_of(mesh))
        assert sorted(order.tolist()) == list(range(8))
        assert order[0] % 4 == 0  # first hop leaves the local host group
    finally:
        mesh_mod.HOST_GRANULARITY = old_gran
    # untagged mesh infers from the platform's process mapping
    assert chips_per_host_of(make_mesh(4)) >= 1


@pytest.mark.parametrize("ndev", [3, 6])
def test_dist_nonpow2_mesh(rng, ndev):
    """Non-power-of-two chip counts: run-count padding with zero-length
    runs must keep every dist algorithm exact (the reference requires
    pow2 threads for m-way, sortmergejoin_multiway.c:53-57 — we don't)."""
    from avx_sort_merge_joins_tpu.parallel import dist_mpass, dist_mpsm

    nR, nS = 12000, 18000
    rk = rng.permutation(np.arange(1, nR + 1)).astype(np.int32)
    sk = rng.integers(1, nR + 1, nS).astype(np.int32)
    exp = merge_join_count_numpy(rk, sk)
    mesh = make_mesh(ndev)
    for fn in (dist_mway.dist_mway_join_count,
               dist_mpass.dist_mpass_join_count,
               dist_mpsm.dist_mpsm_join_count):
        cnt, ov = fn(rk, sk, nR, nS, mesh)
        assert ov == 0 and cnt == exp, fn.__name__


def test_dist_mway_phased(rng):
    """Phase-split distributed m-way: same exact count, real per-phase
    timings for the record row (joincommon.c:175-196 columns)."""
    nR, nS = 20000, 30000
    rk, sk = _workload(rng, nR, nS)
    cnt, ov, phases = dist_mway.dist_mway_join_phased(rk, sk, nR, nS)
    assert ov == 0
    assert cnt == merge_join_count_numpy(rk, sk)
    assert set(phases) == {"sort", "merge1", "mergejoin", "total"}
    assert all(v >= 0 for v in phases.values())


def test_workload_a_skewed():
    """BASELINE config 5's skewed variant: Zipf-shaped fk sampled on
    device through the streamed quantile LUT; count stays exactly |S|
    (every fk matches one unique R key) and the skew is real."""
    from avx_sort_merge_joins_tpu.parallel import scale

    nR = nS = 1 << 20
    cnt, ov = scale.workload_a_join_count(nR, nS,
                                          skew=1.0, slack=4.0)
    assert ov == 0
    assert cnt == nS
    # the sampled S really is skewed: key 1 carries ~1/H(n) of the mass
    mesh_ = make_mesh()
    _, sk = scale.make_workload_a_sharded(nR, nS, mesh_, skew=1.0)
    top = (np.asarray(sk).reshape(-1) == 1).mean()
    assert top > 0.01  # uniform would be ~1e-6


def test_dist_join_count_wrap_detection(capsys):
    """A per-card match count past 2^31 (heavy-hitter key: 50K x 50K dups
    = 2.5e9 matches on one card) comes back exact from the device's int64
    count, with no host recount."""
    from avx_sort_merge_joins_tpu.parallel import dist_join

    n = 50_000
    rk = np.full(n, 7, np.int32)
    sk = np.full(n, 7, np.int32)
    # slack covers the single-destination pile-up (one key range owns
    # ALL tuples), isolating the count from bucket overflow
    cnt, ov = dist_join.dist_join_count(
        rk, np.arange(n, dtype=np.int32), sk, np.arange(n, dtype=np.int32),
        n, n, slack=80.0)
    assert ov == 0
    assert cnt == n * n  # 2.5e9 > 2^31: wrapped int32 would be wrong
    assert "wide path" not in capsys.readouterr().err


def test_dist_flat_only_guards(rng):
    """dist_join / dist_mpsm address only the chip axis: a 2-D mesh must
    be rejected loudly, not misroute buckets."""
    import pytest

    from avx_sort_merge_joins_tpu.parallel import dist_join, dist_mpsm
    from avx_sort_merge_joins_tpu.parallel.mesh import make_mesh2d

    nR, nS = 8192, 8192
    rk, sk = _workload(rng, nR, nS)
    mesh2 = make_mesh2d(2, 4)
    with pytest.raises(ValueError, match="flat mesh"):
        dist_join.dist_join_count(rk, rk, sk, sk, nR, nS, mesh=mesh2)
    with pytest.raises(ValueError, match="flat mesh"):
        dist_mpsm.dist_mpsm_join_count(rk, sk, nR, nS, mesh=mesh2)

def _count_dist_join(rk, sk, nR, nS, mesh):
    return dist_join.dist_join_count(rk, np.arange(nR, dtype=np.int32), sk,
                                     np.arange(nS, dtype=np.int32), nR, nS,
                                     mesh)


def _count_phased(rk, sk, nR, nS, mesh):
    cnt, ov, _ = dist_mway.dist_mway_join_phased(rk, sk, nR, nS, mesh)
    return cnt, ov


def _count_mpass(rk, sk, nR, nS, mesh):
    from avx_sort_merge_joins_tpu.parallel import dist_mpass
    return dist_mpass.dist_mpass_join_count(rk, sk, nR, nS, mesh)


def _count_mpsm(rk, sk, nR, nS, mesh):
    from avx_sort_merge_joins_tpu.parallel import dist_mpsm
    return dist_mpsm.dist_mpsm_join_count(rk, sk, nR, nS, mesh)


def _count_materialize(rk, sk, nR, nS, mesh):
    from avx_sort_merge_joins_tpu.parallel import dist_materialize
    ks, _, cnt, ov = dist_materialize.dist_join_materialize(
        rk, np.arange(nR, dtype=np.int32), sk,
        np.arange(nS, dtype=np.int32), nR, nS, mesh)
    assert len(ks) == cnt
    return cnt, ov


_DIST = {"dist_join": _count_dist_join,
         "mway": dist_mway.dist_mway_join_count,
         "mway_phased": _count_phased,
         "mpass": _count_mpass,
         "mpsm": _count_mpsm,
         "materialize": _count_materialize}


@pytest.mark.parametrize("ndev", [1, 2, 4, 8])
@pytest.mark.parametrize("algo", list(_DIST))
def test_dist_mesh_sizes(rng, algo, ndev):
    """Every distributed algorithm on 1/2/4/8-device meshes, nonunique
    keys with a ragged final shard, exact against numpy."""
    nR, nS = 6007, 9011
    rk = rng.integers(1, 2000, nR).astype(np.int32)
    sk = rng.integers(1, 2000, nS).astype(np.int32)
    cnt, ov = _DIST[algo](rk, sk, nR, nS, make_mesh(ndev))
    assert ov == 0
    assert cnt == merge_join_count_numpy(rk, sk)


@pytest.mark.parametrize("algo", ["mway", "mway_phased", "mpsm"])
def test_dist_past_2_31(algo):
    """A hot key on both sides past 2^31 matches comes back exact from
    every distributed count (int64 per-card counts)."""
    n = 50_000
    rk = np.full(n, 7, np.int32)
    sk = np.full(n, 7, np.int32)
    cnt, ov = _DIST[algo](rk, sk, n, n, make_mesh(4))
    assert ov == 0
    assert cnt == n * n
