"""2-D ('host','chip') mesh tests — the hierarchical topology tier
(reference: src/util/cpu_mapping.c:281-316 regions × threads-per-region;
numa_shuffle.c:80 region-strided RING).  The exchange runs in two stages:
all_to_all over the 'chip' axis within each host, then the 'host' tier —
validated bit-identical to the flat exchange and end-to-end exact through
the distributed joins on a 2×4 virtual CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import shard_map
from jax.sharding import PartitionSpec as P

from avx_sort_merge_joins_tpu.ops.mergejoin import merge_join_count_numpy
from avx_sort_merge_joins_tpu.parallel import dist_mpass, dist_mway, exchange
from avx_sort_merge_joins_tpu.parallel.mesh import (
    AXIS, HOST_AXIS, chips_per_host_of, flat_axes, flat_spec, host_shape,
    is_2d, make_mesh, make_mesh2d)
from avx_sort_merge_joins_tpu.types import NumaStrategy


def _workload(rng, nR, nS):
    rk = rng.permutation(np.arange(1, nR + 1)).astype(np.int32)
    sk = rng.integers(1, nR + 1, nS).astype(np.int32)
    return rk, sk


def test_mesh2d_shape_queries():
    mesh = make_mesh2d(2, 4)
    assert is_2d(mesh)
    assert host_shape(mesh) == (2, 4)
    assert chips_per_host_of(mesh) == 4  # derived from the axis, not a knob
    assert flat_axes(mesh) == (HOST_AXIS, AXIS)
    flat = make_mesh(8)
    assert not is_2d(flat)
    assert host_shape(flat) == (1, 8)


@pytest.mark.parametrize("hc", [(2, 4), (4, 2)])
def test_exchange_hier_matches_flat(rng, hc):
    """The two-stage hierarchical exchange must deliver the exact layout
    of the flat all_to_all (received run s at slots [s*cap, (s+1)*cap))."""
    H, C = hc
    n = H * C
    cap = 16
    data = rng.integers(-1000, 1000, (n, n * cap)).astype(np.int32)
    xd = jnp.asarray(data)

    mesh2 = make_mesh2d(H, C)
    fn2 = jax.jit(shard_map(
        lambda x: exchange.exchange_hier(
            x[0], cap, H, C, HOST_AXIS, AXIS)[None],
        mesh=mesh2, in_specs=flat_spec(mesh2), out_specs=flat_spec(mesh2)))
    got = np.asarray(fn2(xd))

    mesh1 = make_mesh(n)
    fn1 = jax.jit(shard_map(
        lambda x: jax.lax.all_to_all(x[0], AXIS, 0, 0, tiled=True)[None],
        mesh=mesh1, in_specs=P(AXIS), out_specs=P(AXIS)))
    exp = np.asarray(fn1(xd))
    np.testing.assert_array_equal(got, exp)


def test_exchange_hier_host_schedule(rng):
    """Permute-round host tier (RANDOM host schedule) delivers the same
    layout as the fused host all_to_all."""
    from avx_sort_merge_joins_tpu.parallel.mesh import shuffle_order

    H, C = 2, 4
    n = H * C
    cap = 8
    data = rng.integers(0, 100, (n, n * cap)).astype(np.int32)
    xd = jnp.asarray(data)
    mesh2 = make_mesh2d(H, C)
    sched = shuffle_order(NumaStrategy.RANDOM, H, 1).tolist()
    fn = jax.jit(shard_map(
        lambda x: exchange.exchange_hier(
            x[0], cap, H, C, HOST_AXIS, AXIS, host_schedule=sched)[None],
        mesh=mesh2, in_specs=flat_spec(mesh2), out_specs=flat_spec(mesh2)))
    got = np.asarray(fn(xd))
    fn0 = jax.jit(shard_map(
        lambda x: exchange.exchange_hier(
            x[0], cap, H, C, HOST_AXIS, AXIS)[None],
        mesh=mesh2, in_specs=flat_spec(mesh2), out_specs=flat_spec(mesh2)))
    exp = np.asarray(fn0(xd))
    np.testing.assert_array_equal(got, exp)


def test_dist_mway_2d_mesh_exact(rng):
    """End-to-end distributed m-way on a 2×4 mesh with the hierarchical
    exchange."""
    nR, nS = 40_000, 60_000
    rk, sk = _workload(rng, nR, nS)
    mesh = make_mesh2d(2, 4)
    cnt, ov = dist_mway.dist_mway_join_count(rk, sk, nR, nS, mesh=mesh)
    assert ov == 0
    assert cnt == merge_join_count_numpy(rk, sk)


def test_dist_mway_2d_mesh_schedule_and_skew(rng):
    """2-D mesh with a RANDOM host-tier schedule on a skewed nonunique
    workload (splitters + hierarchy together)."""
    nR, nS = 10007, 14013
    rk = rng.integers(1, 2000, nR).astype(np.int32)
    sk = rng.integers(1, 2000, nS).astype(np.int32)
    mesh = make_mesh2d(2, 4)
    cnt, ov = dist_mway.dist_mway_join_count(
        rk, sk, nR, nS, mesh=mesh, slack=3.0,
        numa_strategy=NumaStrategy.RANDOM)
    assert ov == 0
    assert cnt == merge_join_count_numpy(rk, sk)


def test_dist_mpass_2d_mesh_exact(rng):
    nR, nS = 30_000, 45_000
    rk, sk = _workload(rng, nR, nS)
    mesh = make_mesh2d(2, 4)
    cnt, ov = dist_mpass.dist_mpass_join_count(rk, sk, nR, nS, mesh=mesh)
    assert ov == 0
    assert cnt == merge_join_count_numpy(rk, sk)


def test_dist_materialize_2d_mesh_exact(rng):
    """The payload-carrying exchange through the two-stage 2-D form."""
    from avx_sort_merge_joins_tpu.parallel import dist_materialize

    nR, nS = 6000, 9000
    rk = rng.integers(0, 1500, nR).astype(np.int32)
    sk = rng.integers(0, 2000, nS).astype(np.int32)
    ks, _, cnt, ov = dist_materialize.dist_join_materialize(
        rk, np.arange(nR, dtype=np.int32), sk, np.arange(nS, dtype=np.int32),
        nR, nS, mesh=make_mesh2d(2, 4))
    assert ov == 0
    assert cnt == len(ks) == merge_join_count_numpy(rk, sk)
