"""Exchange building blocks of the distributed joins: bucket slicing of
sorted runs, destination grouping, and the padding/capacity rules every
dist pipeline shares (the threadrelchunks analog, reference:
src/joins/joincommon.h:129)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from avx_sort_merge_joins_tpu.models.common import chunk_bounds
from avx_sort_merge_joins_tpu.parallel import exchange as ex
from avx_sort_merge_joins_tpu.parallel.dist_mway import _slice_buckets
from avx_sort_merge_joins_tpu.types import KEY_SENTINEL


@pytest.mark.parametrize("n_valid", [0, 1, 700, 1000])
def test_slice_buckets_matches_numpy(rng, n_valid):
    """Bucket d holds exactly the live keys in [bounds[d], bounds[d+1]),
    its payloads ride along, and the rest of its slots are padding."""
    n, n_dest, cap = 1000, 4, 1024
    ks = np.sort(rng.integers(-100, 100, n)).astype(np.int32)
    ks[n_valid:] = KEY_SENTINEL
    vs = rng.integers(0, 10**6, n).astype(np.int32)
    cuts = [-(2**31) + 1, -50, 0, 50]
    bk, bv, counts, ov = jax.jit(
        lambda k, v, nv: _slice_buckets(k, nv, [jnp.int32(c) for c in cuts],
                                        n_dest, cap, vs=v))(
        jnp.asarray(ks), jnp.asarray(vs), jnp.int32(n_valid))
    bk, bv = np.asarray(bk).reshape(n_dest, cap), np.asarray(bv).reshape(
        n_dest, cap)
    live_k, live_v = ks[:n_valid], vs[:n_valid]
    edges = cuts + [2**31 - 1]
    assert int(ov) == 0
    for d in range(n_dest):
        sel = (live_k >= edges[d]) & (live_k < edges[d + 1])
        c = int(counts[d])
        assert c == sel.sum()
        np.testing.assert_array_equal(bk[d, :c], live_k[sel])
        np.testing.assert_array_equal(bv[d, :c], live_v[sel])
        assert (bk[d, c:] == KEY_SENTINEL).all()


def test_slice_buckets_overflow_counted(rng):
    """More keys for one destination than its capacity: the excess is
    counted (the callers retry with more slack), never silently lost."""
    ks = jnp.asarray(np.zeros(300, np.int32))
    _, _, counts, ov = _slice_buckets(ks, jnp.int32(300),
                                      [jnp.int32(-(2**31) + 1),
                                       jnp.int32(10)], 2, 128)
    assert int(ov) == 300 - 128
    assert np.asarray(counts).tolist() == [128, 0]


def test_bucketize_by_groups_rows(rng):
    """Partition-first grouping: every live (key, payload) row lands in its
    destination's bucket, pads elsewhere."""
    n, n_dest, cap = 2000, 4, 1024
    keys = rng.integers(0, 400, n).astype(np.int32)
    pay = np.arange(n, dtype=np.int32)
    dest = ex.dest_of_keys(jnp.asarray(keys), n_dest, jnp.int32(0),
                           jnp.int32(399))
    bk, bp, counts, ov = ex.bucketize_by(dest, jnp.asarray(keys),
                                         jnp.asarray(pay), jnp.int32(1500),
                                         n_dest, cap, ex.R_PAD_KEY)
    bk, bp = np.asarray(bk).reshape(n_dest, cap), np.asarray(bp).reshape(
        n_dest, cap)
    d_np = np.asarray(dest)[:1500]
    assert int(ov) == 0
    for d in range(n_dest):
        c = int(counts[d])
        got = sorted(zip(bk[d, :c].tolist(), bp[d, :c].tolist()))
        want = sorted(zip(keys[:1500][d_np == d].tolist(),
                          pay[:1500][d_np == d].tolist()))
        assert got == want
        assert (bk[d, c:] == ex.R_PAD_KEY).all()


def test_valid_counts_clip():
    """Tiny relations on wide meshes: trailing shards hold no live rows."""
    assert ex.valid_counts(5, 3, 4).tolist() == [3, 2, 0, 0]
    assert ex.valid_counts(12, 3, 4).tolist() == [3, 3, 3, 3]


def test_bucket_cap_and_pad_column():
    assert ex.bucket_cap(1000, 4, 2.0, 128) == 512
    assert ex.bucket_cap(10, 4, 2.0, 128) == 128
    col = np.asarray(ex.pad_column(np.arange(3), 6, KEY_SENTINEL))
    assert col.tolist() == [0, 1, 2] + [int(KEY_SENTINEL)] * 3


@pytest.mark.parametrize("nS,nchunks,want", [
    (10, 1, [(0, 10)]), (10, 3, [(0, 4), (4, 8), (8, 10)]),
    (2, 5, [(0, 1), (1, 2)]), (0, 4, [])])
def test_chunk_bounds(nS, nchunks, want):
    """mpsm's S runs cover S exactly once, never with an empty run."""
    assert chunk_bounds(nS, nchunks) == want
