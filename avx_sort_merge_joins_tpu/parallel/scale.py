"""Workload-A scale tier: 1.6B ⋈ 1.6B without any full-size array.

The reference's headline scaling workload is R = S = 1.6·10⁹ tuples
(reference: scripts/tput-scalability.sh:15-16, README:234-244).  Four
int32 columns of 1.6B are ~26 GB, which the host would have to build and
copy card by card, so this tier:

  * generates each card's shard ON ITS OWN DEVICE inside shard_map
    (nothing global ever exists; the host only sees scalars),
  * feeds the distributed m-way join through its ``pre_sharded`` input
    path (parallel.dist_mway), so peak per-card footprint is a few
    shard-sized buffers (~n/n_chips × 4 B each).

Workload semantics vs the reference (main.c:534-588): R must be the
unique keys 1..|R| and S a uniform foreign key over them.  The reference
materializes R via a globally synchronized parallel Knuth shuffle
(generator.c:125-178); a global shuffle of 1.6B over chips would itself
be an all_to_all of the entire relation, so this tier assigns chip i the
STRIDED key set {i+1, i+1+P, i+1+2P, ...} (P = n_chips) — globally
unique and exactly as range-uniform per chip as a shuffle, so the
exchange volume and splitter behavior match the shuffled workload.
|R| and |S| must divide by n_chips (1.6B % 8 == 0).

int32 audit for 1.6B: element indices < 2^31 ✓, per-card positions ≤
shard ✓, counts are summed in int64 ✓.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from .mesh import AXIS, make_mesh


ZIPF_QUANTILE_BINS = 1 << 20


def _zipf_quantile_lut(n: int, z: float, bins: int = ZIPF_QUANTILE_BINS
                       ) -> np.ndarray:
    """Host-side quantile table of the Zipf(z) CDF over alphabet 1..n.

    Entry q holds the smallest key whose cumulative probability reaches
    (q+1)/bins.  Built by streaming the harmonic partial sums in chunks —
    O(n) flops, O(bins) memory — so it scales to 1.6B alphabets where the
    reference's full per-key LUT (genzipf.c:60-92) could not exist on a
    card.  Heavy keys span many bins and are therefore sampled with their
    exact mass; tail keys share bins (sub-bin mass is approximated by the
    bin boundary key), which preserves the Zipf shape for skew studies.
    """
    lut = np.empty(bins, np.int64)
    total = 0.0
    # two passes: normalization constant, then boundaries
    chunk = 1 << 24
    for lo in range(1, n + 1, chunk):
        hi = min(n + 1, lo + chunk)
        total += np.sum(1.0 / np.arange(lo, hi, dtype=np.float64) ** z)
    acc = 0.0
    q = 0
    for lo in range(1, n + 1, chunk):
        hi = min(n + 1, lo + chunk)
        cs = acc + np.cumsum(1.0 / np.arange(lo, hi, dtype=np.float64) ** z)
        acc = cs[-1]
        while q < bins and (q + 1) / bins * total <= cs[-1]:
            lut[q] = lo + np.searchsorted(cs, (q + 1) / bins * total)
            q += 1
    lut[q:] = n
    return np.minimum(lut, n)


def make_workload_a_sharded(n_r: int, n_s: int, mesh: Mesh, seed: int = 42,
                            skew: float = 0.0,
                            s_seed: Optional[int] = None):
    """Per-chip on-device generation of the pk-fk workload (uniform fk, or
    Zipf(z=skew) fk — BASELINE's 1.6B uniform + skewed configs).

    Returns ``(rk, sk)`` as (n_chips, shard) device arrays sharded over
    ``mesh`` — suitable for ``dist_mway_join_count(..., pre_sharded=True)``.
    """
    n_chips = int(np.prod(list(mesh.shape.values())))
    assert n_r % n_chips == 0 and n_s % n_chips == 0, (
        "scale tier requires sizes divisible by the chip count")
    shard_r = n_r // n_chips
    shard_s = n_s // n_chips
    # R is the deterministic strided key set (no randomness); the only
    # random stream is S's fk draw, so it follows the S seed (-y) when
    # given — mirroring the reference's separate -x/-y seeding
    if s_seed is None:
        s_seed = seed
    lut = None
    if skew > 0:
        lut = jnp.asarray(_zipf_quantile_lut(n_r, skew), jnp.int32)

    def gen_chip(*args):
        me = jax.lax.axis_index(AXIS)
        j = jnp.arange(shard_r, dtype=jnp.int32)
        rk = me.astype(jnp.int32) + 1 + jnp.int32(n_chips) * j
        key = jax.random.fold_in(jax.random.PRNGKey(s_seed), me)
        if skew > 0:
            (lut_rep,) = args
            u = jax.random.randint(key, (shard_s,), 0, ZIPF_QUANTILE_BINS,
                                   dtype=jnp.int32)
            sk = lut_rep[u]
        else:
            sk = jax.random.randint(key, (shard_s,), 1, n_r + 1,
                                    dtype=jnp.int32)
        return rk.reshape(1, -1), sk.reshape(1, -1)

    in_specs = () if lut is None else (P(),)
    fn = jax.jit(shard_map(gen_chip, mesh=mesh, in_specs=in_specs,
                           out_specs=(P(AXIS), P(AXIS))))
    return fn() if lut is None else fn(lut)


def workload_a_join_count(n_r: int, n_s: int,
                          mesh: Optional[Mesh] = None, seed: int = 42,
                          skew: float = 0.0,
                          slack: float = 2.0,
                          s_seed: Optional[int] = None,
                          phased: bool = False):
    """End-to-end workload-A m-way count join: sharded on-device datagen →
    distributed m-way.  Returns (count, overflow); count must equal |S|
    (every fk — uniform or Zipf — matches exactly one of the unique keys
    1..|R|).

    ``phased=True`` dispatches through the per-phase variant and returns
    ``(count, overflow, phases)`` so the scale tier's [RECORD] row gets
    real SORT / MERGE1 / MJOIN columns (joincommon.c:175-196) instead of
    zeros — at the cost of two extra waits for the device.
    """
    from . import dist_mway

    mesh = mesh or make_mesh()
    rk, sk = make_workload_a_sharded(n_r, n_s, mesh, seed, skew,
                                     s_seed=s_seed)
    if phased:
        return dist_mway.dist_mway_join_phased(
            rk, sk, n_r, n_s, mesh, pre_sharded=True, slack=slack)
    return dist_mway.dist_mway_join_count(
        rk, sk, n_r, n_s, mesh, pre_sharded=True, slack=slack)
