"""Distributed m-pass join (reference: src/joins/sortmergejoin_multipass.c:
phase 3.1 merges pairs of remote runs while pulling them to the local NUMA
node, :410-619; phase 3.2 runs log(numruns) local 2-way merge passes,
:621-708).

With the received runs re-sorted by one library sort, there are no
pairwise passes left to run: the m-pass program is the distributed m-way
one (sorted-run exchange of equi-depth ranges, re-sort, plain count).
"""

from __future__ import annotations

from typing import Optional

from jax.sharding import Mesh

from .dist_mway import dist_mway_join_count


def dist_mpass_join_count(rkeys, skeys, n_r: int, n_s: int,
                          mesh: Optional[Mesh] = None, slack: float = 2.0):
    """Distributed m-pass equi-join match count.  Returns (count,
    overflow) host ints, like :func:`.dist_mway.dist_mway_join_count`."""
    return dist_mway_join_count(rkeys, skeys, n_r, n_s, mesh, slack)
