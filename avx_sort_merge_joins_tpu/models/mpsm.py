"""mpsm join (Albutiu et al., PVLDB'12 — "Massively Parallel Sort-Merge
joins in main memory multi-core database systems").

The reference registers mpsm but ships only a stub that warns and exits
(reference: src/joins/sortmergejoin_mpsm.c:38-45).  The paper's structure:
R is globally range-partitioned and fully sorted per worker; S is only
sorted LOCALLY per worker and never repartitioned; each worker joins its
R range against every worker's sorted S run.

Single-card realization: "workers" degenerate to ``nchunks`` independent S
runs, each sorted on its own and counted against all of sorted R
(MPSM's scan-all-S-runs shape).  With ``nchunks=1`` the program is the
m-way one (``models.common.sortmergejoin``).
"""

from __future__ import annotations

from ..types import JoinConfig, JoinResult, Relation
from . import common


def sortmergejoin_mpsm(R: Relation, S: Relation,
                       config: JoinConfig | None = None,
                       nchunks: int = 1) -> JoinResult:
    return common.sortmergejoin(R, S, config, nchunks=nchunks)
