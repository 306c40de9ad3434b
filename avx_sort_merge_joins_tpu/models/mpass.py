"""m-pass sort-merge join, single card (reference:
src/joins/sortmergejoin_multipass.c: radix-partition → in-cache sort →
log2(#runs) pairwise merge passes → merge join).

A library sort of the whole side leaves no runs to merge pairwise, so on
one card m-pass runs the same program as m-way
(``models.common.sortmergejoin``).
"""

from __future__ import annotations

from ..types import JoinConfig, JoinResult, Relation
from . import common


def sortmergejoin_multipass(R: Relation, S: Relation,
                            config: JoinConfig | None = None) -> JoinResult:
    return common.sortmergejoin(R, S, config)
