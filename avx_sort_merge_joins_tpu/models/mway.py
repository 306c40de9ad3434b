"""m-way sort-merge join, single card — the flagship algorithm
(reference: src/joins/sortmergejoin_multiway.c: radix-partition →
in-cache sort → ONE multi-way merge through a cache-resident FIFO tree →
merge join).

On one card the partition, sort and merge phases collapse into one
library radix sort of each side, and the merge join becomes the plain
count of ``ops.mergejoin``; the program is shared with m-pass and mpsm
(``models.common.sortmergejoin``).
"""

from __future__ import annotations

from ..types import JoinConfig, JoinResult, Relation
from . import common


def sortmergejoin_multiway(R: Relation, S: Relation,
                           config: JoinConfig | None = None) -> JoinResult:
    return common.sortmergejoin(R, S, config)
