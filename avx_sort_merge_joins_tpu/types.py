"""Core data types for the sort-merge-join engine.

The reference stores relations as arrays of 8-byte ``tuple_t {payload lo32,
key hi32}`` compared as one double/int64 (reference: src/types.h:48-54).
Here relations are a **columnar SoA layout** — separate int32 ``keys`` and
``payloads`` columns — so a sort orders keys as integers (no
float-reinterpretation hazards: the fork's negative-key bug, reference:
src/run.log:531-551, cannot occur) and can carry the payload column as its
one value operand.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np

KeyArray = Any  # jnp int32 array
PayloadArray = Any  # jnp int32 array

# Sentinel used to pad variable-sized partitions/runs to static shapes.
# int32 max sorts after every real key; validity masks (not the sentinel
# value) define logical sizes, so full-range keys remain correct.
KEY_SENTINEL = np.int32(2**31 - 1)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class Relation:
    """A columnar in-memory relation of <int32 key, int32 payload> tuples.

    ``num_tuples`` is the logical size; ``keys``/``payloads`` may carry
    trailing padding (kept at KEY_SENTINEL / 0) so that shapes stay static
    under jit — the analog of the reference's RELATION_PADDING discipline
    (reference: src/params.h:41-72).
    """

    keys: KeyArray
    payloads: PayloadArray
    num_tuples: int
    sorted: bool = False

    def tree_flatten(self):
        return (self.keys, self.payloads), (self.num_tuples, self.sorted)

    @classmethod
    def tree_unflatten(cls, aux, children):
        keys, payloads = children
        return cls(keys, payloads, aux[0], aux[1])

    @property
    def capacity(self) -> int:
        return int(self.keys.shape[-1])

    def to_numpy(self) -> tuple[np.ndarray, np.ndarray]:
        n = self.num_tuples
        return (np.asarray(self.keys)[..., :n], np.asarray(self.payloads)[..., :n])

    @classmethod
    def from_numpy(
        cls,
        keys: np.ndarray,
        payloads: Optional[np.ndarray] = None,
        capacity: Optional[int] = None,
        sorted: bool = False,
    ) -> "Relation":
        keys = np.asarray(keys, dtype=np.int32)
        n = keys.shape[-1]
        if payloads is None:
            payloads = np.zeros_like(keys)
        payloads = np.asarray(payloads, dtype=np.int32)
        cap = capacity or n
        if cap != n:
            pad = cap - n
            keys = np.concatenate([keys, np.full(pad, KEY_SENTINEL, np.int32)])
            payloads = np.concatenate([payloads, np.zeros(pad, np.int32)])
        return cls(jnp.asarray(keys), jnp.asarray(payloads), n, sorted)


class NumaStrategy:
    """Exchange-scheduling order of the cross-chip shuffle, mirroring the
    reference's NEXT/RING/RANDOM NUMA shuffle strategies
    (reference: src/util/numa_shuffle.c:55-85)."""

    NEXT = "NEXT"
    RING = "RING"
    RANDOM = "RANDOM"


@dataclasses.dataclass
class JoinConfig:
    """The part of the reference joinconfig_t (reference:
    src/types.h:88-98) that changes what a single-card join computes; the
    thread count, fan-out and shuffle order select the distributed path
    and its exchange schedule instead (``cli.run_join``)."""

    materialize: bool = False  # produce output tuples, not only the count


@dataclasses.dataclass
class ThreadResult:
    """Per-shard results (reference threadresult_t, src/types.h:61-68)."""

    nresults: int
    results: Optional[Relation]
    shard_id: int


@dataclasses.dataclass
class JoinResult:
    """Join result + per-phase timing (reference result_t, src/types.h:70-80
    and the phase-cycle stats of src/joins/joincommon.c:175-196)."""

    totalresults: int
    resultlist: list
    phases: dict  # phase name -> seconds
    throughput: float = 0.0  # (|R| + |S|) / seconds, reference joincommon.c:214-227
