"""Join-output materialization.

The reference's merge_join materializes only the matching S tuple
``<S-key, S-RID>`` per match pair (reference: src/joins/joincommon.c:272-284
under JOIN_MATERIALIZE, written into a chained tuple buffer).  Equivalently:
every S tuple is emitted once per matching R tuple, in S order per key.

Parity note: the reference release cannot actually build its materialize
path — --enable-materialize references a ``tuple_buffer.h`` that does not
ship in the snapshot — so output-file comparison against the binary is
impossible; count parity (tests/test_reference_parity.py) is the strongest
available evidence and this module follows the documented semantics.

Realization: per S element compute cntR(key) (how many R rows share its
key) with a searchsorted rank difference over the sorted R keys, then
compact matched S tuples to the front, in S order, with a prefix sum and
one scatter.  Duplicate-R replication (cntR > 1) is carried as a
per-tuple multiplicity column and physically expanded by
:func:`expand_matches` when cntR > 1 occurs (non-pk R relations) so output
rows match the reference's one-tuple-per-match-pair semantics exactly.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..types import KEY_SENTINEL, Relation


def materialize_matches(rk_sorted, nR: int, sk_sorted, sp_sorted, nS: int):
    """Emit matched S tuples (the reference's <S-key, S-RID> convention).

    Inputs are 1-D sorted columns (R keys; S keys + payloads).  Returns
    device arrays ``(out_keys, out_payloads, out_mult, n_matched_s)``:
    matched S tuples compacted to the front (S order preserved), with
    ``out_mult[i]`` = cntR(key_i) (1 for pk-R).  Total matches =
    sum(out_mult[:n_matched_s]).
    """
    rk = rk_sorted[:nR]
    sk = sk_sorted[:nS]
    sp = sp_sorted[:nS]
    lo = jnp.searchsorted(rk, sk, side="left")
    hi = jnp.searchsorted(rk, sk, side="right")
    mult = (hi - lo).astype(jnp.int32)
    matched = mult > 0
    dest = jnp.cumsum(matched.astype(jnp.int32)) - 1
    dest = jnp.where(matched, dest, nS)  # unmatched rows are dropped
    ok = jnp.full((nS,), KEY_SENTINEL, jnp.int32).at[dest].set(sk, mode="drop")
    op = jnp.zeros((nS,), jnp.int32).at[dest].set(sp, mode="drop")
    om = jnp.zeros((nS,), jnp.int32).at[dest].set(mult, mode="drop")
    n_matched = jnp.sum(matched.astype(jnp.int32))
    return ok, op, om, n_matched


def expand_matches(ok, op, om, n_matched, cap_out: int):
    """Physically replicate matched S tuples by their R multiplicity —
    one output tuple per match PAIR, the reference's nested duplicate
    loops (reference: src/joins/joincommon.c:266-289).

    Inclusive offsets from a cumsum of the multiplicities, then every
    output slot j gathers its source row via ``searchsorted(offsets, j)``
    — no data-dependent shapes.  ``cap_out`` is the static output
    capacity; returns
    ``(ekeys, epayloads, total)`` with pads (KEY_SENTINEL, 0) past
    ``total``; total > cap_out means the caller's capacity was too small
    (detect and retry — never silently truncated, outputs past cap are
    simply not representable so callers must check).
    """
    n = ok.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    mult = jnp.where(idx < n_matched, om, 0)
    offs = jnp.cumsum(mult)  # inclusive scan
    total = offs[-1]
    j = jnp.arange(cap_out, dtype=jnp.int32)
    src = jnp.searchsorted(offs, j, side="right").astype(jnp.int32)
    src = jnp.minimum(src, n - 1)
    valid = j < total
    ek = jnp.where(valid, ok[src], jnp.int32(KEY_SENTINEL))
    ep = jnp.where(valid, op[src], 0)
    return ek, ep, total


def materialized_relation(ok, op, n_matched: int) -> Relation:
    """Wrap compacted match columns as a Relation of n_matched tuples."""
    return Relation(ok, op, int(n_matched), sorted=True)
