"""Shared join runner — the analog of the reference's joincommon layer
(reference: src/joins/joincommon.c): phase orchestration, timing stats and
result assembly, plus the single-card device program every algorithm
runs.  Thread spawning/pinning/barriers are replaced by jit program
boundaries (single card) or shard_map meshes (multi card, see
avx_sort_merge_joins_tpu.parallel).

On one card the m-way, m-pass and mpsm joins compile to the same
program: a ``lax.sort`` of each side's keys and one plain count over the
two sorted sides (``ops.mergejoin``).  Their reference schedules differ
only in how partial sorted runs are merged (one k-way pass, log2 pairwise
passes, or never), and one library sort of the whole side leaves nothing
to merge.  mpsm keeps its one observable difference: ``nchunks`` > 1
sorts S as that many independent runs, each counted against all of R.
"""

from __future__ import annotations

import functools
import time
from typing import Callable, Dict

import jax
import numpy as np

from ..ops import materialize, mergejoin
from ..ops.sort import sort_keys, sort_pairs
from ..types import JoinConfig, JoinResult, Relation, ThreadResult


def run_phases(phases: Dict[str, Callable]):
    """Run named phase thunks, timing each (the analog of the per-phase
    cycle stats printed by joincommon.c:175-196).  Each thunk receives the
    previous thunk's result; every phase ends with the device idle."""
    timings = {}
    result = None
    t_total = time.perf_counter()
    for name, fn in phases.items():
        t0 = time.perf_counter()
        result = jax.block_until_ready(fn(result))
        timings[name] = time.perf_counter() - t0
    timings["total"] = time.perf_counter() - t_total
    return result, timings


def make_result(matches: int, nR: int, nS: int, timings: Dict[str, float]) -> JoinResult:
    total = timings.get("total", sum(v for k, v in timings.items() if k != "total"))
    tput = (nR + nS) / total if total > 0 else 0.0
    return JoinResult(
        totalresults=int(matches),
        resultlist=[],
        phases=timings,
        throughput=tput,
    )


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def sort_side(keys, lo: int, hi: int, scope: str):
    """Keys-only sort of ``keys[lo:hi]``, under the named scope ``scope``
    (``sort_r`` / ``sort_s``) so traces attribute its time."""
    with jax.named_scope(scope):
        return sort_keys(keys[lo:hi])


@jax.jit
def count(rks, sks):
    """Plain match count of two sorted key columns (int64 scalar)."""
    with jax.named_scope("count"):
        return mergejoin.count_sorted(rks, sks)


def chunk_bounds(nS: int, nchunks: int):
    """Static [lo, hi) bounds of mpsm's independent S runs."""
    chunk = -(-nS // nchunks) if nS else 0
    return [(lo, min(lo + chunk, nS)) for lo in range(0, nS, max(chunk, 1))]


@functools.partial(jax.jit, static_argnums=(3, 4))
def _materialize_program(rk, sk, sp, nR: int, nS: int):
    """Sort R keys, sort S keys carrying their payloads, emit the matched
    S tuples (<S-key, S-RID>, joincommon.c:272-284)."""
    with jax.named_scope("sort_r"):
        rks = sort_keys(rk[:nR])
    with jax.named_scope("sort_s"):
        sks, sps = sort_pairs(sk[:nS], sp[:nS])
    with jax.named_scope("materialize"):
        return materialize.materialize_matches(rks, nR, sks, sps, nS)


def _materialize_join(R: Relation, S: Relation) -> JoinResult:
    nR, nS = R.num_tuples, S.num_tuples
    (ok, op, om, n_matched), timings = run_phases(
        {"materialize": lambda _: _materialize_program(
            R.keys, S.keys, S.payloads, nR, nS)})
    nm = int(n_matched)
    matches = int(np.asarray(om[:nm], dtype=np.int64).sum())
    if matches != nm:
        # non-pk R: physically replicate matched S tuples per match pair
        # (joincommon.c:266-289 nested duplicate loops)
        cap_out = max(8, matches)
        ek, ep, _ = jax.jit(materialize.expand_matches,
                            static_argnums=(4,))(ok, op, om, nm, cap_out)
        rel = materialize.materialized_relation(ek, ep, matches)
    else:
        rel = materialize.materialized_relation(ok, op, nm)
    result = make_result(matches, nR, nS, timings)
    result.resultlist = [ThreadResult(nresults=matches, results=rel,
                                      shard_id=0)]
    return result


def sortmergejoin(R: Relation, S: Relation,
                  config: JoinConfig | None = None,
                  nchunks: int = 1) -> JoinResult:
    """The single-card join: sort R, sort S (as ``nchunks`` independent
    runs), count — or, with ``config.materialize``, emit the matching S
    tuples.  Phases are timed as the reference's record columns: "sort"
    and "mergejoin"; partitioning and merging are no separate work here
    and report 0 (``utils.profiling.record_line``)."""
    config = config or JoinConfig()
    if config.materialize:
        return _materialize_join(R, S)
    nR, nS = R.num_tuples, S.num_tuples
    bounds = chunk_bounds(nS, nchunks)

    def sort_phase(_):
        rks = sort_side(R.keys, 0, nR, "sort_r")
        return rks, [sort_side(S.keys, lo, hi, "sort_s")
                     for lo, hi in bounds]

    def join_phase(sorted_sides):
        rks, runs = sorted_sides
        return [count(rks, sks) for sks in runs]

    counts, timings = run_phases({"sort": sort_phase,
                                  "mergejoin": join_phase})
    matches = sum(int(c) for c in counts)
    return make_result(matches, nR, nS, timings)
