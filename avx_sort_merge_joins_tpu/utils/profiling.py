"""Observability — phase timing, the record row, traces.

The analog of the reference's two profiling mechanisms (reference:
src/util/rdtsc.h cycle timers around each join phase printed by
joincommon.c:175-196, and the Intel PCM hardware-counter wrapper
src/util/perf_counters.c bracketed around phases when
--enable-perfcounters):

* wall/phase timing — ``PhaseTimer`` and ``models.common.run_phases``
  (each phase waits for the device with ``jax.block_until_ready``),
* hardware counters — ``jax.profiler`` traces (use :func:`trace` as a
  context manager); the named scopes ``sort_r``, ``sort_s``, ``count``
  and ``materialize`` attribute device time to phases.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import jax


class PhaseTimer:
    """Named phase stopwatch — the rdtsc startTimer/stopTimer analog
    (rdtsc.h:35-57), accumulating seconds per phase like arg_t's
    part/sort/merge/join cycle fields (joincommon.h:106-148)."""

    def __init__(self):
        self.phases: Dict[str, float] = {}
        self._t0: Optional[float] = None
        self._name: Optional[str] = None

    @contextlib.contextmanager
    def phase(self, name: str, result_holder=None):
        t0 = time.perf_counter()
        yield
        self.phases[name] = self.phases.get(name, 0.0) + \
            (time.perf_counter() - t0)

    def report(self, ntuples: int) -> str:
        """Formatted like the reference's stderr stats block
        (joincommon.c:176-196, 214-227)."""
        total = self.phases.get("total", sum(self.phases.values()))
        lines = [f"[STATS] {k:14s} {v*1e6:14.1f} usecs"
                 for k, v in self.phases.items()]
        if total > 0:
            lines.append(f"[STATS] NUMTUPLES {ntuples}, TOTAL-TIME-USECS "
                         f"{total*1e6:.1f}, TUPLES-PER-SECOND "
                         f"{ntuples/total:.0f}")
        return "\n".join(lines)


# canonical phase order of the reference's record format
# (scripts/tput-scalability.sh:28: PARTCYC SORTCYC MERGE1CYC MERGERESTCYC
# MJOINCYC NUMTUP USECS TPUT) — we report microseconds where the reference
# reports cycles; column structure is identical so grid outputs diff
# row-for-row.
RECORD_PHASES = ("part", "sort", "merge1", "mergerest", "mergejoin")


def record_line(algo: str, nthreads: int, n_r: int, n_s: int, run_no: int,
                phases: Dict[str, float]) -> str:
    """One grid-record row in the reference scripts' column layout."""
    ntuples = n_r + n_s
    total = phases.get("total", sum(
        v for k, v in phases.items() if k != "total"))

    def us(k):
        return phases.get(k, 0.0) * 1e6

    cols = " ".join(f"{us(k):.0f}" for k in RECORD_PHASES)
    tput = ntuples / total if total > 0 else 0.0
    return (f"[RECORD] {algo} {nthreads} {n_r} {n_s} {run_no} {cols} "
            f"{ntuples} {total * 1e6:.0f} {tput:.0f}")


@contextlib.contextmanager
def trace(logdir: str):
    """jax.profiler trace context — the PCM_start/stop analog
    (perf_counters.h:51-103); inspect with TensorBoard."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
