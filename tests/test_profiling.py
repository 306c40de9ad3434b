"""Observability utilities (the rdtsc/PCM analogs)."""

from avx_sort_merge_joins_tpu.utils import profiling


def test_phase_timer_report():
    t = profiling.PhaseTimer()
    with t.phase("sort"):
        sum(range(1000))
    with t.phase("join"):
        sum(range(1000))
    rep = t.report(ntuples=1000)
    assert "sort" in rep and "join" in rep
    assert "TUPLES-PER-SECOND" in rep


def test_record_line_columns():
    """The reference scripts' record row (tput-scalability.sh:28): phases
    that are no separate work report 0."""
    row = profiling.record_line("m-way", 1, 10, 20, 0,
                                {"sort": 0.5, "mergejoin": 0.25,
                                 "total": 1.0})
    cols = row.split()
    assert cols[:6] == ["[RECORD]", "m-way", "1", "10", "20", "0"]
    # PART SORT MERGE1 MERGEREST MJOIN
    assert cols[6:11] == ["0", "500000", "0", "0", "250000"]
    assert cols[11:] == ["30", "1000000", "30"]


def test_trace_writes_profile(tmp_path):
    """trace() brackets a jax.profiler trace (the PCM_start/stop analog)."""
    import jax.numpy as jnp

    with profiling.trace(str(tmp_path)):
        jnp.arange(8).sum().block_until_ready()
    assert any(tmp_path.rglob("*.xplane.pb"))
