"""Benchmark harnesses beside the headline ``bench.py`` — the analog of
the reference's bench binaries (reference: src/bench/, built by
src/Makefile.am:67).

Run as modules, e.g.:
    python -m avx_sort_merge_joins_tpu.bench.scalebench 4194304 --devices 1,2,4
"""
