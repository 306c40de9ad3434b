"""Sorting — plain ``lax.sort`` (reference: src/avxsort/avxsort.c and its
scalar twin src/scalarsort/scalarsort.c).

XLA:GPU hands a sort to its library radix sort (a constant number of
passes over memory) only when the sort has ONE key operand and at most
one value operand.  Anything else — two keys, or several values — falls
back to XLA's own comparison network, which is orders of magnitude slower
at 10^8 elements.  Every sort of the engine therefore has one of the two
shapes below; a caller that needs more columns carries a row index as the
value and gathers afterwards.
"""

from __future__ import annotations

import jax


def sort_keys(keys):
    """Ascending sort of one key column."""
    return jax.lax.sort(keys)


def sort_pairs(keys, values):
    """Ascending sort of ``keys`` carrying one ``values`` column along.
    Ties between equal keys come out in no particular order."""
    return jax.lax.sort((keys, values), num_keys=1)
