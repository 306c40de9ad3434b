"""Degenerate relation sizes: empty and single-tuple inputs must count
exactly through every algorithm (the reference's scalar loops handle
these trivially; static-shape device programs must too)."""

import numpy as np
import pytest

from avx_sort_merge_joins_tpu.models.mpass import sortmergejoin_multipass
from avx_sort_merge_joins_tpu.models.mpsm import sortmergejoin_mpsm
from avx_sort_merge_joins_tpu.models.mway import sortmergejoin_multiway
from avx_sort_merge_joins_tpu.types import Relation


@pytest.mark.parametrize("nR,nS", [(0, 100), (100, 0), (1, 1), (1, 100),
                                   (0, 0)])
def test_degenerate_sizes(nR, nS):
    R = Relation.from_numpy(np.arange(1, nR + 1, dtype=np.int32))
    S = Relation.from_numpy(np.ones(nS, np.int32))
    exp = nS if (nR >= 1 and nS) else 0
    assert sortmergejoin_multiway(R, S).totalresults == exp
    assert sortmergejoin_multipass(R, S).totalresults == exp
    assert sortmergejoin_mpsm(R, S).totalresults == exp
    assert sortmergejoin_mpsm(R, S, nchunks=3).totalresults == exp
