"""avx_sort_merge_joins_tpu — a sort-merge-join engine in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the ETH
multi-core sort-merge-joins codebase (PVLDB'13 "Multi-Core, Main-Memory
Joins: Sort vs. Hash Revisited"): the m-pass / m-way / mpsm sort-merge
joins over device-resident columnar relations, on one card or sharded
over the cards of a host with jax.sharding meshes instead of
NUMA-pinned threads.
"""

import importlib

from .types import JoinConfig, JoinResult, Relation  # noqa: F401

__version__ = "0.1.0"

_SUBMODULES = ("datagen", "ops", "models", "parallel", "utils", "bench")


def __getattr__(name):
    """Lazy submodule access (``smj.datagen``, ``smj.models.mway`` …) without
    importing jax-heavy modules at package import time."""
    if name in _SUBMODULES:
        mod = importlib.import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
