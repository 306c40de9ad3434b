"""Workload generators — replica of the reference's datagen layer
(reference: src/datagen/generator.c).

Semantics preserved exactly:

* ``create_relation_pk`` / ``random_unique_gen``: keys 1..n Knuth-shuffled
  with glibc ``RAND_RANGE`` draws (generator.c:55-93).
* ``parallel_create_relation``: per-thread chunks write keys
  ``(offset+i) mod maxid (+1)`` and payloads ``5 + local_i``; the keys are
  then globally shuffled (generator.c:125-178,254-350).  The reference's
  parallel shuffle is seeded from ``time(NULL)+pthread_self()`` per thread,
  so its permutation is irreproducible even between its own runs — only the
  key multiset (a permutation of 1..maxid repeated) is deterministic.  We
  therefore generate the identical multiset with a seeded shuffle.
* ``create_relation_fk``: consecutive independently shuffled 1..maxid
  blocks plus a shuffled 1..remainder block (generator.c:407-445).
* ``create_relation_nonunique``: keys = RAND_RANGE(maxid) per tuple,
  payload = n - i (generator.c:215-231,490-505).
* ``create_relation_zipf``: genzipf pipeline (generator.c:517-534).

Large shuffles use the native C module when built
(:mod:`avx_sort_merge_joins_tpu.datagen.native`), falling back to NumPy.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..types import Relation
from .c_rng import RAND_MAX, GlibcRand
from .genzipf import gen_zipf

_global_rng: Optional[GlibcRand] = None


def seed_generator(seed: int) -> None:
    """Reference seed_generator (generator.c:28-35)."""
    global _global_rng
    _global_rng = GlibcRand(seed)


def _check_seed() -> GlibcRand:
    global _global_rng
    if _global_rng is None:
        _global_rng = GlibcRand(42)  # deterministic default (ref uses time())
    return _global_rng


def _native():
    try:
        from . import native

        return native if native.available() else None
    except Exception:
        return None


def knuth_shuffle_keys(keys: np.ndarray, rng: GlibcRand) -> np.ndarray:
    """In-place Fisher-Yates on keys with j = RAND_RANGE(i) (generator.c:51-66).

    Draw order matches the C loop i = n-1 .. 1 exactly.
    """
    n = keys.shape[0]
    if n <= 1:
        return keys
    nat = _native()
    if nat is not None and n >= 65536:
        nat.knuth_shuffle(keys, rng)
        return keys
    draws = rng.rand_array(n - 1).astype(np.float64)
    idx = np.arange(n - 1, 0, -1, dtype=np.int64)
    js = (draws / float(RAND_MAX + 1) * idx).astype(np.int64)
    for pos, i in enumerate(range(n - 1, 0, -1)):
        j = js[pos]
        keys[i], keys[j] = keys[j], keys[i]
    return keys


def random_unique_gen(n: int, rng: GlibcRand) -> np.ndarray:
    """Shuffled permutation of 1..n (generator.c:83-93)."""
    keys = np.arange(1, n + 1, dtype=np.int32)
    return knuth_shuffle_keys(keys, rng)


def create_relation_pk(num_tuples: int, capacity: Optional[int] = None) -> Relation:
    """Primary-key relation: unique shuffled keys 1..n (generator.c:234-252)."""
    rng = _check_seed()
    keys = random_unique_gen(num_tuples, rng)
    payloads = np.arange(5, 5 + num_tuples, dtype=np.int32)
    return Relation.from_numpy(keys, payloads, capacity)


import functools


@functools.lru_cache(maxsize=32)
def _device_gen(num_tuples: int, maxid: int, nthreads: int):
    """Compiled on-device generator, cached per shape (rebuilding the jitted
    closure per call would recompile every time)."""
    import jax
    import jax.numpy as jnp

    from ..ops.sort import sort_pairs

    @jax.jit
    def gen(seed):
        base = (jnp.arange(num_tuples, dtype=jnp.int32) %
                jnp.int32(maxid)) + 1
        # shuffle = sort by integer-hash draws: one key carrying one
        # value, the library sort's shape; a splitmix-style hash is
        # plenty for a shuffle
        x = jnp.arange(num_tuples, dtype=jnp.int32) + seed
        x = (x ^ (x >> 16)) * jnp.int32(0x7feb352d)
        x = (x ^ (x >> 15)) * jnp.int32(np.int32(np.uint32(0x846ca68b)))
        x = x ^ (x >> 16)
        _, keys = sort_pairs(x, base)
        per = num_tuples // nthreads
        idx = jnp.arange(num_tuples, dtype=jnp.int32)
        chunk_start = jnp.minimum(idx // max(per, 1), nthreads - 1) * per
        return keys, 5 + (idx - chunk_start)

    return gen


def parallel_create_relation(
    num_tuples: int,
    maxid: int,
    nthreads: int = 1,
    capacity: Optional[int] = None,
    device: Optional[bool] = None,
) -> Relation:
    """Unique-key relation built the way the reference's parallel generator
    does (generator.c:254-350): thread t's chunk holds consecutive keys
    starting at its offset (wrapping at maxid) and payloads 5+local_i; keys
    are then globally shuffled.  The multiset equals {1..maxid} tiled to n.

    The reference's parallel shuffle seeds each thread from
    ``time(NULL)+pthread_self()`` (generator.c:137), so its permutation is
    irreproducible even between its own runs — only the key multiset is
    defined.  Large relations (>= 2^22 tuples) therefore generate ON
    DEVICE (a hash-keyed shuffle of the same multiset): the device builds
    them far faster than the host and nothing crosses the host link;
    pass ``device=False`` to force the host path.
    """
    if device is None:
        device = num_tuples >= (1 << 22)
    if device:
        import jax.numpy as jnp

        rng = _check_seed()
        keys, payloads = _device_gen(num_tuples, maxid, max(nthreads, 1))(
            jnp.int32(rng.rand() & 0x7FFFFFFF))
        return Relation(keys, payloads, num_tuples)
    rng = _check_seed()
    base = np.arange(num_tuples, dtype=np.int64) % maxid + 1
    keys = base.astype(np.int32)
    knuth_shuffle_keys(keys, rng)
    # payload = 5 + index within the generating thread's chunk
    per = num_tuples // max(nthreads, 1)
    idx = np.arange(num_tuples, dtype=np.int64)
    chunk_start = np.minimum(idx // max(per, 1), nthreads - 1) * per
    payloads = (5 + (idx - chunk_start)).astype(np.int32)
    return Relation.from_numpy(keys, payloads, capacity)


def create_relation_fk(
    num_tuples: int, maxid: int, capacity: Optional[int] = None
) -> Relation:
    """Foreign-key relation: independently shuffled full 1..maxid blocks plus
    a shuffled 1..remainder block (generator.c:407-445)."""
    rng = _check_seed()
    iters = num_tuples // maxid
    parts = [random_unique_gen(maxid, rng) for _ in range(iters)]
    rem = num_tuples % maxid
    if rem > 0:
        parts.append(random_unique_gen(rem, rng))
    keys = np.concatenate(parts) if parts else np.zeros(0, np.int32)
    payloads = np.arange(5, 5 + num_tuples, dtype=np.int32)
    return Relation.from_numpy(keys, payloads, capacity)


def create_relation_fk_from_pk(
    pk: Relation, num_tuples: int, capacity: Optional[int] = None
) -> Relation:
    """FK relation as tiled copies of the PK relation, globally shuffled
    (generator.c:452-488)."""
    rng = _check_seed()
    pkk, pkp = pk.to_numpy()
    reps = -(-num_tuples // pk.num_tuples)
    keys = np.tile(pkk, reps)[:num_tuples].copy()
    payloads = np.tile(pkp, reps)[:num_tuples].copy()
    knuth_shuffle_keys(keys, rng)
    return Relation.from_numpy(keys, payloads, capacity)


def create_relation_nonunique(
    num_tuples: int, maxid: int, capacity: Optional[int] = None
) -> Relation:
    """Uniform random keys in [0, maxid), payload = n - i
    (generator.c:215-231, RAND_RANGE generator.c:22)."""
    rng = _check_seed()
    draws = rng.rand_array(num_tuples).astype(np.float64)
    keys = (draws / float(RAND_MAX + 1) * maxid).astype(np.int32)
    payloads = (num_tuples - np.arange(num_tuples, dtype=np.int64)).astype(np.int32)
    return Relation.from_numpy(keys, payloads, capacity)


def create_relation_zipf(
    num_tuples: int,
    maxid: int,
    zipf_param: float,
    capacity: Optional[int] = None,
) -> Relation:
    """Zipf-skewed FK relation (generator.c:517-534 → genzipf.c)."""
    rng = _check_seed()
    keys = gen_zipf(num_tuples, maxid, zipf_param, rng)
    payloads = np.arange(5, 5 + num_tuples, dtype=np.int32)
    return Relation.from_numpy(keys, payloads, capacity)


def _native_tblio() -> bool:
    """True when the native .tbl writer (csrc/tblio.cc) imports and
    reports available — probed separately from the write so I/O errors
    in the write itself are never swallowed by a fallback."""
    try:
        from . import native

        return bool(native.tblio_available())
    except Exception:
        return False


def write_relation(rel: Relation, path: str) -> None:
    """Persist a relation as the reference's .tbl text format
    (generator.c:200-213): one "key payload" pair per line.  Uses the
    native multi-threaded writer (csrc/tblio.cc) when built."""
    keys, payloads = rel.to_numpy()
    # probe native availability FIRST; the write itself must never fall
    # back silently (a partially written native file + a full text
    # re-write would duplicate rows and mask real I/O failures)
    if _native_tblio():
        from . import native

        native.tbl_write(path, keys, payloads)
        return
    with open(path, "w") as f:
        for k, p in zip(keys.tolist(), payloads.tolist()):
            f.write(f"{k} {p}\n")


def append_rows(path: str, keys: np.ndarray, payloads: np.ndarray) -> None:
    """Append "key payload" rows to a .tbl file — the streaming-persist
    primitive used by the distributed materialize path: each per-chip
    output chunk flushes sequentially, so the full join output never
    exists in host memory at once (the reference's write_relation emits
    its whole buffer, generator.c:200-213; ours streams).

    Availability of the native writer is probed BEFORE writing; an
    IOError from the write itself propagates (falling back after a
    partial native append would duplicate the rows it already wrote)."""
    if _native_tblio():
        from . import native

        native.tbl_append(path, keys, payloads)
        return
    with open(path, "a") as f:
        for k, p in zip(np.asarray(keys).tolist(),
                        np.asarray(payloads).tolist()):
            f.write(f"{k} {p}\n")


def read_relation(path: str, capacity: Optional[int] = None) -> Relation:
    """Load a .tbl file back into a Relation (offline-comparison path for
    persisted runs, README:146-148)."""
    try:
        from . import native

        if native.tblio_available():
            import os

            cap = capacity or max(1, os.path.getsize(path) // 4)
            keys, payloads = native.tbl_read(path, cap)
            return Relation.from_numpy(keys, payloads, capacity)
    except Exception:
        pass
    ks, ps = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                ks.append(int(parts[0]))
                ps.append(int(parts[1]))
    return Relation.from_numpy(np.asarray(ks, np.int32),
                               np.asarray(ps, np.int32), capacity)
