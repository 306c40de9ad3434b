"""Headline benchmark: m-way sort-merge join throughput on one GPU.

Workload B of the reference (Kim et al.): R ⋈ S with R unique keys 1..|R|
and S a foreign-key relation over R (reference: README:246-258,
src/main.c:471-473; default |R| = |S| = 128·10⁶ 8-byte tuples).  Runs the
single-card m-way program (``models.common``: sort R, sort S, plain
count) and asserts the exact count |S|.

Prints the device (platform, device_kind, count) on stderr and one JSON
line on stdout:
  {"metric": ..., "value": N, "unit": "Mtuples/s", "platform": ...,
   "device_kind": ..., "device_count": N}
Exits non-zero, before any work, when JAX finds no GPU.

Env knobs: SMJ_BENCH_NTUPLES (default 128000000), SMJ_BENCH_REPS (3).
"""

from __future__ import annotations

import json
import os
import sys
import time


def device_or_exit():
    """The first JAX device; exits the process when it is not a GPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"no GPU: JAX's first device is {dev.platform!r} "
                 f"({dev.device_kind}); this benchmark measures a GPU only")
    return dev


def _gen_workload(n: int):
    """Workload B: R unique 1..n, S uniform fk over the same domain
    (main.c:534-588's default), generated on the device."""
    from avx_sort_merge_joins_tpu import datagen

    datagen.seed_generator(42)
    R = datagen.parallel_create_relation(n, n)
    S = datagen.parallel_create_relation(n, n)
    return R.keys, S.keys


def run_join(rk, sk, n: int):
    """One m-way count join of the first n keys of each side; returns the
    count (waits for the device)."""
    from avx_sort_merge_joins_tpu.models import common

    rks = common.sort_side(rk, 0, n, "sort_r")
    sks = common.sort_side(sk, 0, n, "sort_s")
    return int(common.count(rks, sks))


def main() -> None:
    import jax

    dev = device_or_exit()
    from avx_sort_merge_joins_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()

    n = int(os.environ.get("SMJ_BENCH_NTUPLES", 128_000_000))
    reps = int(os.environ.get("SMJ_BENCH_REPS", 3))
    print(f"[bench] platform={dev.platform} device_kind={dev.device_kind} "
          f"device_count={len(jax.devices())} n={n}", file=sys.stderr)
    rk, sk = _gen_workload(n)

    t0 = time.perf_counter()
    matches = run_join(rk, sk, n)  # compile + first run
    print(f"[bench] compile+first run {time.perf_counter() - t0:.3f}s",
          file=sys.stderr)
    if matches != n:
        sys.exit(f"match count {matches} != |S| = {n}")

    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run_join(rk, sk, n)
        times.append(time.perf_counter() - t0)
    secs = sum(times) / len(times)
    tput = 2 * n / secs / 1e6
    print(f"[bench] m-way join: {secs:.4f}s mean of {reps}  "
          f"{tput:.1f} Mtuples/s", file=sys.stderr)
    print(json.dumps({
        "metric": f"mway_join_throughput_{n}x{n}",
        "value": round(tput, 2),
        "unit": "Mtuples/s",
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
    }))


if __name__ == "__main__":
    main()
