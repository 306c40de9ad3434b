"""Scaling-efficiency harness: distributed join throughput vs chip count.

The analog of the reference's thread-scaling grid and its numabench
communication benchmark (reference: scripts/tput-scalability.sh:27-38,
src/bench/tputbench.c:902-1018): run the distributed m-way join at
1, 2, 4, ... devices and report rows/s plus parallel efficiency
tput(n) / (n * tput(1)) — the observable for BASELINE's >=75% scaling
target.  On the CPU-simulated mesh the virtual devices share host cores,
so wall-clock efficiency is a structural proxy (it exposes exchange and
padding overheads, not real interconnect speedups); on a multi-GPU host
the same harness reports real scaling.
"""

from __future__ import annotations

import argparse
import sys
import time

import jax
import numpy as np

from ..ops.mergejoin import merge_join_count_numpy
from ..parallel import dist_mway
from ..parallel.mesh import make_mesh, make_mesh2d


def main(argv=None) -> int:
    from ..utils.cache import enable_compile_cache
    enable_compile_cache()
    p = argparse.ArgumentParser(prog="scalebench")
    p.add_argument("ntuples", type=int, nargs="?", default=1 << 22)
    p.add_argument("--devices", default=None,
                   help="comma list of device counts (default 1,2,4,..,N); "
                        "HxC entries (e.g. 2x4) run a 2-D ('host','chip') "
                        "mesh with the hierarchical exchange")
    p.add_argument("--reps", type=int, default=2)
    p.add_argument("--algo", default="m-way",
                   choices=["m-way", "m-pass", "mpsm"])
    args = p.parse_args(argv)

    ndev_all = len(jax.devices())
    if args.devices:
        counts = [x.strip() for x in args.devices.split(",")]
    else:
        counts = []
        d = 1
        while d <= ndev_all:
            counts.append(str(d))
            d *= 2
    n = args.ntuples
    rng = np.random.default_rng(3)
    rk = rng.permutation(np.arange(1, n + 1)).astype(np.int32)
    sk = rng.integers(1, n + 1, n).astype(np.int32)
    expected = merge_join_count_numpy(rk, sk)

    if args.algo == "m-pass":
        from ..parallel import dist_mpass
        join = dist_mpass.dist_mpass_join_count
    elif args.algo == "mpsm":
        # the S-ring scan-all-S-runs shape that distinguishes mpsm from
        # m-way shows up directly in these rows vs the m-way ones
        from ..parallel import dist_mpsm
        join = dist_mpsm.dist_mpsm_join_count
    else:
        join = dist_mway.dist_mway_join_count

    tput1 = None
    per_count_tput = {}
    for spec_str in counts:
        if "x" in spec_str:
            # 2-D ('host','chip') mesh: hierarchical exchange, per-AXIS
            # efficiency below
            if args.algo == "mpsm":
                print(f"[scalebench] mpsm skipped on 2-D mesh {spec_str} "
                      "(S-ring schedules the flat chip axis only)",
                      file=sys.stderr)
                continue
            h, c = (int(x) for x in spec_str.split("x"))
            mesh = make_mesh2d(h, c)
            nd = h * c
        else:
            nd = int(spec_str)
            mesh = make_mesh(nd)
        cnt, ov = join(rk, sk, n, n, mesh)  # compile + warmup + exact check
        assert ov == 0 and cnt == expected, (nd, cnt, expected)
        best = float("inf")
        for _ in range(args.reps):
            t0 = time.perf_counter()
            join(rk, sk, n, n, mesh)
            best = min(best, time.perf_counter() - t0)
        tput = 2 * n / best
        if tput1 is None:
            tput1 = tput
        per_count_tput[spec_str] = tput
        eff = tput / (nd * tput1)
        cols = [f"efficiency={eff:.2f}"]
        if "x" in spec_str:
            # per-axis efficiency: vs the same total over one host
            # (host-axis cost) and vs the chips-per-host flat point
            # (chip-axis baseline), when those points ran earlier
            flat_c = per_count_tput.get(str(c))
            one_host = per_count_tput.get(f"1x{c}")
            if flat_c:
                cols.append(f"host_axis_eff={tput / (h * flat_c):.2f}")
            if one_host:
                cols.append(f"host_axis_eff_vs_1x={tput / (h * one_host):.2f}")
        print(f"[scalebench] {args.algo} ndev={spec_str} n={n} "
              f"{best*1e6:.0f} usecs {tput/1e6:.1f} Mtuples/s "
              + " ".join(cols), file=sys.stderr)
        print(f"{args.algo} {spec_str} {n} {best*1e6:.0f} {tput/1e6:.2f} "
              f"{eff:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
