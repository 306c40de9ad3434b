"""Command-line driver — the analog of the reference's sortmergejoins
binary (reference: src/main.c): same flags, same workload construction, same
output conventions (``Results = N`` on stdout, statistics on stderr so
scripts can split the streams, joincommon.c:175-196).

``--nthreads`` generalizes to the number of mesh devices: 1 runs the
single-card program; >1 shards the join over a device mesh (on CPU, set
XLA_FLAGS=--xla_force_host_platform_device_count=N to simulate).
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="avx_sort_merge_joins_tpu",
        description="sort-merge joins on accelerators "
                    "(m-way / m-pass / mpsm)")
    # flag set mirrors main.c:722-745
    p.add_argument("-a", "--algo", default="m-way",
                   choices=["m-way", "m-pass", "mpsm"],
                   help="join algorithm (main.c:414-420 registry)")
    p.add_argument("-n", "--nthreads", type=int, default=1,
                   help="number of mesh devices (reference: CPU threads)")
    p.add_argument("-r", "--r-size", type=int, default=128_000_000)
    p.add_argument("-s", "--s-size", type=int, default=128_000_000)
    p.add_argument("-x", "--r-seed", type=int, default=12345)
    p.add_argument("-y", "--s-seed", type=int, default=54321)
    p.add_argument("-z", "--skew", type=float, default=0.0,
                   help="Zipf skew parameter for S")
    p.add_argument("--non-unique", action="store_true",
                   help="R keys drawn uniformly instead of unique 1..|R|")
    p.add_argument("--full-range", action="store_true",
                   help="R keys span the full 2^31 domain (KEY_8B analog)")
    p.add_argument("--scalarsort", action="store_true",
                   help="accepted for flag parity; no effect (every sort is "
                        "the plain lax.sort)")
    p.add_argument("--scalarmerge", action="store_true",
                   help="accepted for flag parity; no effect (every count is "
                        "the plain one)")
    p.add_argument("-f", "--partfanout", type=int, default=16,
                   help="reference PARTFANOUT, a power of 2; accepted for "
                        "flag parity, no effect (there is no merge tree)")
    p.add_argument("-S", "--numastrategy", default="NEXT",
                   choices=["NEXT", "RING", "RANDOM"],
                   help="exchange schedule of the multi-chip shuffle")
    p.add_argument("-m", "--mwaybufsize", type=int, default=0,
                   help="reference merge-buffer size in bytes; accepted for "
                        "flag parity, no effect")
    p.add_argument("--nchunks", type=int, default=1,
                   help="mpsm: number of independent local S runs, each "
                        "sorted on its own and counted against all of R")
    p.add_argument("--materialize", action="store_true",
                   help="produce join output tuples, not only the count")
    p.add_argument("--persist", metavar="DIR", default=None,
                   help="write R.tbl/S.tbl/Out.tbl (generator.c:200-213)")
    p.add_argument("--key8b", action="store_true",
                   help="64-bit keys (the KEY_8B build, main.c:871-877)")
    p.add_argument("-o", "--perfout", metavar="DIR", default=None,
                   help="write a jax.profiler trace (the PCM perf-counter "
                        "output analog, main.c:738)")
    p.add_argument("-p", "--perfconf", default=None,
                   help="accepted for flag parity (PCM event config has no "
                        "analog; traces carry all counters)")
    p.add_argument("--mapping-file", default=None,
                   help="device mapping file (cpu-mapping.txt analog)")
    p.add_argument("--verbose", action="store_true")
    return p


def make_relations(args):
    """Workload construction, mirroring main.c:534-588 exactly:

    default      R = parallel_create_relation(|R|, maxid=|R|)   (unique)
                 S = parallel_create_relation(|S|, maxid=|R|)   (uniform fk)
                     or create_relation_zipf under --skew
    --non-unique R, S = create_relation_nonunique(size, |R|)
    --full-range R = create_relation_nonunique(|R|, INT_MAX)
                 S = create_relation_fk_from_pk(R, |S|)
    """
    from . import datagen
    from .utils.log import info

    datagen.seed_generator(args.r_seed)
    if args.full_range:
        info(f"Creating full-range R with {args.r_size} tuples")
        R = datagen.create_relation_nonunique(args.r_size, 2**31 - 1)
    elif args.non_unique:
        info(f"Creating non-unique R with {args.r_size} tuples")
        R = datagen.create_relation_nonunique(args.r_size, args.r_size)
    else:
        info(f"Creating unique R with {args.r_size} tuples")
        R = datagen.parallel_create_relation(args.r_size, args.r_size,
                                             args.nthreads)
    datagen.seed_generator(args.s_seed)
    if args.full_range:
        info(f"Creating fk-from-pk S with {args.s_size} tuples")
        S = datagen.create_relation_fk_from_pk(R, args.s_size)
    elif args.non_unique:
        info(f"Creating non-unique S with {args.s_size} tuples")
        S = datagen.create_relation_nonunique(args.s_size, args.r_size)
    elif args.skew > 0:
        info(f"Creating Zipf S with {args.s_size} tuples, z={args.skew}")
        S = datagen.create_relation_zipf(args.s_size, args.r_size, args.skew)
    else:
        info(f"Creating uniform fk S with {args.s_size} tuples")
        S = datagen.parallel_create_relation(args.s_size, args.r_size,
                                             args.nthreads)
    return R, S


def _run_dist_materialize(args, R, S, mesh):
    """Materializing distributed join (pair sort → equi-depth splitters →
    exchange → re-sort → per-card materialization, joincommon.c:266-289
    semantics on the mesh).  Under --persist the output STREAMS per-card
    chunks straight into Out.tbl (csrc/tblio append) — host memory stays
    bounded by one card's chunk."""
    from .parallel import dist_materialize
    from .types import JoinResult, Relation, ThreadResult

    stream_to = None
    if args.persist:
        os.makedirs(args.persist, exist_ok=True)
        stream_to = os.path.join(args.persist, "Out.tbl")
    t0 = time.perf_counter()
    ks, ps, cnt, overflow = dist_materialize.dist_join_materialize(
        R.keys, R.payloads, S.keys, S.payloads,
        R.num_tuples, S.num_tuples, mesh, stream_to=stream_to)
    dt = time.perf_counter() - t0
    if overflow:
        print(f"[ERROR] exchange/output overflow ({overflow} tuples); "
              "raise slack", file=sys.stderr)
        sys.exit(1)
    if stream_to is not None:
        print(f"[INFO ] streamed {cnt} output tuples to {stream_to}",
              file=sys.stderr)
        return JoinResult(
            totalresults=cnt, resultlist=[],
            phases={"total": dt},
            throughput=(R.num_tuples + S.num_tuples) / dt)
    rel = Relation.from_numpy(ks, ps, sorted=False)
    return JoinResult(
        totalresults=cnt,
        resultlist=[ThreadResult(nresults=cnt, results=rel, shard_id=0)],
        phases={"total": dt},
        throughput=(R.num_tuples + S.num_tuples) / dt)


def _run_scale_tier(args) -> int:
    """Workload-A tier: relations too large to exist on the host (or any
    one chip) are generated per-shard on device and joined through the
    pre-sharded distributed m-way (parallel.scale — the 1.6B⋈1.6B config,
    tput-scalability.sh:15-16)."""
    import jax

    from .parallel import scale
    from .parallel.mesh import make_mesh

    if len(jax.devices()) < args.nthreads:
        print(f"[ERROR] {args.nthreads} chips requested, "
              f"{len(jax.devices())} available", file=sys.stderr)
        return 2
    mesh = make_mesh(args.nthreads)
    print(f"[INFO ] scale tier: sharded on-device generation of "
          f"{args.r_size}⋈{args.s_size} over {args.nthreads} chips",
          file=sys.stderr)
    t0 = time.perf_counter()
    # phased dispatches give the [RECORD] row real SORT/MERGE1/MJOIN
    # columns (joincommon.c:175-196) at the cost of two extra waits for
    # the devices — SMJ_SCALE_PHASED=0 selects the fused single-dispatch
    # path when raw throughput is the point
    phased = os.environ.get("SMJ_SCALE_PHASED", "1") == "1"
    out = scale.workload_a_join_count(
        args.r_size, args.s_size, mesh, seed=args.r_seed,
        s_seed=args.s_seed,
        skew=args.skew, slack=4.0 if args.skew > 0 else 2.0, phased=phased)
    dt = time.perf_counter() - t0
    if phased:
        cnt, overflow, phases = out
    else:
        cnt, overflow = out
        phases = {"total": dt}
    if overflow:
        print(f"[ERROR] exchange bucket overflow ({overflow})",
              file=sys.stderr)
        return 1
    nt = args.r_size + args.s_size
    print(f"[STATS] NUMTUPLES {nt}, TOTAL-TIME-USECS {dt*1e6:.1f}, "
          f"TUPLES-PER-SECOND {nt/dt:.0f}", file=sys.stderr)
    from .utils import profiling
    print(profiling.record_line(args.algo, args.nthreads, args.r_size,
                                args.s_size, 0, phases),
          file=sys.stderr)
    print(f"Results = {cnt}")
    return 0


def run_join(args, R, S):
    from .types import JoinConfig

    config = JoinConfig(materialize=args.materialize)
    if args.nthreads > 1:
        from .parallel import dist_mway
        from .parallel.mesh import make_mesh

        mesh = make_mesh(args.nthreads)
        t0 = time.perf_counter()
        phases = None
        if args.materialize:
            if args.algo != "m-way":
                print("[WARN ] --materialize with -n>1 uses the "
                      "distributed m-way pipeline", file=sys.stderr)
            return _run_dist_materialize(args, R, S, mesh)
        if args.algo == "m-way":
            # phased variant: per-phase dispatches so the record row gets
            # real SORT/MERGE1/MJOIN columns (joincommon.c:175-196).
            # -S RING/RANDOM routes the exchange through scheduled
            # collective_permute rounds, not the bulk all_to_all
            xpath = ("bulk all_to_all" if args.numastrategy == "NEXT" else
                     f"{args.numastrategy}-scheduled collective_permute "
                     "rounds")
            print(f"[INFO ] exchange path: {xpath}", file=sys.stderr)
            cnt, overflow, phases = dist_mway.dist_mway_join_phased(
                R.keys, S.keys, R.num_tuples, S.num_tuples, mesh,
                numa_strategy=args.numastrategy
                if args.numastrategy != "NEXT" else None)
        elif args.algo == "mpsm":
            from .parallel import dist_mpsm
            cnt, overflow = dist_mpsm.dist_mpsm_join_count(
                R.keys, S.keys, R.num_tuples, S.num_tuples, mesh)
        else:
            from .parallel import dist_mpass
            cnt, overflow = dist_mpass.dist_mpass_join_count(
                R.keys, S.keys, R.num_tuples, S.num_tuples, mesh)
        dt = time.perf_counter() - t0
        if overflow:
            print(f"[ERROR] exchange bucket overflow ({overflow} tuples); "
                  "raise slack", file=sys.stderr)
            sys.exit(1)
        from .types import JoinResult
        return JoinResult(totalresults=cnt, resultlist=[],
                          phases=phases or {"total": dt},
                          throughput=(R.num_tuples + S.num_tuples) / dt)

    if args.algo == "m-way":
        from .models.mway import sortmergejoin_multiway
        return sortmergejoin_multiway(R, S, config)
    if args.algo == "m-pass":
        from .models.mpass import sortmergejoin_multipass
        return sortmergejoin_multipass(R, S, config)
    from .models.mpsm import sortmergejoin_mpsm
    return sortmergejoin_mpsm(R, S, config, nchunks=args.nchunks)


def _run_key8b(args):
    """KEY_8B (64-bit-key, 16-B-tuple) join: the SAME glibc-exact datagen
    streams widened to int64 (the reference's KEY_8B stores identical key
    values in 64-bit storage, types.h:23-29), sorted and counted as int64
    (ops.join64).  The reference's KEY_8B binary errors out unless
    --scalarsort --scalarmerge (main.c:433-445,871-877); here every KEY_8B
    run takes the one plain path.

    Golden parity surface: the --enable-key8B CC=g++ reference build's
    m-pass runs (its KEY_8B m-way is itself broken — Results = 49152 for
    the 100k⋈100k default and hangs on other configs; documented in
    PARITY.md)."""
    import jax

    from .ops import join64
    from .types import JoinResult

    R, S = make_relations(args)
    nR, nS = R.num_tuples, S.num_tuples
    t0 = time.perf_counter()
    cnt = int(jax.block_until_ready(
        join64.key8b_join_count(R.keys, S.keys, nR, nS)))
    dt = time.perf_counter() - t0
    n = nR + nS
    return JoinResult(totalresults=cnt, resultlist=[],
                      phases={"total": dt}, throughput=n / dt), n


def _validate(args):
    """Parameter validation mirroring main.c:860-886."""
    if args.partfanout & (args.partfanout - 1):
        print("[ERROR] partfanout must be a power of 2", file=sys.stderr)
        sys.exit(2)
    if args.nthreads > 1:
        import jax

        if len(jax.devices()) < args.nthreads:
            print(f"[ERROR] {args.nthreads} chips requested, "
                  f"{len(jax.devices())} available", file=sys.stderr)
            sys.exit(2)
    for flag, given in (("--scalarsort", args.scalarsort),
                        ("--scalarmerge", args.scalarmerge),
                        ("-m", args.mwaybufsize != 0),
                        ("-f", args.partfanout != 16)):
        if given:
            # flag parity with the reference binary; every path is the
            # one plain program, so these select nothing
            print(f"[WARN ] {flag} has no effect (every path runs the "
                  "plain sort and count)", file=sys.stderr)
    if args.nchunks != 1 and (args.algo != "mpsm" or args.nthreads > 1):
        # flag honesty: nchunks shapes the single-chip mpsm only (the
        # distributed form's "chunks" are the chips' local S runs)
        print("[WARN ] --nchunks applies to single-chip mpsm only",
              file=sys.stderr)
    if args.nchunks < 1:
        print("[ERROR] --nchunks must be >= 1", file=sys.stderr)
        sys.exit(2)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    _validate(args)
    from .utils.cache import enable_compile_cache
    enable_compile_cache()
    if args.mapping_file:
        # device order for the mesh (cpu-mapping.txt analog)
        from .parallel import mesh as mesh_mod
        mesh_mod.DEFAULT_MESH = mesh_mod.mesh_from_mapping_file(
            args.mapping_file)
    trace_ctx = None
    if args.perfout:
        from .utils.profiling import trace
        trace_ctx = trace(args.perfout)
        trace_ctx.__enter__()
    # workload-A scale tier: relations this large are generated shard by
    # shard on the devices and never exist on the host
    scale_min = int(os.environ.get("SMJ_SHARDED_GEN_MIN", 500_000_000))
    scale_eligible = (
        args.nthreads > 1 and max(args.r_size, args.s_size) >= scale_min
        and not (args.non_unique or args.full_range
                 or args.materialize or args.key8b)
        and args.r_size % args.nthreads == 0
        and args.s_size % args.nthreads == 0)
    if scale_eligible and (args.algo != "m-way"
                           or args.numastrategy != "NEXT"):
        # the scale tier implements the m-way pipeline with the default
        # exchange schedule only — never silently report its numbers for
        # a different requested algorithm/variant (flag honesty)
        print(f"[WARN ] scale tier (>= {scale_min} tuples) supports "
              "-a m-way with the default schedule only; running "
              f"the standard {args.algo} path (host-side datagen — may "
              "exhaust host memory at this size)", file=sys.stderr)
        scale_eligible = False
    if scale_eligible:
        try:
            return _run_scale_tier(args)
        finally:
            if trace_ctx is not None:
                trace_ctx.__exit__(None, None, None)
    try:
        if args.key8b:
            result, ntotal = _run_key8b(args)
            print(f"[STATS] NUMTUPLES {ntotal}, TUPLES-PER-SECOND "
                  f"{result.throughput:.0f}", file=sys.stderr)
            print(f"Results = {result.totalresults}")
            return 0
        R, S = make_relations(args)
        result = run_join(args, R, S)
    finally:
        if trace_ctx is not None:
            trace_ctx.__exit__(None, None, None)
    # statistics to stderr, results to stdout (joincommon.c:175-196 split)
    for name, secs in result.phases.items():
        print(f"[STATS] {name:12s} {secs * 1e6:12.1f} usecs", file=sys.stderr)
    ntotal = R.num_tuples + S.num_tuples
    total = result.phases.get("total", 0.0) or 1e-12
    print(f"[STATS] NUMTUPLES {ntotal}, TOTAL-TIME-USECS {total*1e6:.1f}, "
          f"TUPLES-PER-SECOND {result.throughput:.0f}", file=sys.stderr)
    # the reference scripts' record row (tput-scalability.sh:28 columns,
    # microseconds standing in for cycles)
    from .utils import profiling
    print(profiling.record_line(args.algo, args.nthreads, R.num_tuples,
                                S.num_tuples, 0, result.phases),
          file=sys.stderr)
    print(f"Results = {result.totalresults}")
    if args.persist:
        from .datagen import write_relation
        os.makedirs(args.persist, exist_ok=True)
        write_relation(R, os.path.join(args.persist, "R.tbl"))
        write_relation(S, os.path.join(args.persist, "S.tbl"))
        if args.materialize and result.resultlist:
            write_relation(result.resultlist[0].results,
                           os.path.join(args.persist, "Out.tbl"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
