"""Smoke run of the join engine on the GPU, through the entry points a
user calls, at the paper's workload-B size (128M ⋈ 128M).

    python chip_smoke.py           # one GPU: every single-card phase
    python chip_smoke.py --four    # four GPUs: the distributed joins only

One process, one JAX.  It exits non-zero before any phase when JAX's
first device is not a GPU, and any failed check ends it with a non-zero
exit.  Every time is printed beside the card's name and power limit.  The
last line of stdout is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import re
import subprocess
import sys
import time

N_B = 128_000_000      # workload B, |R| = |S|
N_CHECK = 16_000_000   # phases compared with the numpy oracle
N_KEY8B = 64_000_000
N_M2M = 1_000_000      # many-to-many case: |R| = |S| over a domain of 100


def card_info() -> str:
    """Name and power limit of the card, from nvidia-smi in a child
    process that does not import JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"
    return " | ".join(ln.strip() for ln in out.splitlines() if ln.strip())


class Smoke:
    """The phases, sharing the card line, the sizes and the CLI runner."""

    def __init__(self, card: str, n_b: int = N_B, n_check: int = N_CHECK,
                 n_key8b: int = N_KEY8B, n_m2m: int = N_M2M):
        self.card = card
        self.n_b, self.n_check = n_b, n_check
        self.n_key8b, self.n_m2m = n_key8b, n_m2m

    def say(self, msg: str) -> None:
        print(msg, flush=True)

    def timed(self, label: str, secs: float) -> None:
        self.say(f"  {label}: {secs:.4f} s  [{self.card}]")

    def peak(self, label: str) -> None:
        import jax

        stats = jax.devices()[0].memory_stats() or {}
        peak = stats.get("peak_bytes_in_use")
        shown = f"{peak / 2**30:.2f} GiB" if peak else "not reported"
        self.say(f"  {label} peak_bytes_in_use (process so far): {shown}")

    def cli(self, argv):
        """Run ``cli.main(argv)``; returns (Results, wall seconds, join
        seconds from the [STATS] row)."""
        from avx_sort_merge_joins_tpu import cli

        out, err = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli.main(argv)
        wall = time.perf_counter() - t0
        if rc != 0:
            raise RuntimeError(f"cli {argv} exited {rc}:\n{err.getvalue()}")
        results = int(re.search(r"Results = (\d+)", out.getvalue()).group(1))
        m = re.search(r"TOTAL-TIME-USECS ([0-9.]+)", err.getvalue())
        join = float(m.group(1)) / 1e6 if m else float("nan")
        return results, wall, join

    def cli_three(self, name, argv, want):
        """Compile+first run, then two warm runs, each checked."""
        for label in ("compile+first run", "warm run 1", "warm run 2"):
            got, wall, join = self.cli(argv)
            check(f"{name} Results", got, want)
            self.timed(f"{name} {label} wall (datagen + join)", wall)
            self.timed(f"{name} {label} join ([STATS] total)", join)
        self.say(f"  {name}: Results = {got} == {want}")
        self.peak(name)

    # -- one card -----------------------------------------------------

    def algorithms(self):
        self.say(f"[phase] m-way / m-pass / mpsm through the CLI at "
                 f"{self.n_b}⋈{self.n_b}")
        for algo in ("m-way", "m-pass", "mpsm"):
            self.cli_three(algo, ["-a", algo, "-r", str(self.n_b),
                                  "-s", str(self.n_b)], self.n_b)

    def phase_split(self):
        import jax

        from avx_sort_merge_joins_tpu import cli
        from avx_sort_merge_joins_tpu.models import common
        from avx_sort_merge_joins_tpu.ops import join64, sort

        n = self.n_b
        self.say(f"[phase] split of one warm m-way run at {n}⋈{n}")
        args = cli.build_parser().parse_args(["-r", str(n), "-s", str(n)])
        R, S = cli.make_relations(args)
        rk, sk = R.keys, S.keys
        rks = jax.block_until_ready(common.sort_side(rk, 0, n, "sort_r"))
        sks = jax.block_until_ready(common.sort_side(sk, 0, n, "sort_s"))
        check("count", int(common.count(rks, sks)), n)
        steps = [("sort R", lambda: common.sort_side(rk, 0, n, "sort_r")),
                 ("sort S", lambda: common.sort_side(sk, 0, n, "sort_s")),
                 ("count", lambda: common.count(rks, sks))]
        for name, fn in steps:
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                jax.block_until_ready(fn())
                times.append(time.perf_counter() - t0)
            self.timed(f"{name} (mean of 3, min {min(times):.4f} s)",
                       sum(times) / len(times))
        # which sorts XLA hands to the library radix sort
        with jax.enable_x64(True):
            k64 = jax.numpy.zeros((self.n_key8b,), jax.numpy.int64)
            low64 = lowering(join64._sort64, k64)
        for name, low in (
                ("keys-only int32 sort (sort_r/sort_s)",
                 lowering(common.sort_side, rk, 0, n, "sort_r")),
                ("key+payload int32 sort (materialize S)",
                 lowering(jax.jit(sort.sort_pairs), sk, S.payloads)),
                ("int64 keys-only sort (KEY_8B)", low64),
                ("count program", lowering(common.count, rks, sks))):
            self.say(f"  HLO {name}: {low}")
        self.peak("split")

    def skew_and_duplicates(self):
        from avx_sort_merge_joins_tpu import cli, datagen
        from avx_sort_merge_joins_tpu.models.mway import (
            sortmergejoin_multiway)
        from avx_sort_merge_joins_tpu.ops.mergejoin import (
            merge_join_count_numpy)

        n = str(self.n_check)
        for name, argv in (("zipf z=1.0", ["-z", "1.0"]),
                           ("non-unique", ["--non-unique"])):
            self.say(f"[phase] {name} at {n}⋈{n} vs numpy")
            full = ["-a", "m-way", "-r", n, "-s", n] + argv
            got, wall, join = self.cli(full)
            R, S = cli.make_relations(cli.build_parser().parse_args(full))
            want = merge_join_count_numpy(R.to_numpy()[0], S.to_numpy()[0])
            check(name, got, want)
            self.say(f"  {name}: Results = {got} == numpy {want}")
            self.timed(f"{name} join ([STATS] total, includes compile)",
                       join)
        m = self.n_m2m
        self.say(f"[phase] many-to-many: {m}⋈{m} over a domain of 100 vs "
                 "numpy")
        datagen.seed_generator(7)
        R = datagen.create_relation_nonunique(m, 100)
        S = datagen.create_relation_nonunique(m, 100)
        got = sortmergejoin_multiway(R, S).totalresults
        want = merge_join_count_numpy(R.to_numpy()[0], S.to_numpy()[0])
        check("many-to-many", got, want)
        if m == N_M2M and want <= 2**31:
            raise AssertionError(f"case has only {want} matches, not > 2^31")
        self.say(f"  many-to-many: {got} == numpy {want} "
                 f"({'>' if want > 2**31 else '<='} 2^31)")

    def key8b(self):
        self.say(f"[phase] KEY_8B at {self.n_key8b}⋈{self.n_key8b}")
        n = str(self.n_key8b)
        for label in ("compile+first run", "warm run"):
            got, wall, _ = self.cli(["--key8b", "-a", "m-pass", "-r", n,
                                     "-s", n])
            check("KEY_8B Results", got, self.n_key8b)
            self.timed(f"KEY_8B {label} wall (datagen + join)", wall)
        self.say(f"  KEY_8B: Results = {got} == |S|")
        self.peak("KEY_8B")

    def materialize(self):
        import numpy as np

        from avx_sort_merge_joins_tpu import cli

        n = str(self.n_check)
        self.say(f"[phase] --materialize at {n}⋈{n} vs numpy")
        args = cli.build_parser().parse_args(
            ["--materialize", "-r", n, "-s", n])
        R, S = cli.make_relations(args)
        t0 = time.perf_counter()
        res = cli.run_join(args, R, S)
        self.timed("materialize join (includes compile)",
                   time.perf_counter() - t0)
        gk, gp = res.resultlist[0].results.to_numpy()
        rk = R.to_numpy()[0]
        sk, sp = S.to_numpy()
        ek, ep = numpy_join_rows(rk, sk, sp)
        check("materialize rows", res.totalresults, len(ek))
        check("materialize emitted rows", len(gk), len(ek))
        go, eo = np.lexsort((gp, gk)), np.lexsort((ep, ek))
        if not (np.array_equal(gk[go], ek[eo])
                and np.array_equal(gp[go], ep[eo])):
            raise AssertionError("materialized <key, payload> multiset "
                                 "differs from the numpy join")
        self.say(f"  materialize: {len(gk)} rows, multiset == numpy join")
        self.peak("materialize")

    # -- four cards ---------------------------------------------------

    def four(self):
        from avx_sort_merge_joins_tpu import cli
        from avx_sort_merge_joins_tpu.ops.mergejoin import (
            merge_join_count_numpy)
        from avx_sort_merge_joins_tpu.parallel import dist_join
        from avx_sort_merge_joins_tpu.parallel.mesh import make_mesh

        nb = self.n_b
        self.say(f"[phase] distributed joins over 4 cards at {nb}⋈{nb}")
        base = ["-n", "4", "-r", str(nb), "-s", str(nb)]
        for algo in ("m-way", "m-pass", "mpsm"):
            self.cli_three(f"dist {algo}", ["-a", algo] + base, nb)
        args = cli.build_parser().parse_args(base)
        R, S = cli.make_relations(args)
        mesh = make_mesh(4)
        for label in ("compile+first run", "warm run"):
            t0 = time.perf_counter()
            cnt, ov = dist_join.dist_join_count(
                R.keys, R.payloads, S.keys, S.payloads, nb, nb, mesh)
            self.timed(f"dist_join {label}", time.perf_counter() - t0)
            check("dist_join overflow", ov, 0)
            check("dist_join count", cnt, nb)
        self.say(f"  dist_join: count = {cnt} == |S|")
        del R, S
        n = str(self.n_check)
        full = ["-a", "m-way", "-n", "4", "-r", n, "-s", n, "-z", "1.0"]
        self.say(f"[phase] dist m-way, zipf z=1.0 at {n}⋈{n} vs numpy")
        got, _, join = self.cli(full)
        R, S = cli.make_relations(cli.build_parser().parse_args(full))
        want = merge_join_count_numpy(R.to_numpy()[0], S.to_numpy()[0])
        check("dist zipf", got, want)
        self.say(f"  dist zipf: Results = {got} == numpy {want}")
        self.peak("four")


def check(name, got, want):
    if got != want:
        raise AssertionError(f"{name}: got {got}, want {want}")


def lowering(jitted, *args) -> str:
    """How XLA compiled the sorts of a jitted function for this device:
    library custom calls (e.g. the radix sort) versus XLA's own sort op."""
    text = jitted.lower(*args).compile().as_text()
    targets = sorted(set(re.findall(r'custom_call_target="([^"]+)"', text)))
    sorts = len(re.findall(r"\ssort\(", text))
    return (f"custom calls {targets or 'none'}; XLA sort ops: {sorts}")


def numpy_join_rows(rk, sk, sp):
    """The numpy join output: one <S-key, S-payload> row per match pair."""
    import numpy as np

    ru, rc = np.unique(rk, return_counts=True)
    pos = np.clip(np.searchsorted(ru, sk), 0, max(len(ru) - 1, 0))
    mult = np.where(ru[pos] == sk, rc[pos], 0) if len(ru) else \
        np.zeros_like(sk)
    return np.repeat(sk, mult), np.repeat(sp, mult)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--four", action="store_true",
                   help="run only the distributed joins over four GPUs")
    args = p.parse_args(argv)

    import jax

    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU — JAX's first device is {dev.platform!r} "
              f"({dev.device_kind})", file=sys.stderr)
        return 1
    want = 4 if args.four else 1
    if len(devices) < want:
        print(f"chip_smoke: {want} GPUs needed, JAX sees {len(devices)}",
              file=sys.stderr)
        return 1

    from avx_sort_merge_joins_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()

    card = card_info()
    print(f"[card] {card}", flush=True)
    print(f"[device] platform={dev.platform} device_kind={dev.device_kind} "
          f"count={len(devices)}", flush=True)
    smoke = Smoke(card)
    t0 = time.perf_counter()
    if args.four:
        smoke.four()
    else:
        smoke.algorithms()
        smoke.phase_split()
        smoke.skew_and_duplicates()
        smoke.key8b()
        smoke.materialize()
    smoke.timed("all phases", time.perf_counter() - t0)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
