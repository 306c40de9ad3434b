#!/bin/bash
# Thread(device)-scaling experiment — the tput-scalability.sh analog
# (reference: scripts/tput-scalability.sh: algos x {64..1} threads x reps,
#  record format "ALGO NTHREADS RUNNO PARTCYC SORTCYC MERGE1CYC
#  MERGERESTCYC MJOINCYC NUMTUP USECS TPUT", :27-38).
# Devices replace threads and cycles are reported as microseconds.  The
# reference's second, scalar sweep (:47-60) has no counterpart: every path
# here is the one plain sort and count.  [RECORD] rows on stderr are
# grepped into OUT so rows are comparable column-for-column.  One process
# runs at a time, so each card has one JAX process.
set -u
# run from anywhere: put the repo root on PYTHONPATH
export PYTHONPATH="$(cd "$(dirname "${BASH_SOURCE[0]}")/.." && pwd):${PYTHONPATH:-}"
NR=${NR:-134217728}
NS=${NS:-$NR}
REPS=${REPS:-3}
DEVICES=${DEVICES:-"1"}   # e.g. "4 2 1" on a four-GPU host
ALGOS=${ALGOS:-"m-way m-pass mpsm"}
LOG=${LOG:-tput-scalability.log}
OUT=${OUT:-tput-scalability.txt}

for algo in $ALGOS; do
  for n in $DEVICES; do
    for rep in $(seq 1 "$REPS"); do
      echo "# $algo devices=$n rep=$rep" >> "$LOG"
      # capture stderr to a temp file, then append: the [RECORD] row must
      # not interleave with other lines of the log
      errtmp=$(mktemp)
      python -m avx_sort_merge_joins_tpu -a "$algo" -n "$n" \
        -r "$NR" -s "$NS" >> "$LOG" 2> "$errtmp"
      cat "$errtmp" >> "$LOG"
      grep -E '^\[RECORD\]' "$errtmp" >> "$OUT"
      rm -f "$errtmp"
    done
  done
done
