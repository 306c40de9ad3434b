#!/usr/bin/env bash
# Workload A — BASELINE config #5: 1.6B x 1.6B m-way join over several
# devices (reference: scripts/tput-scalability.sh:15-16,27-38).
#
# The CLI auto-routes sizes >= SMJ_SHARDED_GEN_MIN (default 500M) with
# -n > 1 through the scale tier: sharded ON-DEVICE generation (no host
# array ever holds the relations) -> pre-sharded distributed m-way
# (local sort -> equi-depth splitters -> all_to_all -> re-sort -> count)
# -> Results = |S| assert.
#
#   scripts/workload-a.sh --devices 4 --ntuples 1600000000 [--skew 0.75]
# CPU-scale rehearsal on 8 virtual CPU devices (same entry point, same
# code path — tests/test_cli.py::test_workload_a_runbook_entry):
#   JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
#     scripts/workload-a.sh --devices 8 --ntuples 8000000 --scale-min 1000000
set -u
DEVICES=8
NTUPLES=1600000000
SKEW=0
SCALE_MIN=""
while [[ $# -gt 0 ]]; do
  case "$1" in
    --devices)   DEVICES=$2; shift 2;;
    --ntuples)   NTUPLES=$2; shift 2;;
    --skew)      SKEW=$2; shift 2;;
    --scale-min) SCALE_MIN=$2; shift 2;;
    *) echo "usage: $0 [--devices N] [--ntuples N] [--skew Z] [--scale-min N]" >&2
       exit 2;;
  esac
done
[[ -n "$SCALE_MIN" ]] && export SMJ_SHARDED_GEN_MIN="$SCALE_MIN"

cd "$(dirname "$0")/.."
out=$(python -m avx_sort_merge_joins_tpu -a m-way -n "$DEVICES" \
        -r "$NTUPLES" -s "$NTUPLES" -z "$SKEW") || {
  echo "[workload-a] driver FAILED" >&2; exit 1; }
echo "$out"
# exactness gate: the pk-fk workload's count must equal |S|
if [[ "$out" != *"Results = $NTUPLES"* ]]; then
  echo "[workload-a] FAIL: expected 'Results = $NTUPLES'" >&2
  exit 1
fi
echo "[workload-a] PASS: count == |S| == $NTUPLES over $DEVICES devices"
