#!/bin/bash
# Run chip_smoke.py of each given tree in turn on this host's card, every
# output line stamped with the seconds since that run started, and print
# the phase headers' stamps (a phase's time is the gap to the next header).
#
#   bash scripts/chip_smoke_timeline.sh <log dir> <tree> [<tree> ...]
#
# To compare two commits on one card, unpack each with `git archive` into
# a directory .gitignore lists and pass the parent first. The logs go to
# <log dir>/timeline_<tree name>.log. Exits non-zero if any run fails.
set -u
out=$1
shift
mkdir -p "$out"
out=$(cd "$out" && pwd)
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
status=0
for tree in "$@"; do
  log="$out/timeline_$(basename "$tree").log"
  (cd "$tree" && python3 -u chip_smoke.py 2>&1) | python3 -u -c '
import sys, time
t0 = time.time()
for line in sys.stdin:
    sys.stdout.write(f"{time.time() - t0:8.1f} {line}")
' > "$log"
  rc=${PIPESTATUS[0]}
  echo "$tree: exit $rc"
  [ "$rc" -eq 0 ] || status=1
  grep -E '^ *[0-9.]+ (\[[0-9]+/[0-9]+ |  phase [0-9]+: )' "$log" \
    | cut -c1-120
  tail -n 2 "$log" | cut -c1-300
done
exit $status
