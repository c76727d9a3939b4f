#!/bin/bash
# Disk footprint and wall time of the port's CPU tests:
#   scripts/port_test_footprint.sh [CHECKOUT] [RUNS]
# runs `python -m pytest tests/ -q -k torch_port -p xdist -n 6 --dist loadfile`
# RUNS times in a row (default 3) in CHECKOUT (default this checkout), with
# pytest's default retention of three basetemps, and prints a line per run:
# its exit code and summary, its seconds, the bytes its basetemp holds when it
# ends, and the free bytes of the basetemp's file system before it, after it
# and the least seen during it (sampled every 2 s); then the bytes that all
# the basetemps pytest keeps hold together.
set -uo pipefail
here=$(cd "$(dirname "$0")/.." && pwd)
checkout=$(cd "${1:-$here}" && pwd)
runs=${2:-3}
base="$(python3 -c 'import tempfile; print(tempfile.gettempdir())')/pytest-of-$(id -un)"
free() { df -B1 --output=avail "$(dirname "$base")" | tail -1 | tr -d ' '; }
samples=$(mktemp)
log=$(mktemp)
(while true; do free >> "$samples"; sleep 2; done) &
sampler=$!
trap 'kill $sampler 2>/dev/null; rm -f "$samples" "$log"' EXIT
for i in $(seq "$runs"); do
  : > "$samples"
  before=$(free)
  start=$(date +%s.%N)
  (cd "$checkout" && python -m pytest tests/ -q -k torch_port -p xdist -n 6 --dist loadfile \
    -p no:cacheprovider) > "$log" 2>&1
  rc=$?
  seconds=$(awk -v a="$start" -v b="$(date +%s.%N)" 'BEGIN { printf "%.1f", b - a }')
  after=$(free)
  least=$( (cat "$samples"; echo "$after") | sort -n | head -1)
  current=$(readlink -f "$base/pytest-current")
  grep -a '^FAILED\|^ERROR' "$log"
  echo "run $i: rc $rc ($(tail -1 "$log" | tr -d '=')), $seconds s, basetemp $current" \
    "$(du -sb "$current" | cut -f1) bytes; free before $before, after $after, least $least"
done
echo "kept basetemps: $(ls -d "$base"/pytest-[0-9]* | xargs -n1 basename | tr '\n' ' ')" \
  "$(du -sb "$base" | cut -f1) bytes"
