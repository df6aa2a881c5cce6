#!/bin/sh
# Run chip_smoke.py of a parent commit and of this tree alternately on one
# card (parent, change, change, parent), so that their numbers share a card,
# a power limit and a host.  The parent is unpacked from git under build/
# (ignored by git) before the run:
#
#   rm -rf build/parent && mkdir -p build/parent
#   git archive <parent commit> | tar -x -C build/parent
#   sh scripts/chip_compare.sh build/parent [LOG_DIR]   # from the repository root
#
# Each run's whole output goes to LOG_DIR/<n>-<tree>.log (default
# build/compare); the key lines of each (end-to-end metrics and kernel rows)
# are printed.
set -eu
parent=$1
here=$(pwd)
out="$here/${2:-build/compare}"
mkdir -p "$out"
n=0
for tree in parent change change parent; do
    n=$((n + 1))
    if [ "$tree" = parent ]; then dir=$parent; else dir=$here; fi
    log="$out/$n-$tree.log"
    (cd "$dir" && python3 chip_smoke.py) > "$log" 2>&1 || {
        echo "run $n ($tree) failed:"; tail -n 30 "$log"; exit 1; }
    echo "== run $n: $tree"
    grep -E '^(card|main|stream: (base|delta|spans|compact_all|block_expand|profiled))|^kernel |^kernels:' "$log" || true
done
