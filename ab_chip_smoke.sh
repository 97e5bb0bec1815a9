#!/usr/bin/env bash
# Compare two checkouts on one card: run each one's chip_smoke.py in turns
# A, B, B, A and keep every run's log and its wall time.
#
#   bash ab_chip_smoke.sh <checkout A> <checkout B> <output dir>
#
# Each log is <output dir>/run<i>_<A|B>.log; runs.txt lists the card, then
# per run its checkout, exit code and wall seconds.  Exits nonzero if any
# run failed.
set -u
a=$(cd "$1" && pwd)
b=$(cd "$2" && pwd)
out=$3
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader \
    | tee "$out/runs.txt"
status=0
i=0
for side in A B B A; do
    i=$((i + 1))
    dir=$a
    [ "$side" = B ] && dir=$b
    t0=$(date +%s.%N)
    (cd "$dir" && python3 chip_smoke.py) > "$out/run${i}_${side}.log" 2>&1
    rc=$?
    t1=$(date +%s.%N)
    [ "$rc" -ne 0 ] && status=1
    python3 -c "print('run $i $side $dir rc=$rc wall_s=%.1f' % ($t1 - $t0))" \
        | tee -a "$out/runs.txt"
done
exit $status
