#!/usr/bin/env bash
# What a cell's bounds and limits are set from, run on the card in one go:
#   bash portbench/calibrate.sh <cell> [sets] [traces] [controls]
# sets: two sets of six runs at run_seconds on the same six seeds;
# traces: three runs with --trace 1; controls: three --control runs.
# With no part named, all three.  Output under chiprun_out/cal_<cell>/:
# per run its standard output (the result line last) and its standard error.
set -u
cell=$1; shift
parts=${*:-sets traces controls}
out=chiprun_out/cal_$cell
mkdir -p "$out"
seconds=$(python3 -c 'import json; print(json.load(open("BENCHMARK.json"))["run_seconds"])')
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
run() { # seed seconds trace extra tag
  python3 portbench/run.py --workload "$cell" --seed "$1" --seconds "$2" \
    --trace "$3" $4 > "$out/$5.out" 2> "$out/$5.err"
  echo "== $5 seed=$1 trace=$3 $4 rc=$?"
  tail -n 1 "$out/$5.out" | cut -c1-900
  grep -E "portbench|control" "$out/$5.err" | tail -8
}
for part in $parts; do
  case $part in
    sets) for set in 1 2; do for i in 1 2 3 4 5 6; do
            run $((3000000000 + i * 7919)) "$seconds" 0 "" "s${set}_$i"
          done; done ;;
    traces) for i in 1 2 3; do
              run $((3100000000 + i * 104729)) "$seconds" 1 "" "t$i"
            done ;;
    controls) for i in 1 2 3; do
                run $((3200000000 + i * 15485863)) 8 0 --control "c$i"
              done ;;
  esac
done
