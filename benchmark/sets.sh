# The runs that set a cell's bounds, from the root of a checkout on the card:
#   bash benchmark/sets.sh TAG CELL...
# per cell: a traced run (it builds what the checkout lacks), two sets of six
# runs of BENCHMARK.json's run_seconds on the same six seeds, two more traced
# runs; each run's output in $SETS_OUT/TAG_CELL_LABEL.{out,err} (default
# benchmark/.sets), a line each on stdout.
TAG=$1; shift
OUT=${SETS_OUT:-benchmark/.sets}
SECONDS_A_RUN=$(python3 -c 'import json; print(json.load(open("BENCHMARK.json"))["run_seconds"])')
mkdir -p "$OUT"
nvidia-smi --query-gpu=name,power.limit,clocks.sm --format=csv,noheader
one() { # cell seed trace label
  python3 benchmark/run.py --workload $1 --seed $2 --seconds $SECONDS_A_RUN --trace $3 > "$OUT/${TAG}_$1_$4.out" 2> "$OUT/${TAG}_$1_$4.err"
  echo "$1 $4 seed=$2 rc=$? $(tail -1 "$OUT/${TAG}_$1_$4.out" | cut -c1-330)"
}
for C in "$@"; do
  one $C $((5100000001 + RANDOM)) 1 t1
  for S in 1 2 3 4 5 6; do one $C $((5200000000 + S * 7777)) 0 A$S; done
  for S in 1 2 3 4 5 6; do one $C $((5200000000 + S * 7777)) 0 B$S; done
  one $C $((5300000002 + RANDOM)) 1 t2
  one $C $((5300000003 + RANDOM)) 1 t3
done
