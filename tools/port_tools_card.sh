#!/usr/bin/env bash
# The port's measurement tools on one card, each at its defaults, after the
# card's name and power limit (nvidia-smi).  Each tool's JSON lines go to
# OUT/<tool>.jsonl and its stderr to OUT/<tool>.err; inverse_bench's grid
# goes to OUT/inverse_routing_h100.jsonl behind a "# <card>, <power limit>"
# line, the form of gpu_rscode_torch/data/inverse_routing_h100.jsonl.
#
#   bash tools/port_tools_card.sh [OUT]        # OUT defaults to chiprun_out/tools
#   (run from the repo root on a machine with one CUDA card)
#
# Exits non-zero if any tool did.
set -u
out=${1:-chiprun_out/tools}
mkdir -p "$out"
smi=$(nvidia-smi --query-gpu=name,power.limit --format=csv,noheader)
echo "$smi"
status=0

run() {
  local name=$1 dest=$2
  shift 2
  local t0=$SECONDS
  python3 -m "gpu_rscode_torch.tools.$name" "$@" >> "$dest" 2> "$out/$name.err"
  local rc=$?
  echo "$name rc=$rc $((SECONDS - t0)) s"
  tail -n 3 "$dest" | cut -c1-2000
  [ $rc -eq 0 ] || status=1
}

echo "# $smi" > "$out/inverse_routing_h100.jsonl"
run inverse_bench "$out/inverse_routing_h100.jsonl"
for tool in mesh_bench mesh_overhead strategy_bench k_sweep w16_bench stream_bench; do
  : > "$out/$tool.jsonl"
  run "$tool" "$out/$tool.jsonl"
done
echo "$smi"
exit $status
