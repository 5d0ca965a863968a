#!/bin/bash
# Time this checkout against an unpacked copy of another commit on one
# NVIDIA card, both in one call and in turns (other, this, this, other):
#
#     git archive <commit> | tar -x -C _parent     # a git-ignored directory
#     bash scripts/torch_compare_commits.sh _parent [OUT_DIR]
#
# Runs scripts/torch_composite_bench.py and scripts/torch_head_bench.py
# (this checkout's timing, the other commit's kernels through --package)
# and each checkout's own scripts/torch_step_profile.py without and with
# --lpips, keeps every run's last JSON line under OUT_DIR (default
# outputs/compare) and prints one summary line per run.
set -u
other=${1:?directory of the other commit}
out=${2:-outputs/compare}
mkdir -p "$out"
out=$(cd "$out" && pwd)
profile() {  # name, directory, arguments
  (cd "$2" && python3 scripts/torch_step_profile.py $3 2>/dev/null | tail -1) > "$out/$1.json"
}
python3 scripts/torch_composite_bench.py --package "$other" | tail -1 > "$out/bench_other_1.json"
python3 scripts/torch_composite_bench.py | tail -1 > "$out/bench_this_1.json"
python3 scripts/torch_composite_bench.py | tail -1 > "$out/bench_this_2.json"
python3 scripts/torch_composite_bench.py --package "$other" | tail -1 > "$out/bench_other_2.json"
python3 scripts/torch_head_bench.py --package "$other" | tail -1 > "$out/head_other_1.json"
python3 scripts/torch_head_bench.py | tail -1 > "$out/head_this_1.json"
python3 scripts/torch_head_bench.py | tail -1 > "$out/head_this_2.json"
python3 scripts/torch_head_bench.py --package "$other" | tail -1 > "$out/head_other_2.json"
for cell in plain lpips; do
  args=""
  [ "$cell" = lpips ] && args="--lpips"
  profile "${cell}_other_1" "$other" "$args"
  profile "${cell}_this_1" . "$args"
  profile "${cell}_this_2" . "$args"
  profile "${cell}_other_2" "$other" "$args"
done
python3 - "$out" <<'PY'
import glob
import json
import sys

for path in sorted(glob.glob(sys.argv[1] + "/*.json")):
    try:
        d = json.load(open(path))
    except ValueError as exc:
        print(path, "unreadable:", exc)
        continue
    if "stages" in d:
        print(path, d["card"], "head sweep ms fwd", d["fwd_ms"], "bwd",
              d["bwd_ms"], "bwd da only", d["bwd_da_ms"], "per stage",
              [(r["fwd_ms"], r["bwd_ms"], r["bwd_da_ms"]) for r in d["stages"]])
    elif "bench" in d:
        print(path, d["card"], {k: (d[k]["fwd_ms"], d[k]["bwd_ms"])
                                for k in ("bench", "spread")})
    else:
        print(path, d["card"], "device ms/step", d["device_busy_ms_per_step"],
              "busy share", d["device_busy_share"], "device ops/step",
              d["device_ops_per_step"], "step median ms", d["step_ms_median"],
              "profiled wall ms/step", d["profiled_wall_ms_per_step"])
PY
