"""Time variants of the port's LPIPS head kernels on one NVIDIA card.

    python3 scripts/torch_head_tune.py [--variants 4:4:2,2:2:4] [--reps N]

A variant is F:B:R, the constants kFwdCtasPerSm, kBwdCtasPerSm and
kRowsInFlight of manus_tpu_torch/csrc/lpips_head.cu (the CTAs an SM holds
of each kernel, which caps its registers and sizes its grid, and the rows
a lane group loads at once at C <= 256, half as many at C = 512). For each, the constants are rewritten in a
copy of the source under the build directory, the copy is compiled
(ptxas's registers and spills are printed) and, on the 512x512 features
of scripts/torch_head_bench.py, each stage's forward is checked against
its plain version (chip_smoke.HEAD_FWD_RTOL) and the forward, the
backward and the da-only backward are timed as there (CUDA-graph
replays, HBM-cold). The last line is the whole result as JSON.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_head_bench  # noqa: E402

CONSTANTS = ("kFwdCtasPerSm", "kBwdCtasPerSm", "kRowsInFlight")


def build_variant(conv, cuda_build, values) -> ctypes.CDLL:
    src = (cuda_build.CSRC_DIR / "lpips_head.cu").read_text()
    for name, value in zip(CONSTANTS, values):
        src, n = re.subn(rf"constexpr int {name} = \d+;",
                         f"constexpr int {name} = {value};", src)
        if n != 1:
            raise ValueError(f"{name} not found in lpips_head.cu")
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = cuda_build.BUILD_DIR / f"lpips_head_{'_'.join(map(str, values))}.cu"
    cu.write_text(src)
    out = cu.with_suffix(".so")
    log = subprocess.run(
        [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", str(out),
         str(cu)], capture_output=True, text=True, check=True)
    for line in (log.stdout + log.stderr).splitlines():
        if "registers" in line or ("spill" in line
                                   and "0 bytes spill stores" not in line):
            print("  " + line.strip())
    return conv.HEAD_LIBRARY.open(out)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default="4:4:2")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    chip_smoke = torch_head_bench.load_chip_smoke(torch_head_bench.ROOT)
    import torch

    if not torch.cuda.is_available():
        print("torch_head_tune: no CUDA device", file=sys.stderr)
        return 1
    from manus_tpu_torch.utils import cuda_build

    conv = chip_smoke.conv_mod
    dev = torch.device("cuda")
    result = dict(card=chip_smoke.gpu_name_and_power(), variants={})
    inputs = torch_head_bench.stage_inputs(chip_smoke, dev)
    for variant in args.variants.split(","):
        values = tuple(int(v) for v in variant.split(":"))
        print(f"variant {dict(zip(CONSTANTS, values))}:")
        lib = build_variant(conv, cuda_build, values)
        conv.HEAD_LIBRARY.lib = lib
        conv._head_workspaces.clear()
        stages = []
        for a, b, L, lin, ct in inputs:
            got = conv.head_fwd_cuda(a, b, lin, L).item()
            want = conv.head_fwd_torch(a, b, lin, L).item()
            row = torch_head_bench.time_stage(chip_smoke, a, b, L, lin, ct,
                                              args.reps)
            row["fwd_rel_err"] = abs(got - want) / abs(want)
            if row["fwd_rel_err"] > chip_smoke.HEAD_FWD_RTOL:
                raise RuntimeError(f"variant {variant}: forward {got} "
                                   f"against {want}")
            stages.append(row)
            print("  " + json.dumps(row))
        result["variants"][variant] = dict(stages=stages,
                                           **torch_head_bench.sweep(stages))
        print(f"  sweep {json.dumps(torch_head_bench.sweep(stages))}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
