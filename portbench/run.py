"""Run one cell of the port's benchmark once, on this machine's card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is an entry of BENCHMARK.json: a configuration
(portbench/configs/), a traffic mix (portbench/traffic/) and the driver
the configuration names (portbench/drivers/). The driver sets up from
the seed, measures for --seconds and checks what the measured path
produced against the plain reference (portbench/reference/); with
--trace 1 a further stretch runs under torch.profiler and the per-layer
readers (portbench/metrics/) take their numbers from it. The last line
of standard output is one JSON object: correct, attempted, failed,
metrics, device (and breakdown with --trace 1), then the compared
numbers with their limits, which also close standard error.

Needs a CUDA card: without one, or with fewer than the cell asks for,
it exits with 2 and prints no result. Set-up time (setup_s) runs from
the start of this process to the start of the window.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every kernel cache inside the checkout, at fixed paths
CACHE = ROOT / ".portbench_cache"
os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
os.environ.setdefault("USE_FLAX", "0")
sys.path.insert(0, str(ROOT))

# top-level module names that must not be loaded: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "manus_tpu", "bench")


class RunContext:
    """What a driver gets: the cell's files, the run's arguments, and the
    hooks that mark the window's start and read the memory peak."""

    def __init__(self, config, traffic, seed, seconds, trace, device, tmpdir,
                 scale=None, log=None, note=None):
        self.config, self.traffic = config, traffic
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.tmpdir = device, tmpdir
        self.scale = scale or {}
        self.log = log or (lambda *a, **k: None)
        # the harness's own diagnostics, on standard error
        self.note = note or (lambda msg: print(f"portbench: {msg}",
                                               file=sys.stderr))
        self.t_window = None
        self.memory_peak_bytes = 0

    def window_started(self) -> float:
        self.t_window = time.perf_counter()
        return self.t_window

    def read_memory_peak(self):
        import torch

        if self.device != "cpu":
            self.memory_peak_bytes = max(
                torch.cuda.max_memory_allocated(i)
                for i in range(torch.cuda.device_count()))


def limits_for(workload: str) -> dict:
    with open(Path(__file__).resolve().parent / "limits"
              / f"{workload}.json") as f:
        return {k: v for k, v in json.load(f).items()
                if not k.startswith("_")}


def run_cell(registry, workload: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", scale=None,
             tmpdir=None) -> dict:
    """One run of `workload`: the result line as a dict (without the
    check for a card, which main makes)."""
    w = registry.workload(workload)
    config = registry.config(w["config"])
    traffic = registry.traffic(w["traffic"])
    # a traffic mix may name its own driver (the fine-tune of a config
    # whose frames another mix renders)
    driver = registry.driver(traffic.get("driver", config["driver"]))
    with tempfile.TemporaryDirectory(dir=tmpdir) as tmp:
        ctx = RunContext(config, traffic, seed, seconds, trace, device, tmp,
                         scale=scale)
        out = driver.run(ctx)
    setup_s = ctx.t_window - T_PROCESS
    metrics = {}
    if trace:
        for m in registry.per_layer(workload):
            value = registry.metric_reader(m["name"]).read(out["layer"])
            if value is not None:
                metrics[m["name"]] = dict(value=value, unit=m["unit"])
    else:
        values = dict(out["end_to_end"], setup_s=setup_s)
        for m in registry.end_to_end(workload):
            metrics[m["name"]] = dict(value=values[m["name"]], unit=m["unit"])
    limits = limits_for(workload)
    compared = {k: dict(value=v, limit=limits[k])
                for k, v in out["compared"].items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in compared.values()) and out["failed"] == 0
    device_info = dict(platform="gpu" if device != "cpu" else "cpu",
                       kind=_device_name(device), count=w["chips"],
                       memory_peak_bytes=ctx.memory_peak_bytes)
    line = dict(correct=correct, attempted=out["attempted"],
                failed=out["failed"], metrics=metrics, device=device_info)
    tr = out["layer"].get("trace")
    if trace and tr is not None:
        device_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
        line["breakdown"] = dict(device_ops=tr.top_ops(),
                                 idle_gaps=tr.top_gaps())
    line["compared"] = compared
    return line


def _device_name(device: str) -> str:
    if device == "cpu":
        return "cpu"
    import torch

    return torch.cuda.get_device_name(0)


def forbidden_modules() -> list:
    loaded = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(loaded & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch

    from portbench.registry import Registry

    registry = Registry()
    chips = registry.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f" available", file=sys.stderr)
        return 2
    line = run_cell(registry, args.workload, args.seed, args.seconds,
                    bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}", file=sys.stderr)
        return 3
    for name, c in line["compared"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
