"""Run one cell as portbench/run.py --trace 1 does, with the program's
spans.

    python3 portbench/spans_run.py --workload <cell> --seed <n> \
        --seconds <s>

The drivers under portbench/drivers/ take no spans of their own. This
runs a cell's driver with the recorder of manus_tpu_torch/utils/trace.py
on from before set-up, the traced stretch under an AnchoredProfile
(portbench/spans.py), and four keys added to the driver's layer: the
spans, their join with the stretch, and the window's two ends. Standard
error gets the join's table (device idle, host self time, launches and
blocking calls by span, a step or frame) and the spread of a step's or
frame's time over the spans beneath it; the last line of standard
output is run.py's result line with the seven readings of
portbench/spans.py under "spans", the window's time a step or frame
under "window_ms", and the number of spans the recorder dropped. A
run.py --trace 1 run of the same seed is the same run with the recorder
off. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from types import SimpleNamespace

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import run as run_mod  # noqa: E402
from portbench import spans as sp  # noqa: E402
from portbench import trace as tr  # noqa: E402
from portbench.registry import Registry  # noqa: E402


def run(workload: str, seed: int, seconds: float, device: str = "cuda",
        scale=None, note=None) -> dict:
    """One traced run of `workload` with the spans: run.py's result line,
    plus "spans", "window_ms" and "spans_dropped"."""
    from manus_tpu_torch.utils import trace as rec

    note = note or (lambda msg: print(f"spans_run: {msg}", file=sys.stderr))
    registry = Registry()
    made, seen = [], {}

    def anchored_profile():
        made.append(sp.AnchoredProfile(rec.clock_anchor))
        return made[-1]

    find_driver = registry.driver

    def driver(name):
        mod = find_driver(name)

        def run_with_spans(ctx):
            out = mod.run(ctx)
            rec.disable()
            records = rec.records()
            seen.update(layer=out["layer"], dropped=rec.dropped())
            out["layer"].update(
                spans=records, window_t0=ctx.t_window,
                window_t_end=ctx.t_window + out["layer"]["window_s"],
                span_join=sp.join_profile(made[-1], records, rec.threads())
                if made else None)
            return out

        return SimpleNamespace(run=run_with_spans)

    registry.driver = driver
    saved = tr.Profile
    tr.Profile = anchored_profile
    rec.clear()
    rec.enable()
    try:
        line = run_mod.run_cell(registry, workload, seed, seconds, True,
                                device=device, scale=scale)
    finally:
        tr.Profile = saved
        rec.disable()
        rec.clear()
    layer = seen["layer"]
    line["spans"] = {}
    for name, (unit, _, cell, _, read) in sp.READINGS.items():
        value = read(layer) if cell == workload else None
        if value is not None:
            line["spans"][name] = dict(value=value, unit=unit)
    line["window_ms"] = layer.get("step_ms", layer.get("frame_ms"))
    line["spans_dropped"] = seen["dropped"]
    what = "step" if "trace_steps" in layer else "frame"
    per = layer.get(f"trace_{what}s") or 1
    if layer["span_join"] is not None:
        note(layer["span_join"].table(per, what))
    root = "fit.step" if what == "step" else "composite.frame"
    spread = sp.step_spread(layer, root)
    if spread:
        note(f"ms a {root} in the window by the spans beneath it, "
             f"p10 / median / p90:")
        for name, (p10, med, p90) in spread.items():
            note("  %-20s %8.3f %8.3f %8.3f" % (name, p10, med, p90))
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("spans_run: needs a CUDA card", file=sys.stderr)
        return 2
    line = run(args.workload, args.seed, args.seconds)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
