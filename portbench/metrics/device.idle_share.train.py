"""The card's idle share in a training step: 1 minus the device's busy
time a step over the window's time a step. The busy time is the union
of the device's operations over the stretch traced after the window (in
the same fit call), over its steps; the time a step is the window's,
which no profiler slowed (the profiler's own host cost lengthens a
traced step, so the traced stretch's wall time would overstate the idle
share)."""
LAYER, UNIT, MOVES = "device", "%", "train_step_ms"


def read(layer: dict):
    tr = layer.get("trace")
    if (tr is None or not tr.ops or not layer.get("trace_steps")
            or "step_ms" not in layer):
        return None
    busy_s = tr.busy_s / layer["trace_steps"]
    return 100.0 * (1.0 - busy_s / (layer["step_ms"] * 1e-3))
