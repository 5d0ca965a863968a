"""Device operations a training step in the profiler's trace (kernels,
copies and sets): the host's launch count a step."""
LAYER, UNIT, MOVES = "train step", "launches/step", "train_step_ms"


def read(layer: dict):
    tr = layer.get("trace")
    if tr is None or not layer.get("trace_steps") or not tr.ops:
        return None
    return tr.count() / layer["trace_steps"]
