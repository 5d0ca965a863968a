"""The share of the window that the host spends inside the trainer's
densify events and opacity resets (spans around the Trainer's
densify_step and opacity_reset); nothing when no event fell in the
window."""
LAYER, UNIT, MOVES = "trainer", "%", "train_step_ms"


def read(layer: dict):
    if not layer.get("events") or not layer.get("window_s"):
        return None
    return 100.0 * layer["event_s"] / layer["window_s"]
