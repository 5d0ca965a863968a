"""The card's idle share in a composite frame: 1 minus the device's busy
time a frame over the window's time a frame. The busy time is the union
of the device's operations over the frames traced after the window,
over their number; the time a frame is the window's, which no profiler
slowed."""
LAYER, UNIT, MOVES = "device", "%", "composite_frame_ms"


def read(layer: dict):
    tr = layer.get("trace")
    if (tr is None or not tr.ops or not layer.get("trace_frames")
            or "frame_ms" not in layer):
        return None
    busy_s = tr.busy_s / layer["trace_frames"]
    return 100.0 * (1.0 - busy_s / (layer["frame_ms"] * 1e-3))
