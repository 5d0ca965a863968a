"""A composite frame's share of the card's peak: the least time the card
needs for the frame's work (portbench/counts: the two contact searches
at the bytes they must move, the panels' composite evaluations, the
hand's per-gaussian stages) over the window's measured time a frame."""
LAYER, UNIT, MOVES = "composite render", "%", "composite_frame_ms"


def read(layer: dict):
    work = layer.get("work_s")
    if not work or "frame_ms" not in layer:
        return None
    least = sum(v for k, v in work.items() if k != "evaluations")
    return 100.0 * least / (layer["frame_ms"] * 1e-3)
