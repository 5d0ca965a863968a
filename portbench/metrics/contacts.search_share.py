"""The share of a traced stretch of frames spent in the contact search:
host spans around the composite renderer's calls into ops/contacts,
each synchronised with the card at both ends, over the stretch's wall
time."""
LAYER, UNIT, MOVES = "contacts", "%", "composite_frame_ms"


def read(layer: dict):
    tr = layer.get("trace")
    if tr is None or not layer.get("search_s"):
        return None
    return 100.0 * layer["search_s"] / tr.window_s
