"""Binning's share of the card's busy time in a traced stretch of
training steps: the device time of the operations launched inside the
port's `raster.bin` spans (the pairs, their sort, the tiles' segments),
joined to the stretch by portbench/spans.py's SpanJoin, over the
stretch's busy time. Nothing where the program opens no such span."""
LAYER, UNIT, MOVES = "raster", "%", "train_step_ms"


def read(layer: dict):
    join = layer.get("span_join")
    if join is None or join.busy_s <= 0:
        return None
    ids = join.of_name("raster.bin")
    if not ids:
        return None
    return 100.0 * join.device_s_within(ids) / join.busy_s
