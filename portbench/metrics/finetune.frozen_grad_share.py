"""The share of the rows whose gradient the fine-tune's backward works
out that no optimiser reads: the port's `raster.grad_rows` counter (the
rows each projection backward covers) less its `composite.rows_trained`
(the trained model's slots in the scene, a step), over the former,
summed over a traced stretch of fine-tune steps. It reads 0 where the
backward covers the trained rows alone. Nothing where the program
records no such counters."""
LAYER, UNIT, MOVES = "composite fine-tune", "%", "train_step_ms"


def read(layer: dict):
    counts = layer.get("stretch_counts") or {}
    rows = counts.get("raster.grad_rows")
    trained = counts.get("composite.rows_trained")
    if not rows or trained is None:
        return None
    return 100.0 * (rows - trained) / rows
