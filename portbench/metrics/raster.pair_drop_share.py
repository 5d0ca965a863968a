"""The share of the (gaussian, tile) pairs that binning dropped in a
traced stretch of training steps: the port's `raster.pairs_dropped`
counter over its `raster.pairs_emitted`, summed over the stretch's
views. Nothing where the program records no such counter."""
LAYER, UNIT, MOVES = "raster", "%", "train_step_ms"


def read(layer: dict):
    counts = layer.get("stretch_counts") or {}
    emitted = counts.get("raster.pairs_emitted")
    if not emitted:
        return None
    return 100.0 * counts.get("raster.pairs_dropped", 0.0) / emitted
