"""A densify event's host time: the mean of the port's `fit.densify`
spans that started in the window (the event's launches and its own host
work; the Trainer's log line after it, which waits for the card, lies
outside the span). Nothing when no event fell in the window."""
LAYER, UNIT, MOVES = "trainer", "ms", "train_step_ms"


def read(layer: dict):
    from portbench.spans import _mean_ms

    return _mean_ms(layer, "fit.densify", "start")
