"""The share of the fine-tune's window that run_composite's loop spends
making its batches: the port's `composite.finetune_batch` spans (the
draw of a frame and view, get_batch and the copies to the card, on the
main thread) that started in the window, up to its end, over the
window. Nothing where the program opens no such span."""
LAYER, UNIT, MOVES = "composite fine-tune", "%", "train_step_ms"


def read(layer: dict):
    from portbench.spans import _share

    return _share(layer, ("composite.finetune_batch",))
