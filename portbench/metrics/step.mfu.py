"""The training step's share of the card's peak: the least time the
card needs for the step's work (portbench/counts: VGG16 at the bf16
peak, the composite's evaluations, the per-gaussian stages and the image
losses, each at the larger of its operations and its bytes) over the
window's measured time a step."""
LAYER, UNIT, MOVES = "train step", "%", "train_step_ms"


def read(layer: dict):
    work = layer.get("work_s")
    if not work or "step_ms" not in layer:
        return None
    least = sum(v for k, v in work.items() if k != "evaluations")
    return 100.0 * least / (layer["step_ms"] * 1e-3)
