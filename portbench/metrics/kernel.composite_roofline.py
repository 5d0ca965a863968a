"""The composite kernels' share of their roofline: the least time of the
forward and backward for the evaluations the step's image needs
(portbench/counts/composite.py), over the device time a step of the
kernels of csrc/composite.cu in the trace."""
LAYER, UNIT, MOVES = "composite kernels", "%", "train_step_ms"
KERNELS = ("plan_kernel", "chunk_pass_kernel", "rewalk_kernel",
           "composite_bwd_kernel")


def is_composite(name: str) -> bool:
    return any(k in name for k in KERNELS)


def read(layer: dict):
    tr, work = layer.get("trace"), layer.get("work_s")
    if tr is None or not work or not layer.get("trace_steps"):
        return None
    device_s = tr.device_seconds(is_composite) / layer["trace_steps"]
    if device_s <= 0:
        return None
    return 100.0 * (work["composite_fwd"] + work["composite_bwd"]) / device_s
