"""The conv kernels' share of their roofline: the exact operations of
the VGG16 chains they ran (13 launches a chain, forward or input
gradient, each chain 2 x 305,856 operations a pixel), at the bf16 peak,
over their device time in the trace (csrc/conv3x3.cu: the conv kernel
and its split-K reduction)."""
LAYER, UNIT, MOVES = "conv kernels", "%", "train_step_ms"
CHAIN = 13


def is_conv(name: str) -> bool:
    return "conv3x3_layout_kernel" in name or "conv3x3_splitk_reduce" in name


def read(layer: dict):
    tr = layer.get("trace")
    if tr is None or not layer.get("lpips") or not layer.get("trace_steps"):
        return None
    from portbench.counts.peaks import BF16_FLOP_PER_S

    launches = tr.count(lambda n: "conv3x3_layout_kernel" in n)
    device_s = tr.device_seconds(is_conv)
    if launches == 0 or device_s <= 0:
        return None
    flops = launches / CHAIN * layer["conv_flops_per_chain"]
    return 100.0 * flops / BF16_FLOP_PER_S / device_s
