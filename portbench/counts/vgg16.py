"""VGG16's 13 3x3 convolutions, counted from their shapes: the LPIPS
loss's convolution work at an image size."""
from __future__ import annotations

# (input channels, output channels) of each conv, by stage; a 2x2 pool
# before every stage but the first quarters the pixels
STAGES = (((3, 64), (64, 64)), ((64, 128), (128, 128)),
          ((128, 256), (256, 256), (256, 256)),
          ((256, 512), (512, 512), (512, 512)),
          ((512, 512), (512, 512), (512, 512)))
NUM_CONVS = sum(len(s) for s in STAGES)


def layer_macs_per_pixel() -> list:
    """Multiply-adds each conv takes per pixel of the full-size image:
    9 Ci Co at its stage's resolution, 4^-stage of the pixels."""
    return [9 * ci * co / 4 ** si
            for si, stage in enumerate(STAGES) for ci, co in stage]


def macs_per_pixel() -> float:
    """All 13 convs, one way (305,856 for VGG16)."""
    return sum(layer_macs_per_pixel())


def chain_flops(height: int, width: int) -> float:
    """Operations of one pass of the 13 convs (a forward, or the input
    gradient, which has the same products) over an image: two a
    multiply-add, each stage at its pooled size."""
    total = 0.0
    for si, stage in enumerate(STAGES):
        h, w = height >> si, width >> si
        total += sum(2 * 9 * ci * co * h * w for ci, co in stage)
    return total
