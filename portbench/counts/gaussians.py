"""The per-gaussian stages of a training step, counted from shapes: voxel
skin weights, LBS, covariances, SH colours, projection and masked Adam.

Every slot of the padded capacity is touched by each stage, so the
counts are per slot. Bytes: each leaf read once forward and its
gradient written once; Adam reads the parameter, its gradient and both
moments and writes the parameter and the moments; the grid sample reads
8 corners of B+1 weights. Operations are far below the bytes' time at
the card's float32 rate, so the stages are bound by bytes.
"""
from __future__ import annotations

from portbench.counts.peaks import least_s

PARAM_FLOATS = 3 + 3 + 45 + 3 + 4 + 1  # xyz, SH dc and rest, scale, rot, opacity


def step_bytes(capacity: int, bones: int = 20) -> float:
    per_slot = 4 * (PARAM_FLOATS * (1 + 1 + 4 + 3)  # forward, grad, Adam
                    + 8 * (bones + 1))  # voxel corners
    return float(capacity * per_slot)


def step_least_s(capacity: int, bones: int = 20) -> float:
    return least_s(nbytes=step_bytes(capacity, bones))


def forward_least_s(capacity: int, bones: int = 20) -> float:
    """The same stages forward only (a render): each leaf and the voxel
    corners read once."""
    return least_s(nbytes=float(capacity * 4 * (PARAM_FLOATS
                                                + 8 * (bones + 1))))


def image_losses_least_s(height: int, width: int) -> float:
    """L1 and SSIM on an [H, W, 3] image, forward and backward: the
    render and the gt read, the image gradient written; SSIM's five
    11-tap separable blurs, two passes, both ways."""
    px = height * width * 3
    return least_s(flops=2 * 5 * 2 * 11 * 2 * px, nbytes=3 * 4 * px)
