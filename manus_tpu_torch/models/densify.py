"""Densification statistics (the accumulation side of adaptive density
control): viewspace gradient norms in the CUDA NDC half-size convention
(pixel gradient * 0.5*[W, H]) and per-slot max 2D radii."""
from __future__ import annotations

from typing import NamedTuple

import torch


class DensifyStats(NamedTuple):
    """Running densification signals, all [N_max] float32."""

    grad_accum: torch.Tensor  # sum of viewspace grad norms
    denom: torch.Tensor  # number of accumulations
    max_radii2d: torch.Tensor  # max screen radius seen


def init_stats(capacity: int, device) -> DensifyStats:
    def z():
        return torch.zeros(capacity, dtype=torch.float32, device=device)

    return DensifyStats(grad_accum=z(), denom=z(), max_radii2d=z())


def accumulate_stats(
    stats: DensifyStats,
    viewspace_grad: torch.Tensor,  # [N, 2] d(loss)/d(means2d) in pixels
    radii: torch.Tensor,  # [N] int32
    width: int,
    height: int,
) -> DensifyStats:
    """Add one view's signals, rescaled by 0.5*[W, H] so thresholds tuned
    on the CUDA rasterizer transfer unchanged."""
    visible = radii > 0
    scaled = viewspace_grad * viewspace_grad.new_tensor(
        [0.5 * width, 0.5 * height])
    norm = torch.linalg.norm(scaled, dim=-1)
    return DensifyStats(
        grad_accum=stats.grad_accum + torch.where(visible, norm, 0.0),
        denom=stats.denom + visible.to(torch.float32),
        max_radii2d=torch.maximum(
            stats.max_radii2d,
            torch.where(visible, radii.to(torch.float32), 0.0),
        ),
    )
