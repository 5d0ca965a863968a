"""Trilinear sampling of the voxel skinning-weight grid.

torch.nn.functional.grid_sample's semantics with align_corners=True and
zero padding, as the reference's voxel skinning uses them, on a grid laid
out [D, H, W, C] and sampled at normalised (x, y, z) in [-1, 1], where x
indexes W, y indexes H and z indexes D. The eight corners are one gather
from the flattened grid.
"""
from __future__ import annotations

import torch

from manus_tpu_torch.ops import deform


def grid_sample_trilinear(grid: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """grid: [D, H, W, C]; coords: [N, 3] normalised (x, y, z). Returns
    [N, C]; corners outside the grid weigh 0. Differentiable in coords
    (and grid)."""
    d, h, w, c = grid.shape
    x, y, z = coords.unbind(-1)
    # align_corners=True: -1 -> 0, +1 -> size - 1
    fx = (x + 1.0) * 0.5 * (w - 1)
    fy = (y + 1.0) * 0.5 * (h - 1)
    fz = (z + 1.0) * 0.5 * (d - 1)
    x0, y0, z0 = torch.floor(fx), torch.floor(fy), torch.floor(fz)
    tx, ty, tz = fx - x0, fy - y0, fz - z0
    x0, y0, z0 = x0.to(torch.int64), y0.to(torch.int64), z0.to(torch.int64)

    idxs, wgts = [], []
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                xi, yi, zi = x0 + dx, y0 + dy, z0 + dz
                inside = ((xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
                          & (zi >= 0) & (zi < d))
                idxs.append((zi.clamp(0, d - 1) * h + yi.clamp(0, h - 1)) * w
                            + xi.clamp(0, w - 1))
                wx = tx if dx else 1.0 - tx
                wy = ty if dy else 1.0 - ty
                wz = tz if dz else 1.0 - tz
                wgts.append(torch.where(inside, wx * wy * wz, 0.0))
    idx = torch.stack(idxs)  # [8, N]
    wgt = torch.stack(wgts)  # [8, N]
    vals = grid.reshape(-1, c).index_select(0, idx.reshape(-1)).reshape(
        8, coords.shape[0], c)
    return (wgt[:, :, None] * vals).sum(0)


def skinning_weights_from_voxel_grid(xyz: torch.Tensor,
                                     grid_center: torch.Tensor,
                                     grid_scale: torch.Tensor,
                                     grid_weights: torch.Tensor) -> torch.Tensor:
    """Per-point skin weights: the grid sampled at the points' normalised
    coordinates, then normalised to sum to one. A point that samples all
    zeros (outside the grid) gets the last, background channel, so its
    blended transform stays the identity's, not NaN.

    CUDA tensors take the kernel pair of csrc/deform.cu
    (`ops.deform.skin_sample_cuda`: float32, at most DEFORM_MAX_CHANNELS
    channels, a gradient to xyz alone), CPU tensors the plain version
    (`skinning_weights_from_voxel_grid_torch`)."""
    if xyz.is_cuda:
        return deform.skin_sample_cuda(xyz, grid_center, grid_scale,
                                       grid_weights)
    return skinning_weights_from_voxel_grid_torch(xyz, grid_center,
                                                  grid_scale, grid_weights)


def skinning_weights_from_voxel_grid_torch(xyz: torch.Tensor,
                                           grid_center: torch.Tensor,
                                           grid_scale: torch.Tensor,
                                           grid_weights: torch.Tensor
                                           ) -> torch.Tensor:
    """skinning_weights_from_voxel_grid's plain version."""
    xyz_norm = (xyz - grid_center.reshape(1, 3)) / grid_scale.reshape(1, 3)
    wts = grid_sample_trilinear(grid_weights, xyz_norm)
    denom = wts.sum(-1, keepdim=True)
    wts = wts / torch.where(denom == 0.0, 1.0, denom)
    bg = torch.zeros_like(wts[:1])
    bg[0, -1] = 1.0
    return torch.where(denom == 0.0, bg, wts)
