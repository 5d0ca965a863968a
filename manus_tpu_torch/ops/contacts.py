"""Hand-object contacts: nearest-neighbour distances turned into a 0-1
contact signal and colours, the NOCS colour grid over the canonical hand,
and IoU/F1 of contact masks (the reference's gaussian_utils.py:50-98,
514-577 and get_iou_ours.py:162-232).

The nearest neighbours are ops/knn.nearest_neighbor, |x|^2 + |y|^2 -
2 x.y in full float32 whatever the caller's TF32 setting: on a card the
search kernel of csrc/knn.cu (one pass, no distance matrix in device
memory, float32 FMAs), on the CPU the plain blockwise version. Near
contact the expansion is ill-conditioned: at the hand's scale (|x|^2 ~
1e-2 m^2) float32 leaves an error of ~1e-9 on d^2 on either path, so a
distance under ~1e-4 m is known to no better than ~3e-5 m.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from manus_tpu_torch.ops.grid_sample import grid_sample_trilinear
from manus_tpu_torch.ops.knn import nearest_neighbor
from manus_tpu_torch.utils.colormap import apply_colormap
from manus_tpu_torch.utils.device import resolve_device

CONTACT_THRESHOLD = 0.004  # metres; the reference's get_cmap c_thresh


def contact_map(pt1: torch.Tensor, pt2: torch.Tensor,
                pt1_valid: torch.Tensor | None = None,
                pt2_valid: torch.Tensor | None = None,
                c_thresh: float = CONTACT_THRESHOLD, cmap_type: str = "gray"):
    """Contact signal of each point of pt1 [N, 3] against pt2 [M, 3]:
    1 - min(dist, c_thresh) / c_thresh, 0 where pt1_valid is false; rows
    of pt2 where pt2_valid is false are never the neighbour. Returns
    (d01 [N] in [0, 1], idx [N] int32, colors [N, 3])."""
    dist, idx = nearest_neighbor(pt1, pt2, pt2_valid=pt2_valid)
    d01 = 1.0 - dist.clamp(0.0, c_thresh) / c_thresh
    if pt1_valid is not None:
        d01 = torch.where(pt1_valid, d01, 0.0)
    return d01, idx, apply_colormap(d01, cmap_type)


class NocsGrid(NamedTuple):
    points: torch.Tensor  # [D, H, W, 3]
    colors: torch.Tensor  # [D, H, W, 3]
    center: torch.Tensor  # [3]
    scale: torch.Tensor  # [3]


def get_nocs_grid(keypoints, res: int, ratio=(1.0, 1.0, 1.0),
                  device=None) -> NocsGrid:
    """Normalised-object-coordinate colour grid over the canonical hand's
    bounding box (the reference's get_nocs_grid): keypoints [K, 3] of the
    rest skeleton (Bones.keypoints()), res cells over the longest axis
    scaled per axis by `ratio`, the centre 3 cm below the box's; on
    `device` (None: the card)."""
    device = resolve_device(device)
    keypts = (keypoints.cpu().numpy() if torch.is_tensor(keypoints)
              else np.asarray(keypoints))
    cano_min, cano_max = keypts.min(axis=0), keypts.max(axis=0)
    center = (cano_max + cano_min) / 2 + np.array([0, 0, -0.03])
    x_r, y_r, z_r = ratio
    res_scaled = (res / np.array([x_r, y_r, z_r])).astype(np.int32)
    d, h, w = int(res_scaled[2]), int(res_scaled[1]), int(res_scaled[0])
    zs, ys, xs = np.meshgrid(np.linspace(-1, 1, d), np.linspace(-1, 1, h),
                             np.linspace(-1, 1, w), indexing="ij")
    pts = np.stack([xs, ys, zs], axis=-1).astype(np.float32)
    colors = (pts + 1.0) / 2.0
    scale = np.linalg.norm(cano_max - cano_min) / 2
    scale = np.array([scale * z_r, scale * y_r, scale * x_r], np.float32)
    points = pts * scale + center.astype(np.float32)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    return NocsGrid(points=t(points), colors=t(colors), center=t(center),
                    scale=t(scale))


def get_nocs_colors(xyz: torch.Tensor, grid: NocsGrid) -> torch.Tensor:
    """Trilinear NOCS colour at each position [N, 3] (the reference's
    get_nocs_colors)."""
    norm = (xyz - grid.center[None]) / grid.scale[None]
    return grid_sample_trilinear(grid.colors, norm)


def _bool(mask) -> torch.Tensor:
    return torch.as_tensor(np.asarray(mask) if not torch.is_tensor(mask)
                           else mask).to(torch.bool)


def contact_iou_f1(pred_mask, gt_mask):
    """IoU and F1 of two binary masks (tensors or arrays), 0-d float32
    tensors computed as the JAX package does (counts cast to float32); an
    empty union scores 0."""
    pred, gt = _bool(pred_mask), _bool(gt_mask)

    def count(x):
        return x.sum().to(torch.float32)

    inter, union = count(pred & gt), count(pred | gt)
    iou = inter / union.clamp(min=1)
    fp, fn = count(pred & ~gt), count(~pred & gt)
    precision = inter / (inter + fp).clamp(min=1)
    recall = inter / (inter + fn).clamp(min=1)
    f1 = 2 * precision * recall / (precision + recall).clamp(min=1e-9)
    return iou, f1
