"""Segmentation-mask pruning signals: project points into a camera, look
up a (possibly dilated) mask and flag the points that fall outside; a
keypoint guard turns the signal off for frames whose skeleton itself
projects outside the mask (bad segmentation)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from manus_tpu_torch.utils.camera import Camera
from manus_tpu_torch.utils.transforms import project_points


def dilate_mask(mask: torch.Tensor, kernel_size: int = 11) -> torch.Tensor:
    """Binary dilation by max-pooling. mask: [H, W] -> [H, W] bool."""
    m = mask.to(torch.float32)[None, None]
    pad = kernel_size // 2
    m = F.pad(m, (pad, pad, pad, pad), value=float("-inf"))
    return F.max_pool2d(m, kernel_size, stride=1)[0, 0] > 0


def _lookup(mask, p2d):
    h, w = mask.shape
    xs = torch.clamp(p2d[:, 0], 0, w - 1).to(torch.int64)
    ys = torch.clamp(p2d[:, 1], 0, h - 1).to(torch.int64)
    return mask[ys, xs]


def points_outside_mask(
    camera: Camera,
    points: torch.Tensor,  # [N, 3] posed
    mask: torch.Tensor,  # [H, W] or [H, W, 1]
    keypoints: torch.Tensor | None = None,  # [K, 3]
    dilate: bool = False,
    active: torch.Tensor | None = None,
) -> torch.Tensor:
    """[N] bool: active points projecting outside the segmentation mask."""
    if mask.dim() == 3:
        mask = mask[..., 0]
    if dilate:
        mask = dilate_mask(mask)
    mask = mask.to(torch.bool)
    extr34 = camera.extr[:3, :4]
    outside = ~_lookup(mask, project_points(points, camera.K, extr34))
    if keypoints is not None:
        kp_out = ~_lookup(mask, project_points(keypoints, camera.K, extr34))
        outside = outside & ~kp_out.any()
    if active is not None:
        outside = outside & active
    return outside
