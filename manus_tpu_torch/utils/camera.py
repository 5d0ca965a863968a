"""OpenGL-convention pinhole camera, as torch tensors.

Row-vector convention, as in the JAX package: world_view_transform =
extr^T, full_proj = WVT @ P^T, and points transform as p_row @ M. The
matrices are built in float64 with numpy and stored as float32 tensors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from manus_tpu_torch.utils.device import resolve_device

Z_NEAR = 0.01
Z_FAR = 100.0


def focal2fov(focal: float, pixels: float) -> float:
    return 2 * math.atan(pixels / (2 * focal))


def get_projection_matrix(
    znear: float, zfar: float, fovx: float, fovy: float
) -> np.ndarray:
    """Z-forward OpenGL-style projection matrix (float64)."""
    tan_half_y = math.tan(fovy / 2)
    tan_half_x = math.tan(fovx / 2)
    top = tan_half_y * znear
    right = tan_half_x * znear
    P = np.zeros((4, 4), dtype=np.float64)
    P[0, 0] = znear / right
    P[1, 1] = znear / top
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


TENSOR_FIELDS = (
    "K", "extr", "world_view_transform", "projection_matrix",
    "full_proj_transform", "camera_center", "fovx", "fovy",
)


@dataclasses.dataclass(frozen=True)
class Camera:
    """One camera (or a stack of V cameras with a leading axis).

    Tensor fields are float32 on one device; width and height are ints.
    """

    K: Any  # [3, 3]
    extr: Any  # [4, 4] world->camera (OpenCV), last row (0,0,0,1)
    world_view_transform: Any  # [4, 4] = extr^T
    projection_matrix: Any  # [4, 4] = P^T
    full_proj_transform: Any  # [4, 4] = WVT @ P^T
    camera_center: Any  # [3]
    fovx: Any  # [] radians
    fovy: Any  # []
    width: int
    height: int

    @property
    def tanfovx(self):
        return torch.tan(self.fovx * 0.5)

    @property
    def tanfovy(self):
        return torch.tan(self.fovy * 0.5)


def make_camera(
    K: np.ndarray,
    extr: np.ndarray,
    width: int,
    height: int,
    znear: float = Z_NEAR,
    zfar: float = Z_FAR,
    device=None,
    resize_factor: float = 1.0,
) -> Camera:
    """Camera from OpenCV intrinsics and [3,4] or [4,4] extrinsics. With
    resize_factor f, the camera of the image resized by f: K's first two
    rows times f, the size int(x * f + 0.5) (the reference's rounding)."""
    device = resolve_device(device)
    K = np.array(K, dtype=np.float64)
    K[:2, :] *= resize_factor
    width = int(width * resize_factor + 0.5)
    height = int(height * resize_factor + 0.5)
    fovx = focal2fov(K[0, 0], width)
    fovy = focal2fov(K[1, 1], height)
    extr = np.array(extr, dtype=np.float64)
    if extr.shape == (3, 4):
        extr = np.concatenate([extr, np.array([[0.0, 0.0, 0.0, 1.0]])], axis=0)
    wvt = extr.T
    proj = get_projection_matrix(znear, zfar, fovx, fovy).T
    full = wvt @ proj
    cam_center = np.linalg.inv(wvt)[3, :3]

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    return Camera(
        K=t(K), extr=t(extr), world_view_transform=t(wvt),
        projection_matrix=t(proj), full_proj_transform=t(full),
        camera_center=t(cam_center), fovx=t(fovx), fovy=t(fovy),
        width=width, height=height,
    )


def stack_cameras(cams: list[Camera]) -> Camera:
    """Stack same-resolution cameras into one Camera with a leading [V]."""
    if len({(c.width, c.height) for c in cams}) != 1:
        raise ValueError("cameras of one stack must share a resolution")
    fields = {
        f: torch.stack([getattr(c, f) for c in cams]) for f in TENSOR_FIELDS
    }
    return Camera(**fields, width=cams[0].width, height=cams[0].height)


def index_camera(cams: Camera, i) -> Camera:
    """Camera i of a stacked Camera (an int, or an index tensor/array)."""
    fields = {f: getattr(cams, f)[i] for f in TENSOR_FIELDS}
    return Camera(**fields, width=cams.width, height=cams.height)
