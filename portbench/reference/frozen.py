"""A frozen copy of the plain PyTorch path of the port's hand training
step, for the benchmark's reference.

Every function below is copied from `manus_tpu_torch` (the module each
block came from is named above it) and must not be edited to follow the
port: the reference is what the port is held to, so it does not move
when the port does. Only the port's multi-rank branches (tile owners,
collectives) are left out; nothing here imports the port.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Any, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F


# ---- frozen from manus_tpu_torch/utils/camera.py
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
    device = torch.device(device)
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


# ---- frozen from manus_tpu_torch/utils/transforms.py
def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """[..., 4] wxyz quaternion -> [..., 3, 3] rotation matrix.

    An unnormalised input is scaled by 2/|q|^2, as in the reference.
    """
    r, i, j, k = q.unbind(-1)
    two_s = 2.0 / (q * q).sum(-1)
    o = torch.stack(
        [
            1 - two_s * (j * j + k * k),
            two_s * (i * j - k * r),
            two_s * (i * k + j * r),
            two_s * (i * j + k * r),
            1 - two_s * (i * i + k * k),
            two_s * (j * k - i * r),
            two_s * (i * k - j * r),
            two_s * (j * k + i * r),
            1 - two_s * (i * i + j * j),
        ],
        dim=-1,
    )
    return o.reshape(q.shape[:-1] + (3, 3))

def build_rotation(q: torch.Tensor) -> torch.Tensor:
    """Normalise wxyz quats, then convert to [N, 3, 3] rotations."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return quaternion_to_matrix(q)

def covariance_from_scaling_rotation(
    scaling: torch.Tensor, rotation: torch.Tensor, scaling_modifier: float = 1.0
) -> torch.Tensor:
    """Sigma = (R S)(R S)^T as [N, 6] upper-tri: sum_k s_k^2 R_ik R_jk."""
    R = build_rotation(rotation)
    s2 = (scaling_modifier * scaling) ** 2
    s0, s1, s2_ = s2[..., 0], s2[..., 1], s2[..., 2]

    def sig(i, j):
        return (
            s0 * R[..., i, 0] * R[..., j, 0]
            + s1 * R[..., i, 1] * R[..., j, 1]
            + s2_ * R[..., i, 2] * R[..., j, 2]
        )

    return torch.stack(
        [sig(0, 0), sig(0, 1), sig(0, 2), sig(1, 1), sig(1, 2), sig(2, 2)],
        dim=-1,
    )

def homogenize_points(x: torch.Tensor) -> torch.Tensor:
    """[..., 3] points -> [..., 4] by appending 1."""
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)

def project_points(points: torch.Tensor, K: torch.Tensor,
                   extrin: torch.Tensor) -> torch.Tensor:
    """Pinhole projection of [..., N, 3] world points -> [..., N, 2] pixels.

    K: [3, 3]; extrin: [3, 4] world->camera (OpenCV convention).
    """
    P = K @ extrin
    proj = torch.einsum("ij,...j->...i", P, homogenize_points(points))
    return proj[..., :2] / proj[..., 2:3]


# ---- frozen from manus_tpu_torch/utils/sh.py
C0 = 0.28209479177387814

C1 = 0.4886025119029199

C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)

C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)

C4 = (
    2.5033429417967046,
    -1.7701307697799304,
    0.9461746957575601,
    -0.6690465435572892,
    0.10578554691520431,
    -0.6690465435572892,
    0.47308734787878004,
    -1.7701307697799304,
    0.6258357354491761,
)

def sh_basis(deg: int, dirs: torch.Tensor) -> torch.Tensor:
    """[..., 3] unit directions -> [..., (deg+1)**2] basis values."""
    if not 0 <= deg <= 4:
        raise ValueError(f"SH degree must be 0..4, got {deg}")
    basis = [torch.full_like(dirs[..., 0], C0)]
    if deg > 0:
        x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
        basis += [-C1 * y, C1 * z, -C1 * x]
        if deg > 1:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            basis += [
                C2[0] * xy,
                C2[1] * yz,
                C2[2] * (2.0 * zz - xx - yy),
                C2[3] * xz,
                C2[4] * (xx - yy),
            ]
            if deg > 2:
                basis += [
                    C3[0] * y * (3 * xx - yy),
                    C3[1] * xy * z,
                    C3[2] * y * (4 * zz - xx - yy),
                    C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
                    C3[4] * x * (4 * zz - xx - yy),
                    C3[5] * z * (xx - yy),
                    C3[6] * x * (xx - 3 * yy),
                ]
                if deg > 3:
                    basis += [
                        C4[0] * xy * (xx - yy),
                        C4[1] * yz * (3 * xx - yy),
                        C4[2] * xy * (7 * zz - 1),
                        C4[3] * yz * (7 * zz - 3),
                        C4[4] * (zz * (35 * zz - 30) + 3),
                        C4[5] * xz * (7 * zz - 3),
                        C4[6] * (xx - yy) * (7 * zz - 1),
                        C4[7] * xz * (xx - 3 * yy),
                        C4[8] * (xx * (xx - 3 * yy) - yy * (3 * xx - yy)),
                    ]
    return torch.stack(basis, dim=-1)

def eval_sh(deg: int, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """sh: [..., C, K] coefficients (K >= (deg+1)**2); dirs: [..., 3] unit.
    Returns [..., C]."""
    k = (deg + 1) ** 2
    if sh.shape[-1] < k:
        raise ValueError(f"{sh.shape[-1]} SH coefficients < {k} for degree {deg}")
    return torch.einsum("...ck,...k->...c", sh[..., :k], sh_basis(deg, dirs))

def rgb_to_sh(rgb):
    return (rgb - 0.5) / C0


# ---- frozen from manus_tpu_torch/models/gaussians.py
class GaussianParams(NamedTuple):
    """Differentiable parameter leaves, all padded to [N_max, ...]."""

    xyz: torch.Tensor  # [N, 3]
    features_dc: torch.Tensor  # [N, 1, 3]
    features_rest: torch.Tensor  # [N, K-1, 3]
    scaling: torch.Tensor  # [N, S] log-scales (S=1 if isotropic else 3)
    rotation: torch.Tensor  # [N, 4] wxyz (unnormalised)
    opacity: torch.Tensor

def get_scaling(params: GaussianParams, isotropic: bool = False) -> torch.Tensor:
    s = torch.exp(params.scaling)
    if isotropic or s.shape[-1] == 1:
        s = s[:, :1].expand(s.shape[0], 3)
    return s

def get_opacity(params: GaussianParams) -> torch.Tensor:
    return torch.sigmoid(params.opacity)

def get_features(params: GaussianParams) -> torch.Tensor:
    """[N, K, 3] SH coefficients, dc first (reference layout)."""
    return torch.cat([params.features_dc, params.features_rest], dim=1)

def get_covariance(
    params: GaussianParams,
    scaling_modifier: float = 1.0,
    isotropic: bool = False,
) -> torch.Tensor:
    """[N, 6] upper-tri 3D covariance."""
    return covariance_from_scaling_rotation(
        get_scaling(params, isotropic), params.rotation, scaling_modifier
    )


# ---- frozen from manus_tpu_torch/ops/skinning.py
class SkinnedGaussians(NamedTuple):
    posed_xyz: torch.Tensor  # [N, 3]
    posed_cov: torch.Tensor  # [N, 6]
    tf: torch.Tensor

def bone_deformation_transforms(
    posed_transforms: torch.Tensor,  # [J, 4, 4]
    rest_transforms: torch.Tensor,  # [J, 4, 4]
    append_identity: bool = False,
) -> torch.Tensor:
    """Per-bone rest->posed transforms posed @ inv(rest); `append_identity`
    adds the background channel of voxel skinning."""
    tf = posed_transforms @ torch.linalg.inv(rest_transforms)
    if append_identity:
        eye = torch.eye(4, dtype=tf.dtype, device=tf.device)[None]
        tf = torch.cat([tf, eye], dim=0)
    return tf

def skin_gaussians(
    cano_xyz: torch.Tensor,  # [N, 3]
    cano_cov: torch.Tensor,  # [N, 6] upper-tri canonical covariance
    skin_weights: torch.Tensor,  # [N, B]
    transforms: torch.Tensor,  # [B, 4, 4]
) -> SkinnedGaussians:
    """Blend bone transforms per point, then pose means and R Sigma R^T."""
    b = transforms.shape[0]
    tf = (skin_weights @ transforms.reshape(b, 16)).reshape(-1, 4, 4)

    r00, r01, r02 = tf[:, 0, 0], tf[:, 0, 1], tf[:, 0, 2]
    r10, r11, r12 = tf[:, 1, 0], tf[:, 1, 1], tf[:, 1, 2]
    r20, r21, r22 = tf[:, 2, 0], tf[:, 2, 1], tf[:, 2, 2]
    x, y, z = cano_xyz[:, 0], cano_xyz[:, 1], cano_xyz[:, 2]
    posed_xyz = torch.stack(
        [
            r00 * x + r01 * y + r02 * z + tf[:, 0, 3],
            r10 * x + r11 * y + r12 * z + tf[:, 1, 3],
            r20 * x + r21 * y + r22 * z + tf[:, 2, 3],
        ],
        dim=-1,
    )

    sxx, sxy, sxz, syy, syz, szz = cano_cov.unbind(-1)

    def row_sigma(a, b_, c):  # (a, b, c) . Sigma
        return (
            a * sxx + b_ * sxy + c * sxz,
            a * sxy + b_ * syy + c * syz,
            a * sxz + b_ * syz + c * szz,
        )

    m0 = row_sigma(r00, r01, r02)
    m1 = row_sigma(r10, r11, r12)
    m2 = row_sigma(r20, r21, r22)

    def dot_row(m, a, b_, c):
        return m[0] * a + m[1] * b_ + m[2] * c

    posed_cov = torch.stack(
        [
            dot_row(m0, r00, r01, r02),
            dot_row(m0, r10, r11, r12),
            dot_row(m0, r20, r21, r22),
            dot_row(m1, r10, r11, r12),
            dot_row(m1, r20, r21, r22),
            dot_row(m2, r20, r21, r22),
        ],
        dim=-1,
    )
    return SkinnedGaussians(posed_xyz=posed_xyz, posed_cov=posed_cov, tf=tf)


# ---- frozen from manus_tpu_torch/ops/grid_sample.py
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
    blended transform stays the identity's, not NaN."""
    xyz_norm = (xyz - grid_center.reshape(1, 3)) / grid_scale.reshape(1, 3)
    wts = grid_sample_trilinear(grid_weights, xyz_norm)
    denom = wts.sum(-1, keepdim=True)
    wts = wts / torch.where(denom == 0.0, 1.0, denom)
    bg = torch.zeros_like(wts[:1])
    bg[0, -1] = 1.0
    return torch.where(denom == 0.0, bg, wts)


# ---- frozen from manus_tpu_torch/ops/knn.py
@contextlib.contextmanager
def fp32_matmul():
    """Float32 matmuls on CUDA in full precision (no TF32) inside."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev

def nearest_neighbor(pt1: torch.Tensor, pt2: torch.Tensor, block: int = 1024,
                     pt2_valid: torch.Tensor | None = None):
    """For each point of pt1 [N, 3], the distance to and index of the
    nearest point of pt2 [M, 3]; rows of pt2 where pt2_valid is false are
    never chosen. Returns (dist [N] float32, idx [N] int32)."""
    sq2 = (pt2 * pt2).sum(-1)
    if pt2_valid is not None:
        sq2 = torch.where(pt2_valid, sq2, float("inf"))
    dist, idx = [], []
    with fp32_matmul():
        for i in range(0, pt1.shape[0], block):
            rows = pt1[i:i + block]
            d2 = (rows * rows).sum(-1)[:, None] + sq2[None, :] \
                - 2.0 * (rows @ pt2.T)
            best, j = d2.min(dim=-1)
            dist.append(torch.sqrt(best.clamp(min=0.0)))
            idx.append(j.to(torch.int32))
    return torch.cat(dist), torch.cat(idx)


# ---- frozen from manus_tpu_torch/train/workloads.py
class VoxelGrid(NamedTuple):
    """The skinning-weight grid (data/voxel.py build_voxel_grid)."""

    center: torch.Tensor  # [3]
    scale: torch.Tensor  # [3]
    weights: torch.Tensor  # [D, H, W, B+1], the background channel last


# ---- frozen from manus_tpu_torch/data/voxel.py
def build_voxel_grid(
    bones_keypoints: np.ndarray,  # [K, 3] canonical skeleton keypoints
    res: int = 128,
    ratio=(1.1, 0.9, 0.65),
    offset=(0.0, 0.0, -0.03),
    surface_margin: float = 0.02,
    num_bones: int = 20,
    device=None,
) -> "VoxelGrid":
    """A VoxelGrid of [D, H, W, B+1] weights, the background channel last.

    The geometry is the reference's: the keypoints' bounding-box centre
    plus a per-axis offset, half the box diagonal scaled per axis by
    `ratio` (x takes the z ratio, as in the reference), res / ratio cells
    per axis. `mano` (load_mano_rest) gives the MANO weights; None the
    nearest-keypoint stand-in over the first `num_bones` keypoints
    (the only branch kept here: the benchmark has no MANO mesh).
    """
    device = torch.device(device)
    keypts = np.asarray(bones_keypoints)
    cano_min, cano_max = keypts.min(0), keypts.max(0)
    center = (cano_max + cano_min) / 2 + np.asarray(offset, np.float64)
    x_r, y_r, z_r = ratio
    res_scaled = (res / np.array([x_r, y_r, z_r])).astype(np.int32)
    d, h, w = int(res_scaled[2]), int(res_scaled[1]), int(res_scaled[0])
    half = np.linalg.norm(cano_max - cano_min) / 2
    scale = np.array([half * z_r, half * y_r, half * x_r], np.float32)

    def axis(n):
        return torch.tensor(np.linspace(-1, 1, n).astype(np.float32),
                            device=device)

    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    # grid_sample's convention: x indexes W, y indexes H, z indexes D
    zs, ys, xs = torch.meshgrid(axis(d), axis(h), axis(w), indexing="ij")
    pts = torch.stack([xs, ys, zs], dim=-1).reshape(-1, 3)
    world = pts * t(scale) + t(center)

    kp = keypts[:num_bones] if len(keypts) >= num_bones else np.pad(
        keypts, ((0, num_bones - len(keypts)), (0, 0)), mode="edge")
    kp = t(kp)
    with fp32_matmul():
        d2 = (world ** 2).sum(1)[:, None] + (kp * kp).sum(1)[None, :] \
            - 2 * world @ kp.T
    weights = torch.exp(-d2 / (2 * (0.02 ** 2)))
    weights = weights / weights.sum(1, keepdim=True).clamp(min=1e-8)
    dist, _ = nearest_neighbor(world, kp)
    far = dist > surface_margin * 3

    weights = torch.cat([weights, weights.new_zeros(weights.shape[0], 1)], 1)
    background = torch.zeros_like(weights[:1])
    background[0, -1] = 1.0
    weights = torch.where(far[:, None], background, weights)
    weights = weights / weights.sum(1, keepdim=True).clamp(min=1e-8)
    return VoxelGrid(center=t(center), scale=t(scale),
                     weights=weights.reshape(d, h, w, -1))


# ---- frozen from manus_tpu_torch/ops/rasterizer/projection.py
FRUSTUM_NEAR_Z = 0.2

COV2D_DILATION = 0.3

TILE = 16

class ProjectedGaussians(NamedTuple):
    """Per-gaussian screen-space quantities, all [N, ...]."""

    means2d: torch.Tensor  # [N, 2] pixel coords
    conic: torch.Tensor  # [N, 3] inverse 2D covariance (a, b, c)
    depth: torch.Tensor  # [N] view-space z
    radius: torch.Tensor  # [N] int32 3-sigma pixel radius (0 => culled)
    tile_rect: torch.Tensor  # [N, 4] int32 (tx0, ty0, tx1, ty1), exclusive max
    visible: torch.Tensor

def project_gaussians(
    means3d: torch.Tensor,
    cov3d: torch.Tensor,
    camera: Camera,
    active: torch.Tensor | None = None,
) -> ProjectedGaussians:
    """Project [N, 3] means and [N, 6] upper-tri covariances; `active`
    masks out padded slots."""
    w, h = camera.width, camera.height
    tanfovx, tanfovy = camera.tanfovx, camera.tanfovy
    focal_x = w / (2.0 * tanfovx)
    focal_y = h / (2.0 * tanfovy)

    x, y, z = means3d[:, 0], means3d[:, 1], means3d[:, 2]
    WV = camera.world_view_transform
    FP = camera.full_proj_transform

    def row_xform(M, j):
        return x * M[0, j] + y * M[1, j] + z * M[2, j] + M[3, j]

    pv_x, pv_y, pv_z = (row_xform(WV, j) for j in range(3))
    ph = [row_xform(FP, j) for j in range(4)]
    p_w = 1.0 / (ph[3] + 1e-7)
    p_proj_x, p_proj_y = ph[0] * p_w, ph[1] * p_w

    in_frustum = pv_z > FRUSTUM_NEAR_Z
    depth = pv_z
    depth_safe = torch.where(in_frustum, depth, torch.ones_like(depth))

    lim_x, lim_y = 1.3 * tanfovx, 1.3 * tanfovy
    txtz = torch.clamp(pv_x / depth_safe, -lim_x, lim_x)
    tytz = torch.clamp(pv_y / depth_safe, -lim_y, lim_y)
    tx = txtz * depth_safe
    ty = tytz * depth_safe
    inv_tz = 1.0 / depth_safe
    inv_tz2 = inv_tz * inv_tz

    # J rows: (fx/tz, 0, -fx*tx/tz^2), (0, fy/tz, -fy*ty/tz^2); R is the
    # world->camera rotation; a = J[0] R, b = J[1] R.
    R = camera.extr[:3, :3]
    j00 = focal_x * inv_tz
    j02 = -focal_x * tx * inv_tz2
    j11 = focal_y * inv_tz
    j12 = -focal_y * ty * inv_tz2
    a0 = j00 * R[0, 0] + j02 * R[2, 0]
    a1 = j00 * R[0, 1] + j02 * R[2, 1]
    a2 = j00 * R[0, 2] + j02 * R[2, 2]
    b0 = j11 * R[1, 0] + j12 * R[2, 0]
    b1 = j11 * R[1, 1] + j12 * R[2, 1]
    b2 = j11 * R[1, 2] + j12 * R[2, 2]
    sxx, sxy, sxz, syy, syz, szz = cov3d.unbind(-1)
    u0 = a0 * sxx + a1 * sxy + a2 * sxz
    u1 = a0 * sxy + a1 * syy + a2 * syz
    u2 = a0 * sxz + a1 * syz + a2 * szz
    v0 = b0 * sxx + b1 * sxy + b2 * sxz
    v1 = b0 * sxy + b1 * syy + b2 * syz
    v2 = b0 * sxz + b1 * syz + b2 * szz
    cxx = u0 * a0 + u1 * a1 + u2 * a2 + COV2D_DILATION
    cxy = u0 * b0 + u1 * b1 + u2 * b2
    cyy = v0 * b0 + v1 * b1 + v2 * b2 + COV2D_DILATION

    det = cxx * cyy - cxy * cxy
    det_ok = det != 0.0
    inv_det = 1.0 / torch.where(det_ok, det, torch.ones_like(det))
    conic = torch.stack([cyy * inv_det, -cxy * inv_det, cxx * inv_det], dim=-1)

    mid = 0.5 * (cxx + cyy)
    lambda1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius_f = torch.ceil(3.0 * torch.sqrt(torch.clamp(lambda1, min=0.0)))
    means2d = torch.stack(
        [((p_proj_x + 1.0) * w - 1.0) * 0.5, ((p_proj_y + 1.0) * h - 1.0) * 0.5],
        dim=-1,
    )

    valid = in_frustum & det_ok
    if active is not None:
        valid = valid & active

    # Tile AABB clamped to the grid; a gaussian touching no tile is culled.
    grid_x = (w + TILE - 1) // TILE
    grid_y = (h + TILE - 1) // TILE
    m2d = means2d.detach()
    r = radius_f.detach()

    def tile_index(v, limit):
        return torch.clamp(v.to(torch.int32), 0, limit)

    tx0 = tile_index((m2d[:, 0] - r) / TILE, grid_x)
    ty0 = tile_index((m2d[:, 1] - r) / TILE, grid_y)
    tx1 = tile_index((m2d[:, 0] + r + TILE - 1) / TILE, grid_x)
    ty1 = tile_index((m2d[:, 1] + r + TILE - 1) / TILE, grid_y)
    visible = valid & ((tx1 - tx0) * (ty1 - ty0) > 0)
    radius = torch.where(visible, r, torch.zeros_like(r)).to(torch.int32)
    tile_rect = torch.stack([tx0, ty0, tx1, ty1], dim=-1)

    # Culled slots park at benign constants: a near-zero clip-space w gives
    # inf means2d, and 0 * inf = nan would poison the backward.
    vis = visible[:, None]
    means2d = torch.where(vis, means2d, torch.zeros_like(means2d))
    conic = torch.where(vis, conic, conic.new_tensor([1.0, 0.0, 1.0]))

    return ProjectedGaussians(
        means2d=means2d,
        conic=conic,
        depth=depth,
        radius=radius,
        tile_rect=tile_rect,
        visible=visible,
    )


# ---- frozen from manus_tpu_torch/ops/rasterizer/binning.py
class TileBins(NamedTuple):
    """Pair layout for the composite.

    pair_src: [P_budget] int32, the source gaussian of each sorted pair
      slot; -1 for the invalid tail.
    tile_offsets: [T] int32 segment start of each tile (not aligned); in
      owner mode [T / num_owners], slot i is tile owned_ids[owner, i].
    tile_counts: [T] int32 pairs per tile (budget- and cap-clamped).
    overflow_count: [] int32 pairs dropped by every rule.
    overflow_far: [] int32 the part of overflow_count from the per-tile cap.
    """

    pair_src: torch.Tensor
    tile_offsets: torch.Tensor
    tile_counts: torch.Tensor
    overflow_count: torch.Tensor
    overflow_far: torch.Tensor

def _admit(kept0, in_class, lo: int, hi: int, cap: int):
    """Admission within one size class: the largest rects first, then the
    partial size class in gaussian-id order, up to `cap` members."""
    sizes = torch.arange(lo, hi + 1, dtype=torch.int32, device=kept0.device)
    c = ((kept0[:, None] >= sizes[None, :]) & in_class[:, None]).sum(0)
    s_star = torch.where(c <= cap, sizes, torch.full_like(sizes, hi + 1)).min()
    n_big = (in_class & (kept0 >= s_star)).sum()
    part = in_class & (kept0 == s_star - 1)
    rank = torch.cumsum(part.to(torch.int32), 0)
    return in_class & ((kept0 >= s_star) | (part & (rank <= cap - n_big)))

def bin_gaussians(
    proj: ProjectedGaussians,
    num_tiles_x: int,
    num_tiles_y: int,
    tg_max: int,
    lane_align: int = 128,
    pair_budget_factor: int = 8,
    max_pairs_per_tile: int = 0,
    multi_frac: float = 1.0,
    multi_floor: int = 4096,
) -> TileBins:
    """Single-device binning (the port's bin_gaussians with num_owners 1)."""
    rect = proj.tile_rect
    visible = proj.visible
    device = rect.device
    n = proj.depth.shape[0]
    num_tiles = num_tiles_x * num_tiles_y
    i32 = torch.int32
    t_local = num_tiles

    rw = rect[:, 2] - rect[:, 0]
    rh = rect[:, 3] - rect[:, 1]
    n_slots = rw * rh
    rw_eff = torch.clamp(rw, 1, tg_max)
    rh_eff = torch.minimum(rh, torch.div(tg_max, rw_eff, rounding_mode="floor"))
    rw_kept = torch.minimum(rw, rw_eff)
    kept0 = rw_kept * rh_eff
    is_multi = visible & (kept0 > 1)
    gids = torch.arange(n, dtype=i32, device=device)

    small_max = min(8, tg_max)
    tiers = []
    if tg_max >= 2:
        tiers.append((2, small_max,
                      min(n, max(multi_floor, int(round(n * multi_frac))))))
    if tg_max > small_max:
        cap_big = n if multi_frac >= 1.0 else min(
            n, max(multi_floor // 4, int(round(n * multi_frac / 8)))
        )
        tiers.append((small_max + 1, tg_max, cap_big))

    # tier 0: the top-left cell of every visible gaussian
    tile_blocks = [torch.where(
        visible, rect[:, 1] * num_tiles_x + rect[:, 0],
        torch.full_like(rect[:, 0], num_tiles),
    ).to(i32)]
    depth_blocks = [proj.depth.detach()]
    gidx_blocks = [gids]

    one = visible.to(i32)
    rw_f, rh_f = one, one
    for lo, hi, cap in tiers:
        in_class = is_multi & (kept0 >= lo) & (kept0 <= hi)
        inc = _admit(kept0, in_class, lo, hi, cap)
        rw_f = torch.where(inc, rw_kept, rw_f)
        rh_f = torch.where(inc, rh_eff, rh_f)
        # admitted members first, in gaussian-id order
        order = torch.argsort((~inc).to(i32), stable=True)[:cap]
        m_ok = inc[order]
        m_x0 = rect[order, 0][:, None]
        m_y0 = rect[order, 1][:, None]
        m_rw = torch.clamp(rw_kept[order], min=1)[:, None]
        m_kept = kept0[order][:, None]
        slots = torch.arange(1, hi, dtype=i32, device=device)[None, :]
        dy = torch.div(slots, m_rw, rounding_mode="floor")
        dx = slots - dy * m_rw
        m_valid = m_ok[:, None] & (slots < m_kept)
        tile_k = (m_y0 + dy) * num_tiles_x + (m_x0 + dx)
        tile_blocks.append(torch.where(
            m_valid, tile_k, torch.full_like(tile_k, num_tiles)
        ).to(i32).reshape(-1))
        depth_blocks.append(
            proj.depth.detach()[order][:, None].expand(-1, hi - 1).reshape(-1)
        )
        gidx_blocks.append(order.to(i32)[:, None].expand(-1, hi - 1).reshape(-1))

    kept = rw_f * rh_f
    overflow_trunc = torch.where(
        visible, n_slots - kept, torch.zeros_like(kept)
    ).sum().to(i32)

    pair_tile = torch.cat(tile_blocks)
    pair_depth = torch.cat(depth_blocks)
    pair_gidx = torch.cat(gidx_blocks)
    n_exp = pair_tile.shape[0]
    pair_key = pair_tile
    perm = torch.argsort(pair_gidx, stable=True)
    perm = perm[torch.argsort(pair_depth[perm], stable=True)]
    perm = perm[torch.argsort(pair_key[perm], stable=True)]
    sorted_gidx = pair_gidx[perm]

    valid_tiles = pair_tile[pair_tile < num_tiles]
    flat_counts = torch.bincount(valid_tiles.long(), minlength=num_tiles).to(i32)
    bounds = torch.cat([torch.zeros(1, dtype=i32, device=device),
                        torch.cumsum(flat_counts, 0, dtype=i32)])

    p_budget = n_exp
    if pair_budget_factor > 0:
        p_budget = min(p_budget, n * pair_budget_factor)
    p_budget = ((p_budget + lane_align - 1) // lane_align) * lane_align

    starts = torch.clamp(bounds[:-1], max=p_budget)
    ends = torch.clamp(bounds[1:], max=p_budget)
    counts = ends - starts
    overflow_budget = ((bounds[1:] - bounds[:-1]) - counts).sum().to(i32)
    overflow_far = torch.zeros((), dtype=i32, device=device)
    if max_pairs_per_tile > 0:
        overflow_far = torch.clamp(counts - max_pairs_per_tile, min=0).sum().to(i32)
        counts = torch.clamp(counts, max=max_pairs_per_tile)
    overflow = overflow_trunc + overflow_budget + overflow_far

    total_valid = torch.clamp(bounds[t_local], max=p_budget)
    src = sorted_gidx[:p_budget]
    if p_budget > n_exp:  # lane rounding can exceed the raw pair count
        src = torch.cat([src, torch.full((p_budget - n_exp,), -1, dtype=i32,
                                         device=device)])
    slot_ids = torch.arange(p_budget, dtype=i32, device=device)
    pair_src = torch.where(slot_ids < total_valid, src, torch.full_like(src, -1))

    return TileBins(
        pair_src=pair_src,
        tile_offsets=starts,
        tile_counts=counts,
        overflow_count=overflow,
        overflow_far=overflow_far,
    )


# ---- frozen from manus_tpu_torch/ops/rasterizer/payload.py
F_MEAN_X, F_MEAN_Y = 0, 1

F_CONIC_A, F_CONIC_B, F_CONIC_C = 2, 3, 4

F_OPACITY = 5

F_R, F_G, F_B = 6, 7, 8

NUM_LIVE = 9

NUM_FIELDS = 16

def build_payload(
    proj: ProjectedGaussians,
    colors: torch.Tensor,  # [N, 3]
    opacity: torch.Tensor,  # [N]
    bins: TileBins,
) -> torch.Tensor:
    """Gather per-gaussian fields into the pair layout [16, P]."""
    n = proj.means2d.shape[0]
    src = bins.pair_src.long()
    fields = torch.cat(
        [
            proj.means2d,
            proj.conic,
            opacity[:, None],
            colors,
            proj.means2d.new_zeros(n, NUM_FIELDS - NUM_LIVE),
        ],
        dim=1,
    )  # [N, 16]
    # index_select, not fields[src]: its backward is index_add_, where
    # advanced indexing's is a sort-based index_put_ (accumulate=True)
    rows = torch.index_select(fields, 0, src.clamp(min=0)) * (src >= 0)[:, None]
    return rows.T.contiguous()


# ---- frozen from manus_tpu_torch/ops/rasterizer/oracle.py
ALPHA_EPS = 1.0 / 255.0

ALPHA_MAX = 0.99

T_EPS = 1e-4

def straight_through_min(x: torch.Tensor, cap: float) -> torch.Tensor:
    """min(x, cap) in the forward pass, identity in the backward pass."""
    return x + (x.clamp(max=cap) - x).detach()


# ---- frozen from manus_tpu_torch/ops/rasterizer/composite.py
LOG_T_EPS = math.log(T_EPS)

N_PX = TILE * TILE

def num_slots(ntx: int, nty: int, tile_ids) -> int:
    """The number of tile slots: the grid's, or the tile ids'."""
    return ntx * nty if tile_ids is None else tile_ids.shape[0]

def tile_pixel_coords(ntx: int, nty: int, device, tile_ids=None):
    """Pixel-centre coordinates per tile slot: two [T, 256] float32
    tensors."""
    t = (torch.arange(ntx * nty, device=device) if tile_ids is None
         else tile_ids.to(device=device, dtype=torch.long))[:, None]
    i = torch.arange(N_PX, device=device)[None, :]
    px = ((t % ntx) * TILE + i % TILE).to(torch.float32)
    py = ((t // ntx) * TILE + i // TILE).to(torch.float32)
    return px, py

def composite_tiles_torch(payload, offsets, counts, ntx: int, nty: int,
                          chunk: int = 64, tile_ids=None):
    """Plain PyTorch composite, same math as the kernels; autograd gives
    its backward. Walks the pairs in chunks; chunk k only touches the
    tiles with more than k * chunk pairs."""
    dev = payload.device
    t = num_slots(ntx, nty, tile_ids)
    p = payload.shape[1]
    px, py = tile_pixel_coords(ntx, nty, dev, tile_ids)
    log_t = torch.zeros(t, N_PX, device=dev)
    accum = torch.zeros(t, 3, N_PX, device=dev)
    t_min = torch.ones(t, N_PX, device=dev)
    counts = counts.long()
    max_count = int(counts.max()) if t else 0
    # at least one pass, over no tiles when there are no pairs: the outputs
    # stay a function of the payload, so that a rank of a sharded render
    # with nothing to composite runs the backward of its collectives too
    for k0 in range(0, max(max_count, 1), chunk):
        live = torch.nonzero(counts > k0).squeeze(1)
        j = k0 + torch.arange(chunk, device=dev)
        in_seg = j[None, :] < counts[live, None]  # [L, G]
        cols = torch.clamp(offsets[live].long()[:, None] + j[None, :], max=p - 1)
        f = payload[:, cols]  # [16, L, G]
        dx = px[live][:, None, :] - f[F_MEAN_X][:, :, None]  # [L, G, Px]
        dy = py[live][:, None, :] - f[F_MEAN_Y][:, :, None]
        ca = f[F_CONIC_A][:, :, None]
        cb = f[F_CONIC_B][:, :, None]
        cc = f[F_CONIC_C][:, :, None]
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        op = torch.where(in_seg, f[F_OPACITY], 0.0)[:, :, None]
        alpha = straight_through_min(op * torch.exp(power), ALPHA_MAX)
        gate = (power <= 0.0) & (alpha.detach() >= ALPHA_EPS)
        alpha = torch.where(gate, alpha, 0.0)
        log1m = torch.log1p(-alpha)
        log_cp = log_t[live][:, None, :] + torch.cumsum(log1m, dim=1)
        t_before = torch.exp(log_cp - log1m)
        incl = log_cp.detach() >= LOG_T_EPS
        w = torch.where(incl, alpha * t_before, 0.0)
        colors = f[F_R:F_R + 3].permute(1, 0, 2)  # [L, 3, G]
        accum = accum.index_copy(0, live, accum[live] + colors @ w)
        chunk_min = torch.where(incl & (alpha > 0), torch.exp(log_cp), 1.0).amin(1)
        t_min = t_min.index_copy(0, live, torch.minimum(t_min[live], chunk_min))
        log_t = log_t.index_copy(0, live, log_cp[:, -1, :])
    return accum, t_min

def tiles_to_image(rgb_tiles, t_final, bg, ntx: int, nty: int,
                   width: int, height: int):
    """Tile outputs -> ([H, W, 3] with T_final * bg added, [H, W] T_final)."""
    out = rgb_tiles + t_final[:, None, :] * bg[None, :, None]
    out = out.reshape(nty, ntx, 3, TILE, TILE).permute(0, 3, 1, 4, 2)
    out = out.reshape(nty * TILE, ntx * TILE, 3)
    tf = t_final.reshape(nty, ntx, TILE, TILE).permute(0, 2, 1, 3)
    tf = tf.reshape(nty * TILE, ntx * TILE)
    return out[:height, :width], tf[:height, :width]


# ---- frozen from manus_tpu_torch/ops/rasterizer/api.py
def calculate_colors_from_sh(
    posed_means: torch.Tensor,
    cano_features: torch.Tensor,  # [N, K, 3] (dc first)
    cano_means: torch.Tensor,
    camera: Camera,
    sh_degree: int,
    tf: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """View-dependent RGB from SH. For articulated models (tf given) the
    camera centre is pulled back through inv(tf) per gaussian, a closed-form
    3x3 adjugate solve, so the SH stay pose-invariant; a singular blend
    keeps the untransformed centre."""
    shs = cano_features.transpose(-1, -2)  # [N, 3, K]
    center = camera.camera_center
    if tf is not None:
        R = tf[:, :3, :3]
        rhs = center[None, :] - tf[:, :3, 3]
        a, b, c = R[:, 0, 0], R[:, 0, 1], R[:, 0, 2]
        d, e, f = R[:, 1, 0], R[:, 1, 1], R[:, 1, 2]
        g, h, i = R[:, 2, 0], R[:, 2, 1], R[:, 2, 2]
        co00 = e * i - f * h
        co01 = c * h - b * i
        co02 = b * f - c * e
        co10 = f * g - d * i
        co11 = a * i - c * g
        co12 = c * d - a * f
        co20 = d * h - e * g
        co21 = b * g - a * h
        co22 = a * e - b * d
        det = a * co00 + b * co10 + c * co20
        ok = det.abs() > 1e-12
        inv_det = 1.0 / torch.where(ok, det, torch.ones_like(det))
        x = (co00 * rhs[:, 0] + co01 * rhs[:, 1] + co02 * rhs[:, 2]) * inv_det
        y = (co10 * rhs[:, 0] + co11 * rhs[:, 1] + co12 * rhs[:, 2]) * inv_det
        z = (co20 * rhs[:, 0] + co21 * rhs[:, 1] + co22 * rhs[:, 2]) * inv_det
        cam_inv = torch.where(ok[:, None], torch.stack([x, y, z], dim=-1),
                              center[None, :])
        dirs = cano_means - cam_inv
    else:
        dirs = posed_means - center
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    rgb = eval_sh(sh_degree, shs, dirs)
    return torch.clamp(rgb + 0.5, min=0.0)


# ---- frozen from manus_tpu_torch/utils/losses.py
def l1_loss(pred, gt, mean: bool = True):
    loss = (pred - gt).abs()
    return loss.mean() if mean else loss

def psnr(pred, gt):
    """-10 log10(MSE)."""
    return -10.0 * torch.log10(((pred - gt) ** 2).mean())

@functools.lru_cache(maxsize=16)
def _banded_blur_matrix(size: int, window_size: int, sigma: float) -> np.ndarray:
    """[size, size] banded Toeplitz matrix of the normalised 1D Gaussian
    with zero padding (rows near the border see fewer taps)."""
    g = np.exp(
        -((np.arange(window_size) - window_size // 2) ** 2) / (2 * sigma**2)
    )
    g = (g / g.sum()).astype(np.float32)
    half = window_size // 2
    m = np.zeros((size, size), np.float32)
    for off in range(-half, half + 1):
        m += np.diag(np.full(size - abs(off), g[off + half], np.float32), k=off)
    return m

def _depthwise_blur(img, window_size: int, sigma: float):
    """Per-channel separable Gaussian blur of [H, W, C] with zero padding."""
    h, w, _ = img.shape
    bw = torch.as_tensor(_banded_blur_matrix(w, window_size, sigma),
                         device=img.device)
    bh = torch.as_tensor(_banded_blur_matrix(h, window_size, sigma),
                         device=img.device)
    out = torch.einsum("hwc,wv->hvc", img, bw)
    return torch.einsum("hwc,hu->uwc", out, bh)

def ssim(img1, img2, window_size: int = 11, sigma: float = 1.5):
    """Mean SSIM over [H, W, C] images in [0, 1]."""
    mu1 = _depthwise_blur(img1, window_size, sigma)
    mu2 = _depthwise_blur(img2, window_size, sigma)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _depthwise_blur(img1 * img1, window_size, sigma) - mu1_sq
    sigma2_sq = _depthwise_blur(img2 * img2, window_size, sigma) - mu2_sq
    sigma12 = _depthwise_blur(img1 * img2, window_size, sigma) - mu1_mu2
    C1, C2 = 0.01**2, 0.03**2
    ssim_map = ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2)
    )
    return ssim_map.mean()

def isotropic_regularizer(scaling, condition_number: float, active=None):
    """mean((min_scale / max_scale - condition_number)^2) over active slots.
    scaling: [N, 3] activated scales."""
    per_pt = (scaling.amin(1) / (scaling.amax(1) + 1e-8) - condition_number) ** 2
    if active is None:
        return per_pt.mean()
    per_pt = torch.where(active, per_pt, 0.0)
    return per_pt.sum() / active.sum().clamp(min=1)


# ---- frozen from manus_tpu_torch/train/optim.py
BETA1, BETA2 = 0.9, 0.999

EPS = 1e-15

class AdamState(NamedTuple):
    m: GaussianParams
    v: GaussianParams
    step: int

def init_adam(params: GaussianParams) -> AdamState:
    return AdamState(
        m=GaussianParams(*(torch.zeros_like(p) for p in params)),
        v=GaussianParams(*(torch.zeros_like(p) for p in params)),
        step=0,
    )

def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)

def expon_lr(step: int, lr_init: float, lr_final: float,
             lr_delay_steps: int = 0, lr_delay_mult: float = 1.0,
             max_steps: int = 1000000) -> torch.Tensor:
    """Log-linear LR interpolation, a 0-d float32 tensor; 0 when both
    endpoints are 0 ("disable this parameter")."""
    if lr_init == 0.0 and lr_final == 0.0:
        return _f32(0.0)
    step = _f32(step)
    delay_rate = _f32(1.0)
    if lr_delay_steps > 0:
        delay_rate = lr_delay_mult + (1 - lr_delay_mult) * torch.sin(
            0.5 * math.pi * torch.clamp(step / lr_delay_steps, 0, 1))
    t = torch.clamp(step / max_steps, 0, 1)
    log_lerp = torch.exp(_f32(math.log(lr_init)) * (1 - t)
                         + _f32(math.log(lr_final)) * t)
    return delay_rate * log_lerp

def group_learning_rates(opts, step: int) -> GaussianParams:
    """Per-leaf learning rates for the current step."""
    return GaussianParams(
        xyz=expon_lr(
            step,
            opts.position_lr_init * opts.spatial_lr_scale,
            opts.position_lr_final * opts.spatial_lr_scale,
            lr_delay_mult=opts.position_lr_delay_mult,
            max_steps=opts.position_lr_max_steps,
        ),
        features_dc=_f32(opts.feature_lr),
        features_rest=_f32(opts.feature_lr / 20.0),
        scaling=_f32(opts.scaling_lr),
        rotation=_f32(opts.rotation_lr),
        opacity=_f32(opts.opacity_lr),
    )

def _row_mask(mask, x):
    return mask.reshape((-1,) + (1,) * (x.dim() - 1))

def adam_update(params: GaussianParams, grads: GaussianParams,
                state: AdamState, lrs: GaussianParams, active: torch.Tensor):
    """One masked Adam step; inactive slots are not updated. Bias
    correction uses the global step. Returns (params, state), new tensors."""
    step = state.step + 1
    bc1 = 1.0 - _f32(BETA1) ** step
    bc2 = 1.0 - _f32(BETA2) ** step
    new_p, new_m, new_v = [], [], []
    for p, g, m, v, lr in zip(params, grads, state.m, state.v, lrs):
        mask = _row_mask(active, p)
        g = torch.where(mask, g, 0.0)
        m = BETA1 * m + (1 - BETA1) * g
        v = BETA2 * v + (1 - BETA2) * g * g
        upd = p - lr.to(p.device) * (m / bc1.to(p.device)) / (
            torch.sqrt(v / bc2.to(p.device)) + EPS)
        new_p.append(torch.where(mask, upd, p))
        new_m.append(m)
        new_v.append(v)
    return GaussianParams(*new_p), AdamState(
        m=GaussianParams(*new_m), v=GaussianParams(*new_v), step=step)

def reset_moments_rows(state: AdamState, rows_mask: torch.Tensor) -> AdamState:
    """Zero first and second moments of the masked rows (densify surgery)."""

    def zero_rows(x):
        return torch.where(_row_mask(rows_mask, x), 0.0, x)

    return AdamState(
        m=GaussianParams(*(zero_rows(x) for x in state.m)),
        v=GaussianParams(*(zero_rows(x) for x in state.v)),
        step=state.step,
    )


# ---- frozen from manus_tpu_torch/ops/mask_prune.py
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

