"""Rotation, rigid-transform and covariance math, and forward kinematics,
batched torch (the JAX package's utils/transforms.py).

Quaternions are (w, x, y, z), real part first. Covariances travel as [N, 6]
upper-triangular rows (xx, xy, xz, yy, yz, zz). Every function takes
arbitrary leading batch dimensions.
"""
from __future__ import annotations

import numpy as np
import torch

from manus_tpu_torch.ops import deform


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


def build_scaling_rotation(s: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """L = R @ diag(s): [N, 3] scales and [N, 4] quats -> [N, 3, 3]."""
    return build_rotation(q) * s[:, None, :]


def strip_symmetric(cov: torch.Tensor) -> torch.Tensor:
    """[N, 3, 3] symmetric -> [N, 6] upper triangular."""
    return torch.stack(
        [cov[..., 0, 0], cov[..., 0, 1], cov[..., 0, 2],
         cov[..., 1, 1], cov[..., 1, 2], cov[..., 2, 2]],
        dim=-1,
    )


def build_symmetric(six: torch.Tensor) -> torch.Tensor:
    """[N, 6] upper triangular -> [N, 3, 3] symmetric."""
    xx, xy, xz, yy, yz, zz = six.unbind(-1)
    return torch.stack(
        [
            torch.stack([xx, xy, xz], dim=-1),
            torch.stack([xy, yy, yz], dim=-1),
            torch.stack([xz, yz, zz], dim=-1),
        ],
        dim=-2,
    )


def covariance_from_scaling_rotation(
    scaling: torch.Tensor, rotation: torch.Tensor, scaling_modifier: float = 1.0
) -> torch.Tensor:
    """Sigma = (R S)(R S)^T as [N, 6] upper-tri: sum_k s_k^2 R_ik R_jk.

    CUDA tensors take the kernel pair of csrc/deform.cu
    (`ops.deform.covariance_cuda`: float32, [N, 3] and [N, 4]), CPU
    tensors the plain version (`covariance_from_scaling_rotation_torch`).
    """
    if scaling.is_cuda or rotation.is_cuda:
        return deform.covariance_cuda(scaling, rotation, scaling_modifier)
    return covariance_from_scaling_rotation_torch(scaling, rotation,
                                                  scaling_modifier)


def covariance_from_scaling_rotation_torch(
    scaling: torch.Tensor, rotation: torch.Tensor, scaling_modifier: float = 1.0
) -> torch.Tensor:
    """covariance_from_scaling_rotation's plain version, one torch op a
    term."""
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


def _sqrt_positive_part(x: torch.Tensor) -> torch.Tensor:
    """sqrt(max(0, x)) with a zero subgradient at x == 0."""
    positive = x > 0
    return torch.where(positive, torch.sqrt(torch.where(positive, x, 1.0)),
                       0.0)


def matrix_to_quaternion(m: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] rotation -> [..., 4] wxyz quaternion, from the best
    conditioned of the four candidates (the largest |q_i|)."""
    batch = m.shape[:-2]
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = m.reshape(
        batch + (9,)).unbind(-1)
    q_abs = _sqrt_positive_part(torch.stack([
        1.0 + m00 + m11 + m22,
        1.0 + m00 - m11 - m22,
        1.0 - m00 + m11 - m22,
        1.0 - m00 - m11 + m22,
    ], dim=-1))
    quat_by_rijk = torch.stack([
        torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], -1),
        torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], -1),
        torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], -1),
        torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], -1),
    ], dim=-2)
    candidates = quat_by_rijk / (2.0 * q_abs[..., None].clamp_min(0.1))
    best = q_abs.argmax(-1)
    idx = best[..., None, None].expand(batch + (1, 4))
    return torch.gather(candidates, -2, idx)[..., 0, :]


def _sin_half_over_angle(angles, half):
    small = angles.abs() < 1e-6
    safe = torch.where(small, 1.0, angles)
    return torch.where(small, 0.5 - angles * angles / 48.0,
                       torch.sin(half) / safe)


def axis_angle_to_quaternion(axis_angle: torch.Tensor) -> torch.Tensor:
    """[..., 3] axis * angle -> [..., 4] wxyz."""
    angles = torch.linalg.norm(axis_angle, dim=-1, keepdim=True)
    half = angles * 0.5
    return torch.cat([torch.cos(half),
                      axis_angle * _sin_half_over_angle(angles, half)], -1)


def quaternion_to_axis_angle(q: torch.Tensor) -> torch.Tensor:
    """[..., 4] wxyz -> [..., 3] axis * angle."""
    norms = torch.linalg.norm(q[..., 1:], dim=-1, keepdim=True)
    half = torch.atan2(norms, q[..., :1])
    return q[..., 1:] / _sin_half_over_angle(2.0 * half, half)


def axis_angle_to_matrix(axis_angle: torch.Tensor) -> torch.Tensor:
    return quaternion_to_matrix(axis_angle_to_quaternion(axis_angle))


def matrix_to_axis_angle(m: torch.Tensor) -> torch.Tensor:
    return quaternion_to_axis_angle(matrix_to_quaternion(m))


# The cross-product matrices [k]x of the unit axes X, Y, Z and their
# squares: a rotation by t about axis k is I + sin t [k]x + (1 - cos t)
# [k]x^2 (Rodrigues), so one broadcast builds all three axes' matrices.
_AXIS_INDEX = {"X": 0, "Y": 1, "Z": 2}
_AXIS_PLANE = ((1, 2), (2, 0), (0, 1))  # where [k]x's two entries sit
_axis_consts = {}


def _axis_constants(convention: str, dtype, device):
    """[k]x and [k]x^2 of the convention's three axes ([3, 3, 3] each) and
    the identity, on device, made once. They are written on the device
    entry by entry: a copy from the host would synchronise it, and the
    first call may come inside a loop that must not (preprocess/ik.py)."""
    key = (convention, dtype, device)
    if key not in _axis_consts:
        k = torch.zeros((3, 3, 3), dtype=dtype, device=device)
        for n, c in enumerate(convention):
            i, j = _AXIS_PLANE[_AXIS_INDEX[c]]
            k[n, j, i].fill_(1.0)  # fill_: setitem copies from the host
            k[n, i, j].fill_(-1.0)
        _axis_consts[key] = (k, k @ k,
                             torch.eye(3, dtype=dtype, device=device))
    return _axis_consts[key]


def euler_angles_to_matrix(euler: torch.Tensor, convention: str = "XYZ",
                           intrinsic: bool = False) -> torch.Tensor:
    """[..., 3] Euler angles (radians) -> [..., 3, 3]: the product of the
    three single-axis rotations in the convention's order.
    intrinsic=True reverses the convention and the angles, the
    reference's convention for hand poses. The three rotations are built
    in one broadcast (Rodrigues on each unit axis), so a batch of angles
    costs a handful of launches."""
    if len(convention) != 3 or any(c not in "XYZ" for c in convention):
        raise ValueError(f"bad convention {convention}")
    if intrinsic:
        convention = convention[::-1]
        euler = euler.flip(-1)
    k, k2, eye = _axis_constants(convention, euler.dtype, euler.device)
    m = (eye + torch.sin(euler)[..., None, None] * k
         + (1 - torch.cos(euler))[..., None, None] * k2)  # [..., 3, 3, 3]
    return m[..., 0, :, :] @ m[..., 1, :, :] @ m[..., 2, :, :]


def euler_angles_to_quats(euler: torch.Tensor) -> torch.Tensor:
    """Intrinsic-XYZ Euler angles -> wxyz quaternions."""
    return matrix_to_quaternion(
        euler_angles_to_matrix(euler, "XYZ", intrinsic=True))


def homogenize_matrix(x: torch.Tensor) -> torch.Tensor:
    """[..., 3, 4] -> [..., 4, 4] by appending the (0, 0, 0, 1) row (made on
    x's device: no copy from the host)."""
    row = torch.zeros_like(x[..., :1, :])
    row[..., 3].fill_(1.0)
    return torch.cat([x, row], dim=-2)


def transform_points(mat: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply [..., 4, 4] (or [4, 4]) transforms to [..., 3] points."""
    return torch.einsum("...ij,...j->...i", mat,
                        homogenize_points(pts))[..., :3]


# ---------------------------------------------------------------------------
# Forward kinematics. An inverse on a CUDA tensor synchronises the host
# (torch.linalg.inv checks its result): preprocess/ik.py takes the rest
# inverses once, before its loop.


def build_kintree(bnames, bnames_parent) -> dict:
    """Bone index (str) -> parent index, -1 for a root."""
    bnames = [str(b) for b in np.asarray(bnames).tolist()]
    parents = [None if p is None else str(p)
               for p in np.asarray(bnames_parent).tolist()]
    return {str(i): (bnames.index(p) if p is not None and p != "None"
                     else -1)
            for i, p in enumerate(parents)}


def kintree_to_parent_array(kintree: dict) -> np.ndarray:
    """kintree dict -> int32 parent array (host side)."""
    return np.asarray([kintree[str(i)] for i in range(len(kintree))],
                      dtype=np.int32)


def get_pose_wrt_root(rest_pose: torch.Tensor, pose_param: torch.Tensor,
                      global_pose: torch.Tensor, global_t: torch.Tensor,
                      kintree: dict) -> torch.Tensor:
    """FK along the kinematic tree: [B, J, 4, 4] posed bone matrices.

    rest_pose [J, 4, 4] rest bone matrices; pose_param [B, J, 3, 3] local
    joint rotations; global_pose [B, 3, 3] and global_t [B, 3] the root's
    rotation and translation; kintree {str(i): parent or -1}. A root is
    global @ rest @ pose, a child parent @ (rest_inv[parent] @ rest @
    pose), unrolled over the (static) bones."""
    parents = kintree_to_parent_array(kintree)
    global_trans = homogenize_matrix(
        torch.cat([global_pose, global_t[..., None]], dim=-1))
    pose_h = homogenize_matrix(
        torch.cat([pose_param, torch.zeros_like(pose_param[..., :1])], -1))
    rest_inv = torch.linalg.inv(rest_pose)
    out = [None] * rest_pose.shape[0]
    for i, p in enumerate(parents):
        if p == -1:
            out[i] = global_trans @ rest_pose[i] @ pose_h[:, i]
    for i, p in enumerate(parents):
        if p != -1:
            out[i] = out[p] @ ((rest_inv[p] @ rest_pose[i]) @ pose_h[:, i])
    return torch.stack(out, dim=1)


def rest_local_points(rest_pose: torch.Tensor, rest_joints: torch.Tensor,
                      rest_inv: torch.Tensor = None) -> torch.Tensor:
    """[J, 4] homogeneous joints in their bone's rest frame."""
    if rest_inv is None:
        rest_inv = torch.linalg.inv(rest_pose)
    return torch.einsum("jik,jk->ji", rest_inv, homogenize_points(rest_joints))


def get_keypoints(pose_matrix: torch.Tensor, rest_pose: torch.Tensor,
                  rest_joints: torch.Tensor) -> torch.Tensor:
    """Posed joint positions [B, J, 3] from bone matrices [B, J, 4, 4],
    rest matrices [J, 4, 4] and rest joints [J, 3]."""
    local = rest_local_points(rest_pose, rest_joints)
    return torch.einsum("bjik,jk->bji", pose_matrix, local)[..., :3]
