"""Rotation and covariance math for gaussians, batched torch.

Quaternions are (w, x, y, z), real part first. Covariances travel as [N, 6]
upper-triangular rows (xx, xy, xz, yy, yz, zz).
"""
from __future__ import annotations

import torch


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
