"""Linear blend skinning of gaussians (reference hand_dynamic.py:86-137)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from manus_tpu_torch.ops import deform


class SkinnedGaussians(NamedTuple):
    posed_xyz: torch.Tensor  # [N, 3]
    posed_cov: torch.Tensor  # [N, 6]
    tf: torch.Tensor  # [N, 4, 4] blended per-point transforms


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
    """Blend bone transforms per point, then pose means and R Sigma R^T.

    CUDA tensors take the kernel pair of csrc/deform.cu
    (`ops.deform.skin_cuda`: float32, at most DEFORM_MAX_CHANNELS bones,
    no gradient to the transforms), CPU tensors the plain version
    (`skin_gaussians_torch`)."""
    if cano_xyz.is_cuda:
        return SkinnedGaussians(*deform.skin_cuda(
            cano_xyz, cano_cov, skin_weights, transforms))
    return skin_gaussians_torch(cano_xyz, cano_cov, skin_weights, transforms)


def skin_gaussians_torch(
    cano_xyz: torch.Tensor,  # [N, 3]
    cano_cov: torch.Tensor,  # [N, 6] upper-tri canonical covariance
    skin_weights: torch.Tensor,  # [N, B]
    transforms: torch.Tensor,  # [B, 4, 4]
) -> SkinnedGaussians:
    """skin_gaussians' plain version, one torch op a term."""
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
