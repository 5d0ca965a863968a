"""Synthetic hand scenes: a procedural skeleton, gaussians sampled on its
bones, and hemisphere cameras. Data is made with numpy from a seed, so a
test can feed the same scene to the JAX package and to this port."""
from __future__ import annotations

import numpy as np
import torch

from manus_tpu_torch.models.gaussians import GaussianModel
from manus_tpu_torch.utils.camera import Camera, make_camera


def hemisphere_cameras(
    num: int, width: int, height: int, dist: float = 3.0, fov_deg: float = 50.0,
    seed: int = 0, center=(0.0, 0.0, 0.0), device=None,
) -> list[Camera]:
    """Cameras on a hemisphere looking at `center` (BRICS-rig-like)."""
    rng = np.random.RandomState(seed)
    f = width / (2 * np.tan(np.radians(fov_deg) / 2))
    K = np.array(
        [[f, 0, (width - 1) / 2], [0, f, (height - 1) / 2], [0, 0, 1.0]]
    )
    center = np.asarray(center, np.float64)
    cams = []
    for i in range(num):
        theta = 2 * np.pi * i / num + rng.uniform(0, 0.1)
        phi = np.radians(rng.uniform(15, 75))
        pos = center + dist * np.array(
            [np.cos(theta) * np.cos(phi), np.sin(phi), np.sin(theta) * np.cos(phi)]
        )
        fwd = center - pos
        fwd /= np.linalg.norm(fwd)
        up = np.array([0.0, -1.0, 0.0])
        right = np.cross(up, fwd)
        right /= np.linalg.norm(right) + 1e-9
        up2 = np.cross(fwd, right)
        R = np.stack([right, up2, fwd], axis=0)
        t = -R @ pos
        extr = np.concatenate([R, t[:, None]], axis=1)
        cams.append(make_camera(K.copy(), extr, width, height, device=device))
    return cams


def procedural_skeleton(num_frames: int = 8, scale: float = 0.25) -> dict:
    """A 13-bone skeleton (palm root + 4 fingers x 3 bones), flexing over
    `num_frames` frames; `scale` brings it to real-hand size (~0.25 world
    units). numpy arrays."""
    bones, parents, heads, tails = [], [], [], []
    bones.append("bone_root")
    parents.append("None")
    heads.append([0, 0, 0])
    tails.append([0, 0.3, 0])
    for f in range(4):
        parent = "bone_root"
        base = np.array([-0.15 + 0.1 * f, 0.3, 0.0])
        for j in range(3):
            name = f"bone_{f}_{j}"
            bones.append(name)
            parents.append(parent)
            heads.append(list(base + np.array([0, 0.15 * j, 0])))
            tails.append(list(base + np.array([0, 0.15 * (j + 1), 0])))
            parent = name
    heads = np.asarray(heads, np.float32) * scale
    tails = np.asarray(tails, np.float32) * scale
    j = len(bones)
    rest_T = np.tile(np.eye(4, dtype=np.float32), (j, 1, 1))
    rest_T[:, :3, 3] = heads
    pose_T = np.tile(rest_T[None], (num_frames, 1, 1, 1))
    for fidx in range(num_frames):
        ang = 0.6 * np.sin(2 * np.pi * fidx / num_frames)
        c, s = np.cos(ang), np.sin(ang)
        rot = np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)
        for b in range(1, j):
            pose_T[fidx, b, :3, :3] = rot @ pose_T[fidx, b, :3, :3]
    pose_heads = np.tile(heads[None], (num_frames, 1, 1))
    pose_tails = np.einsum(
        "fbij,bj->fbi", pose_T[:, :, :3, :3], tails - heads
    ) + pose_T[:, :, :3, 3]
    return dict(
        bnames=bones, bnames_parent=parents,
        rest_heads=heads, rest_tails=tails, rest_transforms=rest_T,
        pose_heads=pose_heads, pose_tails=pose_tails,
        pose_transforms=pose_T.astype(np.float32),
    )


def sample_gaussians_on_bones(
    heads: np.ndarray, tails: np.ndarray, transforms: np.ndarray,
    samples_per_bone: int, seed: int = 0,
):
    """Anisotropic gaussian sampling along bones and at joints (the
    reference init, train_utils.py:104-139). Returns numpy (points, colors)."""
    rng = np.random.RandomState(seed)
    j = heads.shape[0]
    mid = (heads + tails) / 2
    length = np.linalg.norm(tails - heads, axis=1, keepdims=True)
    rot = transforms[:, :3, :3]

    def draw(centers, scale_diag, count):
        S = np.zeros((j, 3, 3), np.float32)
        S[:, 0, 0], S[:, 1, 1], S[:, 2, 2] = (
            scale_diag[:, 0], scale_diag[:, 1], scale_diag[:, 2]
        )
        cov = rot @ S @ S.transpose(0, 2, 1) @ rot.transpose(0, 2, 1)
        L = np.linalg.cholesky(cov + 1e-12 * np.eye(3))
        z = rng.normal(size=(count, j, 3)).astype(np.float32)
        pts = centers[None] + np.einsum("jik,cjk->cji", L, z)
        return pts.reshape(-1, 3)

    scale_bones = np.concatenate([length / 5, length / 4, length / 4], axis=1)
    pts1 = draw(mid, scale_bones, samples_per_bone)
    scale_joints = np.concatenate([length / 6, length / 4, length / 6], axis=1)
    pts2 = draw(heads, scale_joints, samples_per_bone // 2)
    points = np.concatenate([pts1, pts2], axis=0).astype(np.float32)
    colors = rng.uniform(0, 1, points.shape).astype(np.float32)
    return points, colors


def perturb_model(model: GaussianModel, seed: int = 1, pos_sigma: float = 0.004,
                  col_sigma: float = 0.1) -> GaussianModel:
    """Jitter positions and dc colours with numpy noise from `seed`, so a
    model trained against renders of the clean one has a real loss."""
    rng = np.random.RandomState(seed)
    p = model.params

    def noise(x, sigma):
        n = rng.normal(0, sigma, tuple(x.shape)).astype(np.float32)
        return torch.as_tensor(n, device=x.device)

    params = p._replace(
        xyz=p.xyz + noise(p.xyz, pos_sigma),
        features_dc=p.features_dc + noise(p.features_dc, col_sigma),
    )
    return model._replace(params=params)
