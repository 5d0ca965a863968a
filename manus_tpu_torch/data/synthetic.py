"""Synthetic scenes: self-supervised stand-ins for the capture data.

A ground-truth gaussian cloud rendered from hemisphere cameras (static),
and an articulated bone-skinned cloud driven by a skeleton's poses
(dynamic): the reference's novel_pose.pkl when it is at REFERENCE_POSES,
else a procedural skeleton. Every draw is a numpy RandomState from a
seed, so the same seed gives the JAX package's scene; the gt images are
rendered through render_gaussians on the dataset's device (the composite
kernels on a CUDA device, their plain version on the CPU) and kept as
numpy arrays, as the loaders keep theirs.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Optional

import numpy as np
import torch

from manus_tpu_torch.data import REFERENCE_DATA
from manus_tpu_torch.models.gaussians import GaussianModel
from manus_tpu_torch.ops.knn import nearest_neighbor
from manus_tpu_torch.ops.rasterizer.api import render_gaussians
from manus_tpu_torch.ops.skinning import (
    bone_deformation_transforms,
    skin_gaussians,
)
from manus_tpu_torch.utils.camera import (
    Camera,
    index_camera,
    make_camera,
    stack_cameras,
)
from manus_tpu_torch.utils.device import resolve_device
from manus_tpu_torch.utils.structures import Bones
from manus_tpu_torch.utils.transforms import covariance_from_scaling_rotation

REFERENCE_POSES = os.path.join(REFERENCE_DATA, "meta_data", "novel_pose.pkl")


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


def get_scene_extent(cam_centers: np.ndarray) -> float:
    """1.1 x the largest distance of a camera centre ([3, N], one column a
    camera) from their mean (the reference's cam_utils.py:10-16)."""
    center = np.mean(cam_centers, axis=1, keepdims=True)
    dist = np.linalg.norm(cam_centers - center, axis=0, keepdims=True)
    return float(np.max(dist) * 1.1)


def _cov6(scales: np.ndarray, quats: np.ndarray) -> np.ndarray:
    return covariance_from_scaling_rotation(
        torch.tensor(scales), torch.tensor(quats)).numpy()


def gt_object_gaussians(n: int = 800, seed: int = 0):
    """A colourful blobby object: gaussians on a deformed sphere."""
    rng = np.random.RandomState(seed)
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    radius = 0.5 * (1.0 + 0.25 * np.sin(4 * u[:, 0]) * np.cos(3 * u[:, 1]))
    means = (u * radius[:, None]).astype(np.float32)
    scales = rng.uniform(0.02, 0.06, (n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    colors = (0.5 + 0.5 * np.stack(
        [np.sin(3 * means[:, 0]), np.cos(5 * means[:, 1]),
         np.sin(2 * means[:, 2])], axis=1,
    )).astype(np.float32)
    opacity = rng.uniform(0.7, 0.98, (n,)).astype(np.float32)
    return dict(means=means, cov6=_cov6(scales, quats), colors=colors,
                opacity=opacity)


def load_reference_skeleton() -> Optional[dict]:
    """The reference's 20-bone hand skeleton and its posed frames, from
    REFERENCE_POSES; None when the file is not there."""
    return load_skeleton(REFERENCE_POSES)


def load_skeleton(path: str) -> Optional[dict]:
    """A meta_data pose pkl (the export_novel_pose.py contract) as
    world-space rest and pose transforms, heads and tails; None if the
    file is absent."""
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        d = pickle.load(f)
    # armature -> world (reference transforms.py:561-590)
    rest_T = np.einsum("bij,bjk->bik", d["rest_matrix_world"],
                       d["rest_matrixs"])
    pose_T = np.einsum("fbij,fbjk->fbik", d["pose_matrix_world"],
                       d["pose_matrixs"])

    def world(mw, pts):
        h = np.concatenate([pts, np.ones_like(pts[..., :1])], axis=-1)
        return np.einsum("...ij,...j->...i", mw, h)[..., :3]

    return dict(
        bnames=[str(b) for b in d["bnames"]],
        bnames_parent=[str(b) for b in d["bnames_parent"]],
        rest_heads=world(d["rest_matrix_world"], d["rest_heads"]),
        rest_tails=world(d["rest_matrix_world"], d["rest_tails"]),
        rest_transforms=rest_T.astype(np.float32),
        pose_heads=world(d["pose_matrix_world"], d["pose_heads"]),
        pose_tails=world(d["pose_matrix_world"], d["pose_tails"]),
        pose_transforms=pose_T.astype(np.float32),
    )


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


def _bg(bg_color: str) -> np.ndarray:
    return np.zeros(3, np.float32) if bg_color == "black" \
        else np.ones(3, np.float32)


def _render_gt(means, cov6, colors, opacity, cam, bg, device):
    """One gt view: the render and its mask (final transmittance < 0.5),
    as numpy."""
    n = means.shape[0]
    with torch.no_grad():
        out = render_gaussians(
            means, cov6, means, torch.zeros(n, 16, 3, device=device),
            opacity, cam, bg, colors_precomp=colors)
    return out.render.cpu().numpy(), (out.t_final < 0.5).cpu().numpy()[..., None]


def _extent(cams) -> float:
    return get_scene_extent(
        np.stack([c.camera_center.cpu().numpy() for c in cams], axis=1))


@dataclasses.dataclass
class SyntheticStaticDataset:
    """Static object scene: gt gaussians, hemisphere cameras, gt renders."""

    cameras: Camera  # stacked [V], on the dataset's device
    images: np.ndarray  # [V, H, W, 3]
    masks: np.ndarray  # [V, H, W, 1] bool
    bg_color: str
    extent: float
    gt: dict
    width: int
    height: int

    @property
    def num_views(self) -> int:
        return self.images.shape[0]

    def get_batch(self, frame: int, views):
        return dict(rgb=self.images[views], mask=self.masks[views])

    def sample_gaussians(self, n: int, seed: int = 1):
        """A noisy init cloud near the gt surface (gt means plus noise)."""
        rng = np.random.RandomState(seed)
        idx = rng.randint(0, self.gt["means"].shape[0], n)
        pts = self.gt["means"][idx] + rng.normal(0, 0.05, (n, 3))
        cols = np.clip(
            self.gt["colors"][idx] + rng.normal(0, 0.2, (n, 3)), 0, 1
        )
        return pts.astype(np.float32), cols.astype(np.float32)


def build_synthetic_static(
    width=128, height=128, num_cameras=20, n_gaussians=800, seed=0,
    bg_color="black", device=None,
) -> SyntheticStaticDataset:
    device = resolve_device(device)
    cams = hemisphere_cameras(num_cameras, width, height, seed=seed,
                              device=device)
    gt = gt_object_gaussians(n_gaussians, seed=seed)

    def t(x):
        return torch.as_tensor(x, device=device)

    bg = t(_bg(bg_color))
    views = [_render_gt(t(gt["means"]), t(gt["cov6"]), t(gt["colors"]),
                        t(gt["opacity"]), c, bg, device)
             for c in cams]
    return SyntheticStaticDataset(
        cameras=stack_cameras(cams),
        images=np.stack([v[0] for v in views]).astype(np.float32),
        masks=np.stack([v[1] for v in views]),
        bg_color=bg_color,
        extent=_extent(cams),
        gt=gt,
        width=width,
        height=height,
    )


@dataclasses.dataclass
class SyntheticDynamicDataset:
    """Articulated hand scene: skeleton frames and gt skinned-cloud renders."""

    cameras: Camera  # stacked [V], on the dataset's device
    images: np.ndarray  # [F, V, H, W, 3]
    masks: np.ndarray  # [F, V, H, W, 1] bool
    bones_rest: Bones
    bones_posed: list  # one Bones per frame
    bg_color: str
    extent: float
    gt: dict
    width: int
    height: int

    @property
    def num_views(self):
        return self.images.shape[1]

    @property
    def num_frames(self):
        return self.images.shape[0]

    def get_batch(self, frame: int, views):
        return dict(rgb=self.images[frame, views],
                    mask=self.masks[frame, views])

    def sample_gaussians_on_bones(self, samples_per_bone: int, seed: int = 1):
        return sample_gaussians_on_bones(
            self.bones_rest.heads.cpu().numpy(),
            self.bones_rest.tails.cpu().numpy(),
            self.bones_rest.transforms.cpu().numpy(),
            samples_per_bone,
            seed=seed,
        )


def build_synthetic_dynamic(
    width=128, height=128, num_cameras=8, num_frames=4,
    samples_per_bone_gt=60, seed=0, bg_color="black",
    use_reference_skeleton=True, device=None,
) -> SyntheticDynamicDataset:
    device = resolve_device(device)
    skel = load_reference_skeleton() if use_reference_skeleton else None
    if skel is None:
        skel = procedural_skeleton(max(num_frames, 2))
    f_total = skel["pose_transforms"].shape[0]
    frame_ids = np.linspace(0, f_total - 1, num_frames).astype(int)

    center = skel["rest_heads"].mean(axis=0)
    span = np.linalg.norm(
        skel["rest_tails"] - skel["rest_heads"], axis=1
    ).sum()
    cam_dist = max(1.0, 2.5 * span / 4)
    cams = hemisphere_cameras(num_cameras, width, height, dist=cam_dist,
                              seed=seed, center=center, device=device)

    # gt: gaussians rigidly attached to bones (hard skinning), posed per
    # frame by LBS, so the images are those of an articulated model
    pts, cols = sample_gaussians_on_bones(
        skel["rest_heads"], skel["rest_tails"], skel["rest_transforms"],
        samples_per_bone_gt, seed=seed,
    )
    rng = np.random.RandomState(seed + 1)
    n = pts.shape[0]
    scale0 = span / 120.0
    scales = rng.uniform(0.5 * scale0, 1.2 * scale0, (n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    cov6 = _cov6(scales, quats)
    opacity = rng.uniform(0.7, 0.98, (n,)).astype(np.float32)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    # hard skin weights: the nearest of 16 points along each bone
    t_vals = np.linspace(0.05, 0.95, 16)[:, None]
    j = skel["rest_heads"].shape[0]
    seg_pts = np.concatenate([
        skel["rest_heads"][b][None] * (1 - t_vals)
        + skel["rest_tails"][b][None] * t_vals for b in range(j)
    ]).astype(np.float32)
    seg_ids = np.repeat(np.arange(j), 16)
    _, nn_idx = nearest_neighbor(t(pts), t(seg_pts))
    bone_of = seg_ids[nn_idx.cpu().numpy()]
    skin = np.zeros((n, j), np.float32)
    skin[np.arange(n), bone_of] = 1.0

    bones_rest = Bones(heads=t(skel["rest_heads"]),
                       tails=t(skel["rest_tails"]),
                       transforms=t(skel["rest_transforms"]))
    gt = dict(means=pts, cov6=cov6, colors=cols, opacity=opacity, skin=skin,
              scales=scales, quats=quats)

    bg = t(_bg(bg_color))
    pts_d, cov_d, skin_d = t(pts), t(cov6), t(skin)
    cols_d, opac_d = t(cols), t(opacity)
    images = np.zeros((num_frames, num_cameras, height, width, 3), np.float32)
    masks = np.zeros((num_frames, num_cameras, height, width, 1), bool)
    bones_posed = []
    for fi, fid in enumerate(frame_ids):
        pose_T = t(skel["pose_transforms"][fid])
        bones_posed.append(Bones(heads=t(skel["pose_heads"][fid]),
                                 tails=t(skel["pose_tails"][fid]),
                                 transforms=pose_T))
        with torch.no_grad():
            sk = skin_gaussians(pts_d, cov_d, skin_d, bone_deformation_transforms(
                pose_T, bones_rest.transforms))
        for vi, c in enumerate(cams):
            images[fi, vi], masks[fi, vi] = _render_gt(
                sk.posed_xyz, sk.posed_cov, cols_d, opac_d, c, bg, device)

    return SyntheticDynamicDataset(
        cameras=stack_cameras(cams),
        images=images,
        masks=masks,
        bones_rest=bones_rest,
        bones_posed=bones_posed,
        bg_color=bg_color,
        extent=_extent(cams),
        gt=gt,
        width=width,
        height=height,
    )


def split_synthetic_static(ds: SyntheticStaticDataset, n_val: int = 2):
    """Held-out cameras (the reference's brics_static.py:61-66): the first
    `n_val` validate, the rest train (at least one). Returns (train, val)."""
    n_val = min(n_val, ds.num_views - 1)

    def take(idx):
        return dataclasses.replace(
            ds,
            cameras=index_camera(ds.cameras, torch.as_tensor(
                idx, device=ds.cameras.K.device)),
            images=ds.images[idx],
            masks=ds.masks[idx],
        )

    return take(np.arange(n_val, ds.num_views)), take(np.arange(n_val))


def split_synthetic_dynamic(ds: SyntheticDynamicDataset,
                            split_ratio: float = 0.1):
    """Held-out frames: the head frames train, the tail frames validate;
    split_ratio is the val share (as data/brics.py's). Returns (train,
    val)."""
    n_train = max(
        1,
        min(ds.num_frames - 1, int(round((1.0 - split_ratio) * ds.num_frames))),
    )

    def take(sl):
        return dataclasses.replace(
            ds,
            images=ds.images[sl],
            masks=ds.masks[sl],
            bones_posed=ds.bones_posed[sl],
        )

    return take(slice(0, n_train)), take(slice(n_train, ds.num_frames))
