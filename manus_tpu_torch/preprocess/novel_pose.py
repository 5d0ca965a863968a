"""Novel-pose sequences without Blender (the JAX package's
preprocess/novel_pose.py): FK of per-joint Euler trajectories over a rest
skeleton, written in the reference's meta_data pkl contract (bnames,
rest/pose matrixs, heads and tails, eulers, root rotation and
translation). The trajectories are flexion cycles inside the anatomical
limits of preprocess/ik.default_hand_dof, or interpolations between key
poses. The pkl loads through data.synthetic.load_skeleton; its
armature->world matrices are identities, so world and armature space
coincide.
"""
from __future__ import annotations

import os
import pickle
from typing import Optional

import numpy as np
import torch

from manus_tpu_torch.preprocess.ik import default_hand_dof
from manus_tpu_torch.utils.device import resolve_device
from manus_tpu_torch.utils.transforms import (
    build_kintree,
    euler_angles_to_matrix,
    get_keypoints,
    get_pose_wrt_root,
)


def flexion_eulers(num_frames: int, dof: np.ndarray, limits: np.ndarray,
                   amplitude: float = 0.8, phase: Optional[np.ndarray] = None,
                   cycles: float = 1.0) -> np.ndarray:
    """[F, J, 3] Euler trajectory: each allowed axis (dof [J, 3], per bone,
    no root row) sweeps a sinusoid over `amplitude` of its limit range
    (limits [J, 3, 2] radians), so every frame is inside the limits."""
    dof = np.asarray(dof, bool)
    limits = np.asarray(limits, np.float32)
    j = dof.shape[0]
    if phase is None:
        phase = np.linspace(0.0, np.pi / 2, j, dtype=np.float32)
    t = np.linspace(0.0, 2 * np.pi * cycles, num_frames, endpoint=False)
    s = 0.5 * (1.0 + np.sin(t[:, None] + phase[None, :]))  # [F, J] in [0, 1]
    lo, hi = limits[..., 0], limits[..., 1]
    mid = 0.5 * (lo + hi)
    half = 0.5 * (hi - lo) * amplitude
    ang = mid[None] + (s[..., None] * 2.0 - 1.0) * half[None]
    return np.where(dof[None], ang, 0.0).astype(np.float32)


def interpolate_eulers(key_eulers: np.ndarray, num_frames: int,
                       ease: bool = True) -> np.ndarray:
    """[F, J, 3] piecewise interpolation through K key poses [K, J, 3],
    cosine-eased per segment; the ends are the first and last keys."""
    keys = np.asarray(key_eulers, np.float32)
    k = keys.shape[0]
    if k == 1:
        return np.tile(keys, (num_frames, 1, 1))
    pos = np.linspace(0.0, k - 1.0, num_frames)
    seg = np.minimum(pos.astype(int), k - 2)
    t = (pos - seg).astype(np.float32)
    if ease:
        t = 0.5 * (1.0 - np.cos(np.pi * t))
    return (keys[seg] * (1.0 - t[:, None, None])
            + keys[seg + 1] * t[:, None, None]).astype(np.float32)


def generate_novel_pose(skeleton: dict, eulers: np.ndarray,
                        root_rotation: Optional[np.ndarray] = None,
                        root_translation: Optional[np.ndarray] = None,
                        out_path: Optional[str] = None, device=None) -> dict:
    """FK of eulers [F, J, 3] (per-bone local, intrinsic XYZ) over the
    skeleton (bnames, bnames_parent, rest_transforms [J, 4, 4] world
    space, rest_heads / rest_tails [J, 3], as data.synthetic's skeletons
    carry them) into the meta_data pkl dict, written to out_path when
    given. FK runs on `device` (the card by default)."""
    device = resolve_device(device)
    rest_T = np.asarray(skeleton["rest_transforms"], np.float32)
    heads = np.asarray(skeleton["rest_heads"], np.float32)
    tails = np.asarray(skeleton["rest_tails"], np.float32)
    j = rest_T.shape[0]
    eulers = np.asarray(eulers, np.float32)
    f = eulers.shape[0]
    if root_rotation is None:
        root_rotation = np.zeros((f, 3), np.float32)
    if root_translation is None:
        root_translation = np.zeros((f, 3), np.float32)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    kintree = build_kintree(skeleton["bnames"], skeleton["bnames_parent"])
    rest = t(rest_T)
    pose_param = euler_angles_to_matrix(t(eulers), "XYZ", intrinsic=True)
    root_R = euler_angles_to_matrix(t(root_rotation), "XYZ", intrinsic=True)
    pose_T = get_pose_wrt_root(rest, pose_param, root_R, t(root_translation),
                               kintree)
    pose_heads = get_keypoints(pose_T, rest, t(heads)).cpu().numpy()
    pose_tails = get_keypoints(pose_T, rest, t(tails)).cpu().numpy()
    pose_param = pose_param.cpu().numpy()

    eye = np.tile(np.eye(4, dtype=np.float32), (j, 1, 1))
    out = {
        "bnames": np.asarray(skeleton["bnames"]),
        "bnames_parent": np.asarray([str(p) for p in
                                     skeleton["bnames_parent"]]),
        "rest_matrixs": rest_T,
        "rest_tails": tails,
        "rest_heads": heads,
        "pose_matrixs": pose_T.cpu().numpy().astype(np.float32),
        "pose_tails": pose_tails.astype(np.float32),
        "pose_heads": pose_heads.astype(np.float32),
        "pose_params": np.concatenate(
            [pose_param, np.zeros((f, j, 3, 1), np.float32)], axis=-1),
        "rest_matrix_world": eye,
        "pose_matrix_world": np.tile(eye[None], (f, 1, 1, 1)),
        "eulers": eulers,
        "root_translation": np.asarray(root_translation, np.float32),
        "root_rotation": np.asarray(root_rotation, np.float32),
    }
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "wb") as fh:
            pickle.dump(out, fh)
    return out


def generate_flexion_sequence(skeleton: dict, num_frames: int = 60,
                              amplitude: float = 0.6,
                              out_path: Optional[str] = None,
                              device=None) -> dict:
    """A flexion cycle in the pkl contract: within default_hand_dof's
    limits for a 20-bone hand, else every bone but the root flexing about
    x in [-0.9, 0.3]."""
    j = len(skeleton["bnames"])
    if j == 20:
        dof, limits = default_hand_dof(j)
        eulers = flexion_eulers(num_frames, dof[1:], limits[1:], amplitude)
    else:
        dof = np.zeros((j, 3), bool)
        dof[1:, 0] = True
        limits = np.zeros((j, 3, 2), np.float32)
        limits[..., 0], limits[..., 1] = -0.9, 0.3
        eulers = flexion_eulers(num_frames, dof, limits, amplitude)
    return generate_novel_pose(skeleton, eulers, out_path=out_path,
                               device=device)
