"""The voxel skinning-weight grid of the hand model.

A regular grid over the canonical hand's bounding box (the reference's
build_voxel_grid and init_mano_weights) whose cells hold skinning
weights plus a last, background channel for cells far from the hand.
With the MANO rest mesh, a cell's weights are the mean of its nearest
vertices' weights (MANO's 16 joint columns mapped onto the 20-bone rig);
without it, soft weights of the nearest skeleton keypoints stand in. The
reference labels off-surface cells with a signed-distance test; here a
cell farther than a margin from the mesh (or three margins from the
keypoints) is background. The grid is built on the given device.
"""
from __future__ import annotations

import os
import pickle
from typing import Optional

import numpy as np
import torch

from manus_tpu_torch.config import ExperimentConfig
from manus_tpu_torch.data import REFERENCE_DATA
from manus_tpu_torch.ops.knn import fp32_matmul, knn_indices, nearest_neighbor
from manus_tpu_torch.train.workloads import VoxelGrid
from manus_tpu_torch.utils.device import resolve_device

MANO_REST = os.path.join(REFERENCE_DATA, "mano", "mano_rest.pkl")
# MANO's 16 weight columns -> the 20-bone rig's order (reference
# train_utils.py:68)
MANO_TO_OURS = [13, 14, 14, 15, 0, 1, 2, 3, 0, 4, 5, 6, 0, 10, 11, 12, 0, 7, 8, 9]


def load_mano_rest(path: str) -> dict:
    """The MANO rest mesh {verts [778, 3], faces, weights [778, 16]} from
    the reference's mano_rest.pkl (a joblib or plain pickle). A missing
    file raises FileNotFoundError: a caller without the mesh passes
    mano=None to build_voxel_grid, which then takes the nearest-keypoint
    stand-in."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"no MANO rest mesh at {path}")
    try:
        import joblib
    except ImportError:
        with open(path, "rb") as f:
            d = pickle.load(f)
    else:
        d = joblib.load(path)
    return dict(
        verts=np.asarray(d["vert"], np.float32),
        faces=np.asarray(d["faces"], np.int32),
        weights=np.asarray(d["weights"], np.float32),
    )


def build_voxel_grid(
    bones_keypoints: np.ndarray,  # [K, 3] canonical skeleton keypoints
    mano: Optional[dict] = None,
    res: int = 128,
    ratio=(1.1, 0.9, 0.65),
    offset=(0.0, 0.0, -0.03),
    neighbors: int = 20,
    surface_margin: float = 0.02,
    num_bones: int = 20,
    device=None,
) -> VoxelGrid:
    """A VoxelGrid of [D, H, W, B+1] weights, the background channel last.

    The geometry is the reference's: the keypoints' bounding-box centre
    plus a per-axis offset, half the box diagonal scaled per axis by
    `ratio` (x takes the z ratio, as in the reference), res / ratio cells
    per axis. `mano` (load_mano_rest) gives the MANO weights; None the
    nearest-keypoint stand-in over the first `num_bones` keypoints.
    """
    device = resolve_device(device)
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

    if mano is not None and mano["weights"].shape[1] >= 16:
        verts = t(mano["verts"])
        init_w = t(mano["weights"][:, MANO_TO_OURS])  # [778, 20]
        idx = knn_indices(world, verts, neighbors).long()
        # the neighbours' mean, summed one neighbour at a time: numpy's
        # order, and no [cells, neighbours, 20] gather
        acc = init_w[idx[:, 0]]
        for j in range(1, neighbors):
            acc = acc + init_w[idx[:, j]]
        weights = acc / neighbors
        dist, _ = nearest_neighbor(world, verts)
        far = dist > surface_margin
    else:
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


def make_voxel_grid(cfg: ExperimentConfig, bones_keypoints: np.ndarray,
                    mano: Optional[dict] = None, num_bones: int = 20,
                    device=None) -> Optional[VoxelGrid]:
    """The hand's skinning grid as the config asks for it (the reference
    CLI's build_hand_pieces): with skin_init "mano_init_voxel" a grid of
    cfg.dataset.grid_res cells over grid_size and grid_offset, with
    "mano_init_points" None (per-point weights); make_train_step holds
    the grid it is given to the same field."""
    if cfg.skin_init == "mano_init_points":
        return None
    if cfg.skin_init != "mano_init_voxel":
        raise ValueError(f"unknown skin_init {cfg.skin_init!r}")
    d = cfg.dataset
    return build_voxel_grid(bones_keypoints, mano=mano, res=d.grid_res,
                            ratio=d.grid_size, offset=d.grid_offset,
                            num_bones=num_bones, device=device)


def mano_skin_weights_20(mano: dict) -> np.ndarray:
    """MANO's per-vertex [778, 16] joint weights on the 20-bone rig,
    renormalised: several rig bones share one MANO column, so each row is
    rescaled to stay a convex blend."""
    w = np.asarray(mano["weights"], np.float32)[:, MANO_TO_OURS]
    return w / np.maximum(w.sum(axis=1, keepdims=True), 1e-8)


def pose_mano_verts(mano: dict, pose_transforms: np.ndarray,
                    rest_transforms: np.ndarray, device=None) -> np.ndarray:
    """The MANO rest mesh posed by linear blend skinning with captured
    per-frame bone transforms ([20, 4, 4] posed and rest): MANO's own
    vertex weights (mano_skin_weights_20) blend the rest -> posed
    transforms the hand model skins with. This stands in for manopth's
    PCA-posed meshes (the MANO model file is not shipped), without the
    pose-corrective blendshapes: mm-scale near the joint creases, below
    the 4 mm contact threshold. Returns [V, 3] float32."""
    from manus_tpu_torch.ops.skinning import bone_deformation_transforms

    device = resolve_device(device)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    w = t(mano_skin_weights_20(mano))  # [V, 20]
    tf_bones = bone_deformation_transforms(t(pose_transforms),
                                           t(rest_transforms))
    with fp32_matmul():
        tf = (w @ tf_bones.reshape(-1, 16)).reshape(-1, 4, 4)
        v = t(mano["verts"])
        posed = torch.einsum("nij,nj->ni", tf[:, :3, :3], v) + tf[:, :3, 3]
    return posed.cpu().numpy().astype(np.float32)


def pose_mano_sequence(mano: dict, bones_posed, bones_rest,
                       device=None) -> list:
    """Posed MANO meshes for every frame (pose_mano_verts), the
    posed_verts_seq of train/baselines.mano_baseline_contacts:
    `bones_posed` a list of per-frame Bones, `bones_rest` the rest Bones."""
    def host(x):
        return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)

    rest_tf = host(bones_rest.transforms)
    return [pose_mano_verts(mano, host(b.transforms), rest_tf, device)
            for b in bones_posed]


def visualize_skin_weights(skin_weights: np.ndarray,
                           seed: int = 0) -> np.ndarray:
    """[N, B] weights -> [N, 3] colours: a distinct colour per bone from a
    seeded palette, blended by the weights (the reference's
    extra.py:172-182), for the validation PLY dumps."""
    rng = np.random.RandomState(seed)
    b = skin_weights.shape[1]
    palette = rng.uniform(0.1, 1.0, (b, 3)).astype(np.float32)
    w = np.asarray(skin_weights, np.float32)
    w = w / np.maximum(w.sum(1, keepdims=True), 1e-8)
    return w @ palette
