"""Carry models, cameras, voxel grids and LPIPS weights across as numpy
arrays.

The JAX package's GaussianParams leaves, Camera fields, checkpoint keys
of the voxel grid and LPIPS params keys have the same names and shapes
here, so what is converted to numpy on one side loads on the other.
"""
from __future__ import annotations

import numpy as np
import torch

from manus_tpu_torch.models.gaussians import GaussianModel, GaussianParams
from manus_tpu_torch.train.workloads import VoxelGrid
from manus_tpu_torch.utils.camera import TENSOR_FIELDS, Camera
from manus_tpu_torch.utils.device import resolve_device

PARAM_KEYS = GaussianParams._fields
MODEL_KEYS = PARAM_KEYS + ("active", "skin_weights")


def model_from_numpy(d: dict, device=None) -> GaussianModel:
    """{xyz, features_dc, features_rest, scaling, rotation, opacity, active,
    skin_weights (optional)} numpy arrays -> GaussianModel on `device`."""
    device = resolve_device(device)

    def t(x, dtype=torch.float32):
        return torch.tensor(np.asarray(x), dtype=dtype, device=device)

    sw = d.get("skin_weights")
    return GaussianModel(
        params=GaussianParams(*(t(d[k]) for k in PARAM_KEYS)),
        active=t(d["active"], torch.bool),
        skin_weights=None if sw is None else t(sw),
    )


def model_to_numpy(model: GaussianModel) -> dict:
    out = {k: v.detach().cpu().numpy() for k, v in model.params._asdict().items()}
    out["active"] = model.active.cpu().numpy()
    if model.skin_weights is not None:
        out["skin_weights"] = model.skin_weights.detach().cpu().numpy()
    return out


def camera_from_numpy(d: dict, device=None) -> Camera:
    """{K, extr, world_view_transform, projection_matrix,
    full_proj_transform, camera_center, fovx, fovy, width, height} -> Camera
    (a leading [V] axis on every array gives a stacked Camera)."""
    device = resolve_device(device)
    fields = {f: torch.tensor(np.asarray(d[f], np.float32), device=device)
              for f in TENSOR_FIELDS}
    return Camera(**fields, width=int(d["width"]), height=int(d["height"]))


def lpips_params_from_numpy(d: dict, device=None) -> dict:
    """{conv{i}_{j}_w (HWIO), conv{i}_{j}_b, lin{k}_w} arrays -> float32
    tensors on `device`, under the same keys."""
    device = resolve_device(device)
    return {k: torch.tensor(np.asarray(v, np.float32), device=device)
            for k, v in d.items()}


def lpips_params_to_numpy(params: dict) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in params.items()}


def voxel_grid_from_numpy(d: dict, device=None) -> VoxelGrid:
    """{vg_center [3], vg_scale [3], vg_weights [D, H, W, B+1]} (the
    checkpoint's keys) -> VoxelGrid of float32 tensors on `device`."""
    device = resolve_device(device)

    def t(k):
        return torch.tensor(np.asarray(d[k], np.float32), device=device)

    return VoxelGrid(center=t("vg_center"), scale=t("vg_scale"),
                     weights=t("vg_weights"))


def voxel_grid_to_numpy(grid: VoxelGrid) -> dict:
    return dict(vg_center=grid.center.cpu().numpy(),
                vg_scale=grid.scale.cpu().numpy(),
                vg_weights=grid.weights.cpu().numpy())
