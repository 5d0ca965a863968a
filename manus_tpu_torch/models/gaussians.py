"""Gaussian parameter store: a padded, fixed-capacity set of tensors.

The same six parameter groups and activations as the reference
GaussianModel. Capacity is a static N_max with an `active` mask, as in the
JAX package: densify and prune flip mask bits and write into free slots,
and everything downstream (render, losses, optimiser) is masked by
`active`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from manus_tpu_torch.ops.knn import knn_self_distances
from manus_tpu_torch.utils import sh as sh_mod
from manus_tpu_torch.utils.device import resolve_device
from manus_tpu_torch.utils.transforms import covariance_from_scaling_rotation


@dataclasses.dataclass(frozen=True)
class GaussianOpts:
    """Model hyperparameters (config/model/gaussian/gaussian.yaml)."""

    sh_degree: int = 3
    position_lr_init: float = 0.0016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    skinning_lr: float = 0.001
    optimize_skin_weights: bool = False
    percent_dense: float = 0.000001
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify: bool = True
    densify_from_step: int = 100
    densify_until_step: int = 50000
    densify_grad_threshold: float = 0.0002
    min_opacity_threshold: float = 0.005
    size_threshold: int = 20
    remove_outliers_step: int = -1
    isotropic_scaling: bool = False
    remove_seg_start: int = 0
    remove_seg_end: int = 1000
    condition_number: float = 0.4
    start_lpips_iter: int = 1000
    skeleton_dist_threshold: float = 0.2  # hand far-point prune (m)
    # The reference's spatial_lr_scale is 0, so xyz never moves through its
    # optimiser; the default keeps that.
    spatial_lr_scale: float = 0.0


class GaussianParams(NamedTuple):
    """Differentiable parameter leaves, all padded to [N_max, ...]."""

    xyz: torch.Tensor  # [N, 3]
    features_dc: torch.Tensor  # [N, 1, 3]
    features_rest: torch.Tensor  # [N, K-1, 3]
    scaling: torch.Tensor  # [N, S] log-scales (S=1 if isotropic else 3)
    rotation: torch.Tensor  # [N, 4] wxyz (unnormalised)
    opacity: torch.Tensor  # [N, 1] logits


class GaussianModel(NamedTuple):
    """Parameters + topology mask + optional skinning weights."""

    params: GaussianParams
    active: torch.Tensor  # [N] bool
    skin_weights: Optional[torch.Tensor] = None  # [N, B] (hand model)

    @property
    def capacity(self) -> int:
        return self.active.shape[0]


def inverse_sigmoid(x: float) -> float:
    return math.log(x / (1 - x))


def get_scaling(params: GaussianParams, isotropic: bool = False) -> torch.Tensor:
    s = torch.exp(params.scaling)
    if isotropic or s.shape[-1] == 1:
        s = s[:, :1].expand(s.shape[0], 3)
    return s


def get_rotation(params: GaussianParams) -> torch.Tensor:
    return params.rotation / torch.linalg.norm(
        params.rotation, dim=-1, keepdim=True
    )


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


def init_gaussian_model(
    points,  # [N0, 3] array-like
    colors,  # [N0, 3] in [0, 1]
    capacity: int,
    opts: GaussianOpts = GaussianOpts(),
    skin_weights=None,  # [N0, B]
    device=None,
) -> GaussianModel:
    """A padded model from an initial point cloud: dc features from
    RGB2SH, log-scales from sqrt(mean 3-NN squared distance), identity
    rotations, opacity logit of 0.1. Padded slots get log-scale -10,
    rotation (1,0,0,0) and opacity logit -9.21."""
    device = resolve_device(device)
    pts = torch.as_tensor(np.asarray(points, np.float32), device=device)
    cols = torch.as_tensor(np.asarray(colors, np.float32), device=device)
    n0 = pts.shape[0]
    if n0 > capacity:
        raise ValueError(f"init points {n0} exceed capacity {capacity}")
    k = (opts.sh_degree + 1) ** 2
    s_dim = 1 if opts.isotropic_scaling else 3

    dist2 = knn_self_distances(pts, k=3).clamp(min=1e-7)
    log_scale = torch.log(torch.sqrt(dist2))[:, None]

    def pad(x, fill=0.0):
        tail = torch.full((capacity - n0,) + x.shape[1:], fill,
                          dtype=x.dtype, device=device)
        return torch.cat([x, tail], dim=0)

    rotation = pad(torch.zeros(n0, 4, device=device))
    rotation[:, 0] = 1.0
    params = GaussianParams(
        xyz=pad(pts),
        features_dc=pad(sh_mod.rgb_to_sh(cols)[:, None, :]),
        features_rest=pad(torch.zeros(n0, k - 1, 3, device=device)),
        scaling=pad(log_scale.expand(n0, s_dim).contiguous(), fill=-10.0),
        rotation=rotation,
        opacity=pad(torch.full((n0, 1), inverse_sigmoid(0.1),
                               device=device), fill=-9.21),
    )
    active = torch.arange(capacity, device=device) < n0
    sw = None
    if skin_weights is not None:
        sw = pad(torch.as_tensor(np.asarray(skin_weights, np.float32),
                                 device=device))
    return GaussianModel(params=params, active=active, skin_weights=sw)
