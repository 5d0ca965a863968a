"""Differentiable rendering API, single device.

Precomputed 3D covariances and SH (or precomputed) colours go in; an
[H, W, 3] image and per-gaussian radii/visibility come out, and gradients
flow to means, covariances, colours and opacities. The densification
"viewspace gradient" is harvested functionally: pass a zeros [N, 2]
`means2d_offset` that requires grad and differentiate the loss w.r.t. it.

Backends:
  * "cuda":   binned tiles, the hand-written CUDA composite kernels;
  * "torch":  binned tiles, the kernels' plain PyTorch version;
  * "oracle": dense per-pixel compositing (small scenes, ground truth).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from manus_tpu_torch.ops.rasterizer import composite as composite_mod
from manus_tpu_torch.ops.rasterizer import oracle as oracle_mod
from manus_tpu_torch.ops.rasterizer.binning import bin_gaussians
from manus_tpu_torch.ops.rasterizer.payload import build_payload
from manus_tpu_torch.ops.rasterizer.projection import TILE, project_gaussians
from manus_tpu_torch.utils import sh as sh_mod
from manus_tpu_torch.utils.camera import Camera

BACKENDS = ("cuda", "torch", "oracle")


class RasterConfig(NamedTuple):
    """Static rasterizer configuration."""

    tg_max: int = 64  # max tiles per gaussian in binning
    chunk: int = 64  # pairs per chunk of the plain torch composite
    max_pairs_per_tile: int = 4096  # per-tile pair cap
    backend: str = "cuda"
    lane_align: int = 128
    pair_budget_factor: int = 8  # pair buffer cap, x N (0 = off)
    multi_frac: float = 1.0  # multi-tile capacity, x N (binning.py)


class RenderOutput(NamedTuple):
    render: torch.Tensor  # [H, W, 3]
    radii: torch.Tensor  # [N] int32
    visible: torch.Tensor  # [N] bool
    t_final: torch.Tensor  # [H, W] final transmittance (detached)
    overflow: torch.Tensor  # [] int32 pairs dropped in binning
    overflow_far: torch.Tensor  # [] int32 the part dropped by the per-tile cap


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
    rgb = sh_mod.eval_sh(sh_degree, shs, dirs)
    return torch.clamp(rgb + 0.5, min=0.0)


def render_gaussians(
    posed_means: torch.Tensor,  # [N, 3]
    posed_cov: torch.Tensor,  # [N, 6] upper-tri
    cano_means: torch.Tensor,  # [N, 3] (SH view dirs for articulated models)
    cano_features: torch.Tensor,  # [N, K, 3] SH coeffs
    cano_opacity: torch.Tensor,  # [N, 1] or [N]
    camera: Camera,
    bg_color: torch.Tensor,  # [3]
    colors_precomp: Optional[torch.Tensor] = None,
    sh_degree: int = 3,
    tf: Optional[torch.Tensor] = None,
    active: Optional[torch.Tensor] = None,
    means2d_offset: Optional[torch.Tensor] = None,
    config: RasterConfig = RasterConfig(),
    gauss_axis=None,
    tile_shard_mode=None,
) -> RenderOutput:
    """Differentiable 3D Gaussian splat render; see the module docstring.

    Multi-device rendering (`gauss_axis`, `tile_shard_mode`) is not ported.
    """
    if gauss_axis is not None or tile_shard_mode is not None:
        raise NotImplementedError(
            "gauss-axis and tile-sharded rendering are not ported")
    if config.backend not in BACKENDS:
        raise ValueError(f"unknown backend {config.backend!r}; one of {BACKENDS}")
    if config.backend == "cuda" and not posed_means.is_cuda:
        raise ValueError("backend='cuda' needs CUDA tensors; "
                         "use backend='torch' on the CPU")
    n = posed_means.shape[0]
    opacity = cano_opacity.reshape(n)
    if colors_precomp is None:
        colors = calculate_colors_from_sh(
            posed_means, cano_features, cano_means, camera, sh_degree, tf)
    else:
        colors = colors_precomp

    proj = project_gaussians(posed_means, posed_cov, camera, active=active)
    if means2d_offset is not None:
        proj = proj._replace(means2d=proj.means2d + means2d_offset)

    w, h = camera.width, camera.height
    bg = torch.as_tensor(bg_color, dtype=posed_means.dtype,
                         device=posed_means.device)
    zero = torch.zeros((), dtype=torch.int32, device=posed_means.device)
    if config.backend == "oracle":
        row_chunk = 16 if h % 16 == 0 else (8 if h % 8 == 0 else 1)
        img, t_final = oracle_mod.render_oracle(
            proj, colors, opacity, bg, w, h, row_chunk=row_chunk)
        overflow, overflow_far = zero, zero
    else:
        ntx = (w + TILE - 1) // TILE
        nty = (h + TILE - 1) // TILE
        bins = bin_gaussians(
            proj, ntx, nty, config.tg_max, lane_align=config.lane_align,
            pair_budget_factor=config.pair_budget_factor,
            max_pairs_per_tile=config.max_pairs_per_tile,
            multi_frac=config.multi_frac,
        )
        pay = build_payload(proj, colors, opacity, bins)
        if config.backend == "cuda":
            rgb_tiles, t_tiles = composite_mod.composite_tiles(
                pay, bins.tile_offsets, bins.tile_counts, ntx, nty)
        else:
            rgb_tiles, t_tiles = composite_mod.composite_tiles_torch(
                pay, bins.tile_offsets, bins.tile_counts, ntx, nty,
                chunk=config.chunk)
        img, t_final = composite_mod.tiles_to_image(
            rgb_tiles, t_tiles, bg, ntx, nty, w, h)
        overflow, overflow_far = bins.overflow_count, bins.overflow_far

    return RenderOutput(
        render=img,
        radii=proj.radius,
        visible=proj.visible,
        t_final=t_final.detach(),
        overflow=overflow,
        overflow_far=overflow_far,
    )
