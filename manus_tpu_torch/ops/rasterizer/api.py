"""Differentiable rendering API, single device.

Precomputed 3D covariances and SH (or precomputed) colours go in; an
[H, W, 3] image and per-gaussian radii/visibility come out, and gradients
flow to means, covariances, colours and opacities. The densification
"viewspace gradient" is harvested functionally: pass a zeros [N, 2]
`means2d_offset` that requires grad and differentiate the loss w.r.t. it.

The stages: projection (`project`) -> binning (binning.py) -> the pair
payload (payload.py) -> the composite of the tiles (`composite`) -> the
image (composite.tiles_to_image). RasterConfig.backend names the path;
the first stage resolves it against its tensors' device
(`resolve_raster_backend`) and the later stages take what it resolved:
  * "cuda":   the projection kernels (projection.project_gaussians_cuda:
              SH colours and the EWA projection, one launch each way),
              binned tiles, the hand-written CUDA composite kernels;
  * "torch":  binned tiles, the kernels' plain PyTorch versions;
  * "oracle": dense per-pixel compositing (small scenes, ground truth).

The render sharded over a gauss group of ranks composes the same stages
(parallel/raster.py).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from manus_tpu_torch.ops.rasterizer import composite as composite_mod
from manus_tpu_torch.ops.rasterizer import oracle as oracle_mod
from manus_tpu_torch.ops.rasterizer.binning import TileBins, bin_gaussians
from manus_tpu_torch.ops.rasterizer.payload import build_payload
from manus_tpu_torch.ops.rasterizer.projection import (
    TILE,
    ProjectedGaussians,
    project_gaussians,
    project_gaussians_cuda,
)
from manus_tpu_torch.utils import sh as sh_mod
from manus_tpu_torch.utils import trace
from manus_tpu_torch.utils.camera import Camera

# The port's names, and the JAX package's, which a config snapshot of
# either package may hold.
PORT_BACKENDS = ("cuda", "torch", "oracle")
JAX_BACKENDS = ("auto", "pallas", "xla")


def resolve_raster_backend(name: str, device) -> str:
    """The port's raster backend for a config's `raster.backend` on
    `device`.

    On a CUDA device "auto", "pallas" and "cuda" are the kernels; "xla",
    the JAX package's plain path, raises rather than run the plain
    version on the card unnoticed ("torch" and "oracle" name it
    explicitly). On the CPU every kernel name means its plain version,
    "torch", as the kernel wrappers do for CPU tensors.
    """
    if name not in PORT_BACKENDS + JAX_BACKENDS:
        raise ValueError(f"unknown raster.backend {name!r}; one of "
                         f"{PORT_BACKENDS + JAX_BACKENDS}")
    if torch.device(device).type == "cuda":
        if name == "xla":
            raise ValueError(
                "raster.backend='xla' names the JAX package's plain path; "
                "on a CUDA device choose 'cuda' (or 'auto'/'pallas', the "
                "kernels), or 'torch'/'oracle' for a plain version")
        return "cuda" if name in ("auto", "pallas") else name
    return "oracle" if name == "oracle" else "torch"


class RasterConfig(NamedTuple):
    """Static rasterizer configuration."""

    # max tiles per gaussian in binning; 0 keeps every pair (graphdeco's
    # rule: no cut, no budget, no per-tile cap)
    tg_max: int = 64
    chunk: int = 64  # pairs per chunk of the plain torch composite
    max_pairs_per_tile: int = 4096  # per-tile pair cap
    backend: str = "cuda"
    lane_align: int = 128
    pair_budget_factor: int = 8  # pair buffer cap, x N (0 = off)
    multi_frac: float = 1.0  # multi-tile capacity, x N (binning.py)
    # the composite's split over gauss ranks (parallel/raster.py)
    tile_shard_mode: str = "owner"
    hot_split_tiles: int = 8  # "hybrid": the deepest tiles split by depth


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
) -> RenderOutput:
    """Differentiable 3D Gaussian splat render; see the module docstring."""
    with trace.span("raster.project"):
        proj, colors, opacity, backend = project(
            posed_means, posed_cov, cano_means, cano_features, cano_opacity,
            camera, colors_precomp, sh_degree, tf, active, config)
        if means2d_offset is not None:
            proj = proj._replace(means2d=proj.means2d + means2d_offset)
    return rasterize(proj, colors, opacity, bg_color, camera, config,
                     backend)


def project(posed_means, posed_cov, cano_means, cano_features, cano_opacity,
            camera: Camera, colors_precomp, sh_degree: int, tf, active,
            config: RasterConfig):
    """The projection stage: the ProjectedGaussians, the colours [N, 3]
    (colors_precomp, or from the SH), the opacities [N] and the backend
    config.backend resolves to on the tensors' device."""
    backend = resolve_raster_backend(config.backend, posed_means.device)
    n = posed_means.shape[0]
    opacity = cano_opacity.reshape(n)
    precomp = colors_precomp is not None
    if backend == "cuda":
        proj, colors = project_gaussians_cuda(
            posed_means, posed_cov, camera, active=active,
            cano_means=cano_means,
            features=None if precomp else cano_features,
            sh_degree=-1 if precomp else sh_degree, tf=tf)
    else:
        colors = None if precomp else calculate_colors_from_sh(
            posed_means, cano_features, cano_means, camera, sh_degree, tf)
        proj = project_gaussians(posed_means, posed_cov, camera,
                                 active=active)
        if trace.enabled() and posed_means.requires_grad:
            # the plain chain's backward covers every row, as the kernel's
            posed_means.register_hook(
                lambda g: trace.count("raster.grad_rows", n))
    return proj, colors_precomp if precomp else colors, opacity, backend


def rasterize(proj: ProjectedGaussians, colors, opacity, bg_color,
              camera: Camera, config: RasterConfig,
              backend: str) -> RenderOutput:
    """The render of projected gaussians on the resolved `backend`: bin,
    build the payload, composite and assemble the image over `bg_color`
    (or the dense oracle); records the bins' pair counters."""
    w, h = camera.width, camera.height
    dev = proj.depth.device
    bg = torch.as_tensor(bg_color, dtype=proj.depth.dtype, device=dev)
    if backend == "oracle":
        row_chunk = 16 if h % 16 == 0 else (8 if h % 8 == 0 else 1)
        with trace.span("raster.composite"):
            img, t_final = oracle_mod.render_oracle(
                proj, colors, opacity, bg, w, h, row_chunk=row_chunk)
        overflow = overflow_far = torch.zeros((), dtype=torch.int32,
                                              device=dev)
    else:
        ntx, nty = (w + TILE - 1) // TILE, (h + TILE - 1) // TILE
        with trace.span("raster.bin"):
            bins = bin_gaussians(proj, ntx, nty, **bin_options(config))
            count_pairs(bins)
        with trace.span("raster.composite"):
            pay = build_payload(proj, colors, opacity, bins)
            rgb, t = composite(pay, bins.tile_offsets, bins.tile_counts, ntx,
                               nty, config, backend)
            img, t_final = composite_mod.tiles_to_image(rgb, t, bg, ntx, nty,
                                                        w, h)
        overflow, overflow_far = bins.overflow_count, bins.overflow_far
    return RenderOutput(
        render=img,
        radii=proj.radius,
        visible=proj.visible,
        t_final=t_final.detach(),
        overflow=overflow,
        overflow_far=overflow_far,
    )


def bin_options(config: RasterConfig) -> dict:
    """bin_gaussians' settings from the config."""
    return dict(tg_max=config.tg_max, lane_align=config.lane_align,
                pair_budget_factor=config.pair_budget_factor,
                max_pairs_per_tile=config.max_pairs_per_tile,
                multi_frac=config.multi_frac)


def count_pairs(bins: TileBins):
    """A view's pair counters (utils/trace.py)."""
    trace.count("raster.pairs_emitted", bins.tile_counts,
                bins.overflow_count)
    trace.count("raster.pairs_kept", bins.tile_counts)
    trace.count("raster.pairs_dropped", bins.overflow_count)


def composite(pay, offsets, counts, ntx: int, nty: int, config: RasterConfig,
              backend: str, tile_ids=None):
    """The composite of the payload's tile segments on the resolved
    `backend`: rgb [T, 3, 256] and T_final [T, 256] of the grid's tiles,
    or of the tile slots `tile_ids` names (composite.py)."""
    offsets, counts = offsets.contiguous(), counts.contiguous()
    if backend == "cuda":
        return composite_mod.composite_tiles(pay, offsets, counts, ntx, nty,
                                             tile_ids=tile_ids)
    return composite_mod.composite_tiles_torch(pay, offsets, counts, ntx, nty,
                                               chunk=config.chunk,
                                               tile_ids=tile_ids)
