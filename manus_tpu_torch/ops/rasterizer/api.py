"""Differentiable rendering API, single device.

Precomputed 3D covariances and SH (or precomputed) colours go in; an
[H, W, 3] image and per-gaussian radii/visibility come out, and gradients
flow to means, covariances, colours and opacities. The densification
"viewspace gradient" is harvested functionally: pass a zeros [N, 2]
`means2d_offset` that requires grad and differentiate the loss w.r.t. it.

Backends:
  * "cuda":   the projection kernels (projection.project_gaussians_cuda:
              SH colours and the EWA projection, one launch each way),
              binned tiles, the hand-written CUDA composite kernels;
  * "torch":  binned tiles, the kernels' plain PyTorch versions;
  * "oracle": dense per-pixel compositing (small scenes, ground truth).

Sharded over the gaussians (`gauss_group`, a row of the rank mesh,
parallel/mesh.py): each rank projects its block of the gaussians and the
projected fields are gathered, so that binning sees the whole cloud; the
composite is then split over the group's ranks by
RasterConfig.tile_shard_mode, as the JAX package splits it over its
gauss mesh axis:
  * "owner": each rank bins and composites the tiles it is dealt by
    binning.tile_owner_tables, then the tiles are gathered and put back
    in grid order; bit for bit the unsharded image;
  * "pairslice": each rank composites an equal slice of the depth-ordered
    pair array over the whole grid, and the per-tile partials are
    composed over the ranks in order, the 1e-4 stop applied per part;
  * "hybrid": owner's tiles, except the hot_split_tiles deepest, whose
    pairs are split by depth range over the ranks and composed as in
    pairslice.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from manus_tpu_torch.ops.rasterizer import composite as composite_mod
from manus_tpu_torch.ops.rasterizer import oracle as oracle_mod
from manus_tpu_torch.ops.rasterizer.binning import (
    TileBins,
    bin_gaussians,
    tile_owner_tables,
)
from manus_tpu_torch.ops.rasterizer.payload import build_payload
from manus_tpu_torch.ops.rasterizer.projection import (
    TILE,
    ProjectedGaussians,
    project_gaussians,
    project_gaussians_cuda,
)
from manus_tpu_torch.parallel.collectives import (
    all_gather_stack,
    all_gather_tiled,
    group_rank,
)
from manus_tpu_torch.utils import sh as sh_mod
from manus_tpu_torch.utils import trace
from manus_tpu_torch.utils.camera import Camera

BACKENDS = ("cuda", "torch", "oracle")
TILE_SHARD_MODES = ("owner", "pairslice", "hybrid")


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
    tile_shard_mode: str = "owner"  # the composite's split over gauss ranks
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
    gauss_group=None,
    gauss_axis_size: int = 1,
) -> RenderOutput:
    """Differentiable 3D Gaussian splat render; see the module docstring.

    With gauss_group (gauss_axis_size ranks, each holding its block of the
    gaussians in the [N, ...] inputs, means2d_offset excepted, which is
    for the whole cloud) the outputs are for the whole cloud and image on
    every rank of the group.
    """
    if config.tile_shard_mode not in TILE_SHARD_MODES:
        raise ValueError(f"unknown tile_shard_mode {config.tile_shard_mode!r};"
                         f" one of {TILE_SHARD_MODES}")
    if config.backend not in BACKENDS:
        raise ValueError(f"unknown backend {config.backend!r}; one of {BACKENDS}")
    if config.backend == "cuda" and not posed_means.is_cuda:
        raise ValueError("backend='cuda' needs CUDA tensors; "
                         "use backend='torch' on the CPU")
    n = posed_means.shape[0]
    opacity = cano_opacity.reshape(n)
    precomp = colors_precomp is not None
    with trace.span("raster.project"):
        if config.backend == "cuda":
            proj, colors = project_gaussians_cuda(
                posed_means, posed_cov, camera, active=active,
                cano_means=cano_means,
                features=None if precomp else cano_features,
                sh_degree=-1 if precomp else sh_degree, tf=tf)
            trace.count("raster.project_kernel", 1)
        else:
            colors = None if precomp else calculate_colors_from_sh(
                posed_means, cano_features, cano_means, camera, sh_degree,
                tf)
            proj = project_gaussians(posed_means, posed_cov, camera,
                                     active=active)
        if precomp:
            colors = colors_precomp
        if gauss_group is not None:
            proj, colors, opacity = _gather_fields(proj, colors, opacity,
                                                   gauss_group)
        if means2d_offset is not None:
            proj = proj._replace(means2d=proj.means2d + means2d_offset)

    w, h = camera.width, camera.height
    bg = torch.as_tensor(bg_color, dtype=posed_means.dtype,
                         device=posed_means.device)
    zero = torch.zeros((), dtype=torch.int32, device=posed_means.device)
    if config.backend == "oracle":
        row_chunk = 16 if h % 16 == 0 else (8 if h % 8 == 0 else 1)
        with trace.span("raster.composite"):
            img, t_final = oracle_mod.render_oracle(
                proj, colors, opacity, bg, w, h, row_chunk=row_chunk)
        overflow, overflow_far = zero, zero
    else:
        img, t_final, bins = _composite(
            proj, colors, opacity, bg, w, h, config, gauss_group,
            gauss_axis_size)
        overflow, overflow_far = bins.overflow_count, bins.overflow_far

    return RenderOutput(
        render=img,
        radii=proj.radius,
        visible=proj.visible,
        t_final=t_final.detach(),
        overflow=overflow,
        overflow_far=overflow_far,
    )


def _gather_fields(proj: ProjectedGaussians, colors, opacity, group):
    """The projected fields, colours and opacity of the whole cloud from
    each rank's block: one differentiable gather of the float fields,
    one of the integer ones."""
    floats = torch.cat([proj.means2d, proj.conic, proj.depth[:, None],
                        colors, opacity[:, None]], 1)
    ints = torch.cat([proj.radius[:, None], proj.tile_rect,
                      proj.visible[:, None].to(torch.int32)], 1)
    f = all_gather_tiled(floats, group)
    i = all_gather_tiled(ints, group)
    proj = ProjectedGaussians(
        means2d=f[:, 0:2], conic=f[:, 2:5], depth=f[:, 5], radius=i[:, 0],
        tile_rect=i[:, 1:5], visible=i[:, 5].bool())
    return proj, f[:, 6:9], f[:, 9]


def _over_compose(rgb_parts, t_parts):
    """Ordered over-compose of the ranks' partial segments ([G, T, 3, 256],
    [G, T, 256]): rank order is depth order within every tile, and
    (rgb, T) composition is associative. The 1e-4 stop applies per part:
    a later part is dropped once the running T has crossed it."""
    rgb_c, t_c = rgb_parts[0], t_parts[0]
    for r2, t2 in zip(rgb_parts[1:], t_parts[1:]):
        go = t_c > composite_mod.T_EPS
        rgb_c = rgb_c + torch.where(go[:, None, :], t_c[:, None, :] * r2, 0.0)
        t_c = torch.where(go, t_c * t2, t_c)
    return rgb_c, t_c


def _tiles(pay, offs, cnts, ntx, nty, config, tids=None):
    if config.backend == "cuda":
        return composite_mod.composite_tiles(pay, offs, cnts, ntx, nty,
                                             tile_ids=tids)
    return composite_mod.composite_tiles_torch(pay, offs, cnts, ntx, nty,
                                               chunk=config.chunk,
                                               tile_ids=tids)


def _gather_tiles(rgb, t, group, stack: bool):
    """A rank's tile outputs gathered over the group in one collective:
    tiled ([G * T, ...]) or stacked ([G, T, ...])."""
    both = torch.cat([rgb, t[:, None]], 1)
    out = (all_gather_stack if stack else all_gather_tiled)(both, group)
    return out[..., :3, :], out[..., 3, :]


def _composite(proj, colors, opacity, bg, w: int, h: int,
               config: RasterConfig, group, n: int):
    """Bin, build the payload and composite, split over the gauss group's
    n ranks as config.tile_shard_mode says. Returns the image [H, W, 3]
    over `bg`, its final transmittance [H, W] and the bins; records the
    bins' pair counters (utils/trace.py)."""
    ntx, nty = (w + TILE - 1) // TILE, (h + TILE - 1) // TILE
    num_tiles = ntx * nty
    split = group is not None and n > 1
    mode = config.tile_shard_mode
    pairslice = split and mode == "pairslice"
    dealt = split and num_tiles % n == 0
    hybrid = dealt and mode == "hybrid" and config.hot_split_tiles > 0
    # hybrid with no hot tiles is owner, as in the JAX package
    owner = dealt and not pairslice and not hybrid
    col = group_rank(group)
    with trace.span("raster.bin"):
        bins = _bin(proj, ntx, nty, config, col, n, owner, pairslice, group)
    with trace.span("raster.composite"):
        rgb, t = _composite_bins(proj, colors, opacity, bins, ntx, nty,
                                 config, group, n, col,
                                 (owner, pairslice, hybrid))
        img, t_final = composite_mod.tiles_to_image(rgb, t, bg, ntx, nty,
                                                    w, h)
    return img, t_final, bins


def _bin(proj, ntx: int, nty: int, config: RasterConfig, col: int, n: int,
         owner: bool, pairslice: bool, group):
    """The bins this rank composites: its owned tiles', or its slice of
    the pair array."""
    bins = bin_gaussians(
        proj, ntx, nty, config.tg_max, lane_align=config.lane_align,
        pair_budget_factor=config.pair_budget_factor,
        max_pairs_per_tile=config.max_pairs_per_tile,
        multi_frac=config.multi_frac, owner=col if owner else 0,
        num_owners=n if owner else 1, group=group if owner else None)
    trace.count("raster.pairs_emitted", bins.tile_counts,
                bins.overflow_count)
    trace.count("raster.pairs_kept", bins.tile_counts)
    trace.count("raster.pairs_dropped", bins.overflow_count)
    if pairslice:
        # an equal slice of the pair array a rank, its width rounded up to
        # lane_align so that the slices fall where JAX's do
        p = bins.pair_src.shape[0]
        la = max(config.lane_align, 1)
        s = -(-(-(-p // n)) // la) * la
        src = torch.cat([bins.pair_src, bins.pair_src.new_full(
            (s * n - p,), -1)])
        start = col * s
        off = torch.clamp(bins.tile_offsets - start, 0, s)
        end = torch.clamp(bins.tile_offsets + bins.tile_counts - start, 0, s)
        bins = bins._replace(pair_src=src[start:start + s], tile_offsets=off,
                             tile_counts=end - off)
    return bins


def _composite_bins(proj, colors, opacity, bins: TileBins, ntx: int,
                    nty: int, config: RasterConfig, group, n: int, col: int,
                    modes):
    """The payload and the composite of the bins, put together over the
    group's ranks as `modes` (owner, pairslice, hybrid) say: the full
    grid's rgb [T, 3, 256] and T_final [T, 256]."""
    owner, pairslice, hybrid = modes
    num_tiles = ntx * nty
    dev = proj.depth.device
    pay = build_payload(proj, colors, opacity, bins)
    offs, cnts, tids = bins.tile_offsets, bins.tile_counts, None
    if owner or hybrid:
        _, _, owned_np, perm_np = tile_owner_tables(ntx, nty, n)
        owned = torch.as_tensor(owned_np[col], device=dev)
        perm = torch.as_tensor(perm_np, device=dev).long()
        tids = owned
    if hybrid:
        # the k deepest tiles (ties: the lower id first, as top_k) leave
        # their owner's slot; each rank composites an equal depth range
        k = min(config.hot_split_tiles, num_tiles)
        hot_ids = torch.argsort(-bins.tile_counts, stable=True)[:k]
        hot_cnt = bins.tile_counts[hot_ids]
        hot_off = bins.tile_offsets[hot_ids]
        share = -(-hot_cnt // n)
        sub_off = hot_off + torch.minimum(col * share, hot_cnt)
        sub_end = hot_off + torch.minimum((col + 1) * share, hot_cnt)
        own_cnt = torch.where(torch.isin(owned, hot_ids), 0,
                              bins.tile_counts[owned.long()])
        offs = torch.cat([bins.tile_offsets[owned.long()], sub_off])
        cnts = torch.cat([own_cnt, sub_end - sub_off]).to(torch.int32)
        tids = torch.cat([owned, hot_ids.to(torch.int32)])
    rgb, t = _tiles(pay, offs.contiguous(), cnts.contiguous(), ntx, nty,
                    config, tids)
    if pairslice:
        rgb, t = _over_compose(*_gather_tiles(rgb, t, group, stack=True))
    elif hybrid:
        t_loc = owned.shape[0]
        own_rgb, own_t = _gather_tiles(rgb[:t_loc], t[:t_loc], group,
                                       stack=False)
        hot_rgb, hot_t = _over_compose(*_gather_tiles(
            rgb[t_loc:], t[t_loc:], group, stack=True))
        rgb = own_rgb[perm].index_copy(0, hot_ids, hot_rgb)
        t = own_t[perm].index_copy(0, hot_ids, hot_t)
    elif owner:
        rgb, t = _gather_tiles(rgb, t, group, stack=False)
        rgb, t = rgb[perm], t[perm]
    return rgb, t
