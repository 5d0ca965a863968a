"""The raster sharded over the gaussians: a row of the rank mesh (the
gauss group, parallel/mesh.py) renders one view together.

Each rank projects its block of the gaussians and the projected fields
are gathered, so that binning sees the whole cloud; the composite is then
split over the group's n ranks by RasterConfig.tile_shard_mode, as the
JAX package splits it over its gauss mesh axis:
  * "owner": each rank bins and composites the tiles it is dealt by
    binning.tile_owner_tables, then the tiles are gathered and put back
    in grid order; bit for bit the unsharded image;
  * "pairslice": each rank composites an equal slice of the depth-ordered
    pair array over the whole grid, and the per-tile partials are
    composed over the ranks in order, the 1e-4 stop applied per part;
  * "hybrid": owner's tiles, except the hot_split_tiles deepest, whose
    pairs are split by depth range over the ranks and composed as in
    pairslice. With no hot tiles it is owner, as in the JAX package.
With the oracle backend, or a grid whose tiles the ranks cannot share
evenly (owner, hybrid), every rank renders the gathered cloud whole.

The stages, their spans and counters are the one-card raster's
(ops/rasterizer/api.py).
"""
from __future__ import annotations

import torch

from manus_tpu_torch.ops.rasterizer import api
from manus_tpu_torch.ops.rasterizer import composite as composite_mod
from manus_tpu_torch.ops.rasterizer.api import RasterConfig, RenderOutput
from manus_tpu_torch.ops.rasterizer.binning import (
    TileBins,
    bin_gaussians,
    tile_owner_tables,
)
from manus_tpu_torch.ops.rasterizer.payload import build_payload
from manus_tpu_torch.ops.rasterizer.projection import TILE, ProjectedGaussians
from manus_tpu_torch.parallel.collectives import (
    all_gather_stack,
    all_gather_tiled,
    group_rank,
)
from manus_tpu_torch.utils import trace
from manus_tpu_torch.utils.camera import Camera

TILE_SHARD_MODES = ("owner", "pairslice", "hybrid")


def check_tile_shard_mode(mode: str):
    """JAX falls back to owner on an unknown mode; the port raises."""
    if mode not in TILE_SHARD_MODES:
        raise ValueError(f"unknown tile_shard_mode {mode!r};"
                         f" one of {TILE_SHARD_MODES}")


def render_sharded(posed_means, posed_cov, cano_means, cano_features,
                   cano_opacity, camera: Camera, bg_color, sh_degree: int = 3,
                   tf=None, active=None, means2d_offset=None,
                   config: RasterConfig = RasterConfig(), group=None,
                   n: int = 1) -> RenderOutput:
    """api.render_gaussians (SH colours) over the gauss `group` of n
    ranks, each holding its block of the gaussians in the [N, ...] inputs
    (means2d_offset excepted, which is for the whole cloud). The outputs
    are for the whole cloud and image on every rank of the group."""
    check_tile_shard_mode(config.tile_shard_mode)
    with trace.span("raster.project"):
        proj, colors, opacity, backend = api.project(
            posed_means, posed_cov, cano_means, cano_features, cano_opacity,
            camera, None, sh_degree, tf, active, config)
        proj, colors, opacity = _gather_fields(proj, colors, opacity, group)
        if means2d_offset is not None:
            proj = proj._replace(means2d=proj.means2d + means2d_offset)

    w, h = camera.width, camera.height
    ntx, nty = (w + TILE - 1) // TILE, (h + TILE - 1) // TILE
    mode = config.tile_shard_mode
    pairslice = mode == "pairslice"
    if backend == "oracle" or not (pairslice or (ntx * nty) % n == 0):
        return api.rasterize(proj, colors, opacity, bg_color, camera, config,
                             backend)
    hybrid = mode == "hybrid" and config.hot_split_tiles > 0
    owner = not pairslice and not hybrid
    col = group_rank(group)
    with trace.span("raster.bin"):
        bins = bin_gaussians(proj, ntx, nty, **api.bin_options(config),
                             owner=col if owner else 0,
                             num_owners=n if owner else 1,
                             group=group if owner else None)
        api.count_pairs(bins)
        if pairslice:
            bins = _pair_slice(bins, col, n, config.lane_align)
    with trace.span("raster.composite"):
        pay = build_payload(proj, colors, opacity, bins)
        if pairslice:
            rgb, t = api.composite(pay, bins.tile_offsets, bins.tile_counts,
                                   ntx, nty, config, backend)
            rgb, t = _over_compose(*_gather_tiles(rgb, t, group, stack=True))
        else:
            rgb, t = _composite_dealt(pay, bins, ntx, nty, config, backend,
                                      group, n, col, hybrid)
        bg = torch.as_tensor(bg_color, dtype=proj.depth.dtype,
                             device=proj.depth.device)
        img, t_final = composite_mod.tiles_to_image(rgb, t, bg, ntx, nty,
                                                    w, h)
    return RenderOutput(img, proj.radius, proj.visible, t_final.detach(),
                        bins.overflow_count, bins.overflow_far)


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


def _pair_slice(bins: TileBins, col: int, n: int, lane_align: int):
    """Rank col's equal slice of the pair array, its width rounded up to
    lane_align so that the slices fall where JAX's do, with the tiles'
    segments clipped to it."""
    p = bins.pair_src.shape[0]
    la = max(lane_align, 1)
    s = -(-(-(-p // n)) // la) * la
    src = torch.cat([bins.pair_src, bins.pair_src.new_full((s * n - p,), -1)])
    start = col * s
    off = torch.clamp(bins.tile_offsets - start, 0, s)
    end = torch.clamp(bins.tile_offsets + bins.tile_counts - start, 0, s)
    return bins._replace(pair_src=src[start:start + s], tile_offsets=off,
                         tile_counts=end - off)


def _composite_dealt(pay, bins: TileBins, ntx: int, nty: int,
                     config: RasterConfig, backend: str, group, n: int,
                     col: int, hybrid: bool):
    """Owner's and hybrid's composite, the full grid's rgb [T, 3, 256] and
    T_final [T, 256]: rank col composites the tiles it is dealt (owner:
    from its own bins), the tiles are gathered and put back in grid
    order. Hybrid takes the hot_split_tiles deepest tiles out of their
    owners' slots and gives each rank an equal depth range of them."""
    dev = pay.device
    _, _, owned_np, perm_np = tile_owner_tables(ntx, nty, n)
    owned = torch.as_tensor(owned_np[col], device=dev)
    perm = torch.as_tensor(perm_np, device=dev).long()
    if not hybrid:
        rgb, t = api.composite(pay, bins.tile_offsets, bins.tile_counts, ntx,
                               nty, config, backend, owned)
        rgb, t = _gather_tiles(rgb, t, group, stack=False)
        return rgb[perm], t[perm]
    # the k deepest tiles (ties: the lower id first, as top_k)
    k = min(config.hot_split_tiles, ntx * nty)
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
    rgb, t = api.composite(pay, offs, cnts, ntx, nty, config, backend, tids)
    t_loc = owned.shape[0]
    own_rgb, own_t = _gather_tiles(rgb[:t_loc], t[:t_loc], group,
                                   stack=False)
    hot_rgb, hot_t = _over_compose(*_gather_tiles(
        rgb[t_loc:], t[t_loc:], group, stack=True))
    return (own_rgb[perm].index_copy(0, hot_ids, hot_rgb),
            own_t[perm].index_copy(0, hot_ids, hot_t))


def _gather_tiles(rgb, t, group, stack: bool):
    """A rank's tile outputs gathered over the group in one collective:
    tiled ([G * T, ...]) or stacked ([G, T, ...])."""
    both = torch.cat([rgb, t[:, None]], 1)
    out = (all_gather_stack if stack else all_gather_tiled)(both, group)
    return out[..., :3, :], out[..., 3, :]


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
