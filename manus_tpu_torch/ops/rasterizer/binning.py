"""Tile binning: projected gaussians -> per-tile, depth-ordered pair lists.

Gives the same pair array, segments and overflow counts as the JAX
package's single-device `bin_gaussians`, drop rules included:

  1. size-tiered expansion. Every visible gaussian emits its top-left
     cell. Multi-tile gaussians, in two size classes (2..8 cells and
     9..tg_max cells), emit the rest of their rect if the class's static
     capacity (multi_frac * N, floored by multi_floor) admits them; the
     largest rects are admitted first, then ties in gaussian-id order.
     A rect wider or taller than tg_max allows is cut to a sub-rect
     (width clamped to tg_max, then rows to tg_max // width). Lost cells
     are overflow-counted. With tg_max 0 (the graphdeco rasterizer's
     rule, the port's own setting: the JAX package has no such mode)
     every visible gaussian emits its whole rect, nothing is cut, left
     out or dropped by rules 3-4, and the pairs' number is read back to
     the host once, to size the buffers, where the tiers' are static;
  2. pairs ordered by (tile, depth, gaussian id). torch.sort has no
     multi-key form, so this is three stable argsorts, least significant
     key first: gaussian id, then depth, then tile;
  3. per-tile counts from the kept cells, truncated to the pair budget
     N * pair_budget_factor rounded up to lane_align (which drops the
     highest tile ids first), then capped at max_pairs_per_tile per tile
     (which drops the farthest pairs; `overflow_far` counts those).

With `owner` and `num_owners` > 1 (owner-mode tile sharding,
parallel/raster.py) a rank bins only the tiles it owns under
`tile_owner_tables`: pairs of other tiles sort to the tail, the tile
keys are the owned tiles' local slots, the budget is the owner's share,
and the budget and cap drops are summed over the owners' `group`.

Every step is a torch op on the gaussians' device; with tg_max 0 one
host read a call.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from manus_tpu_torch.ops.rasterizer.projection import ProjectedGaussians
from manus_tpu_torch.parallel.collectives import all_reduce_sum


@functools.lru_cache(maxsize=64)
def tile_owner_tables(num_tiles_x: int, num_tiles_y: int, num_owners: int):
    """Static tile -> owner assignment for tile-sharded rasterisation.

    Tiles are dealt one by one in diagonal scan order ((tx + ty, tx)
    ascending), so spatial neighbours go to different owners for any n
    (a flat t mod n puts each owner on a vertical stripe when n divides
    the grid width) and every owner gets exactly T/n tiles.

    Returns numpy arrays: owner[T], rank[T] (slot within the owner's
    id-ascending list), owned_ids[n, T/n] and perm[T] (the position of
    global tile t in the owner-major gather of the owners' slots).
    """
    assert (num_tiles_x * num_tiles_y) % num_owners == 0
    t = np.arange(num_tiles_x * num_tiles_y)
    tx, ty = t % num_tiles_x, t // num_tiles_x
    deal = np.lexsort((tx, tx + ty))  # diagonal scan order
    owner = np.empty(t.shape[0], np.int32)
    owner[deal] = np.arange(t.shape[0], dtype=np.int32) % num_owners
    t_local = t.shape[0] // num_owners
    rank = np.zeros_like(owner)
    owned_ids = np.empty((num_owners, t_local), np.int32)
    for c in range(num_owners):
        ids = np.flatnonzero(owner == c)
        owned_ids[c] = ids
        rank[ids] = np.arange(ids.shape[0], dtype=np.int32)
    perm = owner * t_local + rank
    return owner, rank, owned_ids, perm


class TileBins(NamedTuple):
    """Pair layout for the composite.

    pair_src: [P_budget] int32, the source gaussian of each sorted pair
      slot; -1 for the invalid tail.
    tile_offsets: [T] int32 segment start of each tile (not aligned); in
      owner mode [T / num_owners], slot i is tile owned_ids[owner, i].
    tile_counts: [T] int32 pairs per tile (budget- and cap-clamped).
    overflow_count: [] int32 pairs dropped by every rule.
    overflow_far: [] int32 the part of overflow_count from the per-tile cap.
    """

    pair_src: torch.Tensor
    tile_offsets: torch.Tensor
    tile_counts: torch.Tensor
    overflow_count: torch.Tensor
    overflow_far: torch.Tensor


def _admit(kept0, in_class, lo: int, hi: int, cap: int):
    """Admission within one size class: the largest rects first, then the
    partial size class in gaussian-id order, up to `cap` members."""
    sizes = torch.arange(lo, hi + 1, dtype=torch.int32, device=kept0.device)
    c = ((kept0[:, None] >= sizes[None, :]) & in_class[:, None]).sum(0)
    s_star = torch.where(c <= cap, sizes, torch.full_like(sizes, hi + 1)).min()
    n_big = (in_class & (kept0 >= s_star)).sum()
    part = in_class & (kept0 == s_star - 1)
    rank = torch.cumsum(part.to(torch.int32), 0)
    return in_class & ((kept0 >= s_star) | (part & (rank <= cap - n_big)))


def _expand_whole(rect, visible, depth, num_tiles_x: int):
    """Every cell of every visible gaussian's rect, gaussian by gaussian
    and row by row within its rect: the (tile, depth, gaussian id) of
    each pair. The pairs' number is read back to the host once."""
    device = rect.device
    rw = (rect[:, 2] - rect[:, 0]).long()
    cells = torch.where(visible, rw * (rect[:, 3] - rect[:, 1]), 0)
    total = int(cells.sum())
    gid = torch.repeat_interleave(
        torch.arange(cells.shape[0], device=device), cells,
        output_size=total)
    first = torch.cumsum(cells, 0) - cells
    k = torch.arange(total, device=device) - first[gid]
    w = rw[gid]
    dy = torch.div(k, w, rounding_mode="floor")
    tile = (rect[gid, 1] + dy) * num_tiles_x + rect[gid, 0] + (k - dy * w)
    return tile.to(torch.int32), depth[gid], gid.to(torch.int32)


def _expand_tiers(proj: ProjectedGaussians, num_tiles_x: int,
                  num_tiles: int, tg_max: int, multi_frac: float,
                  multi_floor: int):
    """The size-tiered expansion (rule 1): the (tile, depth, gaussian id)
    of each slot of the static buffers, num_tiles where a slot holds no
    pair, and the cells that the tg_max cut and the tiers' capacities
    left out."""
    rect = proj.tile_rect
    visible = proj.visible
    device = rect.device
    n = proj.depth.shape[0]
    i32 = torch.int32
    rw = rect[:, 2] - rect[:, 0]
    rh = rect[:, 3] - rect[:, 1]
    n_slots = rw * rh
    rw_eff = torch.clamp(rw, 1, tg_max)
    rh_eff = torch.minimum(rh, torch.div(tg_max, rw_eff,
                                         rounding_mode="floor"))
    rw_kept = torch.minimum(rw, rw_eff)
    kept0 = rw_kept * rh_eff
    is_multi = visible & (kept0 > 1)
    gids = torch.arange(n, dtype=i32, device=device)

    small_max = min(8, tg_max)
    tiers = []
    if tg_max >= 2:
        tiers.append((2, small_max,
                      min(n, max(multi_floor,
                                 int(round(n * multi_frac))))))
    if tg_max > small_max:
        cap_big = n if multi_frac >= 1.0 else min(
            n, max(multi_floor // 4, int(round(n * multi_frac / 8)))
        )
        tiers.append((small_max + 1, tg_max, cap_big))

    # tier 0: the top-left cell of every visible gaussian
    tile_blocks = [torch.where(
        visible, rect[:, 1] * num_tiles_x + rect[:, 0],
        torch.full_like(rect[:, 0], num_tiles),
    ).to(i32)]
    depth_blocks = [proj.depth.detach()]
    gidx_blocks = [gids]

    one = visible.to(i32)
    rw_f, rh_f = one, one
    for lo, hi, cap in tiers:
        in_class = is_multi & (kept0 >= lo) & (kept0 <= hi)
        inc = _admit(kept0, in_class, lo, hi, cap)
        rw_f = torch.where(inc, rw_kept, rw_f)
        rh_f = torch.where(inc, rh_eff, rh_f)
        # admitted members first, in gaussian-id order
        order = torch.argsort((~inc).to(i32), stable=True)[:cap]
        m_ok = inc[order]
        m_x0 = rect[order, 0][:, None]
        m_y0 = rect[order, 1][:, None]
        m_rw = torch.clamp(rw_kept[order], min=1)[:, None]
        m_kept = kept0[order][:, None]
        slots = torch.arange(1, hi, dtype=i32, device=device)[None, :]
        dy = torch.div(slots, m_rw, rounding_mode="floor")
        dx = slots - dy * m_rw
        m_valid = m_ok[:, None] & (slots < m_kept)
        tile_k = (m_y0 + dy) * num_tiles_x + (m_x0 + dx)
        tile_blocks.append(torch.where(
            m_valid, tile_k, torch.full_like(tile_k, num_tiles)
        ).to(i32).reshape(-1))
        depth_blocks.append(
            proj.depth.detach()[order][:, None].expand(-1, hi - 1).reshape(-1)
        )
        gidx_blocks.append(
            order.to(i32)[:, None].expand(-1, hi - 1).reshape(-1))

    kept = rw_f * rh_f
    overflow_trunc = torch.where(
        visible, n_slots - kept, torch.zeros_like(kept)
    ).sum().to(i32)

    return (torch.cat(tile_blocks), torch.cat(depth_blocks),
            torch.cat(gidx_blocks), overflow_trunc)


def bin_gaussians(
    proj: ProjectedGaussians,
    num_tiles_x: int,
    num_tiles_y: int,
    tg_max: int,
    lane_align: int = 128,
    pair_budget_factor: int = 8,
    max_pairs_per_tile: int = 0,
    multi_frac: float = 1.0,
    multi_floor: int = 4096,
    owner: int = 0,
    num_owners: int = 1,
    group=None,
) -> TileBins:
    """See the module docstring. `owner` is this rank's place in the
    owners' `group` (a torch.distributed group of num_owners ranks);
    tg_max 0 keeps every pair (the budget, the per-tile cap, multi_frac
    and multi_floor then play no part)."""
    rect = proj.tile_rect
    visible = proj.visible
    device = rect.device
    n = proj.depth.shape[0]
    num_tiles = num_tiles_x * num_tiles_y
    i32 = torch.int32
    sharded = num_owners > 1
    t_local = num_tiles // num_owners
    if sharded:
        owner_np, rank_np, owned_np, _ = tile_owner_tables(
            num_tiles_x, num_tiles_y, num_owners)

    if tg_max <= 0:
        pair_tile, pair_depth, pair_gidx = _expand_whole(
            rect, visible, proj.depth.detach(), num_tiles_x)
        overflow_trunc = torch.zeros((), dtype=i32, device=device)
    else:
        pair_tile, pair_depth, pair_gidx, overflow_trunc = _expand_tiers(
            proj, num_tiles_x, num_tiles, tg_max, multi_frac, multi_floor)
    n_exp = pair_tile.shape[0]
    pair_key = pair_tile
    if sharded:
        # only the owned tiles' pairs, keyed by their local slot; the rest
        # key to the t_local sentinel and sort to the tail
        safe_t = torch.clamp(pair_tile, max=num_tiles - 1).long()
        is_local = (pair_tile < num_tiles) & (
            torch.as_tensor(owner_np, device=device)[safe_t] == owner)
        pair_key = torch.where(
            is_local, torch.as_tensor(rank_np, device=device)[safe_t],
            torch.full_like(pair_tile, t_local))
    # the whole-rect expansion comes in gaussian-id order already
    perm = (torch.arange(n_exp, device=device) if tg_max <= 0
            else torch.argsort(pair_gidx, stable=True))
    perm = perm[torch.argsort(pair_depth[perm], stable=True)]
    perm = perm[torch.argsort(pair_key[perm], stable=True)]
    sorted_gidx = pair_gidx[perm]

    valid_tiles = pair_tile[pair_tile < num_tiles]
    flat_counts = torch.bincount(valid_tiles.long(), minlength=num_tiles).to(i32)
    if sharded:
        flat_counts = flat_counts[torch.as_tensor(owned_np[owner],
                                                  device=device).long()]
    bounds = torch.cat([torch.zeros(1, dtype=i32, device=device),
                        torch.cumsum(flat_counts, 0, dtype=i32)])

    p_budget = n_exp
    if pair_budget_factor > 0 and tg_max > 0:
        p_budget = min(p_budget, n * pair_budget_factor)
    if sharded and tg_max > 0:
        # 1.5x the owner's even share of the budget plus an 8-lane floor
        # (JAX's rule: a small grid cannot be balanced statically)
        p_budget = min(p_budget,
                       -(-(p_budget * 3) // (2 * num_owners)) + 8 * lane_align)
    # at least one lane, so that no call hands the composite an empty
    # buffer
    p_budget = max(p_budget, 1)
    p_budget = ((p_budget + lane_align - 1) // lane_align) * lane_align

    starts = torch.clamp(bounds[:-1], max=p_budget)
    ends = torch.clamp(bounds[1:], max=p_budget)
    counts = ends - starts
    overflow_budget = ((bounds[1:] - bounds[:-1]) - counts).sum().to(i32)
    overflow_far = torch.zeros((), dtype=i32, device=device)
    if max_pairs_per_tile > 0 and tg_max > 0:
        overflow_far = torch.clamp(counts - max_pairs_per_tile, min=0).sum().to(i32)
        counts = torch.clamp(counts, max=max_pairs_per_tile)
    if sharded:
        # each pair has one owner: the global totals on every rank
        overflow_budget, overflow_far = all_reduce_sum(
            torch.stack([overflow_budget, overflow_far]), group).unbind(0)
    overflow = overflow_trunc + overflow_budget + overflow_far

    total_valid = torch.clamp(bounds[t_local], max=p_budget)
    src = sorted_gidx[:p_budget]
    if p_budget > n_exp:  # lane rounding can exceed the raw pair count
        src = torch.cat([src, torch.full((p_budget - n_exp,), -1, dtype=i32,
                                         device=device)])
    slot_ids = torch.arange(p_budget, dtype=i32, device=device)
    pair_src = torch.where(slot_ids < total_valid, src, torch.full_like(src, -1))

    return TileBins(
        pair_src=pair_src,
        tile_offsets=starts,
        tile_counts=counts,
        overflow_count=overflow,
        overflow_far=overflow_far,
    )
