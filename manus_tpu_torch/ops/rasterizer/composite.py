"""Tile compositing: the hand-written CUDA kernels and their plain version.

Counterpart of the JAX package's pallas_backend.py. Each 16x16 tile
composites its depth-ordered pair segment of the [16, P] payload front to
back (numerics in csrc/composite.cu and oracle.py).

  * `CompositeFn` binds the forward and backward CUDA kernels
    (csrc/composite.cu) as one autograd function. The kernels cut every
    tile's segment into depth chunks and give each (tile, chunk) its own
    CTA; `ChunkState` is what the forward saves for the backward;
  * `composite_tiles_torch` is the plain PyTorch version of the same math
    over [T, chunk, 256] blocks, differentiated by autograd;
  * `composite_tiles_split_torch` and `composite_split_backward_torch`
    are the plain model of the kernels' split by depth chunk, for the
    tests: the same function, computed the way the kernels compute it;
  * `composite_tiles` launches the kernels for a CUDA payload and runs the
    plain version for a CPU payload.

Every function takes the [T] tile slots' `tile_ids` (global tile ids, the
JAX kernels' `tile_ids=`): slot t composites tile tile_ids[t] of the
ntx x nty grid, for a rank that composites a subset of the grid (owner
and hybrid tile sharding, parallel/raster.py). None means the full
grid, slot t = tile t.

Outputs: rgb [T, 3, 256] and t_final [T, 256], in slot order.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from manus_tpu_torch.ops.rasterizer.oracle import (
    ALPHA_EPS,
    ALPHA_MAX,
    T_EPS,
    straight_through_min,
)
from manus_tpu_torch.ops.rasterizer.payload import (
    F_CONIC_A,
    F_CONIC_B,
    F_CONIC_C,
    F_MEAN_X,
    F_MEAN_Y,
    F_OPACITY,
    F_R,
    NUM_FIELDS,
)
from manus_tpu_torch.utils import cuda_build

LOG_T_EPS = math.log(T_EPS)
# The split forward walks a chunk a second time, pair by pair, for a pixel
# whose log T at the chunk's start plus the chunk's whole sum falls below
# LOG_T_EPS + STOP_MARGIN. 0 is the rule; a test raises it to drive the
# case that rounding alone makes rare: a second walk that does not stop.
STOP_MARGIN = 0.0
TILE = 16
N_PX = TILE * TILE

_P, _I64, _I32, _F32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                        ctypes.c_float)
LIBRARY = cuda_build.Kernels("composite", {
    "composite_chunk": ([], ctypes.c_int),
    "composite_occupancy": ([_P], ctypes.c_int),
    "composite_fwd": (
        [_P, _I64, _P, _P, _P, _I32, _I32, _P, _P, _P, _P, _P, _P, _I32, _P,
         _P, _F32, _P], ctypes.c_int),
    "composite_bwd": (
        [_P, _I64, _P, _P, _P, _I32, _I32, _P, _P, _I32, _P, _P, _P, _P, _P,
         _P, _P, _P], ctypes.c_int),
})


def chunk_size() -> int:
    """Pairs per (tile, chunk) item of the CUDA kernels."""
    return LIBRARY.get().composite_chunk()


def kernel_occupancy() -> dict:
    """CTAs an SM can hold of each composite kernel, by the CUDA runtime's
    occupancy calculator."""
    n = (ctypes.c_int * 3)()
    LIBRARY.check(LIBRARY.get().composite_occupancy(n), "composite_occupancy")
    return dict(zip(("chunk_pass", "rewalk", "bwd"), n))


def num_slots(ntx: int, nty: int, tile_ids) -> int:
    """The number of tile slots: the grid's, or the tile ids'."""
    return ntx * nty if tile_ids is None else tile_ids.shape[0]


def _slots(payload, offsets, counts, ntx: int, nty: int, tile_ids) -> int:
    """The number of tile slots of a launch whose inputs the kernels take,
    or ValueError."""
    if not payload.is_cuda:
        raise ValueError("the CUDA composite needs a CUDA payload")
    dev = payload.device
    cuda_build.check_tensor(payload, "payload", torch.float32,
                            (NUM_FIELDS, None), dev)
    t = num_slots(ntx, nty, tile_ids)
    cuda_build.check_tensor(offsets, "tile_offsets", torch.int32, (t,), dev)
    cuda_build.check_tensor(counts, "tile_counts", torch.int32, (t,), dev)
    if tile_ids is not None:
        cuda_build.check_tensor(tile_ids, "tile_ids", torch.int32, (t,), dev)
    return t


@cuda_build.counted
def composite_fwd_cuda(payload, offsets, counts, ntx: int, nty: int,
                       tile_ids=None):
    """Launch the forward (csrc/composite.cu: the plan of (tile, chunk)
    items, the chunk pass and the second walk, three device kernels, one
    count). Returns (rgb [T,3,256], t_final [T,256], log_t [T,256], n_walk
    [T,256] int32, ChunkState); the last three feed the backward."""
    t = _slots(payload, offsets, counts, ntx, nty, tile_ids)
    dev = payload.device
    n_items = max_items(payload.shape[1], t, chunk_size())
    rgb = torch.empty(t, 3, N_PX, dtype=torch.float32, device=dev)
    t_final = torch.empty(t, N_PX, dtype=torch.float32, device=dev)
    log_t = torch.empty(t, N_PX, dtype=torch.float32, device=dev)
    n_walk = torch.empty(t, N_PX, dtype=torch.int32, device=dev)
    tables = torch.empty(t + 1 + n_items, dtype=torch.int32, device=dev)
    state = ChunkState(
        tables[:t + 1], tables[t + 1:],
        torch.empty(n_items, 4, N_PX, dtype=torch.float32, device=dev))
    # per item and pixel: the chunk's own log-T sum, colour and last pair
    chunk_sums = torch.empty(n_items, 5, N_PX, dtype=torch.float32, device=dev)
    ptr = cuda_build.ptr
    LIBRARY.launch(
        "composite_fwd", ptr(payload), payload.shape[1], ptr(offsets),
        ptr(counts), ptr(tile_ids), t, ntx, ptr(rgb), ptr(t_final),
        ptr(log_t), ptr(n_walk), ptr(state.item_start), ptr(state.item_tile),
        n_items, ptr(chunk_sums), ptr(state.saved), STOP_MARGIN,
        device=dev, counter=composite_fwd_cuda)
    composite_fwd_cuda.tile_id_launches += tile_ids is not None
    return rgb, t_final, log_t, n_walk, state


# of the launches, the ones over tile ids (a subset of the grid)
composite_fwd_cuda.tile_id_launches = 0


@cuda_build.counted
def composite_bwd_cuda(payload, offsets, counts, ntx: int, nty: int,
                       d_rgb, d_tfin, t_final, log_t, n_walk,
                       state: ChunkState, tile_ids=None):
    """Launch the backward kernel on what the forward returned. Returns
    d_payload [16, P]."""
    t = _slots(payload, offsets, counts, ntx, nty, tile_ids)
    dev = payload.device
    n_items = max_items(payload.shape[1], t, chunk_size())
    for name, x, shape, dtype in (
        ("d_rgb", d_rgb, (t, 3, N_PX), torch.float32),
        ("d_tfin", d_tfin, (t, N_PX), torch.float32),
        ("t_final", t_final, (t, N_PX), torch.float32),
        ("log_t", log_t, (t, N_PX), torch.float32),
        ("n_walk", n_walk, (t, N_PX), torch.int32),
        ("state.item_start", state.item_start, (t + 1,), torch.int32),
        ("state.item_tile", state.item_tile, (n_items,), torch.int32),
        ("state.saved", state.saved, (n_items, 4, N_PX), torch.float32),
    ):
        cuda_build.check_tensor(x, name, dtype, shape, dev)
    d_payload = torch.zeros_like(payload)
    ptr = cuda_build.ptr
    LIBRARY.launch(
        "composite_bwd", ptr(payload), payload.shape[1], ptr(offsets),
        ptr(counts), ptr(tile_ids), t, ntx, ptr(state.item_start),
        ptr(state.item_tile), n_items, ptr(state.saved), ptr(d_rgb),
        ptr(d_tfin), ptr(t_final), ptr(log_t), ptr(n_walk), ptr(d_payload),
        device=dev, counter=composite_bwd_cuda)
    composite_bwd_cuda.tile_id_launches += tile_ids is not None
    return d_payload


composite_bwd_cuda.tile_id_launches = 0


class CompositeFn(torch.autograd.Function):
    """The CUDA forward kernel, with the CUDA backward kernel as its VJP."""

    @staticmethod
    def forward(ctx, payload, offsets, counts, ntx: int, nty: int,
                tile_ids=None):
        rgb, t_final, log_t, n_walk, state = composite_fwd_cuda(
            payload, offsets, counts, ntx, nty, tile_ids)
        ctx.save_for_backward(payload, offsets, counts, t_final, log_t, n_walk,
                              *state)
        ctx.grid = (ntx, nty)
        ctx.tile_ids = tile_ids
        return rgb, t_final

    @staticmethod
    def backward(ctx, d_rgb, d_tfin):
        payload, offsets, counts, t_final, log_t, n_walk, *state = \
            ctx.saved_tensors
        d_rgb = torch.zeros_like(t_final).unsqueeze(1).expand(-1, 3, -1) \
            if d_rgb is None else d_rgb
        d_tfin = torch.zeros_like(t_final) if d_tfin is None else d_tfin
        d_payload = composite_bwd_cuda(
            payload, offsets, counts, *ctx.grid, d_rgb.contiguous(),
            d_tfin.contiguous(), t_final, log_t, n_walk, ChunkState(*state),
            ctx.tile_ids)
        return d_payload, None, None, None, None, None


def tile_pixel_coords(ntx: int, nty: int, device, tile_ids=None):
    """Pixel-centre coordinates per tile slot: two [T, 256] float32
    tensors."""
    t = (torch.arange(ntx * nty, device=device) if tile_ids is None
         else tile_ids.to(device=device, dtype=torch.long))[:, None]
    i = torch.arange(N_PX, device=device)[None, :]
    px = ((t % ntx) * TILE + i % TILE).to(torch.float32)
    py = ((t // ntx) * TILE + i // TILE).to(torch.float32)
    return px, py


def composite_tiles_torch(payload, offsets, counts, ntx: int, nty: int,
                          chunk: int = 64, tile_ids=None):
    """Plain PyTorch composite, same math as the kernels; autograd gives
    its backward. Walks the pairs in chunks; chunk k only touches the
    tiles with more than k * chunk pairs."""
    dev = payload.device
    t = num_slots(ntx, nty, tile_ids)
    p = payload.shape[1]
    px, py = tile_pixel_coords(ntx, nty, dev, tile_ids)
    log_t = torch.zeros(t, N_PX, device=dev)
    accum = torch.zeros(t, 3, N_PX, device=dev)
    t_min = torch.ones(t, N_PX, device=dev)
    counts = counts.long()
    max_count = int(counts.max()) if t else 0
    # at least one pass, over no tiles when there are no pairs: the outputs
    # stay a function of the payload, so that a rank of a sharded render
    # with nothing to composite runs the backward of its collectives too
    for k0 in range(0, max(max_count, 1), chunk):
        live = torch.nonzero(counts > k0).squeeze(1)
        j = k0 + torch.arange(chunk, device=dev)
        in_seg = j[None, :] < counts[live, None]  # [L, G]
        cols = torch.clamp(offsets[live].long()[:, None] + j[None, :], max=p - 1)
        f = payload[:, cols]  # [16, L, G]
        dx = px[live][:, None, :] - f[F_MEAN_X][:, :, None]  # [L, G, Px]
        dy = py[live][:, None, :] - f[F_MEAN_Y][:, :, None]
        ca = f[F_CONIC_A][:, :, None]
        cb = f[F_CONIC_B][:, :, None]
        cc = f[F_CONIC_C][:, :, None]
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        op = torch.where(in_seg, f[F_OPACITY], 0.0)[:, :, None]
        alpha = straight_through_min(op * torch.exp(power), ALPHA_MAX)
        gate = (power <= 0.0) & (alpha.detach() >= ALPHA_EPS)
        alpha = torch.where(gate, alpha, 0.0)
        log1m = torch.log1p(-alpha)
        log_cp = log_t[live][:, None, :] + torch.cumsum(log1m, dim=1)
        t_before = torch.exp(log_cp - log1m)
        incl = log_cp.detach() >= LOG_T_EPS
        w = torch.where(incl, alpha * t_before, 0.0)
        colors = f[F_R:F_R + 3].permute(1, 0, 2)  # [L, 3, G]
        accum = accum.index_copy(0, live, accum[live] + colors @ w)
        chunk_min = torch.where(incl & (alpha > 0), torch.exp(log_cp), 1.0).amin(1)
        t_min = t_min.index_copy(0, live, torch.minimum(t_min[live], chunk_min))
        log_t = log_t.index_copy(0, live, log_cp[:, -1, :])
    return accum, t_min


class ChunkState(NamedTuple):
    """What the split forward saves for the split backward. A tile's
    segment is cut into depth chunks of `chunk` pairs; one item is one
    (tile, chunk), numbered tile by tile, front chunk first."""

    item_start: torch.Tensor  # [T + 1] int32 first item of each tile; [T] = items in all
    item_tile: torch.Tensor  # [max_items] int32 the tile of each item
    saved: torch.Tensor  # [max_items, 4, 256] f32: log T at the chunk's
    # start, then the colour the chunk added; per pixel only the chunks up
    # to the one that holds its last included pair are filled in


def max_items(p: int, t: int, chunk: int) -> int:
    """The static bound on the number of (tile, chunk) items: the segments
    are disjoint within the P pair columns, and every tile with pairs may
    end in one partial chunk."""
    return -(-p // chunk) + t


def _chunk_terms(payload, cols, px, py):
    """Per pair column and pixel of one tile, [n, 256] each: alpha (clamped),
    the gate (the pair counts at the pixel), exp(power), dx, dy."""
    f = payload[:, cols]
    dx = px[None, :] - f[F_MEAN_X][:, None]
    dy = py[None, :] - f[F_MEAN_Y][:, None]
    ca, cb, cc = (f[i][:, None] for i in (F_CONIC_A, F_CONIC_B, F_CONIC_C))
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    g = torch.exp(power)
    alpha = torch.clamp(f[F_OPACITY][:, None] * g, max=ALPHA_MAX)
    gate = (power <= 0.0) & (alpha >= ALPHA_EPS)
    return torch.where(gate, alpha, 0.0), gate, g, dx, dy


@torch.no_grad()
def composite_tiles_split_torch(payload, offsets, counts, ntx: int, nty: int,
                                chunk: int, tile_ids=None):
    """The plain model of the CUDA forward's split by depth range.

    Pass 1, every (tile, chunk) item on its own: from T = 1 and with no
    stop rule, L = the sum of log1p(-alpha) over the chunk's gated pairs,
    K = the colour the chunk would add, and the index + 1 of its last
    gated pair. Pass 2, per pixel over its tile's chunks in order, with
    `pre` the log T at the chunk's start: while pre + L >= log(1e-4) the
    chunk is included whole (it adds exp(pre) K, and pre += L); the first
    chunk that fails is walked pair by pair from the true `pre` under the
    stop rule, and if rounding lets that walk reach the chunk's end after
    all, the pixel goes on with the next chunk.

    Returns rgb [T, 3, 256], t_final, log_t, n_walk (int32) [T, 256] with
    the kernels' meaning, and the ChunkState for
    composite_split_backward_torch. Used by the tests, by nothing on the
    main path."""
    dev = payload.device
    t, p = num_slots(ntx, nty, tile_ids), payload.shape[1]
    px, py = tile_pixel_coords(ntx, nty, dev, tile_ids)
    counts_l = counts.long()
    n_chunks = (counts_l + chunk - 1) // chunk
    item_start = torch.cat([n_chunks.new_zeros(1), torch.cumsum(n_chunks, 0)])
    n_items = max_items(p, t, chunk)
    saved = torch.zeros(n_items, 4, N_PX, device=dev)
    item_tile = torch.full((n_items,), -1, dtype=torch.int32, device=dev)
    rgb = torch.zeros(t, 3, N_PX, device=dev)
    log_t = torch.zeros(t, N_PX, device=dev)
    n_walk = torch.zeros(t, N_PX, dtype=torch.int32, device=dev)
    for tile in torch.nonzero(counts_l).squeeze(1).tolist():
        first, count = int(item_start[tile]), int(counts_l[tile])
        pre = torch.zeros(N_PX, device=dev)
        col = torch.zeros(3, N_PX, device=dev)
        last = torch.zeros(N_PX, dtype=torch.long, device=dev)
        done = torch.zeros(N_PX, dtype=torch.bool, device=dev)
        for c in range(int(n_chunks[tile])):
            lo, hi = c * chunk, min((c + 1) * chunk, count)
            cols = int(offsets[tile]) + torch.arange(lo, hi, device=dev)
            alpha, gate, _, _, _ = _chunk_terms(payload, cols, px[tile], py[tile])
            colours = payload[F_R:F_R + 3, cols]
            idx1 = torch.arange(lo + 1, hi + 1, device=dev)[:, None]
            log1m = torch.log1p(-alpha)
            # pass 1: the chunk alone, from T = 1
            rel = torch.cumsum(log1m, 0)
            chunk_l = rel[-1]
            chunk_k = colours @ (alpha * torch.exp(rel - log1m))
            chunk_last = torch.where(gate, idx1, 0).amax(0)
            # pass 2
            item_tile[first + c] = tile
            saved[first + c, 0] = pre
            walk = ~done & (pre + chunk_l < LOG_T_EPS + STOP_MARGIN)
            whole = ~done & ~walk
            lt = pre[None, :] + rel
            incl = gate & (lt >= LOG_T_EPS)
            walk_k = colours @ torch.where(incl, alpha * torch.exp(lt - log1m), 0.0)
            walk_last = torch.where(incl, idx1, 0).amax(0)
            walk_lt = torch.where(incl, lt, math.inf).amin(0)  # lt only falls
            walk_lt = torch.where(incl.any(0), walk_lt, pre)
            add = torch.where(walk, walk_k,
                              torch.where(whole, torch.exp(pre) * chunk_k, 0.0))
            saved[first + c, 1:] = add
            col = col + add
            last = torch.where(walk, torch.maximum(last, walk_last),
                               torch.where(whole, torch.maximum(last, chunk_last),
                                           last))
            pre = torch.where(walk, walk_lt,
                              torch.where(whole, pre + chunk_l, pre))
            done = done | (walk & (gate & ~incl).any(0))
        rgb[tile], log_t[tile], n_walk[tile] = col, pre, last.to(torch.int32)
    state = ChunkState(item_start.to(torch.int32), item_tile, saved)
    return rgb, torch.exp(log_t), log_t, n_walk, state


@torch.no_grad()
def composite_split_backward_torch(payload, offsets, counts, ntx: int, nty: int,
                                   chunk: int, d_rgb, d_tfin, t_final, log_t,
                                   n_walk, state: ChunkState, tile_ids=None):
    """The plain model of the CUDA backward: d_payload [16, P] from the
    split forward's outputs and saved state, every (tile, chunk) item on
    its own. A pixel takes part in the chunks up to the one that holds its
    last included pair (n_walk). There it starts from the forward's final
    log T and nothing behind; in an earlier chunk from the next chunk's
    saved log T and, behind, the saved colours of the later chunks summed
    farthest first (not the total less a prefix: that cancels)."""
    dev = payload.device
    px, py = tile_pixel_coords(ntx, nty, dev, tile_ids)
    counts_l = counts.long()
    d_payload = torch.zeros_like(payload)
    for tile in torch.nonzero(counts_l).squeeze(1).tolist():
        first, count = int(state.item_start[tile]), int(counts_l[tile])
        n_chunks = int(state.item_start[tile + 1]) - first
        nw = n_walk[tile].long()
        last_chunk = torch.div(nw - 1, chunk, rounding_mode="floor")
        tfin_term = t_final[tile] * d_tfin[tile]
        dr = d_rgb[tile]  # [3, 256]
        for c in range(n_chunks):
            lo, hi = c * chunk, min((c + 1) * chunk, count)
            if not bool((nw > lo).any()):
                continue
            behind = torch.zeros(3, N_PX, device=dev)
            for k in range(n_chunks - 1, c, -1):
                behind += torch.where(last_chunk >= k, state.saved[first + k, 1:], 0.0)
            lt_end = log_t[tile]
            if c + 1 < n_chunks:
                lt_end = torch.where(last_chunk > c, state.saved[first + c + 1, 0],
                                     lt_end)
            cols = int(offsets[tile]) + torch.arange(lo, hi, device=dev)
            alpha, gate, g, dx, dy = _chunk_terms(payload, cols, px[tile], py[tile])
            f = payload[:, cols]
            act = gate & (torch.arange(lo, hi, device=dev)[:, None] < nw[None, :])
            log1m = torch.where(act, torch.log1p(-alpha), 0.0)
            from_here = torch.flip(torch.cumsum(torch.flip(log1m, [0]), 0), [0])
            t_bef = torch.exp(lt_end[None, :] - from_here)
            w = torch.where(act, alpha * t_bef, 0.0)
            cd = f[F_R:F_R + 3].T @ dr  # [n, 256]
            wcd = w * cd
            suffix = (dr * behind).sum(0)[None, :] + \
                torch.flip(torch.cumsum(torch.flip(wcd, [0]), 0), [0]) - wcd
            d_alpha = torch.where(
                act, t_bef * cd - (suffix + tfin_term) / (1.0 - alpha), 0.0)
            d_power = d_alpha * f[F_OPACITY][:, None] * g  # straight through the clamp
            dpx, dpy = d_power * dx, d_power * dy
            ca, cb, cc = (f[i][:, None] for i in (F_CONIC_A, F_CONIC_B, F_CONIC_C))
            d_payload[F_MEAN_X, cols] = (ca * dpx + cb * dpy).sum(1)
            d_payload[F_MEAN_Y, cols] = (cc * dpy + cb * dpx).sum(1)
            d_payload[F_CONIC_A, cols] = (-0.5 * dpx * dx).sum(1)
            d_payload[F_CONIC_B, cols] = (-dpx * dy).sum(1)
            d_payload[F_CONIC_C, cols] = (-0.5 * dpy * dy).sum(1)
            d_payload[F_OPACITY, cols] = (d_alpha * g).sum(1)
            d_payload[F_R:F_R + 3, cols] = (w[None] * dr[:, None, :]).sum(2)
    return d_payload


def composite_tiles(payload, offsets, counts, ntx: int, nty: int,
                    chunk: int = 64, tile_ids=None):
    """The CUDA kernels for a CUDA payload; the plain version for a CPU
    payload (`chunk` only applies there)."""
    if payload.is_cuda:
        return CompositeFn.apply(payload, offsets, counts, ntx, nty, tile_ids)
    return composite_tiles_torch(payload, offsets, counts, ntx, nty, chunk,
                                 tile_ids)


def tiles_to_image(rgb_tiles, t_final, bg, ntx: int, nty: int,
                   width: int, height: int):
    """Tile outputs -> ([H, W, 3] with T_final * bg added, [H, W] T_final)."""
    out = rgb_tiles + t_final[:, None, :] * bg[None, :, None]
    out = out.reshape(nty, ntx, 3, TILE, TILE).permute(0, 3, 1, 4, 2)
    out = out.reshape(nty * TILE, ntx * TILE, 3)
    tf = t_final.reshape(nty, ntx, TILE, TILE).permute(0, 2, 1, 3)
    tf = tf.reshape(nty * TILE, ntx * TILE)
    return out[:height, :width], tf[:height, :width]
