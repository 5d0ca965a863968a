"""Tile compositing: the hand-written CUDA kernels and their plain version.

Counterpart of the JAX package's pallas_backend.py. Each 16x16 tile
composites its depth-ordered pair segment of the [16, P] payload front to
back (numerics in csrc/composite.cu and oracle.py).

  * `CompositeFn` binds the forward and backward CUDA kernels
    (csrc/composite.cu) as one autograd function;
  * `composite_tiles_torch` is the plain PyTorch version of the same math
    over [T, chunk, 256] blocks, differentiated by autograd;
  * `composite_tiles` launches the kernels for a CUDA payload and runs the
    plain version for a CPU payload.

Outputs: rgb [T, 3, 256] and t_final [T, 256].
"""
from __future__ import annotations

import ctypes
import math

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
TILE = 16
N_PX = TILE * TILE

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_SIGNATURES = {
    "composite_fwd": (
        [_P, _I64, _P, _P, _I32, _I32, _P, _P, _P, _P, _P], ctypes.c_int),
    "composite_bwd": (
        [_P, _I64, _P, _I32, _I32, _P, _P, _P, _P, _P, _P, _P], ctypes.c_int),
    "composite_error_string": ([ctypes.c_int], ctypes.c_char_p),
}


def _library():
    return cuda_build.load("composite", _SIGNATURES)


def _check_launch(lib, rc: int, what: str):
    if rc != 0:
        msg = lib.composite_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: {msg} ({rc})")


def _check_inputs(payload, offsets, counts, ntx: int, nty: int):
    if not payload.is_cuda:
        raise ValueError("the CUDA composite needs a CUDA payload")
    if payload.dtype != torch.float32 or payload.dim() != 2 \
            or payload.shape[0] != NUM_FIELDS or not payload.is_contiguous():
        raise ValueError(
            f"payload must be a contiguous float32 [{NUM_FIELDS}, P] tensor, "
            f"got {payload.dtype} {tuple(payload.shape)}")
    for name, x in (("tile_offsets", offsets), ("tile_counts", counts)):
        if x.device != payload.device or x.dtype != torch.int32 \
                or x.shape != (ntx * nty,) or not x.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous int32 [{ntx * nty}] tensor on "
                f"{payload.device}, got {x.dtype} {tuple(x.shape)} on {x.device}")


def composite_fwd_cuda(payload, offsets, counts, ntx: int, nty: int):
    """Launch the forward kernel. Returns (rgb [T,3,256], t_final [T,256],
    log_t [T,256], n_walk [T,256] int32); the last two feed the backward."""
    _check_inputs(payload, offsets, counts, ntx, nty)
    lib = _library()
    t = ntx * nty
    dev = payload.device
    rgb = torch.empty(t, 3, N_PX, dtype=torch.float32, device=dev)
    t_final = torch.empty(t, N_PX, dtype=torch.float32, device=dev)
    log_t = torch.empty(t, N_PX, dtype=torch.float32, device=dev)
    n_walk = torch.empty(t, N_PX, dtype=torch.int32, device=dev)
    rc = lib.composite_fwd(
        payload.data_ptr(), payload.shape[1], offsets.data_ptr(),
        counts.data_ptr(), t, ntx, rgb.data_ptr(), t_final.data_ptr(),
        log_t.data_ptr(), n_walk.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _check_launch(lib, rc, "composite_fwd")
    composite_fwd_cuda.launches += 1
    return rgb, t_final, log_t, n_walk


composite_fwd_cuda.launches = 0


def composite_bwd_cuda(payload, offsets, counts, ntx: int, nty: int,
                       d_rgb, d_tfin, t_final, log_t, n_walk):
    """Launch the backward kernel. Returns d_payload [16, P]."""
    _check_inputs(payload, offsets, counts, ntx, nty)
    t = ntx * nty
    for name, x, shape, dtype in (
        ("d_rgb", d_rgb, (t, 3, N_PX), torch.float32),
        ("d_tfin", d_tfin, (t, N_PX), torch.float32),
        ("t_final", t_final, (t, N_PX), torch.float32),
        ("log_t", log_t, (t, N_PX), torch.float32),
        ("n_walk", n_walk, (t, N_PX), torch.int32),
    ):
        if x.device != payload.device or x.dtype != dtype \
                or x.shape != shape or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} {shape} "
                             f"tensor on {payload.device}")
    lib = _library()
    d_payload = torch.zeros_like(payload)
    rc = lib.composite_bwd(
        payload.data_ptr(), payload.shape[1], offsets.data_ptr(), t, ntx,
        d_rgb.data_ptr(), d_tfin.data_ptr(), t_final.data_ptr(),
        log_t.data_ptr(), n_walk.data_ptr(), d_payload.data_ptr(),
        torch.cuda.current_stream(payload.device).cuda_stream,
    )
    _check_launch(lib, rc, "composite_bwd")
    composite_bwd_cuda.launches += 1
    return d_payload


composite_bwd_cuda.launches = 0


class CompositeFn(torch.autograd.Function):
    """The CUDA forward kernel, with the CUDA backward kernel as its VJP."""

    @staticmethod
    def forward(ctx, payload, offsets, counts, ntx: int, nty: int):
        rgb, t_final, log_t, n_walk = composite_fwd_cuda(
            payload, offsets, counts, ntx, nty)
        ctx.save_for_backward(payload, offsets, counts, t_final, log_t, n_walk)
        ctx.grid = (ntx, nty)
        return rgb, t_final

    @staticmethod
    def backward(ctx, d_rgb, d_tfin):
        payload, offsets, counts, t_final, log_t, n_walk = ctx.saved_tensors
        d_rgb = torch.zeros_like(t_final).unsqueeze(1).expand(-1, 3, -1) \
            if d_rgb is None else d_rgb
        d_tfin = torch.zeros_like(t_final) if d_tfin is None else d_tfin
        d_payload = composite_bwd_cuda(
            payload, offsets, counts, *ctx.grid, d_rgb.contiguous(),
            d_tfin.contiguous(), t_final, log_t, n_walk)
        return d_payload, None, None, None, None


def tile_pixel_coords(ntx: int, nty: int, device):
    """Pixel-centre coordinates per tile: two [T, 256] float32 tensors."""
    t = torch.arange(ntx * nty, device=device)[:, None]
    i = torch.arange(N_PX, device=device)[None, :]
    px = ((t % ntx) * TILE + i % TILE).to(torch.float32)
    py = ((t // ntx) * TILE + i // TILE).to(torch.float32)
    return px, py


def composite_tiles_torch(payload, offsets, counts, ntx: int, nty: int,
                          chunk: int = 64):
    """Plain PyTorch composite, same math as the kernels; autograd gives
    its backward. Walks the pairs in chunks; chunk k only touches the
    tiles with more than k * chunk pairs."""
    dev = payload.device
    t = ntx * nty
    p = payload.shape[1]
    px, py = tile_pixel_coords(ntx, nty, dev)
    log_t = torch.zeros(t, N_PX, device=dev)
    accum = torch.zeros(t, 3, N_PX, device=dev)
    t_min = torch.ones(t, N_PX, device=dev)
    counts = counts.long()
    max_count = int(counts.max()) if t else 0
    for k0 in range(0, max_count, chunk):
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


def composite_tiles(payload, offsets, counts, ntx: int, nty: int,
                    chunk: int = 64):
    """The CUDA kernels for a CUDA payload; the plain version for a CPU
    payload (`chunk` only applies there)."""
    if payload.is_cuda:
        return CompositeFn.apply(payload, offsets, counts, ntx, nty)
    return composite_tiles_torch(payload, offsets, counts, ntx, nty, chunk)


def tiles_to_image(rgb_tiles, t_final, bg, ntx: int, nty: int,
                   width: int, height: int):
    """Tile outputs -> ([H, W, 3] with T_final * bg added, [H, W] T_final)."""
    out = rgb_tiles + t_final[:, None, :] * bg[None, :, None]
    out = out.reshape(nty, ntx, 3, TILE, TILE).permute(0, 3, 1, 4, 2)
    out = out.reshape(nty * TILE, ntx * TILE, 3)
    tf = t_final.reshape(nty, ntx, TILE, TILE).permute(0, 2, 1, 3)
    tf = tf.reshape(nty * TILE, ntx * TILE)
    return out[:height, :width], tf[:height, :width]
