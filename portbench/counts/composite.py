"""The composite's work on one image: the pixel-pair evaluations that
front-to-back compositing needs, and their least time on the card.

A pixel walks its tile's depth-ordered pairs up to and including the
one that takes its transmittance below 1e-4 (the rasterizer stops
before compositing that pair, but has to evaluate it to know); pairs
past the stop need no evaluation, whatever a kernel does with them.
"""
from __future__ import annotations

import math

import torch

from portbench.counts.peaks import least_s

TILE_PX = 256
T_EPS = 1e-4
ALPHA_MAX, ALPHA_EPS = 0.99, 1.0 / 255.0
# Float operations per evaluated pixel-pair, counted from the port's
# csrc/composite.cu (transcendentals one each): the forward's gates,
# alpha, log-T step and colour accumulation; the backward's
# recomputation, gradient terms and its share of the nine-value warp
# reduction (the port's PERF kernel table uses the same counts).
FWD_FLOP_PER_EVAL, BWD_FLOP_PER_EVAL = 32, 61
# payload rows a pair carries: 9 float32 fields forward; the backward
# reads them and writes their 9 gradients
FWD_BYTES_PER_PAIR, BWD_BYTES_PER_PAIR = 36, 72


@torch.no_grad()
def walk_counts(payload, offsets, counts, ntx: int, chunk: int = 64):
    """[T, 256] evaluations each pixel needs, from the [16, P] payload
    (rows: mean x, y; conic a, b, c; opacity; rgb) and each tile's
    segment of it."""
    dev = payload.device
    t = offsets.shape[0]
    tid = torch.arange(t, device=dev)[:, None]
    i = torch.arange(TILE_PX, device=dev)[None, :]
    px = ((tid % ntx) * 16 + i % 16).float()
    py = ((tid // ntx) * 16 + i // 16).float()
    counts = counts.long()
    log_t = torch.zeros(t, TILE_PX, device=dev)
    n_eval = torch.zeros(t, TILE_PX, dtype=torch.long, device=dev)
    p = payload.shape[1]
    for k0 in range(0, int(counts.max()) if t else 0, chunk):
        live = torch.nonzero(counts > k0).squeeze(1)
        j = k0 + torch.arange(chunk, device=dev)
        in_seg = j[None, :] < counts[live, None]
        cols = torch.clamp(offsets[live].long()[:, None] + j[None, :],
                           max=p - 1)
        f = payload[:, cols]
        dx = px[live][:, None, :] - f[0][:, :, None]
        dy = py[live][:, None, :] - f[1][:, :, None]
        power = (-0.5 * (f[2][:, :, None] * dx * dx
                         + f[4][:, :, None] * dy * dy)
                 - f[3][:, :, None] * dx * dy)
        alpha = torch.clamp(f[5][:, :, None] * torch.exp(power), max=ALPHA_MAX)
        alpha = torch.where((power <= 0) & (alpha >= ALPHA_EPS)
                            & in_seg[:, :, None], alpha, 0.0)
        log_cp = log_t[live][:, None, :] + torch.cumsum(torch.log1p(-alpha), 1)
        # pairs walked: those in the segment while the pixel's T before
        # them was still at or above the stop (log T only falls), so the
        # pair that crosses the stop counts
        before = torch.cat([log_t[live][:, None, :], log_cp[:, :-1]], 1)
        walked = in_seg[:, :, None] & (before >= math.log(T_EPS))
        n_eval[live] += walked.sum(1)
        log_t[live] = log_cp[:, -1]
    return n_eval


def least_times(n_eval) -> tuple:
    """(forward, backward) least seconds for a [T, 256] evaluation count:
    each pair that some pixel of its tile evaluates is read once, the
    tile's offsets and counts once, each output pixel written once."""
    tiles = n_eval.shape[0]
    evals = float(n_eval.sum())
    pairs = float(n_eval.amax(1).sum())
    px = tiles * TILE_PX
    fwd = least_s(FWD_FLOP_PER_EVAL * evals,
                  FWD_BYTES_PER_PAIR * pairs + 8 * tiles + 24 * px)
    bwd = least_s(BWD_FLOP_PER_EVAL * evals,
                  BWD_BYTES_PER_PAIR * pairs + 4 * tiles + 28 * px)
    return fwd, bwd
