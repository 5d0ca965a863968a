"""Nearest neighbours of point sets, blockwise.

Squared distances are |x|^2 + |y|^2 - 2 x.y^T in float32 over blocks of
query rows, as the JAX package computes them, so thresholds on them and
neighbour sets come out the same. The products run in full float32:
`fp32_matmul` turns TF32 off around them whatever the caller has set.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def fp32_matmul():
    """Float32 matmuls on CUDA in full precision (no TF32) inside."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def knn_self_distances(points: torch.Tensor, k: int = 3,
                       block: int = 4096) -> torch.Tensor:
    """Mean squared distance from each point to its k nearest neighbours,
    itself excluded (simple-knn's distCUDA2 for k=3).

    Blockwise |x|^2 + |y|^2 - 2 x.y^T with a top-k per row, on the points'
    own device. points: [N, 3] float32. Returns [N] float32.
    """
    pts = points.to(torch.float32)
    n = pts.shape[0]
    sq = (pts * pts).sum(-1)
    kk = min(k, n - 1)
    out = torch.empty(n, dtype=torch.float32, device=pts.device)
    with fp32_matmul():
        for i in range(0, n, block):
            rows = pts[i:i + block]
            d2 = sq[i:i + block, None] + sq[None, :] - 2.0 * (rows @ pts.T)
            r = torch.arange(rows.shape[0], device=pts.device)
            d2[r, r + i] = float("inf")
            top = torch.topk(d2, kk, dim=-1, largest=False).values
            out[i:i + block] = top.clamp(min=0.0).mean(-1)
    return out


def nearest_neighbor(pt1: torch.Tensor, pt2: torch.Tensor, block: int = 1024,
                     pt2_valid: torch.Tensor | None = None):
    """For each point of pt1 [N, 3], the distance to and index of the
    nearest point of pt2 [M, 3]; rows of pt2 where pt2_valid is false are
    never chosen. Returns (dist [N] float32, idx [N] int32)."""
    sq2 = (pt2 * pt2).sum(-1)
    if pt2_valid is not None:
        sq2 = torch.where(pt2_valid, sq2, float("inf"))
    dist, idx = [], []
    with fp32_matmul():
        for i in range(0, pt1.shape[0], block):
            rows = pt1[i:i + block]
            d2 = (rows * rows).sum(-1)[:, None] + sq2[None, :] \
                - 2.0 * (rows @ pt2.T)
            best, j = d2.min(dim=-1)
            dist.append(torch.sqrt(best.clamp(min=0.0)))
            idx.append(j.to(torch.int32))
    return torch.cat(dist), torch.cat(idx)


def knn_indices(query: torch.Tensor, ref: torch.Tensor, k: int,
                block: int = 1024) -> torch.Tensor:
    """Indices of the k nearest ref points [M, 3] of each query point
    [N, 3], nearest first. Returns [N, k] int32."""
    sq2 = (ref * ref).sum(-1)
    out = []
    with fp32_matmul():
        for i in range(0, query.shape[0], block):
            rows = query[i:i + block]
            d2 = (rows * rows).sum(-1)[:, None] + sq2[None, :] \
                - 2.0 * (rows @ ref.T)
            out.append(torch.topk(d2, k, dim=-1, largest=False).indices.to(
                torch.int32))
    return torch.cat(out)
