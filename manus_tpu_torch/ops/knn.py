"""Nearest-neighbour distances for the gaussian scale init."""
from __future__ import annotations

import torch


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
    for i in range(0, n, block):
        rows = pts[i:i + block]
        d2 = sq[i:i + block, None] + sq[None, :] - 2.0 * (rows @ pts.T)
        r = torch.arange(rows.shape[0], device=pts.device)
        d2[r, r + i] = float("inf")
        top = torch.topk(d2, kk, dim=-1, largest=False).values
        out[i:i + block] = top.clamp(min=0.0).mean(-1)
    return out
