"""Statistical outliers of a gaussian cloud: the Local Outlier Probability.

The reference prunes outliers once with MeshLab's "select point cloud
outliers" filter (prob 0.8), which implements LoOP (Kriegel et al.):

  sigma(p)  = sqrt(mean_{o in kNN(p)} d^2(p, o))      (standard distance)
  plof(p)   = sigma(p) / mean_{o in kNN(p)} sigma(o) - 1
  nplof     = lambda * sqrt(mean_p plof(p)^2)
  LoOP(p)   = max(0, erf(plof(p) / (nplof * sqrt(2))))

over the padded cloud with an active mask: inactive slots are neither
queries nor neighbours. The kNN is blockwise over query rows on the
points' device. Squared distances are summed from the coordinate
differences, (x - x')^2 + (y - y')^2 + (z - z')^2, each step its own
elementwise operation, rounded once the same way on any device; the
|x|^2 + |y|^2 - 2 x.y of ops/knn.py would cancel to ~1e-4 of d^2 in a
dense cloud, where many neighbours then tie exactly and the card and
the CPU break the ties apart (a probability moved by up to ~0.06).
"""
from __future__ import annotations

import math

import torch


def _knn_d2_and_idx(points, valid, k: int, block: int):
    """Squared distances and indices of the k nearest valid neighbours of
    every row, itself excluded. points: [N, 3] with N % block == 0; the
    rows of invalid points hold values the caller masks."""
    n = points.shape[0]
    coords = torch.where(valid[:, None], points, 0.0).unbind(-1)
    cols = torch.arange(n, device=points.device)
    d2s, idxs = [], []
    for i in range(0, n, block):
        r = slice(i, i + block)
        dx, dy, dz = (c[r, None] - c for c in coords)
        d2 = dx * dx + dy * dy + dz * dz
        d2 = torch.where(valid & (cols != cols[r, None]), d2, float("inf"))
        top = torch.topk(d2, k, dim=-1, largest=False)
        d2s.append(top.values.clamp(min=0.0))
        idxs.append(top.indices)
    return torch.cat(d2s), torch.cat(idxs)


def loop_outlier_probability(points: torch.Tensor, valid: torch.Tensor,
                             k: int = 32, lam: float = 3.0,
                             block: int = 1024) -> torch.Tensor:
    """Per-point LoOP in [0, 1], 0 for invalid rows. points: [N, 3] with N
    a multiple of block (outlier_mask pads)."""
    d2, idx = _knn_d2_and_idx(points, valid, k, block)
    sigma = torch.sqrt(d2.mean(-1))
    nb_sigma = sigma[idx].mean(-1)
    plof = sigma / nb_sigma.clamp(min=1e-12) - 1.0
    plof = torch.where(valid, plof, 0.0)
    n_valid = valid.sum().clamp(min=1)
    nplof = lam * torch.sqrt((plof * plof).sum() / n_valid)
    z = plof / (nplof * math.sqrt(2.0)).clamp(min=1e-12)
    prob = torch.special.erf(z).clamp(min=0.0)
    return torch.where(valid, prob, 0.0)


def outlier_probability(points: torch.Tensor, valid: torch.Tensor,
                        k: int = 32, block: int = 1024) -> torch.Tensor:
    """loop_outlier_probability of any N: the cloud is padded to the block
    with invalid rows, and k is at most N - 1. Returns [N]."""
    n = points.shape[0]
    block = min(block, max(8, n))
    pad = (-n) % block
    if pad:
        points = torch.cat([points, points.new_zeros(pad, 3)])
        valid = torch.cat([valid, valid.new_zeros(pad)])
    return loop_outlier_probability(points, valid, k=min(k, n - 1),
                                    block=block)[:n]


def outlier_mask(points: torch.Tensor, valid: torch.Tensor, prob: float = 0.8,
                 k: int = 32, block: int = 1024) -> torch.Tensor:
    """[N] bool: a valid point whose LoOP exceeds `prob` (the reference's
    0.8). k is 32 where the reference asks MeshLab for 512: LoOP settles
    long before that, and the top-k's cost grows with k."""
    return outlier_probability(points, valid, k=k, block=block) > prob
