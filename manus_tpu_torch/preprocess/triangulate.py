"""Multi-view keypoint triangulation (confidence-weighted DLT), batched
torch (the JAX package's preprocess/triangulate.py).

The 2D keypoint networks upstream produce [V, J, 3] (x, y, confidence)
per frame; this turns them into [J, 4] (xyz, mean confidence). Every
function takes leading batch dimensions (frames) ahead of V: frames are
independent, so a sequence triangulates in one batch.
"""
from __future__ import annotations

import torch


def batch_triangulate(keypoints: torch.Tensor, P_all: torch.Tensor,
                      min_view: int = 2) -> torch.Tensor:
    """DLT triangulation of J joints from V views: keypoints [..., V, J, 3]
    (x, y, conf), P_all [V, 3, 4] (K @ [R|t]) -> [..., J, 4] (xyz, the
    mean confidence of the views that see it), a zero row where fewer
    than min_view views see the joint (its A is zero and its SVD
    arbitrary: masked, as the JAX package masks it)."""
    conf = keypoints[..., 2]  # [..., V, J]
    n_seen = (conf > 0).sum(-2)  # [..., J]
    u = keypoints[..., 0].transpose(-1, -2)[..., None]  # [..., J, V, 1]
    v = keypoints[..., 1].transpose(-1, -2)[..., None]
    c = conf.transpose(-1, -2)[..., None]
    p0, p1, p2 = P_all[:, 0, :], P_all[:, 1, :], P_all[:, 2, :]  # [V, 4]
    A = torch.cat([c * (u * p2 - p0), c * (v * p2 - p1)], dim=-2)
    X = _null_vector(A)
    w = X[..., 3:]
    X = X / torch.where(w.abs() > 1e-12, w, 1.0)
    conf3d = conf.sum(-2) / n_seen.clamp_min(1)
    out = torch.cat([X[..., :3], conf3d[..., None]], dim=-1)
    return torch.where((n_seen >= min_view)[..., None], out, 0.0)


# Gram matrices a batched SVD takes at once (cuSOLVER's batched Jacobi
# SVD of matrices up to 32 x 32)
NULL_VECTOR_CHUNK = 8192


def _null_vector(A: torch.Tensor) -> torch.Tensor:
    """The homogeneous least-squares solution of A [..., m, 4] X = 0: the
    right singular vector of A's smallest singular value (the JAX
    package's SVD of A), taken from the SVD of the 4x4 Gram matrix A^T A
    formed in float64. The float64 normal equations keep float32's
    accuracy at a triangulation's conditioning, and a card takes a batch
    of 4x4 SVDs in one launch, where it takes the SVDs of thousands of
    [m, 4] matrices one at a time."""
    a = A.double()
    gram = (a.transpose(-1, -2) @ a).reshape(-1, 4, 4)
    x = torch.cat([torch.linalg.svd(g)[2][:, -1]
                   for g in gram.split(NULL_VECTOR_CHUNK)])
    return x.reshape(A.shape[:-2] + (4,)).to(A.dtype)


def reprojection_error(points3d: torch.Tensor, keypoints: torch.Tensor,
                       P_all: torch.Tensor) -> torch.Tensor:
    """Pixel reprojection error [..., V, J] of points3d [..., J, 3]
    against keypoints [..., V, J, 3]."""
    homo = torch.cat([points3d, torch.ones_like(points3d[..., :1])], -1)
    proj = torch.einsum("vab,...jb->...vja", P_all, homo)
    z = proj[..., 2:]
    xy = proj[..., :2] / torch.where(z.abs() > 1e-12, z, 1.0)
    return torch.linalg.norm(xy - keypoints[..., :2], dim=-1)


def _max_err(kp, P_all, min_view):
    """Each joint's worst reprojection error over the views that see it."""
    p3d = batch_triangulate(kp, P_all, min_view)
    err = reprojection_error(p3d[..., :3], kp, P_all)
    return torch.where(kp[..., 2] > 0, err, 0.0).amax(-2)


def iterative_triangulate(keypoints: torch.Tensor, P_all: torch.Tensor,
                          min_view: int = 2, iterations: int = 3,
                          error_threshold_px: float = 20.0) -> torch.Tensor:
    """Robust triangulation by greedy leave-one-view-out: per pass and
    joint, try dropping each view (all V at once, one batched solve over
    [..., V, J, 2V, 4]), keep the drop that minimises the worst remaining
    reprojection error, and accept it only where the fit violates the
    threshold and the drop improves it. keypoints [..., V, J, 3]."""
    n_v = keypoints.shape[-3]
    eye = torch.eye(n_v, dtype=torch.bool, device=keypoints.device)
    kp = keypoints
    for _ in range(iterations):
        base_err = _max_err(kp, P_all, min_view)  # [..., J]
        # candidate d drops view d: its confidences zeroed
        conf = kp[..., 2].unsqueeze(-3)  # [..., 1, V, J]
        drop_conf = torch.where(eye[:, :, None], 0.0, conf)  # [..., D, V, J]
        cand = torch.cat([kp[..., :2].unsqueeze(-4).expand(
            drop_conf.shape + (2,)), drop_conf[..., None]], -1)
        cand_err = _max_err(cand, P_all, min_view)  # [..., D, J]
        best_err, best_view = cand_err.min(-2)
        accept = (base_err > error_threshold_px) & (best_err < base_err)
        v_ids = torch.arange(n_v, device=kp.device)
        kill = (v_ids[:, None] == best_view[..., None, :]) & accept[..., None, :]
        kp = torch.cat([kp[..., :2],
                        torch.where(kill, 0.0, kp[..., 2])[..., None]], -1)
    return batch_triangulate(kp, P_all, min_view)
