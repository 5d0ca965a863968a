"""Nearest neighbours of point sets.

Squared distances are |x|^2 + |y|^2 - 2 x.y in float32, as the JAX
package computes them, so thresholds on them and neighbour sets come out
the same. `nearest_neighbor` has two paths:

  * CUDA tensors: the kernel of csrc/knn.cu (`nearest_neighbor_cuda`),
    one pass that gives each query its nearest valid reference and that
    distance without the distance matrix ever reaching device memory:
    |x|^2 + min_j (|y_j|^2 - 2 x.y_j), three float32 FMAs a pair (no
    TF32, no tensor cores, whatever the caller has set), ties to the
    lowest index. Its reference slices come from `knn_plan`;
  * CPU tensors: the plain version, blockwise over query rows as torch
    operations, with the products in full float32 (`fp32_matmul` turns
    TF32 off around them).

The two round differently; both stay within 8 u (|x| + |y|)^2 of the
exact d^2. `knn_self_distances` and `knn_indices` (set-up only, top-k)
are blockwise torch operations on either device.
"""
from __future__ import annotations

import contextlib
import ctypes
from typing import NamedTuple

import torch

from manus_tpu_torch.ops.conv import SM_COUNT
from manus_tpu_torch.utils import cuda_build


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
    never chosen, and a row with none to choose gets (inf, 0). Returns
    (dist [N] float32, idx [N] int32). CUDA tensors take the kernel (block
    is then unused), CPU tensors the plain blockwise version."""
    if pt1.is_cuda or pt2.is_cuda:
        return nearest_neighbor_cuda(
            pt1.contiguous(), pt2.contiguous(),
            None if pt2_valid is None else pt2_valid.contiguous())
    return nearest_neighbor_torch(pt1, pt2, block, pt2_valid)


def nearest_neighbor_torch(pt1: torch.Tensor, pt2: torch.Tensor,
                           block: int = 1024,
                           pt2_valid: torch.Tensor | None = None):
    """nearest_neighbor's plain version: |x|^2 + |y|^2 - 2 x.y^T over
    blocks of `block` query rows, a row minimum each."""
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


# ---------------------------------------------------------------------------
# The CUDA kernel (csrc/knn.cu) and its plan.

# The kernel's fixed shape (knn_config() in csrc/knn.cu; a test on the card
# holds the two equal): threads a CTA, queries a thread, references staged
# a step, CTAs an SM.
KNN_THREADS, KNN_QUERIES, KNN_TILE, KNN_CTAS_PER_SM = 256, 8, 256, 2
KNN_BLOCK_QUERIES = KNN_THREADS * KNN_QUERIES
# Fewest references a slice may hold: below it a CTA's tiles are too few
# to pay for the slice's share of the merge.
KNN_MIN_SLICE = 4 * KNN_TILE


class KnnPlan(NamedTuple):
    """How csrc/knn.cu runs one search: query_blocks CTAs of
    KNN_BLOCK_QUERIES queries each, times `slices` contiguous slices of
    slice_len references (the last may be shorter). More than one slice
    adds a merge of the slices' results."""
    query_blocks: int
    slices: int
    slice_len: int

    @property
    def ctas(self) -> int:
        return self.query_blocks * self.slices


def knn_plan(n: int, m: int, sm_count: int = SM_COUNT) -> KnnPlan:
    """The slices of a search of n queries against m references on a card
    of sm_count SMs: as many as keep the grid within the CTAs the card
    holds at once (KNN_CTAS_PER_SM an SM), so that it fills the card where
    the query blocks alone do not, and no more than leave each slice
    KNN_MIN_SLICE references. One slice where the query blocks fill the
    card (the voxel grid's ~2M cells) or the references are few."""
    if n < 1 or m < 1:
        raise ValueError(f"knn_plan needs points on both sides, got "
                         f"{n} x {m}")
    blocks = -(-n // KNN_BLOCK_QUERIES)
    slots = sm_count * KNN_CTAS_PER_SM
    slices = max(1, min(slots // blocks, m // KNN_MIN_SLICE))
    slice_len = -(-m // slices)
    return KnnPlan(blocks, -(-m // slice_len), slice_len)


_P, _I32 = ctypes.c_void_p, ctypes.c_int
LIBRARY = cuda_build.Kernels("knn", {
    "knn_nearest": ([_P, _I32, _P, _P, _I32, _I32, _I32, _P, _P, _P, _P,
                     _P], ctypes.c_int),
    "knn_config": ([_P], None),
    "knn_occupancy": ([_P], ctypes.c_int),
})


@cuda_build.counted
def nearest_neighbor_cuda(pt1: torch.Tensor, pt2: torch.Tensor,
                          pt2_valid: torch.Tensor | None = None,
                          plan: KnnPlan | None = None):
    """Launch the search kernel: pt1 [N, 3], pt2 [M, 3] float32 on one
    card, pt2_valid [M] bool or None -> (dist [N] float32, idx [N] int32),
    under `plan` (default: knn_plan's for the card). No host sync."""
    dev = pt1.device
    if not pt1.is_cuda:
        raise ValueError("the CUDA nearest neighbour needs CUDA tensors")
    n, m = pt1.shape[0], pt2.shape[0]
    cuda_build.check_tensor(pt1, "pt1", torch.float32, (n, 3), dev)
    cuda_build.check_tensor(pt2, "pt2", torch.float32, (m, 3), dev)
    if pt2_valid is not None:
        cuda_build.check_tensor(pt2_valid, "pt2_valid", torch.bool, (m,), dev)
    if m == 0:
        raise ValueError("nearest_neighbor needs at least one reference point")
    dist = torch.empty(n, dtype=torch.float32, device=dev)
    idx = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return dist, idx
    if plan is None:
        plan = knn_plan(n, m, torch.cuda.get_device_properties(
            dev).multi_processor_count)
    if plan.slices < 1 or not (plan.slices - 1) * plan.slice_len < m \
            <= plan.slices * plan.slice_len \
            or plan.query_blocks != -(-n // KNN_BLOCK_QUERIES):
        raise ValueError(f"{plan} does not cover {n} x {m} points")
    part_d = part_i = None
    if plan.slices > 1:
        part_d = torch.empty(plan.slices, n, dtype=torch.float32, device=dev)
        part_i = torch.empty(plan.slices, n, dtype=torch.int32, device=dev)
    ptr = cuda_build.ptr
    LIBRARY.launch(
        "knn_nearest", ptr(pt1), n, ptr(pt2), ptr(pt2_valid), m, plan.slices,
        plan.slice_len, ptr(part_d), ptr(part_i), ptr(dist), ptr(idx),
        device=dev, counter=nearest_neighbor_cuda)
    return dist, idx


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
