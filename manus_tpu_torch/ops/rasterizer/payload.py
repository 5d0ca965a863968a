"""Pair payload for the composite: a field-major [16, P] float32 tensor.

One column per (gaussian, tile) pair in binned order, the 9 live fields in
the first rows (order below) and zero padding to 16; invalid pairs get
all-zero columns (opacity 0 composites as a no-op). The backward of the
gather is autograd's index_add_, one pass over the pairs.
"""
from __future__ import annotations

import torch

from manus_tpu_torch.ops.rasterizer.binning import TileBins
from manus_tpu_torch.ops.rasterizer.projection import ProjectedGaussians

# Field order (rows of the payload matrix); the CUDA kernels read the same.
F_MEAN_X, F_MEAN_Y = 0, 1
F_CONIC_A, F_CONIC_B, F_CONIC_C = 2, 3, 4
F_OPACITY = 5
F_R, F_G, F_B = 6, 7, 8
NUM_LIVE = 9
NUM_FIELDS = 16


def build_payload(
    proj: ProjectedGaussians,
    colors: torch.Tensor,  # [N, 3]
    opacity: torch.Tensor,  # [N]
    bins: TileBins,
) -> torch.Tensor:
    """Gather per-gaussian fields into the pair layout [16, P]."""
    n = proj.means2d.shape[0]
    src = bins.pair_src.long()
    fields = torch.cat(
        [
            proj.means2d,
            proj.conic,
            opacity[:, None],
            colors,
            proj.means2d.new_zeros(n, NUM_FIELDS - NUM_LIVE),
        ],
        dim=1,
    )  # [N, 16]
    # index_select, not fields[src]: its backward is index_add_, where
    # advanced indexing's is a sort-based index_put_ (accumulate=True)
    rows = torch.index_select(fields, 0, src.clamp(min=0)) * (src >= 0)[:, None]
    return rows.T.contiguous()
