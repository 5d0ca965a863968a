"""Gaussian projection: world-space means + 3D covariances -> screen space.

The upstream-3DGS forward projection contract:

  * row-vector view/proj transforms (p_row @ M),
  * frustum cull at view-space z <= 0.2,
  * EWA 2D covariance J R Sigma R^T J^T with the 1.3*tanfov clamp on
    view-space x/z, y/z and the +0.3 screen-space dilation,
  * conic (inverse cov2d), 3-sigma radius from the max eigenvalue,
  * NDC -> pixel mapping ((v+1)*S - 1)/2, so pixel centres sit at
    integer coordinates.

Differentiable; radius, tile rect and visibility are detached (they only
steer binning).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from manus_tpu_torch.utils.camera import Camera

FRUSTUM_NEAR_Z = 0.2
COV2D_DILATION = 0.3
TILE = 16  # pixels per tile side


class ProjectedGaussians(NamedTuple):
    """Per-gaussian screen-space quantities, all [N, ...]."""

    means2d: torch.Tensor  # [N, 2] pixel coords
    conic: torch.Tensor  # [N, 3] inverse 2D covariance (a, b, c)
    depth: torch.Tensor  # [N] view-space z
    radius: torch.Tensor  # [N] int32 3-sigma pixel radius (0 => culled)
    tile_rect: torch.Tensor  # [N, 4] int32 (tx0, ty0, tx1, ty1), exclusive max
    visible: torch.Tensor  # [N] bool: touches >= 1 tile


def project_gaussians(
    means3d: torch.Tensor,
    cov3d: torch.Tensor,
    camera: Camera,
    active: torch.Tensor | None = None,
) -> ProjectedGaussians:
    """Project [N, 3] means and [N, 6] upper-tri covariances; `active`
    masks out padded slots."""
    w, h = camera.width, camera.height
    tanfovx, tanfovy = camera.tanfovx, camera.tanfovy
    focal_x = w / (2.0 * tanfovx)
    focal_y = h / (2.0 * tanfovy)

    x, y, z = means3d[:, 0], means3d[:, 1], means3d[:, 2]
    WV = camera.world_view_transform
    FP = camera.full_proj_transform

    def row_xform(M, j):
        return x * M[0, j] + y * M[1, j] + z * M[2, j] + M[3, j]

    pv_x, pv_y, pv_z = (row_xform(WV, j) for j in range(3))
    ph = [row_xform(FP, j) for j in range(4)]
    p_w = 1.0 / (ph[3] + 1e-7)
    p_proj_x, p_proj_y = ph[0] * p_w, ph[1] * p_w

    in_frustum = pv_z > FRUSTUM_NEAR_Z
    depth = pv_z
    depth_safe = torch.where(in_frustum, depth, torch.ones_like(depth))

    lim_x, lim_y = 1.3 * tanfovx, 1.3 * tanfovy
    txtz = torch.clamp(pv_x / depth_safe, -lim_x, lim_x)
    tytz = torch.clamp(pv_y / depth_safe, -lim_y, lim_y)
    tx = txtz * depth_safe
    ty = tytz * depth_safe
    inv_tz = 1.0 / depth_safe
    inv_tz2 = inv_tz * inv_tz

    # J rows: (fx/tz, 0, -fx*tx/tz^2), (0, fy/tz, -fy*ty/tz^2); R is the
    # world->camera rotation; a = J[0] R, b = J[1] R.
    R = camera.extr[:3, :3]
    j00 = focal_x * inv_tz
    j02 = -focal_x * tx * inv_tz2
    j11 = focal_y * inv_tz
    j12 = -focal_y * ty * inv_tz2
    a0 = j00 * R[0, 0] + j02 * R[2, 0]
    a1 = j00 * R[0, 1] + j02 * R[2, 1]
    a2 = j00 * R[0, 2] + j02 * R[2, 2]
    b0 = j11 * R[1, 0] + j12 * R[2, 0]
    b1 = j11 * R[1, 1] + j12 * R[2, 1]
    b2 = j11 * R[1, 2] + j12 * R[2, 2]
    sxx, sxy, sxz, syy, syz, szz = cov3d.unbind(-1)
    u0 = a0 * sxx + a1 * sxy + a2 * sxz
    u1 = a0 * sxy + a1 * syy + a2 * syz
    u2 = a0 * sxz + a1 * syz + a2 * szz
    v0 = b0 * sxx + b1 * sxy + b2 * sxz
    v1 = b0 * sxy + b1 * syy + b2 * syz
    v2 = b0 * sxz + b1 * syz + b2 * szz
    cxx = u0 * a0 + u1 * a1 + u2 * a2 + COV2D_DILATION
    cxy = u0 * b0 + u1 * b1 + u2 * b2
    cyy = v0 * b0 + v1 * b1 + v2 * b2 + COV2D_DILATION

    det = cxx * cyy - cxy * cxy
    det_ok = det != 0.0
    inv_det = 1.0 / torch.where(det_ok, det, torch.ones_like(det))
    conic = torch.stack([cyy * inv_det, -cxy * inv_det, cxx * inv_det], dim=-1)

    mid = 0.5 * (cxx + cyy)
    lambda1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius_f = torch.ceil(3.0 * torch.sqrt(torch.clamp(lambda1, min=0.0)))
    means2d = torch.stack(
        [((p_proj_x + 1.0) * w - 1.0) * 0.5, ((p_proj_y + 1.0) * h - 1.0) * 0.5],
        dim=-1,
    )

    valid = in_frustum & det_ok
    if active is not None:
        valid = valid & active

    # Tile AABB clamped to the grid; a gaussian touching no tile is culled.
    grid_x = (w + TILE - 1) // TILE
    grid_y = (h + TILE - 1) // TILE
    m2d = means2d.detach()
    r = radius_f.detach()

    def tile_index(v, limit):
        return torch.clamp(v.to(torch.int32), 0, limit)

    tx0 = tile_index((m2d[:, 0] - r) / TILE, grid_x)
    ty0 = tile_index((m2d[:, 1] - r) / TILE, grid_y)
    tx1 = tile_index((m2d[:, 0] + r + TILE - 1) / TILE, grid_x)
    ty1 = tile_index((m2d[:, 1] + r + TILE - 1) / TILE, grid_y)
    visible = valid & ((tx1 - tx0) * (ty1 - ty0) > 0)
    radius = torch.where(visible, r, torch.zeros_like(r)).to(torch.int32)
    tile_rect = torch.stack([tx0, ty0, tx1, ty1], dim=-1)

    # Culled slots park at benign constants: a near-zero clip-space w gives
    # inf means2d, and 0 * inf = nan would poison the backward.
    vis = visible[:, None]
    means2d = torch.where(vis, means2d, torch.zeros_like(means2d))
    conic = torch.where(vis, conic, conic.new_tensor([1.0, 0.0, 1.0]))

    return ProjectedGaussians(
        means2d=means2d,
        conic=conic,
        depth=depth,
        radius=radius,
        tile_rect=tile_rect,
        visible=visible,
    )
