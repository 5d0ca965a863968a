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

On a card, render_gaussians takes `project_gaussians_cuda` instead: the
kernels of csrc/project.cu compute this projection and the SH colours
(api.calculate_colors_from_sh) in one launch forward and one backward,
under an autograd Function, where the plain pair is ~260-320 torch
operations a view and ~360 more in autograd's backward. The plain pair
stays the CPU's path and the one the kernels are held to.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from manus_tpu_torch.utils import cuda_build, trace
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


# ---------------------------------------------------------------------------
# The CUDA kernels (csrc/project.cu).

# The most SH coefficients a row the kernels take (degree 4; kMaxCoeffs in
# csrc/project.cu).
PROJECT_MAX_COEFFS = 25

_P, _I32 = ctypes.c_void_p, ctypes.c_int
# n, k, deg, width, height; means, cov, cano, feat, tf, active; the
# camera's six tensors
_INPUTS = [_I32] * 5 + [_P] * 6 + [_P] * 6
LIBRARY = cuda_build.Kernels("project", {
    # ... means2d, conic, depth, radius, rect, visible, colors; stream
    "project_forward": (_INPUTS + [_P] * 7 + [_P], ctypes.c_int),
    # ... g_means2d, g_conic, g_colors; d_means, d_cov, d_cano, d_feat,
    # d_tf; stream
    "project_backward": (_INPUTS + [_P] * 3 + [_P] * 5 + [_P],
                         ctypes.c_int),
})


def camera_tensors(camera: Camera, dev) -> tuple:
    """The six camera tensors the kernels read (world_view_transform,
    full_proj_transform, extr, camera_center, fovx, fovy), contiguous
    float32 on `dev`; the host reads none of them back."""
    fields = (("world_view_transform", (4, 4)), ("full_proj_transform",
              (4, 4)), ("extr", (4, 4)), ("camera_center", (3,)),
              ("fovx", ()), ("fovy", ()))
    out = []
    for name, shape in fields:
        t = getattr(camera, name).contiguous()
        cuda_build.check_tensor(t, f"camera.{name}", torch.float32, shape,
                                dev)
        out.append(t)
    return tuple(out)


def _project_inputs(means, cov, cam, active, cano, feat, tf, sh_degree):
    """The kernels' inputs as csrc/project.cu takes them, or ValueError.
    Returns (n, coefficients a row)."""
    dev = means.device
    if not means.is_cuda:
        raise ValueError("the CUDA projection needs CUDA tensors")
    n = means.shape[0]
    check = cuda_build.check_tensor
    check(means, "means", torch.float32, (n, 3), dev)
    check(cov, "cov", torch.float32, (n, 6), dev)
    if active is not None:
        check(active, "active", torch.bool, (n,), dev)
    if (cano is None) != (tf is None):
        raise ValueError("cano and tf go together (an articulated model's "
                         "SH directions)")
    if tf is not None:
        check(cano, "cano", torch.float32, (n, 3), dev)
        check(tf, "tf", torch.float32, (n, 4, 4), dev)
    if sh_degree < 0:
        if feat is not None:
            raise ValueError("features without an SH degree")
        return n, 0
    if not 0 <= sh_degree <= 4:
        raise ValueError(f"SH degree must be 0..4, got {sh_degree}")
    if feat is None or feat.dim() != 3:
        raise ValueError("SH colours need [N, K, 3] features")
    k = feat.shape[1]
    if k < (sh_degree + 1) ** 2:
        raise ValueError(f"{k} SH coefficients < {(sh_degree + 1) ** 2} "
                         f"for degree {sh_degree}")
    if k > PROJECT_MAX_COEFFS:
        raise ValueError(f"the CUDA projection takes at most "
                         f"{PROJECT_MAX_COEFFS} SH coefficients a row, got "
                         f"{k}")
    check(feat, "features", torch.float32, (n, k, 3), dev)
    return n, k


@cuda_build.counted
def project_fwd_cuda(means, cov, cam, width: int, height: int, active=None,
                     cano=None, feat=None, tf=None, sh_degree: int = -1):
    """Launch the forward kernel: `means` [N, 3] and `cov` [N, 6] posed,
    under the camera `cam` (camera_tensors) at width x height; with
    sh_degree >= 0 also the SH colours of `feat` [N, K, 3], from the
    camera centre or, with `tf` [N, 4, 4], from it pulled back through
    inv(tf) against `cano` [N, 3]. Returns (means2d, conic, depth,
    radius, tile_rect, visible, colors or None), as project_gaussians and
    calculate_colors_from_sh give them. No host sync."""
    n, k = _project_inputs(means, cov, cam, active, cano, feat, tf, sh_degree)
    dev = means.device
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    means2d = torch.empty(n, 2, **f32)
    conic = torch.empty(n, 3, **f32)
    depth = torch.empty(n, **f32)
    radius = torch.empty(n, **i32)
    rect = torch.empty(n, 4, **i32)
    visible = torch.empty(n, dtype=torch.bool, device=dev)
    colors = torch.empty(n, 3, **f32) if sh_degree >= 0 else None
    if n:
        LIBRARY.launch(
            "project_forward", n, k, sh_degree, width, height,
            *map(cuda_build.ptr, (means, cov, cano, feat, tf, active, *cam,
                                  means2d, conic, depth, radius, rect,
                                  visible, colors)),
            device=dev, counter=project_fwd_cuda)
    return means2d, conic, depth, radius, rect, visible, colors


@cuda_build.counted
def project_bwd_cuda(means, cov, cam, width: int, height: int, active, cano,
                     feat, tf, sh_degree: int, g_means2d, g_conic, g_colors,
                     need=(True,) * 5):
    """Launch the backward kernel on project_fwd_cuda's inputs and the
    gradients of means2d [N, 2], conic [N, 3] and colors [N, 3] (None for
    zero). Returns the gradients of (means, cov, cano, feat, tf), each
    None where `need` says so or the input is None. No host sync."""
    n, k = _project_inputs(means, cov, cam, active, cano, feat, tf, sh_degree)
    dev = means.device
    grads = []
    for g, name, width_ in ((g_means2d, "g_means2d", 2),
                            (g_conic, "g_conic", 3),
                            (g_colors, "g_colors", 3)):
        if g is not None:
            g = g.contiguous()
            cuda_build.check_tensor(g, name, torch.float32, (n, width_), dev)
        grads.append(g)
    if sh_degree < 0:
        grads[2] = None
    outs = [torch.empty_like(x) if x is not None and want else None
            for x, want in zip((means, cov, cano, feat, tf), need)]
    if n and any(o is not None for o in outs):
        LIBRARY.launch(
            "project_backward", n, k, sh_degree, width, height,
            *map(cuda_build.ptr, (means, cov, cano, feat, tf, active, *cam,
                                  *grads, *outs)),
            device=dev, counter=project_bwd_cuda)
    return tuple(outs)


class _Project(torch.autograd.Function):
    """project_fwd_cuda with project_bwd_cuda as its backward; depth,
    radius, tile_rect and visible carry no gradient. Each backward launch
    counts the rows it covers as `raster.grad_rows` (utils/trace.py)."""

    @staticmethod
    def forward(ctx, means, cov, cano, feat, tf, active, cam, size,
                sh_degree):
        ctx.set_materialize_grads(False)
        out = project_fwd_cuda(means, cov, cam, *size, active, cano, feat,
                               tf, sh_degree)
        ctx.save_for_backward(means, cov, cano, feat, tf, active)
        ctx.cam, ctx.size, ctx.sh_degree = cam, size, sh_degree
        ctx.mark_non_differentiable(*out[2:6])
        return out

    @staticmethod
    def backward(ctx, g_means2d, g_conic, g_depth, g_radius, g_rect,
                 g_visible, g_colors):
        del g_depth, g_radius, g_rect, g_visible
        need = ctx.needs_input_grad[:5]
        if not any(need):
            return (None,) * 9
        means, cov, cano, feat, tf, active = ctx.saved_tensors
        trace.count("raster.grad_rows", means.shape[0])
        grads = project_bwd_cuda(means, cov, ctx.cam, *ctx.size, active,
                                 cano, feat, tf, ctx.sh_degree, g_means2d,
                                 g_conic, g_colors, need)
        return (*grads, None, None, None, None)


def project_gaussians_cuda(
    means3d: torch.Tensor,
    cov3d: torch.Tensor,
    camera: Camera,
    active: torch.Tensor | None = None,
    cano_means: torch.Tensor | None = None,
    features: torch.Tensor | None = None,
    sh_degree: int = -1,
    tf: torch.Tensor | None = None,
):
    """project_gaussians and, with features and sh_degree >= 0,
    api.calculate_colors_from_sh (cano_means is read only with tf) in the
    kernels of csrc/project.cu, differentiable. Returns
    (ProjectedGaussians, colors [N, 3] or None). CUDA tensors only: a call
    the kernels cannot take raises."""
    dev = means3d.device
    cam = camera_tensors(camera, dev)
    cano = cano_means.contiguous() if tf is not None else None
    feat = features.contiguous() if sh_degree >= 0 else None
    out = _Project.apply(
        means3d.contiguous(), cov3d.contiguous(), cano, feat,
        None if tf is None else tf.contiguous(),
        None if active is None else active.contiguous(), cam,
        (camera.width, camera.height), sh_degree)
    return ProjectedGaussians(*out[:6]), out[6]
