"""The gaussians' deformation stage on the card: the kernels of
csrc/deform.cu and the autograd Functions around them.

Three plain-chain functions take these for CUDA tensors, and keep their
plain version for CPU tensors:

  * utils/transforms.py `covariance_from_scaling_rotation`:
    `covariance_cuda` (covariance_fwd_cuda / covariance_bwd_cuda);
  * ops/skinning.py `skin_gaussians`: `skin_cuda` (skin_fwd_cuda /
    skin_bwd_cuda);
  * ops/grid_sample.py `skinning_weights_from_voxel_grid`:
    `skin_sample_cuda` (skin_sample_fwd_cuda / skin_sample_bwd_cuda).

Each kernel is one launch a call, counted on its wrapper. The forwards
round every operation as the plain chain does; the backwards are the
closed-form vector-Jacobian products recomputed from the inputs. Nothing
here differentiates the bone transforms, the grid or its placement: the
wrappers raise where one of them requires a gradient.
"""
from __future__ import annotations

import ctypes

import torch

from manus_tpu_torch.utils import cuda_build

# The most bones a skinned row, and channels a grid (kMaxChannels in
# csrc/deform.cu): the CTA's staged rows and the transforms fit in shared
# memory, and a warp holds a sampled row in two channels a lane.
DEFORM_MAX_CHANNELS = 64

_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
LIBRARY = cuda_build.Kernels("deform", {
    # n, scaling, row and column strides, rotation, modifier; cov; stream
    "covariance_forward": ([_I32, _P, _I64, _I64, _P, ctypes.c_float, _P,
                            _P], ctypes.c_int),
    # ...; g_cov, g_scaling, g_rotation; stream
    "covariance_backward": ([_I32, _P, _I64, _I64, _P, ctypes.c_float, _P,
                             _P, _P, _P], ctypes.c_int),
    # n, b, xyz, cov, w, transforms; posed xyz, posed cov, tf; stream
    "skin_forward": ([_I32, _I32] + [_P] * 4 + [_P] * 3 + [_P],
                     ctypes.c_int),
    # ...; g posed xyz, g posed cov, g tf; d xyz, d cov, d w; stream
    "skin_backward": ([_I32, _I32] + [_P] * 4 + [_P] * 6 + [_P],
                      ctypes.c_int),
    # n, d, h, w, c, xyz, center, scale, grid; weights; stream
    "skin_sample_forward": ([_I32] * 5 + [_P] * 4 + [_P, _P], ctypes.c_int),
    # ...; g weights, d xyz; stream
    "skin_sample_backward": ([_I32] * 5 + [_P] * 4 + [_P, _P, _P],
                             ctypes.c_int),
})

_check = cuda_build.check_tensor


def _on_card(x: torch.Tensor):
    if not x.is_cuda:
        raise ValueError("the CUDA deformation kernels need CUDA tensors, "
                         f"got one on {x.device}")
    return x.device


def _rows(x, name: str, width: int, dev, n=None):
    """x is a contiguous float32 [n, width] tensor on dev; returns n."""
    if x.dim() != 2:
        raise ValueError(f"{name} must be [N, {width}], got "
                         f"{tuple(x.shape)}")
    n = x.shape[0] if n is None else n
    _check(x, name, torch.float32, (n, width), dev)
    return n


def _grads(grads, names, widths, n, dev):
    """Each incoming gradient contiguous and checked, or None."""
    out = []
    for g, name, width in zip(grads, names, widths):
        if g is not None:
            g = g.contiguous()
            _check(g, name, torch.float32, (n, *width), dev)
        out.append(g)
    return out


# ---------------------------------------------------------------------------
# Covariance.

def _covariance_inputs(scaling, rotation):
    """(n, device); scaling [N, 3] float32 at any strides (an isotropic
    model's expanded column has stride 0), rotation contiguous [N, 4]."""
    dev = _on_card(scaling)
    n = _rows(rotation, "rotation", 4, dev)
    if scaling.dtype != torch.float32 or scaling.shape != (n, 3) \
            or scaling.device != dev:
        raise ValueError(f"scaling must be a float32 ({n}, 3) tensor on "
                         f"{dev}, got {scaling.dtype} "
                         f"{tuple(scaling.shape)} on {scaling.device}")
    return n, dev


@cuda_build.counted
def covariance_fwd_cuda(scaling, rotation, scaling_modifier: float = 1.0):
    """Launch the forward kernel: Sigma [N, 6] (upper triangle) of scaling
    [N, 3] times scaling_modifier and the unnormalised wxyz rotation
    [N, 4]. No host sync."""
    n, dev = _covariance_inputs(scaling, rotation)
    cov = torch.empty(n, 6, dtype=torch.float32, device=dev)
    if n:
        LIBRARY.launch("covariance_forward", n, scaling.data_ptr(),
                       *scaling.stride(), rotation.data_ptr(),
                       float(scaling_modifier), cov.data_ptr(), device=dev,
                       counter=covariance_fwd_cuda)
    return cov


@cuda_build.counted
def covariance_bwd_cuda(scaling, rotation, scaling_modifier, g_cov,
                        need=(True, True)):
    """Launch the backward kernel on covariance_fwd_cuda's inputs and
    Sigma's gradient [N, 6]: (g_scaling [N, 3] contiguous, g_rotation
    [N, 4]), each None where `need` says so. No host sync."""
    n, dev = _covariance_inputs(scaling, rotation)
    g_cov = g_cov.contiguous()
    _check(g_cov, "g_cov", torch.float32, (n, 6), dev)
    outs = [torch.empty(n, w, dtype=torch.float32, device=dev) if want
            else None for w, want in zip((3, 4), need)]
    if n and any(o is not None for o in outs):
        LIBRARY.launch("covariance_backward", n, scaling.data_ptr(),
                       *scaling.stride(), rotation.data_ptr(),
                       float(scaling_modifier), g_cov.data_ptr(),
                       *map(cuda_build.ptr, outs), device=dev,
                       counter=covariance_bwd_cuda)
    return tuple(outs)


class _Covariance(torch.autograd.Function):
    """covariance_fwd_cuda with covariance_bwd_cuda as its backward."""

    @staticmethod
    def forward(ctx, scaling, rotation, scaling_modifier):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(scaling, rotation)
        ctx.scaling_modifier = scaling_modifier
        return covariance_fwd_cuda(scaling, rotation, scaling_modifier)

    @staticmethod
    def backward(ctx, g_cov):
        need = ctx.needs_input_grad[:2]
        if g_cov is None or not any(need):
            return None, None, None
        scaling, rotation = ctx.saved_tensors
        g_s, g_r = covariance_bwd_cuda(scaling, rotation,
                                       ctx.scaling_modifier, g_cov, need)
        return g_s, g_r, None


def covariance_cuda(scaling, rotation, scaling_modifier: float = 1.0):
    """covariance_from_scaling_rotation in the kernels, differentiable in
    scaling and rotation. CUDA float32 tensors only."""
    rotation = rotation.contiguous()
    if torch.is_grad_enabled() and (scaling.requires_grad
                                    or rotation.requires_grad):
        return _Covariance.apply(scaling, rotation, float(scaling_modifier))
    return covariance_fwd_cuda(scaling, rotation, scaling_modifier)


# ---------------------------------------------------------------------------
# Skinning.

def _skin_inputs(xyz, cov, skin_weights, transforms):
    """(n, b, device) of contiguous float32 xyz [N, 3], cov [N, 6], skin
    weights [N, B] and transforms [B, 4, 4], B <= DEFORM_MAX_CHANNELS."""
    dev = _on_card(xyz)
    n = _rows(xyz, "cano_xyz", 3, dev)
    _rows(cov, "cano_cov", 6, dev, n)
    if transforms.dim() != 3:
        raise ValueError(f"transforms must be [B, 4, 4], got "
                         f"{tuple(transforms.shape)}")
    b = transforms.shape[0]
    if not 1 <= b <= DEFORM_MAX_CHANNELS:
        raise ValueError(f"the CUDA skinning takes 1 to "
                         f"{DEFORM_MAX_CHANNELS} bones, got {b}")
    _check(transforms, "transforms", torch.float32, (b, 4, 4), dev)
    _rows(skin_weights, "skin_weights", b, dev, n)
    return n, b, dev


@cuda_build.counted
def skin_fwd_cuda(cano_xyz, cano_cov, skin_weights, transforms):
    """Launch the forward kernel: (posed xyz [N, 3], posed cov [N, 6], the
    blended transforms tf [N, 4, 4]) as skin_gaussians gives them. No host
    sync."""
    n, b, dev = _skin_inputs(cano_xyz, cano_cov, skin_weights, transforms)
    f32 = dict(dtype=torch.float32, device=dev)
    out = (torch.empty(n, 3, **f32), torch.empty(n, 6, **f32),
           torch.empty(n, 4, 4, **f32))
    if n:
        LIBRARY.launch("skin_forward", n, b, *map(cuda_build.ptr, (
            cano_xyz, cano_cov, skin_weights, transforms, *out)),
            device=dev, counter=skin_fwd_cuda)
    return out


@cuda_build.counted
def skin_bwd_cuda(cano_xyz, cano_cov, skin_weights, transforms, g_xyz,
                  g_cov, g_tf, need=(True, True, True)):
    """Launch the backward kernel on skin_fwd_cuda's inputs and the
    gradients of posed xyz [N, 3], posed cov [N, 6] and tf [N, 4, 4]
    (None for zero). Returns the gradients of (cano_xyz, cano_cov,
    skin_weights), each None where `need` says so. No host sync."""
    n, b, dev = _skin_inputs(cano_xyz, cano_cov, skin_weights, transforms)
    grads = _grads([g_xyz, g_cov, g_tf], ["g_xyz", "g_cov", "g_tf"],
                   [(3,), (6,), (4, 4)], n, dev)
    outs = [torch.empty_like(x) if want else None
            for x, want in zip((cano_xyz, cano_cov, skin_weights), need)]
    if n and any(o is not None for o in outs):
        LIBRARY.launch("skin_backward", n, b, *map(cuda_build.ptr, (
            cano_xyz, cano_cov, skin_weights, transforms, *grads, *outs)),
            device=dev, counter=skin_bwd_cuda)
    return tuple(outs)


class _Skin(torch.autograd.Function):
    """skin_fwd_cuda with skin_bwd_cuda as its backward; tf carries a
    gradient only where the skin weights take one."""

    @staticmethod
    def forward(ctx, cano_xyz, cano_cov, skin_weights, transforms):
        ctx.set_materialize_grads(False)
        out = skin_fwd_cuda(cano_xyz, cano_cov, skin_weights, transforms)
        ctx.save_for_backward(cano_xyz, cano_cov, skin_weights, transforms)
        if not ctx.needs_input_grad[2]:
            ctx.mark_non_differentiable(out[2])
        return out

    @staticmethod
    def backward(ctx, g_xyz, g_cov, g_tf):
        need = ctx.needs_input_grad[:3]
        if not any(need) or (g_xyz is None and g_cov is None
                             and g_tf is None):
            return None, None, None, None
        grads = skin_bwd_cuda(*ctx.saved_tensors, g_xyz, g_cov, g_tf, need)
        return (*grads, None)


def skin_cuda(cano_xyz, cano_cov, skin_weights, transforms):
    """skin_gaussians in the kernels: (posed xyz, posed cov, tf),
    differentiable in the first three. CUDA float32 tensors only; the
    transforms may not require a gradient."""
    if transforms.requires_grad:
        raise ValueError("the CUDA skinning takes no gradient to the bone "
                         "transforms")
    args = tuple(x.contiguous() for x in (cano_xyz, cano_cov, skin_weights,
                                          transforms))
    if torch.is_grad_enabled() and any(x.requires_grad for x in args[:3]):
        return _Skin.apply(*args)
    return skin_fwd_cuda(*args)


# ---------------------------------------------------------------------------
# The voxel grid's skin weights.

def _sample_inputs(xyz, center, scale, grid):
    """(n, (d, h, w, c), device) of contiguous float32 xyz [N, 3], center
    [3], scale [3] and grid [D, H, W, C], C <= DEFORM_MAX_CHANNELS."""
    dev = _on_card(xyz)
    n = _rows(xyz, "xyz", 3, dev)
    _check(center, "grid_center", torch.float32, (3,), dev)
    _check(scale, "grid_scale", torch.float32, (3,), dev)
    if grid.dim() != 4:
        raise ValueError(f"the grid must be [D, H, W, C], got "
                         f"{tuple(grid.shape)}")
    if not 1 <= grid.shape[3] <= DEFORM_MAX_CHANNELS:
        raise ValueError(f"the CUDA grid sample takes 1 to "
                         f"{DEFORM_MAX_CHANNELS} channels, got "
                         f"{grid.shape[3]}")
    _check(grid, "grid_weights", torch.float32, tuple(grid.shape), dev)
    return n, tuple(grid.shape), dev


@cuda_build.counted
def skin_sample_fwd_cuda(xyz, grid_center, grid_scale, grid_weights):
    """Launch the forward kernel: the skin weights [N, C] of xyz [N, 3] as
    skinning_weights_from_voxel_grid gives them. No host sync."""
    n, (d, h, w, c), dev = _sample_inputs(xyz, grid_center, grid_scale,
                                          grid_weights)
    out = torch.empty(n, c, dtype=torch.float32, device=dev)
    if n:
        LIBRARY.launch("skin_sample_forward", n, d, h, w, c,
                       *map(cuda_build.ptr, (xyz, grid_center, grid_scale,
                                             grid_weights, out)),
                       device=dev, counter=skin_sample_fwd_cuda)
    return out


@cuda_build.counted
def skin_sample_bwd_cuda(xyz, grid_center, grid_scale, grid_weights,
                         g_weights):
    """Launch the backward kernel: xyz's gradient [N, 3] from the
    weights' g_weights [N, C]. No host sync."""
    n, (d, h, w, c), dev = _sample_inputs(xyz, grid_center, grid_scale,
                                          grid_weights)
    g_weights, = _grads([g_weights], ["g_weights"], [(c,)], n, dev)
    d_xyz = torch.empty(n, 3, dtype=torch.float32, device=dev)
    if n:
        LIBRARY.launch("skin_sample_backward", n, d, h, w, c,
                       *map(cuda_build.ptr, (xyz, grid_center, grid_scale,
                                             grid_weights, g_weights,
                                             d_xyz)),
                       device=dev, counter=skin_sample_bwd_cuda)
    return d_xyz


class _SkinSample(torch.autograd.Function):
    """skin_sample_fwd_cuda with skin_sample_bwd_cuda as its backward, to
    the positions alone."""

    @staticmethod
    def forward(ctx, xyz, grid_center, grid_scale, grid_weights):
        ctx.save_for_backward(xyz, grid_center, grid_scale, grid_weights)
        return skin_sample_fwd_cuda(xyz, grid_center, grid_scale,
                                    grid_weights)

    @staticmethod
    def backward(ctx, g_weights):
        return (skin_sample_bwd_cuda(*ctx.saved_tensors, g_weights),
                None, None, None)


def skin_sample_cuda(xyz, grid_center, grid_scale, grid_weights):
    """skinning_weights_from_voxel_grid in the kernels, differentiable in
    xyz. CUDA float32 tensors only; the grid, its centre and its scale may
    not require a gradient."""
    if any(t.requires_grad for t in (grid_center, grid_scale, grid_weights)):
        raise ValueError("the CUDA grid sample takes no gradient to the "
                         "grid or its placement")
    args = (xyz.contiguous(), grid_center.reshape(3).contiguous(),
            grid_scale.reshape(3).contiguous(), grid_weights.contiguous())
    if torch.is_grad_enabled() and xyz.requires_grad:
        return _SkinSample.apply(*args)
    return skin_sample_fwd_cuda(*args)
