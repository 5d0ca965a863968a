"""Image losses and metrics: L1, L2, windowed SSIM, PSNR, isotropy term,
and the VGG16-LPIPS term (train/lpips.py).

Reference numerics (Gaussian 11x11 window, sigma 1.5, C1=0.01^2,
C2=0.03^2, zero padding). Images are [H, W, C].

`ssim` has two paths:

  * CUDA tensors: the kernel pair of csrc/ssim.cu (`ssim_cuda`), the
    11-tap windows staged in shared memory, one launch forward and one
    backward under an autograd Function; [H, W, 3] float32 only;
  * CPU tensors: the plain version (`ssim_torch`), the blurs as products
    with dense banded matrices, as the JAX package computes them.

`ssim_partials` and `ssim_grad` are the kernels' math in plain torch over
the banded blur: the three partial maps the forward keeps and the closed
form the backward evaluates.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from manus_tpu_torch.train import lpips
from manus_tpu_torch.utils import cuda_build

C1, C2 = 0.01**2, 0.03**2
# The window the kernels take (kTaps in csrc/ssim.cu).
SSIM_WINDOW = 11


def l1_loss(pred, gt, mean: bool = True):
    loss = (pred - gt).abs()
    return loss.mean() if mean else loss


def l2_loss(pred, gt, mean: bool = True):
    loss = (pred - gt) ** 2
    return loss.mean() if mean else loss


def psnr(pred, gt):
    """-10 log10(MSE)."""
    return -10.0 * torch.log10(((pred - gt) ** 2).mean())


@functools.lru_cache(maxsize=16)
def _gaussian_taps(window_size: int, sigma: float) -> np.ndarray:
    """[window_size] float32: the normalised 1D Gaussian."""
    g = np.exp(
        -((np.arange(window_size) - window_size // 2) ** 2) / (2 * sigma**2)
    )
    return (g / g.sum()).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _banded_blur_matrix(size: int, window_size: int, sigma: float) -> np.ndarray:
    """[size, size] banded Toeplitz matrix of the normalised 1D Gaussian
    with zero padding (rows near the border see fewer taps)."""
    g = _gaussian_taps(window_size, sigma)
    half = window_size // 2
    m = np.zeros((size, size), np.float32)
    for off in range(-half, half + 1):
        m += np.diag(np.full(size - abs(off), g[off + half], np.float32), k=off)
    return m


def _depthwise_blur(img, window_size: int, sigma: float):
    """Per-channel separable Gaussian blur of [H, W, C] with zero padding."""
    h, w, _ = img.shape
    bw = torch.as_tensor(_banded_blur_matrix(w, window_size, sigma),
                         device=img.device)
    bh = torch.as_tensor(_banded_blur_matrix(h, window_size, sigma),
                         device=img.device)
    out = torch.einsum("hwc,wv->hvc", img, bw)
    return torch.einsum("hwc,hu->uwc", out, bh)


def ssim(img1, img2, window_size: int = 11, sigma: float = 1.5):
    """Mean SSIM over [H, W, C] images in [0, 1]. CUDA tensors take the
    kernel pair (`ssim_cuda`: no gradient to img2), CPU tensors the plain
    version (`ssim_torch`)."""
    if img1.is_cuda or img2.is_cuda:
        return ssim_cuda(img1.contiguous(), img2.contiguous(), window_size,
                         sigma)
    return ssim_torch(img1, img2, window_size, sigma)


def _ssim_terms(img1, img2, window_size: int, sigma: float):
    """(SSIM map, mu1, mu2, A1, A2, B1, B2) over the banded blur; the map
    is A1 A2 / (B1 B2)."""
    mu1 = _depthwise_blur(img1, window_size, sigma)
    mu2 = _depthwise_blur(img2, window_size, sigma)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _depthwise_blur(img1 * img1, window_size, sigma) - mu1_sq
    sigma2_sq = _depthwise_blur(img2 * img2, window_size, sigma) - mu2_sq
    sigma12 = _depthwise_blur(img1 * img2, window_size, sigma) - mu1_mu2
    a1, a2 = 2 * mu1_mu2 + C1, 2 * sigma12 + C2
    b1, b2 = mu1_sq + mu2_sq + C1, sigma1_sq + sigma2_sq + C2
    return (a1 * a2) / (b1 * b2), mu1, mu2, a1, a2, b1, b2


def ssim_torch(img1, img2, window_size: int = 11, sigma: float = 1.5):
    """ssim's plain version: the blurs as banded matrix products."""
    return _ssim_terms(img1, img2, window_size, sigma)[0].mean()


def ssim_partials(img1, img2, window_size: int = 11, sigma: float = 1.5):
    """csrc/ssim.cu's forward in plain torch: (mean SSIM, [3, H, W, C] the
    partial maps p1, p2, p3 of the SSIM map s). p2 = ds/dsigma1^2, p3 =
    ds/dsigma12, p1 = ds/dmu1 with the sigma terms folded in."""
    s, mu1, mu2, a1, a2, b1, b2 = _ssim_terms(img1, img2, window_size, sigma)
    den = b1 * b2
    p2 = -s / b2
    p3 = 2 * a1 / den
    d_mu1 = 2 * mu2 * a2 / den - 2 * mu1 * s / b1
    p1 = d_mu1 - 2 * mu1 * p2 - mu2 * p3
    return s.mean(), torch.stack([p1, p2, p3])


def ssim_grad(partials, img1, img2, grad, window_size: int = 11,
              sigma: float = 1.5):
    """csrc/ssim.cu's backward in plain torch: d(mean SSIM)/d img1 times
    the incoming gradient `grad`, g / N [G*p1 + 2 x G*p2 + y G*p3]. The
    window is symmetric, so the blur is its own adjoint."""
    b1, b2, b3 = (_depthwise_blur(p, window_size, sigma) for p in partials)
    return grad / img1.numel() * (b1 + 2 * img1 * b2 + img2 * b3)


# ---------------------------------------------------------------------------
# The CUDA kernels (csrc/ssim.cu).

_P, _I32 = ctypes.c_void_p, ctypes.c_int
LIBRARY = cuda_build.Kernels("ssim", {
    # x, y, h, w, taps (host), part, block_sums, out; stream
    "ssim_forward": ([_P, _P, _I32, _I32, _P, _P, _P, _P, _P],
                     ctypes.c_int),
    # part, x, y, h, w, taps (host), grad, dx; stream
    "ssim_backward": ([_P, _P, _P, _I32, _I32, _P, _P, _P, _P],
                      ctypes.c_int),
    "ssim_blocks": ([_I32, _I32], ctypes.c_int),
})


@functools.lru_cache(maxsize=16)
def _kernel_taps(sigma: float):
    """The 11 taps as the kernels take them: the float32 numbers of
    _banded_blur_matrix in host memory, passed by value at the launch."""
    return (ctypes.c_float * SSIM_WINDOW)(*_gaussian_taps(SSIM_WINDOW, sigma))


def _check_images(img1, img2):
    """img1 and img2 as the kernels take them, or ValueError: contiguous
    [H, W, 3] float32 on one card. Returns (H, W)."""
    if not img1.is_cuda:
        raise ValueError("the CUDA SSIM needs CUDA tensors")
    if img1.dim() != 3 or img1.shape[2] != 3:
        raise ValueError(f"the CUDA SSIM takes [H, W, 3] images, got "
                         f"{tuple(img1.shape)}")
    h, w, _ = img1.shape
    cuda_build.check_tensor(img1, "img1", torch.float32, (h, w, 3),
                            img1.device)
    cuda_build.check_tensor(img2, "img2", torch.float32, (h, w, 3),
                            img1.device)
    return h, w


@cuda_build.counted
def ssim_fwd_cuda(img1, img2, sigma: float = 1.5, partials: bool = True):
    """Launch the forward kernel: (mean SSIM, a 0-d float32 summed on the
    card in a fixed order by the same launch; the [3, H, W, 3] partial
    maps the backward reads, or None unless `partials`). No host sync."""
    h, w = _check_images(img1, img2)
    dev = img1.device
    part = torch.empty(3, h, w, 3, dtype=torch.float32, device=dev) \
        if partials else None
    sums = torch.empty(LIBRARY.get().ssim_blocks(h, w), dtype=torch.float32,
                       device=dev)
    out = torch.empty((), dtype=torch.float32, device=dev)
    ptr = cuda_build.ptr
    LIBRARY.launch("ssim_forward", ptr(img1), ptr(img2), h, w,
                   ctypes.addressof(_kernel_taps(sigma)), ptr(part),
                   ptr(sums), ptr(out), device=dev, counter=ssim_fwd_cuda)
    return out, part


@cuda_build.counted
def ssim_bwd_cuda(part, img1, img2, grad, sigma: float = 1.5):
    """Launch the backward kernel: d(grad * mean SSIM)/d img1 [H, W, 3]
    from ssim_fwd_cuda's partial maps and the 0-d float32 `grad`, read on
    the card. No host sync."""
    h, w = _check_images(img1, img2)
    dev = img1.device
    cuda_build.check_tensor(part, "partials", torch.float32, (3, h, w, 3),
                            dev)
    cuda_build.check_tensor(grad, "grad", torch.float32, (), dev)
    dx = torch.empty_like(img1)
    ptr = cuda_build.ptr
    LIBRARY.launch("ssim_backward", ptr(part), ptr(img1), ptr(img2), h, w,
                   ctypes.addressof(_kernel_taps(sigma)), ptr(grad), ptr(dx),
                   device=dev, counter=ssim_bwd_cuda)
    return dx


class _SsimCuda(torch.autograd.Function):
    """The kernel pair: the forward keeps its partial maps, the backward
    blurs them into img1's gradient."""

    @staticmethod
    def forward(ctx, img1, img2, sigma):
        value, part = ssim_fwd_cuda(img1, img2, sigma)
        ctx.save_for_backward(part, img1, img2)
        ctx.sigma = sigma
        return value

    @staticmethod
    def backward(ctx, grad):
        part, img1, img2 = ctx.saved_tensors
        return ssim_bwd_cuda(part, img1, img2, grad.contiguous(),
                             ctx.sigma), None, None


def ssim_cuda(img1, img2, window_size: int = 11, sigma: float = 1.5):
    """Mean SSIM of contiguous [H, W, 3] float32 CUDA images through the
    kernel pair, differentiable in img1; img2 (the gt) may not require a
    gradient. Without a gradient to take (no_grad, or img1 needs none) the
    forward runs alone and writes no partial maps."""
    if window_size != SSIM_WINDOW:
        raise ValueError(f"the CUDA SSIM takes a {SSIM_WINDOW}-tap window, "
                         f"got {window_size}")
    if img2.requires_grad:
        raise ValueError("the CUDA SSIM takes no gradient to img2 (the gt)")
    if torch.is_grad_enabled() and img1.requires_grad:
        return _SsimCuda.apply(img1, img2, sigma)
    return ssim_fwd_cuda(img1, img2, sigma, partials=False)[0]


def isotropic_regularizer(scaling, condition_number: float, active=None):
    """mean((min_scale / max_scale - condition_number)^2) over active slots.
    scaling: [N, 3] activated scales."""
    per_pt = (scaling.amin(1) / (scaling.amax(1) + 1e-8) - condition_number) ** 2
    if active is None:
        return per_pt.mean()
    per_pt = torch.where(active, per_pt, 0.0)
    return per_pt.sum() / active.sum().clamp(min=1)


def compute_losses(pred_image, gt_image, scaling, active, loss_names: tuple,
                   loss_weights: tuple, condition_number: float = 0.4,
                   lpips_params=None, lpips_enabled: bool = True,
                   lpips_downsample: int = 1, lpips_gt_feats=None,
                   lpips_engine: str = "auto"):
    """Weighted multi-loss (reference base.py:323-365). Returns (total,
    {name: loss}).

    lpips_loss: 0 when lpips_params is None (no weights resolved). Else
    lpips_params, an LPIPS params dict (or a VGG16 one packed for the
    layout chain), runs on lpips_engine (lpips.resolve_lpips_engine's
    names; make_train_step resolves loss.lpips_conv once), and
    lpips_enabled, a host bool, is the
    reference's start_lpips_iter gate (base.py:333-341): when it is false
    the term is an fp32 0 and no conv runs. lpips_downsample k > 1 average-pools pred and gt k x k first.
    lpips_gt_feats, the gt's stage features from lpips.lpips_features
    (built at the same lpips_downsample on the same engine), skip the gt
    forward; exact, as the gt branch carries no gradient.
    """
    losses = {}
    for name in loss_names:
        if name == "rgb_loss":
            losses[name] = l1_loss(pred_image, gt_image)
        elif name == "l2_loss":
            losses[name] = l2_loss(pred_image, gt_image)
        elif name == "ssim_loss":
            losses[name] = 1.0 - ssim(pred_image, gt_image)
        elif name == "isotropic_reg":
            losses[name] = isotropic_regularizer(scaling, condition_number, active)
        elif name == "lpips_loss":
            losses[name] = _lpips_term(
                pred_image, gt_image, lpips_params, lpips_enabled,
                lpips_downsample, lpips_gt_feats, lpips_engine)
        else:
            raise ValueError(f"unknown loss {name}")
    total = torch.zeros((), dtype=pred_image.dtype, device=pred_image.device)
    for name, w in zip(loss_names, loss_weights):
        total = total + w * losses[name]
    return total, losses


def _lpips_term(pred_image, gt_image, params, enabled: bool, downsample: int,
                gt_feats, engine: str):
    dev = pred_image.device
    if params is None:
        return torch.zeros((), dtype=pred_image.dtype, device=dev)
    if not enabled:
        return torch.zeros((), dtype=torch.float32, device=dev)
    pred = lpips.pool_avg(pred_image, downsample)
    if gt_feats is not None:
        return lpips.lpips_distance_cached(params, pred, list(gt_feats),
                                           engine)
    return lpips.lpips_distance(params, pred,
                                lpips.pool_avg(gt_image, downsample), engine)
