"""Image losses and metrics: L1, L2, windowed SSIM, PSNR, isotropy term,
and the VGG16-LPIPS term (train/lpips.py).

Reference numerics (Gaussian 11x11 window, sigma 1.5, C1=0.01^2,
C2=0.03^2, zero padding). Images are [H, W, C].
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from manus_tpu_torch.train import lpips


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
def _banded_blur_matrix(size: int, window_size: int, sigma: float) -> np.ndarray:
    """[size, size] banded Toeplitz matrix of the normalised 1D Gaussian
    with zero padding (rows near the border see fewer taps)."""
    g = np.exp(
        -((np.arange(window_size) - window_size // 2) ** 2) / (2 * sigma**2)
    )
    g = (g / g.sum()).astype(np.float32)
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
    """Mean SSIM over [H, W, C] images in [0, 1]."""
    mu1 = _depthwise_blur(img1, window_size, sigma)
    mu2 = _depthwise_blur(img2, window_size, sigma)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _depthwise_blur(img1 * img1, window_size, sigma) - mu1_sq
    sigma2_sq = _depthwise_blur(img2 * img2, window_size, sigma) - mu2_sq
    sigma12 = _depthwise_blur(img1 * img2, window_size, sigma) - mu1_mu2
    C1, C2 = 0.01**2, 0.03**2
    ssim_map = ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2)
    )
    return ssim_map.mean()


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
