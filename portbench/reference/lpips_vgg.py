"""VGG16-LPIPS in plain PyTorch, at the precision the port's loss states.

The port's LPIPS loss runs VGG16's 13 convolutions on bf16 features with
float32 accumulation (its layout chain). This is that arithmetic written
out plainly: every feature map, and every gradient that flows back
between layers, is rounded to bf16; each convolution multiplies bf16
values (exact in float32) and sums in float32 with TF32 off, adds the
float32 bias and applies the ReLU before the rounding. The head is
float32: unit-normalised features, squared differences weighted by the
1x1 heads, the mean over pixels, the sum over the 5 stages.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)
STAGES = (2, 2, 3, 3, 3)  # convolutions a stage
HEAD_EPS = 1e-10


class _RoundBF16(torch.autograd.Function):
    """Round to the nearest bf16 value, kept as float32; the gradient is
    rounded the same way on its way back."""

    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(torch.float32)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(torch.float32)


def round_bf16(x):
    return _RoundBF16.apply(x)


def vgg16_features(params: dict, img):
    """The 5 post-ReLU stage features [1, C, h, w] of img ([H, W, 3] in
    [0, 1])."""
    shift = img.new_tensor(SHIFT)
    scale = img.new_tensor(SCALE)
    x = round_bf16(((img * 2.0 - 1.0 - shift) / scale).permute(2, 0, 1)[None])
    feats = []
    for si, n_conv in enumerate(STAGES):
        if si:
            x = F.max_pool2d(x, 2, 2)
        for li in range(n_conv):
            w = round_bf16(params[f"conv{si}_{li}_w"].permute(3, 2, 0, 1))
            y = F.conv2d(x, w, padding=1) + params[f"conv{si}_{li}_b"][
                None, :, None, None]
            x = round_bf16(torch.relu(y))
        feats.append(x)
    return feats


def lpips_distance(params: dict, img1, img2):
    """The LPIPS distance of two [H, W, 3] images in [0, 1], differentiable
    in both."""
    total = None
    for k, (a, b) in enumerate(zip(vgg16_features(params, img1),
                                   vgg16_features(params, img2))):
        na = a / (torch.linalg.norm(a, dim=1, keepdim=True) + HEAD_EPS)
        nb = b / (torch.linalg.norm(b, dim=1, keepdim=True) + HEAD_EPS)
        npix = float(a.shape[2] * a.shape[3])
        d = ((na - nb) ** 2 * params[f"lin{k}_w"][None, :, None, None]
             ).sum() / npix
        total = d if total is None else total + d
    return total
