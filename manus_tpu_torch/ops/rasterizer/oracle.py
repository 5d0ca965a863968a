"""Dense per-pixel compositing: the correctness anchor for the tiled paths.

Evaluates every (pixel, gaussian) pair, so it is for small scenes only.
Its numerics are the upstream rasterizer's:

  * depth-stable order (ties by gaussian index),
  * power > 0 skip, alpha = min(0.99, opacity * exp(power)),
  * alpha < 1/255 skip,
  * termination before the gaussian that would take transmittance below
    1e-4 (the inclusion mask CP_k >= 1e-4 on the running product),
  * out = sum w_k c_k + T_final * bg.

The 0.99 clamp is straight-through and the gates carry no gradient.
"""
from __future__ import annotations

import torch

from manus_tpu_torch.ops.rasterizer.projection import TILE, ProjectedGaussians

ALPHA_EPS = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4


def straight_through_min(x: torch.Tensor, cap: float) -> torch.Tensor:
    """min(x, cap) in the forward pass, identity in the backward pass."""
    return x + (x.clamp(max=cap) - x).detach()


def render_oracle(
    proj: ProjectedGaussians,
    colors: torch.Tensor,  # [N, 3]
    opacity: torch.Tensor,  # [N]
    bg: torch.Tensor,  # [3]
    width: int,
    height: int,
    row_chunk: int = 16,
):
    """Render ([H, W, 3], [H, W] T_final) by dense compositing."""
    order = torch.argsort(proj.depth.detach(), stable=True)
    means2d = proj.means2d[order]
    conic = proj.conic[order]
    colors_s = colors[order]
    opacity_s = opacity[order]
    rect = proj.tile_rect[order]
    valid = proj.visible[order]
    dev = means2d.device

    xs = torch.arange(width, dtype=torch.float32, device=dev)
    imgs, tfins = [], []
    for y0 in range(0, height, row_chunk):
        ys = torch.arange(y0, min(y0 + row_chunk, height), dtype=torch.float32,
                          device=dev)
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        pix = torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)  # [P, 2]
        pt = (pix / TILE).to(torch.int32)
        d = pix[:, None, :] - means2d[None, :, :]
        dx, dy = d[..., 0], d[..., 1]
        power = (-0.5 * (conic[None, :, 0] * dx * dx + conic[None, :, 2] * dy * dy)
                 - conic[None, :, 1] * dx * dy)
        alpha = straight_through_min(opacity_s[None, :] * torch.exp(power),
                                     ALPHA_MAX)
        in_tile = (
            (pt[:, None, 0] >= rect[None, :, 0]) & (pt[:, None, 0] < rect[None, :, 2])
            & (pt[:, None, 1] >= rect[None, :, 1]) & (pt[:, None, 1] < rect[None, :, 3])
        )
        gate = valid[None, :] & (power <= 0.0) & in_tile & (alpha.detach() >= ALPHA_EPS)
        alpha = torch.where(gate, alpha, torch.zeros_like(alpha))
        log1m = torch.log1p(-alpha)
        log_cp = torch.cumsum(log1m, dim=1)
        cp = torch.exp(log_cp)
        t_before = torch.exp(log_cp - log1m)
        incl = cp.detach() >= T_EPS
        w = torch.where(incl, alpha * t_before, torch.zeros_like(alpha))
        rgb = w @ colors_s
        t_final = torch.where(incl & (alpha > 0), cp, torch.ones_like(cp)).amin(1)
        out = rgb + t_final[:, None] * bg[None, :]
        imgs.append(out.reshape(-1, width, 3))
        tfins.append(t_final.reshape(-1, width))
    return torch.cat(imgs, 0), torch.cat(tfins, 0)
