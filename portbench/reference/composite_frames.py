"""The plain reference of the contact stage's gt_eval frames: the posed
hand worked out again from the inputs (frozen voxel skinning in float32,
TF32 off), its contacts with the object in float64, their running sum,
and the two panels rendered by the frozen plain composite.

A frame's contacts depend only on its pose, so the window's frames need
one search a pose. The search is |x|^2 + |y|^2 - 2 x.y over blocks of
hand points in float64 (the cancellation leaves ~1e-18 m^2 on d^2 at the
hand's scale). The control is the next precision below the float32 the
port states for the search: TF32 does not apply to it (its products
have an inner size of 3, which cuBLAS runs without tensor cores), so it
is bfloat16 operands with float32 sums, `contacts(..., dtype=
torch.float32, operands=torch.bfloat16)`.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference import frozen as fz
from portbench.reference.colormap import apply_colormap
from portbench.reference.hand_step import LEAVES, precision

CONTACT_THRESHOLD = 0.004  # metres, the reference's c_thresh
PANEL_ALPHA = 0.3


def params_of(cloud: dict, device) -> fz.GaussianParams:
    return fz.GaussianParams(*(cloud[k].to(device) for k in LEAVES))


def voxel_grid(cfg: dict, inputs: dict, device):
    d = cfg["dataset"]
    keypts = np.concatenate([inputs["rest_heads"][:1], inputs["rest_tails"]])
    return fz.build_voxel_grid(keypts, res=d["grid_res"], ratio=d["grid_size"],
                               offset=d["grid_offset"],
                               num_bones=inputs["rest"].shape[0],
                               device=device)


def posed_hand(inputs: dict, grid, f: int, device):
    """(posed xyz [N, 3], blended transforms [N, 4, 4]) of pose f."""
    p = params_of(inputs["init"], device)
    rest = torch.as_tensor(inputs["rest"], device=device)
    bone_tf = fz.bone_deformation_transforms(
        torch.as_tensor(inputs["pose"][f], device=device), rest,
        append_identity=True)
    skin_w = fz.skinning_weights_from_voxel_grid(p.xyz, grid.center,
                                                 grid.scale, grid.weights)
    sk = fz.skin_gaussians(p.xyz, fz.get_covariance(p), skin_w, bone_tf)
    return sk.posed_xyz, sk.tf


@torch.no_grad()
def contacts(x, y, x_valid, y_valid, dtype=torch.float64, operands=None,
             block: int = 2048):
    """The contact signal 1 - min(d, c) / c of each x [N, 3] against its
    nearest valid y [M, 3], 0 where x is not valid, in `dtype`; with
    `operands`, the points rounded to that type first."""
    if operands is not None:
        x, y = x.to(operands), y.to(operands)
    x, y = x.to(dtype), y.to(dtype)
    sq_y = torch.where(y_valid, (y * y).sum(-1), float("inf"))
    out = []
    with precision(False):
        for i in range(0, x.shape[0], block):
            rows = x[i:i + block]
            d2 = (rows * rows).sum(-1)[:, None] + sq_y[None, :] \
                - 2.0 * (rows @ y.T)
            out.append(torch.sqrt(d2.min(dim=-1).values.clamp(min=0.0)))
    dist = torch.cat(out)
    d01 = 1.0 - dist.clamp(0.0, CONTACT_THRESHOLD) / CONTACT_THRESHOLD
    return torch.where(x_valid, d01, 0.0)


@torch.no_grad()
def render_precomp(cfg: dict, p: fz.GaussianParams, active, colors, cam):
    """[H, W, 3] render of the canonical cloud `p` in `colors`, black
    background, by the frozen plain path under the config's raster
    options; and its payload and bins (the composite's work)."""
    r = cfg["raster"]
    opac = fz.get_opacity(p).reshape(-1)
    proj = fz.project_gaussians(p.xyz, fz.get_covariance(p), cam,
                                active=active)
    w, h = cam.width, cam.height
    ntx, nty = (w + fz.TILE - 1) // fz.TILE, (h + fz.TILE - 1) // fz.TILE
    bins = fz.bin_gaussians(proj, ntx, nty, r["tg_max"],
                            lane_align=r["lane_align"],
                            pair_budget_factor=r["pair_budget_factor"],
                            max_pairs_per_tile=r["max_pairs_per_tile"],
                            multi_frac=r["multi_frac"])
    pay = fz.build_payload(proj, colors, opac, bins)
    rgb_t, t_t = fz.composite_tiles_torch(pay, bins.tile_offsets,
                                          bins.tile_counts, ntx, nty,
                                          chunk=r["chunk"])
    img, _ = fz.tiles_to_image(rgb_t, t_t, torch.zeros(3, device=p.xyz.device),
                               ntx, nty, w, h)
    return img, pay, bins


@torch.no_grad()
def gt_eval_panels(cfg: dict, inputs: dict, tf, d01, acc, cano_cam, device):
    """The gt_eval frame [H, 2W, 3] in [0, 1]: the canonical hand from the
    canonical camera in its SH colours (through the posed transforms)
    blended with the magma contact map, then with the running sum's."""
    p = params_of(inputs["init"], device)
    active = inputs["init"]["active"].to(device)
    rgb = fz.calculate_colors_from_sh(p.xyz, fz.get_features(p), p.xyz,
                                      cano_cam, 3, tf)
    panels = []
    for values in (d01, acc.clamp(0, 1)):
        colors = (rgb * PANEL_ALPHA
                  + (1 - PANEL_ALPHA) * apply_colormap(values.float()))
        panels.append(render_precomp(cfg, p, active, colors, cano_cam)[0])
    return torch.cat(panels, dim=1).clamp(0, 1)


def image_gap(u8, want) -> float:
    """The mean gap between an 8-bit image and a [0, 1] float one cast to
    8 bits as the port's composite writes its frames ((x * 255) cast to
    uint8), over 255."""
    want8 = (want.clamp(0, 1) * 255).to(torch.uint8)
    got = torch.as_tensor(u8, device=want.device)
    return float((got.float() - want8.float()).abs().mean()) / 255.0
