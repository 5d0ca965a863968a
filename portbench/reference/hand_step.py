"""The plain reference of the hand training step: the first steps of
HAND_GAUSSIAN training from the benchmark's inputs, in float32 with TF32
off (the control turns TF32 on).

It works everything out from the inputs again: the voxel skinning grid
from the rest skeleton, the cameras from K and the extrinsics, the bone
transforms from the poses. One step is voxel skin weights, LBS, SH
colours, EWA projection, tile binning under the pair budget, the plain
composite, L1 + SSIM + isotropy (+ LPIPS from start_lpips_iter), the
gradients by autograd, masked per-group Adam and the mask-prune phase,
as the frozen copy in `frozen.py` has them.
"""
from __future__ import annotations

import contextlib
from types import SimpleNamespace

import numpy as np
import torch

from portbench.reference import frozen as fz
from portbench.reference.lpips_vgg import lpips_distance

LEAVES = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
          "opacity")


@contextlib.contextmanager
def precision(tf32: bool):
    """TF32 off for the reference, on for the control, in matmuls and
    convolutions alike; the previous settings come back on exit."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _loss(cfg: dict, opts, params, active, skin_w, bone_tf, cam, gt, bg,
          lpips_params, lpips_on: bool):
    r = cfg["raster"]
    iso = opts.isotropic_scaling
    cov_cano = fz.get_covariance(params, isotropic=iso)
    sk = fz.skin_gaussians(params.xyz, cov_cano, skin_w, bone_tf)
    feats = fz.get_features(params)
    opac = fz.get_opacity(params).reshape(-1)
    colors = fz.calculate_colors_from_sh(sk.posed_xyz, feats, params.xyz,
                                         cam, opts.sh_degree, sk.tf)
    proj = fz.project_gaussians(sk.posed_xyz, sk.posed_cov, cam,
                                active=active)
    w, h = cam.width, cam.height
    ntx, nty = (w + fz.TILE - 1) // fz.TILE, (h + fz.TILE - 1) // fz.TILE
    bins = fz.bin_gaussians(
        proj, ntx, nty, r["tg_max"], lane_align=r["lane_align"],
        pair_budget_factor=r["pair_budget_factor"],
        max_pairs_per_tile=r["max_pairs_per_tile"],
        multi_frac=r["multi_frac"])
    pay = fz.build_payload(proj, colors, opac, bins)
    rgb_t, t_t = fz.composite_tiles_torch(pay, bins.tile_offsets,
                                          bins.tile_counts, ntx, nty,
                                          chunk=r["chunk"])
    img, _ = fz.tiles_to_image(rgb_t, t_t, bg, ntx, nty, w, h)
    scaling = fz.get_scaling(params, iso)
    parts = {}
    for name in cfg["loss"]["losses"]:
        if name == "rgb_loss":
            parts[name] = fz.l1_loss(img, gt)
        elif name == "ssim_loss":
            parts[name] = 1.0 - fz.ssim(img, gt)
        elif name == "isotropic_reg":
            parts[name] = fz.isotropic_regularizer(
                scaling, opts.condition_number, active)
        elif name == "lpips_loss":
            parts[name] = (lpips_distance(lpips_params, img, gt) if lpips_on
                           else img.new_zeros(()))
        else:
            raise ValueError(f"the reference has no loss {name!r}")
    total = img.new_zeros(())
    for name, wt in zip(cfg["loss"]["losses"], cfg["loss"]["loss_weight"]):
        total = total + wt * parts[name]
    return total, sk.posed_xyz.detach(), dict(pay=pay, bins=bins)


def run_steps(cfg: dict, scene: dict, batches: list, lpips_params=None,
              device="cuda", tf32: bool = False) -> dict:
    """Take len(batches) steps of the hand from its initial state.

    cfg: the configuration as run (the config file's `config`); scene:
    the benchmark's inputs (init cloud, rest and posed skeleton, K,
    extr); batches: (frame, view, gt rgb [H, W, 3] and mask [H, W, 1]
    float32) a step.

    Returns each step's loss, each leaf's gradient as Adam's first moment
    holds it after step 1, the leaves after the last step, the active
    mask, and the first step's payload and bins (the composite's work).
    """
    opts = SimpleNamespace(**cfg["model"])
    dev = torch.device(device)
    d = cfg["dataset"]
    init = scene["init"]
    params = fz.GaussianParams(*(init[k].to(dev).clone() for k in LEAVES))
    active = init["active"].to(dev).clone()
    opt = fz.init_adam(params)
    keypts = np.concatenate([scene["rest_heads"][:1], scene["rest_tails"]])
    rest = torch.as_tensor(scene["rest"], dtype=torch.float32, device=dev)
    bg = torch.zeros(3, device=dev)
    out = dict(losses=[], work=None)
    with precision(tf32):
        grid = fz.build_voxel_grid(keypts, res=d["grid_res"],
                                   ratio=d["grid_size"],
                                   offset=d["grid_offset"],
                                   num_bones=rest.shape[0], device=dev)
        for step, (f, v, gt, mask) in enumerate(batches):
            gt = torch.as_tensor(gt, device=dev)
            mask = torch.as_tensor(mask, device=dev)
            cam = fz.make_camera(scene["K"][v], scene["extr"][v], d["width"],
                                 d["height"], device=dev)
            pose = torch.as_tensor(scene["pose"][f], device=dev)
            bone_tf = fz.bone_deformation_transforms(pose, rest,
                                                     append_identity=True)
            skin_w = fz.skinning_weights_from_voxel_grid(
                params.xyz, grid.center, grid.scale, grid.weights)
            leaves = fz.GaussianParams(*(p.detach().requires_grad_(True)
                                         for p in params))
            lpips_on = step >= opts.start_lpips_iter
            loss, posed, work = _loss(cfg, opts, leaves, active, skin_w,
                                      bone_tf, cam, gt, bg, lpips_params,
                                      lpips_on)
            grads = torch.autograd.grad(loss, list(leaves), allow_unused=True)
            grads = fz.GaussianParams(*(torch.zeros_like(p) if g is None
                                        else g for g, p in zip(grads, leaves)))
            lrs = fz.group_learning_rates(opts, step)
            params, opt = fz.adam_update(params, grads, opt, lrs, active)
            params = fz.GaussianParams(*(p.detach() for p in params))
            outside = torch.zeros_like(active)
            if opts.remove_seg_start <= step < opts.remove_seg_end:
                kp = torch.as_tensor(np.concatenate(
                    [scene["heads"][f][:1], scene["tails"][f]]), device=dev)
                outside = fz.points_outside_mask(
                    cam, posed, mask, keypoints=kp, dilate=True,
                    active=active)
            elif step % 100 == 0 and step >= opts.remove_seg_end:
                kp = torch.as_tensor(np.concatenate(
                    [scene["heads"][f][:1], scene["tails"][f]]), device=dev)
                dist = torch.linalg.norm(posed[:, None, :] - kp[None],
                                         dim=-1).mean(1)
                outside = (dist > opts.skeleton_dist_threshold) & active
            active = active & ~outside
            opt = fz.reset_moments_rows(opt, outside)
            out["losses"].append(float(loss.detach()))
            if step == 0:
                out["grad1"] = {k: m / (1.0 - fz.BETA1)
                                for k, m in zip(LEAVES, opt.m)}
                out["work"] = work
    out["params"] = dict(zip(LEAVES, params))
    out["active"] = active
    return out

