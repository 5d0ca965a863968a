"""The plain reference of the OBJ_GAUSSIAN training step: the first steps
of a static object's training from its initial cloud, in float32 with
TF32 off in matmuls and cuDNN (the control turns it on).

One step is the 3D Gaussian Splatting step as MANUS configures it for the
object (config/OBJ_GAUSSIAN.yaml, scripts/train/train_object.sh): the
identity pose, SH colours from the view direction, EWA projection,
binning, front-to-back compositing over a black background, L1 + SSIM +
isotropy at 0.8 / 0.2 / 0.1, gradients by autograd, Adam with a learning
rate per parameter group on the live slots only, and the out-of-mask
prune while it is on. Projection, compositing, losses and Adam are the
plain versions in `frozen.py`; binning is this file's own.

Binning follows the published rasterizer (graphdeco): every (gaussian,
tile) pair of every visible gaussian's 3-sigma tile rectangle is kept,
with no cap on a gaussian's tiles, no pair budget and no per-tile cap.
The port's tuned settings (a 2N budget, 4,096 pairs a tile, capped
multi-tile gaussians) drop pairs at the object's depth and are one of
the cell's faults. The rasterizer's numbers are graphdeco's, as the
port's contract (ROADMAP.md) states them: a 0.3 pixel dilation of the 2D
covariance, a z > 0.2 near cull, the 1/255 alpha gate, a 0.99 alpha
clamp, a pixel's walk ending before the gaussian that would take its
transmittance below 1e-4.

Departures from the published description, each also the program's:

- capacity: the cloud lives in a fixed number of slots of which
  `active` marks the live ones (the published model grows its tensors);
  free slots take no part in a step and their Adam moments stay zero;
- the steps start from the program's initial cloud, which a run first
  holds to this file's `init_cloud` (the published rule, computed here
  in float64) under the cell's `init` limit; so a fault of the
  initial cloud fails `init`, and a fault of the steps fails the steps'
  numbers.

The densify event's reference is `densify.py` beside this file.
"""
from __future__ import annotations

import math
from types import SimpleNamespace

import torch

from portbench.reference import frozen as fz
from portbench.reference.hand_step import LEAVES, precision


def init_cloud(points, colors, capacity: int, opts, device,
               dtype=torch.float64, operands=None,
               budget_bytes: int = 1 << 30) -> dict:
    """The initial cloud by the published rule (graphdeco's
    create_from_pcd with simple-knn's distCUDA2): a point's scale the root
    of its mean squared distance to its three nearest other points, that
    mean clamped below at 1e-7, as the log the leaves hold; degree-0 SH
    from its colour, the higher degrees 0; the identity rotation; opacity
    0.1 as its logit. Padded to `capacity` slots, the first len(points)
    live (the free slots' values take no part in a step).

    The squared distances are sums of squared coordinate differences in
    `dtype`, over blocks of rows of about `budget_bytes`, on `device`;
    `operands` (the control's bfloat16) rounds the coordinates first.
    Returns float32 leaves by name and the bool `active`."""
    dev = torch.device(device)
    pts = torch.as_tensor(points, device=dev).to(dtype)
    if operands is not None:
        pts = pts.to(operands).to(dtype)
    cols = torch.as_tensor(colors, device=dev).to(dtype)
    n0 = pts.shape[0]
    block = max(1, budget_bytes // (3 * n0 * pts.element_size()))
    mean3 = torch.empty(n0, dtype=dtype, device=dev)
    for i in range(0, n0, block):
        d2 = ((pts[i:i + block, None, :] - pts[None]) ** 2).sum(-1)
        rows = torch.arange(d2.shape[0], device=dev)
        d2[rows, rows + i] = float("inf")
        mean3[i:i + block] = torch.topk(d2, min(3, n0 - 1), dim=1,
                                        largest=False).values.mean(1)
    k = (opts.sh_degree + 1) ** 2
    s_dim = 1 if opts.isotropic_scaling else 3
    live = dict(
        xyz=pts,
        features_dc=fz.rgb_to_sh(cols)[:, None, :],
        features_rest=torch.zeros(n0, k - 1, 3, dtype=dtype, device=dev),
        scaling=(0.5 * torch.log(mean3.clamp(min=1e-7)))[:, None].expand(
            n0, s_dim),
        rotation=torch.tensor([1.0, 0, 0, 0], dtype=dtype,
                              device=dev).expand(n0, 4),
        opacity=torch.full((n0, 1), math.log(0.1 / 0.9), dtype=dtype,
                           device=dev))
    out = {}
    for name, x in live.items():
        pad = torch.zeros((capacity - n0,) + tuple(x.shape[1:]),
                          dtype=torch.float32, device=dev)
        out[name] = torch.cat([x.to(torch.float32), pad])
    out["active"] = torch.arange(capacity, device=dev) < n0
    return out


def bin_all_pairs(proj, ntx: int, nty: int) -> fz.TileBins:
    """Every (gaussian, tile) pair of every visible gaussian's tile
    rectangle, in the order the composite walks them: by tile, then depth
    from the camera, then gaussian id. Nothing is dropped, so both drop
    counts are 0; pair_src holds exactly the pairs."""
    dev = proj.depth.device
    rect = proj.tile_rect.long()
    ids = torch.nonzero(proj.visible).flatten()
    x0, y0, x1, y1 = rect[ids].unbind(1)
    w, h = x1 - x0, y1 - y0
    gid, tile = [], []
    # one offset (dx, dy) of the rectangles at a time, over the gaussians
    # whose rectangle reaches it, gaussian ids ascending within each
    for dy in range(int(h.max()) if ids.numel() else 0):
        for dx in range(int(w.max())):
            reach = (dx < w) & (dy < h)
            gid.append(ids[reach])
            tile.append((y0[reach] + dy) * ntx + x0[reach] + dx)
    gid = torch.cat(gid) if gid else ids
    tile = torch.cat(tile) if tile else ids
    # back to gaussian-id order, then stable sorts: depth, then tile
    order = torch.argsort(gid, stable=True)
    order = order[torch.argsort(proj.depth.detach()[gid[order]],
                                stable=True)]
    order = order[torch.argsort(tile[order], stable=True)]
    counts = torch.bincount(tile, minlength=ntx * nty).to(torch.int32)
    offsets = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    return fz.TileBins(pair_src=gid[order].to(torch.int32),
                       tile_offsets=offsets, tile_counts=counts,
                       overflow_count=zero, overflow_far=zero)


def render(params, active, cam, opts, bg, chunk: int = 64):
    """The image [H, W, 3] of the object from `cam`, with its bins and
    payload (the composite's work)."""
    opac = fz.get_opacity(params).reshape(-1)
    cov = fz.get_covariance(params, isotropic=opts.isotropic_scaling)
    colors = fz.calculate_colors_from_sh(params.xyz, fz.get_features(params),
                                         params.xyz, cam, opts.sh_degree)
    proj = fz.project_gaussians(params.xyz, cov, cam, active=active)
    w, h = cam.width, cam.height
    ntx, nty = (w + fz.TILE - 1) // fz.TILE, (h + fz.TILE - 1) // fz.TILE
    bins = bin_all_pairs(proj, ntx, nty)
    pay = fz.build_payload(proj, colors, opac, bins)
    rgb_t, t_t = fz.composite_tiles_torch(pay, bins.tile_offsets,
                                          bins.tile_counts, ntx, nty,
                                          chunk=chunk)
    img, _ = fz.tiles_to_image(rgb_t, t_t, bg, ntx, nty, w, h)
    return img, dict(pay=pay, bins=bins, ntx=ntx)


def _loss(cfg: dict, opts, params, active, cam, gt, bg):
    img, work = render(params, active, cam, opts, bg)
    scaling = fz.get_scaling(params, opts.isotropic_scaling)
    parts = {}
    for name in cfg["loss"]["losses"]:
        if name == "rgb_loss":
            parts[name] = fz.l1_loss(img, gt)
        elif name == "ssim_loss":
            parts[name] = 1.0 - fz.ssim(img, gt)
        elif name == "isotropic_reg":
            parts[name] = fz.isotropic_regularizer(
                scaling, opts.condition_number, active)
        else:
            raise ValueError(f"the object's reference has no loss {name!r}")
    total = img.new_zeros(())
    for name, wt in zip(cfg["loss"]["losses"], cfg["loss"]["loss_weight"]):
        total = total + wt * parts[name]
    return total, work


def run_steps(cfg: dict, scene: dict, batches: list, device="cuda",
              tf32: bool = False) -> dict:
    """Take len(batches) steps of the object from its initial state.

    cfg: the configuration as run (the config file's `config`); scene:
    the initial cloud (`init`: the leaves and `active` as the program
    starts from them), K and extr; batches: (view, gt rgb [H, W, 3], mask
    [H, W, 1] float32) a step.

    Returns each step's loss, each leaf's gradient as Adam's first moment
    holds it after step 1, the leaves after the last step, the active
    mask, and the first step's payload and bins."""
    opts = SimpleNamespace(**cfg["model"])
    dev = torch.device(device)
    d = cfg["dataset"]
    init = scene["init"]
    params = fz.GaussianParams(*(init[k].to(dev).clone() for k in LEAVES))
    active = init["active"].to(dev).clone()
    opt = fz.init_adam(params)
    bg = torch.zeros(3, device=dev)
    out = dict(losses=[], work=None)
    with precision(tf32):
        for step, (v, gt, mask) in enumerate(batches):
            gt = torch.as_tensor(gt, device=dev)
            mask = torch.as_tensor(mask, device=dev)
            cam = fz.make_camera(scene["K"][v], scene["extr"][v], d["width"],
                                 d["height"], device=dev)
            leaves = fz.GaussianParams(*(p.detach().requires_grad_(True)
                                         for p in params))
            loss, work = _loss(cfg, opts, leaves, active, cam, gt, bg)
            grads = torch.autograd.grad(loss, list(leaves), allow_unused=True)
            grads = fz.GaussianParams(*(torch.zeros_like(p) if g is None
                                        else g for g, p in zip(grads, leaves)))
            lrs = fz.group_learning_rates(opts, step)
            params, opt = fz.adam_update(params, grads, opt, lrs, active)
            params = fz.GaussianParams(*(p.detach() for p in params))
            if opts.remove_seg_start <= step < opts.remove_seg_end:
                # the positions the step rendered, the mask undilated
                outside = fz.points_outside_mask(cam, leaves.xyz.detach(),
                                                 mask, active=active)
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
