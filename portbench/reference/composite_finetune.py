"""The plain reference of the contact stage's hand fine-tune: the first
steps of COMPOSITE's optimize_hand from the benchmark's inputs, in
float32 with TF32 off in matmuls and cuDNN (the control turns it on).

One step is MANUS's fine-tune (src/modules/composite.py:27-35): the
hand's voxel skin weights sampled at its positions (the gradient
flowing through the sample to them), LBS, the object at the identity
pose, the two clouds concatenated hand first; SH colours from the view
direction pulled back through each gaussian's transform (the object's
is the identity), EWA projection, every (gaussian, tile) pair binned
(object_step.bin_all_pairs), front-to-back compositing over a black
background, L1 + SSIM at COMPOSITE's 0.8 / 0.2, gradients by autograd
to the hand's leaves only, and Adam with a learning rate per parameter
group (group_learning_rates at the step's index) on the hand's live
slots. The object carries no gradient and is never updated.

On the card the composite runs in blocks of whole tiles, each under
torch.utils.checkpoint: a block's forward keeps nothing for the
backward, which computes it again, one block at a time. Blocks gather
the tiles deepest first, so that a block's chunk walk is as long as its
deepest tile and the walk over the scene's 2,000-10,000-pair object
tiles is done few times. The pixels a block produces are its tiles',
whatever else a block holds, so blocking changes no value.

Departures from the published description, each also the program's:

- capacity: each cloud lives in a fixed number of slots of which
  `active` marks the live ones; free slots take no part in the render
  and Adam leaves them as they are;
- binning keeps every pair (the published rasterizer's rule), where
  COMPOSITE's preset caps a tile's pairs and the pairs a view: at the
  object's size the caps drop pairs (portbench/limits note the cell's
  raster.tg_max 0);
- the position learning rate is position_lr_init x spatial_lr_scale,
  which the stage leaves at 0, as the program's config does: the
  positions receive gradients and Adam moments but do not move;
- the untrained stand-ins of the checkpoints (portbench/composite_scene.py).
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from portbench.reference import frozen as fz
from portbench.reference.hand_step import LEAVES, precision
from portbench.reference.object_step import bin_all_pairs

# the pairs a block of tiles composites at most, but for a single
# deeper tile (its saved state for the backward ~15 KB a pair)
BLOCK_PAIRS = 1 << 19


def tile_blocks(counts: torch.Tensor, budget: int = BLOCK_PAIRS) -> list:
    """The tile ids in blocks: deepest first, each block's pairs at most
    `budget` (a deeper tile alone)."""
    c = counts.long().cpu()
    order = torch.argsort(c, descending=True, stable=True)
    blocks, cur, total = [], [], 0
    for tid, n in zip(order.tolist(), c[order].tolist()):
        if cur and total + n > budget:
            blocks.append(cur)
            cur, total = [], 0
        cur.append(tid)
        total += n
    if cur:
        blocks.append(cur)
    return [torch.tensor(b, device=counts.device) for b in blocks]


def composite_blocks(pay, offsets, counts, ntx: int, nty: int, chunk: int,
                     budget: int = BLOCK_PAIRS):
    """fz.composite_tiles_torch over the whole grid, by blocks of tiles
    under checkpoint: rgb [T, 3, 256] and T_final [T, 256]."""
    t = ntx * nty
    rgb = pay.new_zeros(t, 3, fz.N_PX)
    t_fin = pay.new_zeros(t, fz.N_PX)
    for ids in tile_blocks(counts, budget):
        def block(p, ids=ids):
            return fz.composite_tiles_torch(p, offsets[ids], counts[ids], ntx,
                                            nty, chunk=chunk, tile_ids=ids)
        if pay.requires_grad:
            r, tf = checkpoint(block, pay, use_reentrant=False)
        else:
            r, tf = block(pay)
        rgb = rgb.index_copy(0, ids, r)
        t_fin = t_fin.index_copy(0, ids, tf)
    return rgb, t_fin


def scene_of(hand, h_active, obj, skin_w, bone_tf, opts):
    """The concatenated scene, hand first: posed means, posed
    covariances, canonical means, SH features, opacities, transforms
    and the active mask."""
    iso = opts.isotropic_scaling
    sk = fz.skin_gaussians(hand.xyz, fz.get_covariance(hand, isotropic=iso),
                           skin_w, bone_tf)
    o_params = fz.GaussianParams(*(obj[k] for k in LEAVES))
    o_cov = fz.get_covariance(o_params, isotropic=iso)
    n_o = o_params.xyz.shape[0]
    eye = torch.eye(4, dtype=sk.tf.dtype, device=sk.tf.device).expand(
        n_o, 4, 4)
    return (torch.cat([sk.posed_xyz, o_params.xyz]),
            torch.cat([sk.posed_cov, o_cov]),
            torch.cat([hand.xyz, o_params.xyz]),
            torch.cat([fz.get_features(hand), fz.get_features(o_params)]),
            torch.cat([fz.get_opacity(hand).reshape(-1),
                       fz.get_opacity(o_params).reshape(-1)]),
            torch.cat([sk.tf, eye]),
            torch.cat([h_active, obj["active"]]))


def render(scene, cam, opts, bg, chunk: int):
    """The image [H, W, 3] of the concatenated `scene` from `cam`, with
    its payload and bins."""
    posed, cov, cano, feats, opac, tf, active = scene
    colors = fz.calculate_colors_from_sh(posed, feats, cano, cam,
                                         opts.sh_degree, tf)
    proj = fz.project_gaussians(posed, cov, cam, active=active)
    w, h = cam.width, cam.height
    ntx, nty = (w + fz.TILE - 1) // fz.TILE, (h + fz.TILE - 1) // fz.TILE
    bins = bin_all_pairs(proj, ntx, nty)
    pay = fz.build_payload(proj, colors, opac, bins)
    rgb_t, t_t = composite_blocks(pay, bins.tile_offsets, bins.tile_counts,
                                  ntx, nty, chunk)
    img, _ = fz.tiles_to_image(rgb_t, t_t, bg, ntx, nty, w, h)
    return img, dict(pay=pay.detach(), bins=bins, ntx=ntx)


def _loss(cfg: dict, img, gt):
    total = img.new_zeros(())
    for name, wt in zip(cfg["loss"]["losses"], cfg["loss"]["loss_weight"]):
        if name == "rgb_loss":
            part = fz.l1_loss(img, gt)
        elif name == "ssim_loss":
            part = 1.0 - fz.ssim(img, gt)
        elif name == "lpips_loss":  # the fine-tune drops the LPIPS term
            continue
        else:
            raise ValueError(f"the fine-tune's reference has no loss "
                             f"{name!r}")
        total = total + wt * part
    return total


class Rig:
    """The hand's voxel grid, rest transforms and cameras, worked out
    from the inputs."""

    def __init__(self, cfg: dict, scene: dict, device):
        d = cfg["dataset"]
        self.d, self.scene, self.device = d, scene, device
        keypts = np.concatenate([scene["rest_heads"][:1],
                                 scene["rest_tails"]])
        self.rest = torch.as_tensor(scene["rest"], dtype=torch.float32,
                                    device=device)
        self.grid = fz.build_voxel_grid(
            keypts, res=d["grid_res"], ratio=d["grid_size"],
            offset=d["grid_offset"], num_bones=self.rest.shape[0],
            device=device)

    def camera(self, v: int):
        return fz.make_camera(self.scene["K"][v], self.scene["extr"][v],
                              self.d["width"], self.d["height"],
                              device=self.device)

    def bone_tf(self, f: int):
        pose = torch.as_tensor(self.scene["pose"][f], device=self.device)
        return fz.bone_deformation_transforms(pose, self.rest,
                                              append_identity=True)

    def skin_weights(self, xyz):
        g = self.grid
        return fz.skinning_weights_from_voxel_grid(xyz, g.center, g.scale,
                                                   g.weights)


def run_steps(cfg: dict, scene: dict, batches: list, device="cuda",
              tf32: bool = False, with_object: bool = True) -> dict:
    """Take len(batches) fine-tune steps of the hand from its initial
    state against the frozen object.

    cfg: the configuration as run (the config file's `config`); scene:
    the benchmark's inputs (the hand's `init` and the object's `obj`
    clouds, the rest and posed skeleton, K, extr); batches: (frame,
    view, gt rgb [H, W, 3], mask [H, W, 1] float32) a step. Without
    `with_object` the hand is rendered alone (a fault).

    Returns each step's loss, each hand leaf's gradient as Adam's first
    moment holds it after step 1, the hand's leaves after the last step,
    and the object's leaves as the steps left them."""
    opts = SimpleNamespace(**cfg["model"])
    dev = torch.device(device)
    chunk = cfg["raster"]["chunk"]
    init = scene["init"]
    params = fz.GaussianParams(*(init[k].to(dev).clone() for k in LEAVES))
    active = init["active"].to(dev).clone()
    obj = {k: v.to(dev) for k, v in scene["obj"].items()}
    if not with_object:
        obj["active"] = torch.zeros_like(obj["active"])
    opt = fz.init_adam(params)
    bg = torch.zeros(3, device=dev)
    out = dict(losses=[])
    with precision(tf32):
        rig = Rig(cfg, scene, dev)
        for step, (f, v, gt, _mask) in enumerate(batches):
            gt = torch.as_tensor(gt, device=dev)
            leaves = fz.GaussianParams(*(p.detach().requires_grad_(True)
                                         for p in params))
            parts = scene_of(leaves, active, obj, rig.skin_weights(leaves.xyz),
                             rig.bone_tf(f), opts)
            img, _ = render(parts, rig.camera(v), opts, bg, chunk)
            loss = _loss(cfg, img, gt)
            grads = torch.autograd.grad(loss, list(leaves), allow_unused=True)
            grads = fz.GaussianParams(*(torch.zeros_like(p) if g is None
                                        else g for g, p in zip(grads, leaves)))
            lrs = fz.group_learning_rates(opts, step)
            params, opt = fz.adam_update(params, grads, opt, lrs, active)
            params = fz.GaussianParams(*(p.detach() for p in params))
            out["losses"].append(float(loss.detach()))
            if step == 0:
                out["grad1"] = {k: m / (1.0 - fz.BETA1)
                                for k, m in zip(LEAVES, opt.m)}
    out["params"] = dict(zip(LEAVES, params))
    out["obj"] = obj
    return out


@torch.no_grad()
def view_payload(cfg: dict, rig: Rig, obj: dict, hand: dict, h_active,
                 f: int, v: int):
    """The payload and bins of the concatenated scene of frame f from
    camera v, with the hand's leaves `hand` and the object's `obj` (by
    name): the composite's work (portbench/counts/finetune.py)."""
    opts = SimpleNamespace(**cfg["model"])
    p = fz.GaussianParams(*(hand[k] for k in LEAVES))
    parts = scene_of(p, h_active, obj, rig.skin_weights(p.xyz),
                     rig.bone_tf(f), opts)
    _, work = render(parts, rig.camera(v), opts,
                     torch.zeros(3, device=rig.device),
                     cfg["raster"]["chunk"])
    return work
