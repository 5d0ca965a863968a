"""The hand and object models rendered together, with hand-object contact
distances accumulated over frames (the reference's modules/composite.py).

Both trained models are GaussianModels; the full scene concatenates their
clouds (padded capacities concatenate, active masks too). The render
layouts, panels side by side:

  results:     [rgb | hand contact | object contact | accumulated contact]
  gt_eval:     [hand contact | accumulated contact], canonical camera
  acc_gt_eval: [skin-weight colours | the accumulated contact given]
  nocs:        [rgb | nocs hand | nocs object]

Contacts are ops/contacts.contact_map in both directions over active
slots (on the card, one launch of the search kernel of csrc/knn.cu
each); the running sum stays a [N_hand] tensor on the device. Every
panel is one render_gaussians call, so one composite forward launch on
the card.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from manus_tpu_torch.config import ExperimentConfig
from manus_tpu_torch.models.gaussians import (
    GaussianModel,
    GaussianOpts,
    GaussianParams,
    get_covariance,
    get_features,
    get_opacity,
    get_scaling,
)
from manus_tpu_torch.ops import contacts as contacts_mod
from manus_tpu_torch.ops.grid_sample import skinning_weights_from_voxel_grid
from manus_tpu_torch.ops.rasterizer.api import (
    RasterConfig,
    calculate_colors_from_sh,
    render_gaussians,
)
from manus_tpu_torch.train import optim as optim_mod
from manus_tpu_torch.train.workloads import (
    TrainState,
    VoxelGrid,
    forward_gaussians,
    resolve_skin_weights,
)
from manus_tpu_torch.utils import losses as loss_mod
from manus_tpu_torch.utils import trace
from manus_tpu_torch.utils.colormap import apply_colormap

MODES = ("results", "gt_eval", "acc_gt_eval", "nocs")
PANELS = {"results": 4, "gt_eval": 2, "acc_gt_eval": 2, "nocs": 3}


class CompositeModels(NamedTuple):
    hand: GaussianModel
    obj: GaussianModel
    voxel_grid: Optional[VoxelGrid] = None


def _scene(hand: GaussianModel, obj: GaussianModel, skin_w, bone_tf,
           hand_opts: GaussianOpts, obj_opts: GaussianOpts):
    """(posed hand xyz, cov, tf), (object xyz, cov, identity tf)."""
    h_xyz, h_cov, h_tf = forward_gaussians(hand.params, hand.active, skin_w,
                                           bone_tf, hand_opts)
    o_xyz, o_cov, _ = forward_gaussians(obj.params, obj.active, None, None,
                                        obj_opts)
    o_tf = torch.eye(4, dtype=h_tf.dtype, device=h_tf.device).expand(
        o_xyz.shape[0], 4, 4)
    return (h_xyz, h_cov, h_tf), (o_xyz, o_cov, o_tf)


def make_composite_render(cfg: ExperimentConfig, raster_cfg: RasterConfig,
                          mode: str, cmap_type: str = "magma",
                          alpha: float = 0.3,
                          hand_opts: GaussianOpts = GaussianOpts(),
                          obj_opts: GaussianOpts = GaussianOpts()):
    """The composite renderer of one contact_render_type (MODES).

    composite_render(models, bone_tf, camera, cano_camera, bg, acc_dist,
    aux_colors, stats=None) -> (render [H, W * panels, 3], new_acc [N_hand],
    h_d01 [N_hand]); aux_colors [N_hand, 3] colour the skin panel of
    acc_gt_eval and the nocs panels. With a `stats` dict, its
    "pair_overflow" becomes the largest of the panels' binning overflow
    (a 0-d tensor). No gradient is taken.
    """
    del cfg
    if mode not in MODES:
        raise ValueError(f"unknown contact_render_type {mode!r}; one of "
                         f"{MODES}")

    def composite_render(models: CompositeModels, bone_tf, camera,
                         cano_camera, bg, acc_dist, aux_colors, stats=None):
        overflow = []

        def render_cloud(xyz, cov, cano_xyz, feats, opac, active, cam, tf,
                         colors_precomp):
            out = render_gaussians(
                xyz, cov, cano_xyz, feats, opac, cam, bg,
                colors_precomp=colors_precomp, sh_degree=3, tf=tf,
                active=active, config=raster_cfg)
            overflow.append(out.overflow)
            return out.render

        with torch.no_grad():
            hand, obj = models.hand, models.obj
            skin_w = resolve_skin_weights(hand, models.voxel_grid)
            (h_xyz, h_cov, h_tf), (o_xyz, o_cov, o_tf) = _scene(
                hand, obj, skin_w, bone_tf, hand_opts, obj_opts)
            hp, op_ = hand.params, obj.params
            h_act, o_act = hand.active, obj.active
            h_feats, o_feats = get_features(hp), get_features(op_)
            h_opac, o_opac = get_opacity(hp)[:, 0], get_opacity(op_)[:, 0]

            # hand <-> object nearest distances over active slots only
            with trace.span("composite.contacts"):
                h_d01, _, h_cmap = contacts_mod.contact_map(
                    h_xyz, o_xyz, pt1_valid=h_act, pt2_valid=o_act,
                    cmap_type=cmap_type)
                o_d01, o_idx, o_cmap = contacts_mod.contact_map(
                    o_xyz, h_xyz, pt1_valid=o_act, pt2_valid=h_act,
                    cmap_type=cmap_type)

            panels = []
            if mode in ("results", "nocs"):  # the full scene's rgb
                panels.append(render_cloud(
                    torch.cat([h_xyz, o_xyz]), torch.cat([h_cov, o_cov]),
                    torch.cat([hp.xyz, op_.xyz]),
                    torch.cat([h_feats, o_feats]),
                    torch.cat([h_opac, o_opac]), torch.cat([h_act, o_act]),
                    camera, torch.cat([h_tf, o_tf]), None))

            # the hand's colours at its canonical positions through the
            # posed transforms, as the JAX package computes them
            h_rgb = calculate_colors_from_sh(hp.xyz, h_feats, hp.xyz,
                                             cano_camera, 3, h_tf)
            o_rgb = calculate_colors_from_sh(o_xyz, o_feats, o_xyz, camera, 3,
                                             None)
            h_cov_cano = get_covariance(hp,
                                        isotropic=hand_opts.isotropic_scaling)
            o_cov_cano = get_covariance(op_,
                                        isotropic=obj_opts.isotropic_scaling)

            def cano_hand(colors):
                return render_cloud(hp.xyz, h_cov_cano, hp.xyz, h_feats,
                                    h_opac, h_act, cano_camera, None, colors)

            def posed_object(colors):
                return render_cloud(o_xyz, o_cov_cano, o_xyz, o_feats, o_opac,
                                    o_act, camera, None, colors)

            def posed_hand(colors):
                return render_cloud(h_xyz, h_cov, hp.xyz, h_feats, h_opac,
                                    h_act, camera, h_tf, colors)

            if mode in ("results", "gt_eval"):
                # hand-only contact, canonical pose and camera
                panels.append(cano_hand(h_rgb * alpha + (1 - alpha) * h_cmap))
            if mode == "results":  # object-only contact in the posed scene
                panels.append(posed_object(o_rgb * alpha
                                           + (1 - alpha) * o_cmap))
            if mode in ("results", "gt_eval"):
                new_acc = acc_dist + h_d01  # the running sum over frames
                acc_cmap = apply_colormap(new_acc.clamp(0, 1), cmap_type)
                panels.append(cano_hand(h_rgb * alpha
                                        + (1 - alpha) * acc_cmap))
            elif mode == "acc_gt_eval":
                new_acc = acc_dist
                sk = posed_hand(aux_colors)
                acc_cmap = apply_colormap(acc_dist.clamp(0, 1), "gray")
                panels = [sk, posed_hand(acc_cmap)]
            else:  # nocs
                new_acc = acc_dist + h_d01
                panels.append(cano_hand(torch.where(
                    (h_d01 > 0)[:, None], aux_colors, 0.0)))
                panels.append(posed_object(torch.where(
                    (o_d01 > 0)[:, None], aux_colors[o_idx.long()], 0.0)))
            render = torch.cat(panels, dim=1)
        if stats is not None:
            stats["pair_overflow"] = torch.stack(overflow).max()
        return render, new_acc, h_d01

    return composite_render


def _skin_weights_traced(model: GaussianModel,
                         voxel_grid: Optional[VoxelGrid]):
    """The skin weights with the gradient through the grid sample to the
    positions, as the JAX fine-tune step takes it."""
    if voxel_grid is not None:
        return skinning_weights_from_voxel_grid(
            model.params.xyz, voxel_grid.center, voxel_grid.scale,
            voxel_grid.weights)
    return model.skin_weights


def make_composite_finetune_step(cfg: ExperimentConfig,
                                 raster_cfg: RasterConfig, optimize: str,
                                 voxel_grid: Optional[VoxelGrid] = None,
                                 hand_opts: GaussianOpts = GaussianOpts(),
                                 obj_opts: GaussianOpts = GaussianOpts()):
    """Composite fine-tuning (the reference's composite.py:27-35): one of
    the two models ("hand" or "object") trains on the full composite
    render's photometric loss (cfg.loss without lpips_loss), with masked
    Adam at group_learning_rates(cfg.model, step); the other is frozen
    and carries no gradient. Skin weights and the voxel grid are not
    trained.

    step(state, frozen_model, batch) -> (state, {loss, psnr}); `state` is
    a workloads.TrainState of the trainable model (init_train_state);
    batch: rgb [H, W, 3], mask [H, W, 1], camera (one), bg [3], bone_tf
    [B(+1), 4, 4]. psnr is of the masked render.

    Traced (utils/trace.py), a step opens make_train_step's spans
    (step.forward, step.backward, step.update) and counts the slots the
    trained model places in the scene: composite.rows_trained.
    """
    if optimize not in ("hand", "object"):
        raise ValueError(f"optimize must be 'hand' or 'object', got "
                         f"{optimize!r}")
    opts = cfg.model
    kept = [(n, w) for n, w in zip(cfg.loss.losses, cfg.loss.loss_weight)
            if n != "lpips_loss"]
    loss_names = tuple(n for n, _ in kept)
    loss_weights = tuple(w for _, w in kept)
    iso = (hand_opts if optimize == "hand" else obj_opts).isotropic_scaling

    def step(state: TrainState, frozen: GaussianModel, batch):
        trace.count("composite.rows_trained", state.model.capacity)
        with trace.span("step.forward"):
            params = GaussianParams(*(p.detach().requires_grad_(True)
                                      for p in state.model.params))
            train_model = state.model._replace(params=params)
            hand = train_model if optimize == "hand" else frozen
            obj = frozen if optimize == "hand" else train_model
            skin_w = _skin_weights_traced(hand, voxel_grid)
            (h_xyz, h_cov, h_tf), (o_xyz, o_cov, o_tf) = _scene(
                hand, obj, skin_w, batch["bone_tf"], hand_opts, obj_opts)
            hp, op_ = hand.params, obj.params
            out = render_gaussians(
                torch.cat([h_xyz, o_xyz]), torch.cat([h_cov, o_cov]),
                torch.cat([hp.xyz, op_.xyz]),
                torch.cat([get_features(hp), get_features(op_)]),
                torch.cat([get_opacity(hp)[:, 0], get_opacity(op_)[:, 0]]),
                batch["camera"], batch["bg"], sh_degree=3,
                tf=torch.cat([h_tf, o_tf]),
                active=torch.cat([hand.active, obj.active]),
                config=raster_cfg)
            total, _ = loss_mod.compute_losses(
                out.render, batch["rgb"], get_scaling(params, iso),
                train_model.active, loss_names, loss_weights,
                opts.condition_number)
        with trace.span("step.backward"):
            grads = torch.autograd.grad(total, list(params),
                                        allow_unused=True)
            grads = GaussianParams(*(torch.zeros_like(p) if g is None else g
                                     for g, p in zip(grads, params)))
        with trace.span("step.update"):
            lrs = optim_mod.group_learning_rates(opts, state.step)
            new_params, new_opt = optim_mod.adam_update(
                state.model.params, grads, state.opt, lrs, state.model.active)
            render = out.render.detach()
            metrics = dict(loss=total.detach(),
                           psnr=loss_mod.psnr(render * batch["mask"],
                                              batch["rgb"] * batch["mask"]))
            new_state = state._replace(
                model=state.model._replace(params=GaussianParams(
                    *(p.detach() for p in new_params))),
                opt=new_opt, step=state.step + 1)
        return new_state, metrics

    return step
