"""The training step of the object and hand (articulated LBS) workloads,
and the densification events between steps.

One step renders each view, sums the losses, takes gradients with
autograd, applies masked per-group Adam (and, with trainable point skin
weights, their own Adam), runs the mask-pruning phase and accumulates
densification statistics. Batches carry a leading view axis V; views are
an unrolled loop. Decisions that depend only on the step number are
taken on the host, and those that depend on data are tensor masks, so a
step or a densify event makes no host round-trip.

With a rank mesh (parallel/mesh.py) the step is the JAX package's
shard_map step: each rank takes its data row's views and its gauss
column's block of the gaussians, computes the gradients of that part,
and the reductions of manus_tpu/train/workloads.py:288-318 put the full
gradients together on every rank, where the update runs on the same
values everywhere.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from manus_tpu_torch.config import ExperimentConfig
from manus_tpu_torch.models import densify as densify_mod
from manus_tpu_torch.models.gaussians import (
    GaussianModel,
    GaussianOpts,
    GaussianParams,
    get_covariance,
    get_features,
    get_opacity,
    get_scaling,
)
from manus_tpu_torch.ops.grid_sample import skinning_weights_from_voxel_grid
from manus_tpu_torch.ops.mask_prune import points_outside_mask
from manus_tpu_torch.ops.rasterizer.api import RasterConfig, render_gaussians
from manus_tpu_torch.ops.skinning import skin_gaussians
from manus_tpu_torch.parallel.collectives import (
    all_gather_stack,
    all_gather_tiled,
    all_reduce_mean,
    broadcast,
)
from manus_tpu_torch.parallel.mesh import gauss_rows
from manus_tpu_torch.parallel.raster import (
    check_tile_shard_mode,
    render_sharded,
)
from manus_tpu_torch.train import lpips as lpips_mod
from manus_tpu_torch.train import optim as optim_mod
from manus_tpu_torch.utils import losses as loss_mod
from manus_tpu_torch.utils import trace
from manus_tpu_torch.utils.camera import index_camera


class VoxelGrid(NamedTuple):
    """The skinning-weight grid (data/voxel.py build_voxel_grid)."""

    center: torch.Tensor  # [3]
    scale: torch.Tensor  # [3]
    weights: torch.Tensor  # [D, H, W, B+1], the background channel last


class TrainState(NamedTuple):
    model: GaussianModel
    opt: optim_mod.AdamState
    stats: densify_mod.DensifyStats
    step: int
    gen: torch.Generator  # on the model's device: the split noise
    mask_pruned_flag: torch.Tensor  # [] bool: did mask-prune fire this step
    # Adam moments of the per-point skin weights; None without them
    skin_opt: Optional[optim_mod.ArrayAdamState] = None


def init_train_state(model: GaussianModel, seed: int = 0) -> TrainState:
    dev = model.active.device
    return TrainState(
        model=model,
        opt=optim_mod.init_adam(model.params),
        stats=densify_mod.init_stats(model.capacity, dev),
        step=0,
        gen=torch.Generator(device=dev).manual_seed(seed),
        mask_pruned_flag=torch.zeros((), dtype=torch.bool, device=dev),
        skin_opt=None if model.skin_weights is None
        else optim_mod.init_array_adam(model.skin_weights),
    )


def resolve_skin_weights(model: GaussianModel,
                         voxel_grid: Optional[VoxelGrid] = None
                         ) -> Optional[torch.Tensor]:
    """Voxel mode samples the weights from the grid at the current
    (detached) positions every step; points mode uses the stored ones."""
    if voxel_grid is not None:
        return skinning_weights_from_voxel_grid(
            model.params.xyz.detach(), voxel_grid.center, voxel_grid.scale,
            voxel_grid.weights)
    return model.skin_weights


def forward_gaussians(params: GaussianParams, active, skin_weights,
                      bone_tf: Optional[torch.Tensor], opts: GaussianOpts):
    """Object (identity pose) or hand (LBS). Returns (posed_xyz, posed_cov,
    tf or None); bone_tf: [B, 4, 4] rest->posed transforms."""
    cov_cano = get_covariance(params, isotropic=opts.isotropic_scaling)
    if bone_tf is None:
        return params.xyz, cov_cano, None
    sk = skin_gaussians(params.xyz, cov_cano, skin_weights, bone_tf)
    return sk.posed_xyz, sk.posed_cov, sk.tf


def make_raster_config(cfg: ExperimentConfig) -> RasterConfig:
    r = cfg.raster
    check_tile_shard_mode(r.tile_shard_mode)
    return RasterConfig(
        tg_max=r.tg_max, chunk=r.chunk,
        max_pairs_per_tile=r.max_pairs_per_tile, backend=r.backend,
        lane_align=r.lane_align, pair_budget_factor=r.pair_budget_factor,
        multi_frac=r.multi_frac, tile_shard_mode=r.tile_shard_mode,
        hot_split_tiles=r.hot_split_tiles,
    )


def make_train_step(cfg: ExperimentConfig, extent: float, articulated: bool,
                    voxel_grid: Optional[VoxelGrid] = None, mesh=None,
                    lpips_params=None):
    """The train step for one workload configuration.

    Batch (leading V = views per step): rgb [V,H,W,3], mask [V,H,W,1],
    cameras: a stacked Camera [V], bg [3], and for the hand bone_tf
    [B,4,4] (B+1: a voxel grid's background channel) and keypoints [K,3];
    optionally lpips_gt_feats, the gt's LPIPS stage features (a tuple of
    per-stage tensors with a leading V, lpips.lpips_features of each
    view), which skip the gt's VGG forward.
    lpips_params (an LPIPS params dict; packed here once for the layout
    chain) feeds the lpips_loss term from step opts.start_lpips_iter on,
    on the engine of cfg.loss.lpips_conv (lpips.resolve_lpips_engine). Returns
    step(state, batch) -> (state, metrics), metrics a dict of 0-d tensors.
    With voxel_grid (data/voxel.py make_voxel_grid) the skin weights are
    sampled from it every step; the hand takes one exactly when
    cfg.skin_init is "mano_init_voxel". With opts.optimize_skin_weights
    and no grid the model's per-point skin weights are trained at
    opts.skinning_lr and stay a convex blend.
    `extent` is read by the densify events (make_densify_step), not here.

    With `mesh` (parallel/mesh.py make_mesh, this rank a member) the batch
    is the rank's own views (mesh.shard_batch of the whole batch, or the
    views distributed.process_local_batch_indices names) and the state is
    the same on every rank (mesh.replicate_state). The rank computes the
    loss and gradients of its views and its block of the gaussians under
    cfg.raster.tile_shard_mode; the loss, parameter and skin-weight
    gradients are averaged over the data group, the parameter gradients
    divided by the gauss axis's size (each of its ranks computes the same
    loss from the gathered fields, so the gathers' sum-scatter counts each
    cotangent n_gauss times) and gathered over it, the viewspace gradients
    scaled by the local view count, averaged over the gauss group and
    gathered over the data group, and the overflow counts summed over the
    tile owners: the same metrics and new state on every rank.
    """
    del extent
    opts = cfg.model
    n_gauss = 1 if mesh is None else mesh.n_gauss
    g_group = None if mesh is None else mesh.gauss_group
    d_group = None if mesh is None else mesh.data_group
    if mesh is not None and not mesh.member:
        raise ValueError("this rank is not in the mesh")
    if articulated and (voxel_grid is not None) != (
            cfg.skin_init == "mano_init_voxel"):
        raise ValueError(
            f"skin_init {cfg.skin_init!r} with "
            f"{'a' if voxel_grid is not None else 'no'} voxel grid")
    # per-point weights are a leaf only without a grid
    train_sw = bool(opts.optimize_skin_weights) and voxel_grid is None
    raster_cfg = make_raster_config(cfg)
    loss_names = tuple(cfg.loss.losses)
    loss_weights = tuple(cfg.loss.loss_weight)
    width, height = cfg.dataset.width, cfg.dataset.height
    lpips_engine = "pallas"
    if lpips_params is not None and "lpips_loss" in loss_names:
        lpips_engine = lpips_mod.resolve_lpips_engine(cfg.loss.lpips_conv,
                                                      lpips_params)
        if lpips_engine == "pallas":
            lpips_params = lpips_mod.pack_lpips_params(lpips_params)

    def loss_fn(params, m2d_off, active, skin_w, batch, lpips_on: bool,
                active_full):
        posed_xyz, posed_cov, tf = forward_gaussians(
            params, active, skin_w, batch.get("bone_tf"), opts)
        feats = get_features(params)
        opac = get_opacity(params)
        scaling = get_scaling(params, opts.isotropic_scaling)
        # the loss terms that reduce over the gaussians see the whole cloud,
        # so that every gauss rank computes the same loss
        scaling_full = all_gather_tiled(scaling, g_group)
        totals, radii, parts, overflow = [], [], [], []
        gt_feats = batch.get("lpips_gt_feats")
        for i in range(batch["rgb"].shape[0]):
            args = (posed_xyz, posed_cov, params.xyz, feats, opac,
                    index_camera(batch["cameras"], i), batch["bg"])
            kw = dict(sh_degree=opts.sh_degree, tf=tf, active=active,
                      means2d_offset=m2d_off[i], config=raster_cfg)
            out = (render_sharded(*args, **kw, group=g_group, n=n_gauss)
                   if n_gauss > 1 else render_gaussians(*args, **kw))
            total, part = loss_mod.compute_losses(
                out.render, batch["rgb"][i], scaling_full, active_full,
                loss_names,
                loss_weights, opts.condition_number,
                lpips_params=lpips_params, lpips_enabled=lpips_on,
                lpips_downsample=cfg.loss.lpips_downsample,
                lpips_engine=lpips_engine,
                lpips_gt_feats=None if gt_feats is None
                else [f[i] for f in gt_feats])
            if i == 0:
                psnr = loss_mod.psnr(out.render.detach(), batch["rgb"][0])
            totals.append(total)
            radii.append(out.radii)
            parts.append(part)
            overflow.append(torch.stack([out.overflow, out.overflow_far]))
        radii = torch.stack(radii)
        aux = dict(
            radii=radii, max_radius=radii.max(),
            psnr=psnr,
            parts={k: torch.stack([p[k] for p in parts]) for k in parts[0]},
            posed_xyz=posed_xyz.detach(), overflow=torch.stack(overflow),
        )
        return torch.stack(totals).mean(), aux

    def _reduce_over_mesh(loss, g_params, g_sw, g_m2d, aux, do_stats: bool):
        """The JAX step's reductions (workloads.py:288-318) and out_specs:
        everything the update reads, the same on every rank."""
        loss = all_reduce_mean(loss, d_group)

        def param_grad(g):
            g = all_reduce_mean(g, d_group) / n_gauss
            return all_gather_tiled(g, g_group)

        g_params = GaussianParams(*(param_grad(g) for g in g_params))
        if g_sw is not None:
            g_sw = param_grad(g_sw)
        aux = dict(aux, posed_xyz=all_gather_tiled(aux["posed_xyz"], g_group))
        if do_stats:
            # the viewspace gradients and radii of every view, in view order
            g_m2d = all_gather_tiled(all_reduce_mean(g_m2d, g_group), d_group)
            aux["radii"] = all_gather_tiled(aux["radii"], d_group)
        # per-view metrics of every data row; the psnr is the first view's
        parts = aux["parts"]
        per_view = torch.stack([aux["overflow"][:, 0].float(),
                                aux["overflow"][:, 1].float(),
                                *(parts[k].detach() for k in parts)], 1)
        rows = all_gather_tiled(per_view, d_group)
        head = all_gather_stack(torch.stack(
            [aux["psnr"], aux["max_radius"].float()]), d_group)
        aux.update(
            overflow=rows[:, :2].to(aux["overflow"].dtype),
            parts={k: rows[:, 2 + i] for i, k in enumerate(parts)},
            psnr=head[0, 0], max_radius=head[:, 1].max().to(torch.int32))
        return loss, g_params, g_sw, g_m2d, aux

    def update(state: TrainState, batch, loss, g_params, g_sw, g_m2d, aux,
               do_stats: bool):
        """Adam, the mask prune and the densify statistics: the new state
        and the step's metrics."""
        model, step = state.model, state.step
        n = model.capacity
        lrs = optim_mod.group_learning_rates(opts, step)
        new_params, new_opt = optim_mod.adam_update(
            model.params, g_params, state.opt, lrs, model.active)
        loss = loss.detach()
        new_sw, new_skin_opt = model.skin_weights, state.skin_opt
        if train_sw:
            # masked Adam, then clamp >= 0 and renormalise, so the LBS blend
            # stays a convex combination of bone transforms
            new_sw, new_skin_opt = optim_mod.array_adam_update(
                model.skin_weights, g_sw, state.skin_opt,
                opts.skinning_lr, model.active, new_opt.step)
            new_sw = new_sw.clamp(min=0.0)
            norm = new_sw.sum(-1, keepdim=True)
            new_sw = torch.where(model.active[:, None] & (norm > 1e-8),
                                 new_sw / norm.clamp(min=1e-8),
                                 model.skin_weights)

        # mask pruning phase (reference on_after_backward)
        in_seg_phase = opts.remove_seg_start <= step < opts.remove_seg_end
        posed = aux["posed_xyz"]
        outside = torch.zeros(n, dtype=torch.bool, device=posed.device)
        if in_seg_phase:
            # against the batch's first view, which the data group's first
            # rank holds
            if mesh is None or mesh.data_index == 0:
                outside = points_outside_mask(
                    index_camera(batch["cameras"], 0), posed,
                    batch["mask"][0],
                    keypoints=batch.get("keypoints") if articulated else None,
                    dilate=articulated, active=model.active,
                )
            outside = broadcast(outside.to(torch.uint8), 0, d_group).bool()
        elif articulated and step % 100 == 0 and step >= opts.remove_seg_end:
            # distance-to-skeleton prune every 100 steps after the seg phase
            kp = batch["keypoints"]
            dist = torch.linalg.norm(
                posed[:, None, :] - kp[None, :, :], dim=-1).mean(1)
            outside = (dist > opts.skeleton_dist_threshold) & model.active
        do_prune = outside.any()
        # an all-false mask leaves active and the moments as they are
        new_active = model.active & ~outside
        new_opt = optim_mod.reset_moments_rows(new_opt, outside)
        if new_skin_opt is not None:
            new_skin_opt = optim_mod.array_reset_rows(new_skin_opt, outside)

        # densification stats, skipped on mask-prune steps
        new_stats = state.stats
        if do_stats:
            acc = new_stats
            for i in range(g_m2d.shape[0]):
                acc = densify_mod.accumulate_stats(
                    acc, g_m2d[i], aux["radii"][i], width, height)
            new_stats = densify_mod.DensifyStats(*(
                torch.where(do_prune, old, new)
                for old, new in zip(state.stats, acc)))

        metrics = dict(
            loss=loss,
            psnr=aux["psnr"],
            num_active=new_active.sum(),
            mask_pruned=outside.sum(),
            pair_overflow=aux["overflow"][:, 0].max(),
            pair_overflow_far=aux["overflow"][:, 1].max(),
            max_radius=aux["max_radius"],
        )
        for k, val in aux["parts"].items():
            metrics[f"loss/{k}"] = val.detach().mean()
        trace.count("gaussians.live", metrics["num_active"])

        new_state = state._replace(
            model=model._replace(params=GaussianParams(
                *(p.detach() for p in new_params)), active=new_active,
                skin_weights=new_sw),
            opt=new_opt,
            stats=new_stats,
            step=step + 1,
            mask_pruned_flag=do_prune,
            skin_opt=new_skin_opt,
        )
        return new_state, metrics

    def train_step(state: TrainState, batch):
        v = batch["rgb"].shape[0]
        model = state.model
        n = model.capacity
        step = state.step
        # this rank's block of the gaussians (all of them without a mesh)
        rows = slice(0, n) if mesh is None else gauss_rows(n, mesh)
        skin_w = resolve_skin_weights(model, voxel_grid)
        skin_w = None if skin_w is None else skin_w[rows]
        params = GaussianParams(*(p[rows].detach().requires_grad_(True)
                                  for p in model.params))
        m2d = torch.zeros(v, n, 2, device=model.active.device,
                          requires_grad=True)
        leaves = [*params, m2d]
        if train_sw:
            skin_w = skin_w.detach().requires_grad_(True)
            leaves.append(skin_w)
        # the start_lpips_iter gate (reference base.py:333-341)
        lpips_on = step >= opts.start_lpips_iter
        do_stats = step < opts.densify_until_step
        with trace.span("step.forward"):
            loss, aux = loss_fn(params, m2d, model.active[rows], skin_w,
                                batch, lpips_on, model.active)
        with trace.span("step.backward"):
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            grads = [torch.zeros_like(x) if g is None else g
                     for g, x in zip(grads, leaves)]
            # loss averages the views: rescale to per-view-loss gradients,
            # so densify thresholds do not depend on the number of views
            g_m2d = grads[len(params)] * v
            g_sw = grads[-1] if train_sw else None
            g_params = GaussianParams(*grads[:len(params)])
            if mesh is not None:
                loss, g_params, g_sw, g_m2d, aux = _reduce_over_mesh(
                    loss.detach(), g_params, g_sw, g_m2d, aux, do_stats)
        with trace.span("step.update"):
            return update(state, batch, loss, g_params, g_sw, g_m2d, aux,
                          do_stats)

    return train_step


def make_densify_step(cfg: ExperimentConfig, extent: float):
    """(densify_step, opacity_reset_step), each state -> state (and the
    densify step's info). The split noise is drawn from state.gen on the
    state's device; the size prune runs once the step is past
    opts.opacity_reset_interval, a host decision on the int step."""
    opts = cfg.model

    def densify_step(state: TrainState):
        cap = state.model.capacity
        noise = torch.randn((2, cap, 3), generator=state.gen,
                            device=state.model.active.device)
        model, opt, stats, info = densify_mod.densify_and_prune(
            state.model, state.opt, state.stats, opts, extent, noise,
            use_size_threshold=state.step > opts.opacity_reset_interval)
        skin_opt = state.skin_opt
        if skin_opt is not None:
            # written and killed slots are exactly the activity flips
            # (children land in free slots)
            skin_opt = optim_mod.array_reset_rows(
                skin_opt, model.active != state.model.active)
        return state._replace(model=model, opt=opt, stats=stats,
                              skin_opt=skin_opt), info

    def opacity_reset_step(state: TrainState):
        model, opt = densify_mod.reset_opacity(state.model, state.opt)
        return state._replace(model=model, opt=opt)

    return densify_step, opacity_reset_step


def make_eval_step(cfg: ExperimentConfig, articulated: bool,
                   voxel_grid: Optional[VoxelGrid] = None,
                   lpips_params: Optional[dict] = None):
    """One view's render and metrics for validation, with no gradient.

    eval_step(model, cam, rgb [H,W,3], mask [H,W,1], bg [3], bone_tf=None)
    -> dict of render [H,W,3], psnr, ssim and lpips (of the masked render
    against the masked gt; lpips 0 without lpips_params, the AlexNet or
    VGG16 params of train/lpips.py), posed_xyz [N,3] for the PLY dumps,
    and the pair overflow counts. `articulated` is implied by bone_tf.
    """
    del articulated
    opts = cfg.model
    raster_cfg = make_raster_config(cfg)

    def eval_step(model: GaussianModel, cam, rgb, mask, bg, bone_tf=None):
        with torch.no_grad():
            skin_w = resolve_skin_weights(model, voxel_grid)
            posed_xyz, posed_cov, tf = forward_gaussians(
                model.params, model.active, skin_w, bone_tf, opts)
            out = render_gaussians(
                posed_xyz, posed_cov, model.params.xyz,
                get_features(model.params), get_opacity(model.params), cam,
                bg, sh_degree=opts.sh_degree, tf=tf, active=model.active,
                config=raster_cfg,
            )
            render = out.render * mask
            gt = rgb * mask
            metrics = dict(
                render=out.render,
                psnr=loss_mod.psnr(render, gt),
                ssim=loss_mod.ssim(render, gt),
                lpips=render.new_zeros(()) if lpips_params is None
                else lpips_mod.lpips_distance(lpips_params, render, gt),
                posed_xyz=posed_xyz,
                pair_overflow=out.overflow,
                pair_overflow_far=out.overflow_far,
            )
        return metrics

    return eval_step
