"""The training loop on the host: batches, the densify cadence, validation,
CSV metrics and checkpoints.

Drives the train step and the densify events of train/workloads.py at
the reference's cadences (gaussian_utils.py:451-502, main.py): densify
every `densification_interval` steps inside the densify window (not on a
step that pruned by mask), the opacity reset every
`opacity_reset_interval` steps (and at densify_from_step on a white
background), a one-shot LoOP outlier prune at `remove_outliers_step`,
and validation and checkpoints on their own intervals. The files are the
JAX package's: results/val_results.csv, logs/train_metrics.csv,
logs/events.jsonl, results/val_results/{images,gaussians}/ and
checkpoints/step%06d-loss%.6f[-vpsnr%.4f].npz.

The trainer keeps a private copy of the config: it may leave lpips_loss
out of the training loss, and the caller's config (the one the CLI
snapshots) stays as it was given.

With trainer.data_axis or trainer.gauss_axis > 1 it trains over a rank
mesh (parallel/distributed.make_multihost_mesh, one process a rank,
the process group already joined): the state is replicated from the
first rank, every rank draws the same batch from the same seed and
loads only its data row's views, and the sharded step leaves the same
state on every rank. Only the mesh's first rank writes files (CSVs,
logs, images, PLYs, checkpoints); the others wait for it at a barrier
after each checkpoint.
"""
from __future__ import annotations

import copy
import csv
import dataclasses
import json
import os
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from manus_tpu_torch.config import ExperimentConfig, config_to_dict
from manus_tpu_torch.data.prefetch import PrefetchLoader
from manus_tpu_torch.data.voxel import visualize_skin_weights
from manus_tpu_torch.models.densify import prune_by_mask
from manus_tpu_torch.ops.outliers import outlier_mask
from manus_tpu_torch.ops.skinning import bone_deformation_transforms
from manus_tpu_torch.parallel.distributed import (
    make_multihost_mesh,
    process_local_batch_indices,
)
from manus_tpu_torch.parallel.mesh import check_replicated, replicate_state
from manus_tpu_torch.train import checkpoint as ckpt_mod
from manus_tpu_torch.train import lpips as lpips_mod
from manus_tpu_torch.train.optim import array_reset_rows
from manus_tpu_torch.train.workloads import (
    VoxelGrid,
    init_train_state,
    make_densify_step,
    make_eval_step,
    make_train_step,
    resolve_skin_weights,
)
from manus_tpu_torch.utils import trace
from manus_tpu_torch.utils.camera import index_camera
from manus_tpu_torch.utils.io import concat_images, dump_image, dump_points

MIB = 1 << 20


class MetricsCSV:
    """A CSV file with a header, one row appended per write; with
    enabled False (a rank that does not write) it writes nothing."""

    def __init__(self, path: str, header, enabled: bool = True):
        self.path = path
        self.enabled = enabled
        if not enabled:
            return
        os.makedirs(os.path.dirname(path), exist_ok=True)
        if not os.path.exists(path):
            with open(path, "w", newline="") as f:
                csv.writer(f).writerow(header)

    def write(self, row):
        if not self.enabled:
            return
        with open(self.path, "a", newline="") as f:
            csv.writer(f).writerow(row)


class ScalarLoggers:
    """Scalar sinks besides the CSVs: wandb when asked for and importable,
    jsonl (logs/events.jsonl) as an offline event stream."""

    def __init__(self, names, out_dir: str, run_name: str, config: dict,
                 log=print):
        self.wandb = None
        self.jsonl = None
        if "wandb" in names:
            try:
                import wandb

                self.wandb = wandb.init(project="manus_tpu", name=run_name,
                                        config=config, dir=out_dir)
            except Exception as e:  # the package is absent, or offline
                log(f"[loggers] wandb unavailable ({e}); csv/jsonl only")
        if "jsonl" in names:
            os.makedirs(os.path.join(out_dir, "logs"), exist_ok=True)
            self.jsonl = open(os.path.join(out_dir, "logs", "events.jsonl"),
                              "a")

    def log_scalars(self, step: int, scalars: dict):
        if self.wandb is not None:
            self.wandb.log(scalars, step=step)
        if self.jsonl is not None:
            self.jsonl.write(json.dumps({"step": step, **scalars}) + "\n")
            self.jsonl.flush()

    def close(self):
        if self.wandb is not None:
            self.wandb.finish()
        if self.jsonl is not None:
            self.jsonl.close()


def _strip_loss(loss_cfg, name: str):
    keep = [i for i, nm in enumerate(loss_cfg.losses) if nm != name]
    return dataclasses.replace(
        loss_cfg, losses=tuple(loss_cfg.losses[i] for i in keep),
        loss_weight=tuple(loss_cfg.loss_weight[i] for i in keep))


class Trainer:
    """Single-workload trainer (object or hand) on the model's device,
    over a rank mesh when the config's axes ask for one.

    `timings["step_s"]` holds the host seconds of each fit iteration,
    from the batch to the log block, with no synchronise (the benchmark's
    hand_train driver reads it). The loop's layers are spans of
    utils/trace.py, recorded when that is enabled.
    """

    def __init__(
        self,
        cfg: ExperimentConfig,
        dataset,
        model,
        articulated: bool,
        voxel_grid: Optional[VoxelGrid] = None,
        out_dir: Optional[str] = None,
        val_dataset=None,
        log=print,
    ):
        self.device = model.active.device
        cfg = copy.deepcopy(cfg)
        self.cfg = cfg
        self.log = log
        self.dataset = dataset
        # held-out data; without it validate() uses train views and says so
        self.val_dataset = val_dataset
        self._warned_train_val = False
        self.articulated = articulated
        self.voxel_grid = voxel_grid
        self.out_dir = out_dir or os.path.join(
            cfg.trainer.output_dir, cfg.trainer.project,
            cfg.dataset.subject or "synthetic", cfg.trainer.exp_name,
        )
        self.ckpt_dir = os.path.join(self.out_dir, "checkpoints")
        self.mesh = None
        if cfg.trainer.data_axis > 1 or cfg.trainer.gauss_axis > 1:
            assert cfg.trainer.batch_views % cfg.trainer.data_axis == 0, (
                "batch_views must divide evenly over data_axis")
            assert cfg.capacity % cfg.trainer.gauss_axis == 0, (
                "capacity must divide evenly over gauss_axis")
            self.mesh = make_multihost_mesh(n_data=cfg.trainer.data_axis,
                                            n_gauss=cfg.trainer.gauss_axis)
        # the rank that writes files: the mesh's first, or the only one
        self.writer = self.mesh is None or self.mesh.is_first
        if self.writer:
            os.makedirs(self.out_dir, exist_ok=True)

        self.state = init_train_state(model, seed=cfg.trainer.seed)
        if self.mesh is not None:
            self.state = replicate_state(self.state, self.mesh)
            m, v = self.mesh, cfg.trainer.batch_views
            log(f"[mesh] {m.n_data}x{m.n_gauss}: rank {m.rank} at data row "
                f"{m.data_index}, gauss column {m.gauss_index}; loads views "
                f"{process_local_batch_indices(v, m).tolist()} of each "
                f"batch of {v}, shard mode {cfg.raster.tile_shard_mode}")
        self.timings = dict(step_s=[])
        # two LPIPS nets, as in the reference (loss_utils.py:17-19): VGG16
        # for the training loss, AlexNet for the val metric; each falls
        # back to a seeded random-feature net, and val_results.csv says
        # which in its lpips_mode column
        self.lpips_params = self.lpips_eval_params = None
        self.lpips_mode = self.lpips_eval_mode = "off"
        if "lpips_loss" in cfg.loss.losses or cfg.loss.lpips_weights:
            params, self.lpips_mode = lpips_mod.resolve_lpips_params_mode(
                cfg.loss.lpips_weights, cfg.loss.lpips_fallback,
                seed=cfg.trainer.seed, log=log, arch="vgg",
                device=self.device)
            if params is not None:
                self.lpips_params = lpips_mod.pack_lpips_params(params)
            self.lpips_eval_params, self.lpips_eval_mode = (
                lpips_mod.resolve_lpips_params_mode(
                    cfg.loss.lpips_eval_weights, cfg.loss.lpips_fallback,
                    seed=cfg.trainer.seed, log=log, arch="alex",
                    device=self.device))
        # a random-feature VGG16 is not the reference's loss: it stays out
        # of the training loss unless loss.lpips_random_in_loss is set
        if ("lpips_loss" in cfg.loss.losses
                and self.lpips_mode.endswith("random-feature")
                and not cfg.loss.lpips_random_in_loss):
            cfg.loss = _strip_loss(cfg.loss, "lpips_loss")
            log("[lpips] lpips_loss REMOVED from the training loss: only "
                "random-feature weights are available and "
                "loss.lpips_random_in_loss is false (the val metric "
                "column stays live). Supply pretrained weights "
                "(loss.lpips_weights=...) to restore the reference loss.")
        self.train_step = make_train_step(
            cfg, dataset.extent, articulated, voxel_grid, mesh=self.mesh,
            lpips_params=self.lpips_params)
        self.densify_step, self.opacity_reset = make_densify_step(
            cfg, dataset.extent)
        self.eval_step = make_eval_step(
            cfg, articulated, voxel_grid, lpips_params=self.lpips_eval_params)
        self.val_csv = MetricsCSV(
            os.path.join(self.out_dir, "results", "val_results.csv"),
            ["name", "step", "psnr", "ssim", "lpips", "rendering_time",
             "pair_overflow", "lpips_mode"], enabled=self.writer,
        )
        self.train_csv = MetricsCSV(
            os.path.join(self.out_dir, "logs", "train_metrics.csv"),
            ["step", "loss", "psnr", "num_active", "iters_per_s"],
            enabled=self.writer,
        )
        self.loggers = ScalarLoggers(
            cfg.trainer.loggers if self.writer else (), self.out_dir,
            cfg.trainer.exp_name, config_to_dict(cfg), log=log)
        self._rng = np.random.RandomState(cfg.trainer.seed)
        self.bg = (np.ones(3, np.float32) if cfg.dataset.bg_color == "white"
                   else np.zeros(3, np.float32))
        self._bg_dev = torch.as_tensor(self.bg, device=self.device)
        self._device_cache = self._build_device_cache()
        self._lpips_feat_cache = self._build_lpips_feat_cache()
        self._eval_warmed = False

    # ---- batching -------------------------------------------------------
    def _build_device_cache(self):
        """The whole [F, V, H, W, 3] rgb and [F, V, H, W, 1] mask on the
        device when they fit under trainer.device_cache_mb, so a step's
        batch is a gather there; None when off or too big."""
        cfg = self.cfg
        ds = self.dataset
        f_n = ds.num_frames if self.articulated else 1
        px = f_n * ds.num_views * cfg.dataset.height * cfg.dataset.width
        if cfg.trainer.device_cache_mb <= 0:
            return None
        if px * 4 * 4 > cfg.trainer.device_cache_mb * MIB:
            return None
        all_views = np.arange(ds.num_views)
        rgb, mask = [], []
        for f in range(f_n):
            raw = ds.get_batch(f, all_views)
            rgb.append(np.asarray(raw["rgb"], np.float32))
            mask.append(np.asarray(raw["mask"], np.float32))
        return (torch.as_tensor(np.stack(rgb), device=self.device),
                torch.as_tensor(np.stack(mask), device=self.device))

    def _build_lpips_feat_cache(self):
        """The gt LPIPS stage features of every device-cached image,
        computed once (lpips.lpips_features, at the loss's downsample, on
        the loss's engine): the step then skips the gt's VGG forward. A
        tuple of per-stage [F, V, ...] tensors, or None when off: no
        lpips_loss, over
        loss.lpips_gt_cache_mb, no image cache, or a random background."""
        cfg = self.cfg
        if (self.lpips_params is None
                or "lpips_loss" not in cfg.loss.losses
                or cfg.loss.lpips_gt_cache_mb <= 0
                or cfg.dataset.bg_color == "random"
                or self._device_cache is None):
            return None
        engine = lpips_mod.resolve_lpips_engine(cfg.loss.lpips_conv,
                                                self.lpips_params)
        k = cfg.loss.lpips_downsample
        rgb_all, _ = self._device_cache
        f_n, v_n = rgb_all.shape[:2]

        def feats(img):
            return lpips_mod.lpips_features(self.lpips_params,
                                            lpips_mod.pool_avg(img, k),
                                            engine)

        with torch.no_grad():
            first = feats(rgb_all[0, 0])
            per_img = sum(a.numel() * a.element_size() for a in first)
            total_mb = per_img * f_n * v_n / MIB
            if total_mb > cfg.loss.lpips_gt_cache_mb:
                self.log(f"[lpips] gt-feature cache skipped: {total_mb:.0f} "
                         f"MB over loss.lpips_gt_cache_mb="
                         f"{cfg.loss.lpips_gt_cache_mb}")
                return None
            cache = tuple(a.new_empty((f_n, v_n) + tuple(a.shape))
                          for a in first)
            for f in range(f_n):
                for v in range(v_n):
                    fs = first if f == v == 0 else feats(rgb_all[f, v])
                    for dst, a in zip(cache, fs):
                        dst[f, v] = a
        self.log(f"[lpips] gt-feature cache: {f_n * v_n} images, "
                 f"{total_mb:.0f} MB ({engine})")
        return cache

    def sample_batch(self):
        """The next batch: a frame and batch_views views drawn from the
        trainer's seed; over a mesh the same draw on every rank, of which
        each loads its own views (process_local_batch_indices)."""
        v = self.cfg.trainer.batch_views
        ds = self.dataset
        f = self._rng.randint(0, ds.num_frames) if self.articulated else 0
        views = self._rng.randint(0, ds.num_views, size=v)
        if self.mesh is not None:
            views = views[process_local_batch_indices(v, self.mesh)]
        random_bg = self.cfg.dataset.bg_color == "random"
        if random_bg:
            # a fresh background each fetch, composited into the gt and
            # passed to the renderer (the reference's get_bg_color)
            bg = torch.as_tensor(self._rng.rand(3).astype(np.float32),
                                 device=self.device)
        else:
            bg = self._bg_dev
        idx = torch.as_tensor(views, device=self.device)
        if self._device_cache is not None:
            rgb_all, mask_all = self._device_cache
            rgb, mask = rgb_all[f, idx], mask_all[f, idx]
        else:
            raw = ds.get_batch(f, views)
            rgb = torch.as_tensor(np.asarray(raw["rgb"], np.float32),
                                  device=self.device)
            mask = torch.as_tensor(np.asarray(raw["mask"], np.float32),
                                   device=self.device)
        if random_bg:
            rgb = rgb * mask + bg * (1.0 - mask)
        batch = dict(rgb=rgb, mask=mask, cameras=index_camera(ds.cameras, idx),
                     bg=bg)
        if self._lpips_feat_cache is not None:
            batch["lpips_gt_feats"] = tuple(a[f, idx]
                                            for a in self._lpips_feat_cache)
        if self.articulated:
            batch["bone_tf"] = self._bone_tf(f)
            batch["keypoints"] = ds.bones_posed[f].keypoints()
        return batch

    def _bone_tf(self, frame: int, ds=None):
        ds = ds if ds is not None else self.dataset
        return bone_deformation_transforms(
            ds.bones_posed[frame].transforms, ds.bones_rest.transforms,
            append_identity=self.voxel_grid is not None)

    # ---- training -------------------------------------------------------
    def fit(self, max_steps: Optional[int] = None):
        cfg = self.cfg
        max_steps = max_steps or cfg.trainer.max_steps
        self._log_mark = (time.time(), 0)
        last_loss = float("inf")
        # a producer thread keeps batches ready (the reference's DataLoader
        # workers)
        loader = PrefetchLoader(self.sample_batch, depth=2,
                                device=self.device)
        try:
            for step in range(max_steps):
                with trace.span("fit.step", step=step):
                    t_step = time.perf_counter()
                    with trace.span("fit.batch_wait", seq=loader.n_got):
                        batch = next(loader)
                    with trace.span("fit.train_step"):
                        self.state, metrics = self.train_step(self.state,
                                                              batch)
                    self._events(step)
                    if (step % cfg.trainer.log_every == 0
                            or step == max_steps - 1):
                        with trace.span("fit.log"):
                            last_loss = self._log_step(step, metrics)
                    self.timings["step_s"].append(time.perf_counter()
                                                  - t_step)
                    val_due = (cfg.trainer.val_every and step > 0
                               and step % cfg.trainer.val_every == 0)
                    ckpt_due = (cfg.trainer.checkpoint_every and step > 0
                                and step % cfg.trainer.checkpoint_every == 0)
                    # a checkpoint is val-keyed when held-out data exists,
                    # so "best" resolves on the val metric
                    if val_due or (ckpt_due and self._can_val_key()):
                        self.validate(step)
                    if ckpt_due:
                        self.save(step, last_loss)
        finally:
            loader.close()
        if self._can_val_key():
            self.validate(max_steps)
        self.save(max_steps, last_loss)
        return self.state

    def _events(self, step: int):
        """The densify event and the opacity reset due after `step`."""
        cfg, opts, log = self.cfg, self.cfg.model, self.log
        densify_due = (
            opts.densify
            and opts.densify_from_step < step < opts.densify_until_step
            and step % opts.densification_interval == 0
        )
        reset_due = (
            step % opts.opacity_reset_interval == 0 and step != 0
        ) or (
            cfg.dataset.bg_color == "white"
            and step == opts.densify_from_step
        )
        if densify_due:
            # the reference skips densify on mask-prune steps
            if bool(self.state.mask_pruned_flag):
                log(f"[densify] step {step}: skipped (mask-prune step)")
            else:
                with trace.span("fit.densify", step=step):
                    self.state, info = self.densify_step(self.state)
                log(f"[densify] step {step}: active="
                    f"{int(info['num_active'])} "
                    f"clones={int(info['clones'])} "
                    f"splits={int(info['splits'])} "
                    f"pruned={int(info['pruned'])} "
                    f"dropped={int(info['alloc_dropped'])}")
                # the one-shot statistical outlier prune, at the densify
                # event of remove_outliers_step (reference
                # gaussian_utils.py:484, gaussian.py:323-326)
                if step == opts.remove_outliers_step:
                    self.state, n_out = self._remove_outliers()
                    log(f"[outliers] step {step}: removed {n_out}")
        if reset_due and step != 0:
            with trace.span("fit.opacity_reset", step=step):
                self.state = self.opacity_reset(self.state)
            log(f"[reset] step {step}: opacity reset")

    def _log_step(self, step: int, metrics: dict) -> float:
        """The log_every row: the CSV, the scalar loggers and the log line
        (each value read from the device). Returns the step's loss."""
        now = time.time()
        t_last, step_last = self._log_mark
        ips = (step - step_last) / max(now - t_last, 1e-9)
        self._log_mark = (now, step)
        loss = float(metrics["loss"])
        psnr = float(metrics["psnr"])
        n_act = int(metrics["num_active"])
        self.train_csv.write([step, loss, psnr, n_act, round(ips, 2)])
        scalars = dict(loss=loss, psnr=psnr, num_active=n_act,
                       iters_per_s=ips)
        if self.cfg.trainer.log_losses:
            scalars.update({k: float(v) for k, v in metrics.items()
                            if k.startswith("loss/")})
        self.loggers.log_scalars(step, scalars)
        # ovf: all dropped pairs; far: those the per-tile cap dropped
        # (farthest, mostly past early exit)
        self.log(f"step {step}: loss={loss:.5f} psnr={psnr:.2f} "
                 f"active={n_act} it/s={ips:.1f} "
                 f"maxrad={int(metrics['max_radius'])} "
                 f"ovf={int(metrics['pair_overflow'])} "
                 f"far={int(metrics['pair_overflow_far'])}")
        return loss

    def _can_val_key(self):
        return self.val_dataset is not None and bool(
            self.cfg.trainer.val_every)

    def final_val_psnr(self, step: int):
        """Held-out PSNR at `step`: fit()'s validation at that step, or a
        new one."""
        if getattr(self, "_val_step", None) == step:
            return self._val_psnr
        return self.validate(step)

    def _remove_outliers(self):
        """The one-shot LoOP outlier prune (prob 0.8 on canonical xyz,
        ops/outliers.py)."""
        model = self.state.model
        mask = outlier_mask(model.params.xyz, model.active, prob=0.8)
        new_model, new_opt, n = prune_by_mask(model, self.state.opt, mask)
        state = self.state._replace(model=new_model, opt=new_opt)
        if state.skin_opt is not None:
            state = state._replace(
                skin_opt=array_reset_rows(state.skin_opt, mask))
        return state, int(n)

    # ---- validation -----------------------------------------------------
    def _val_items(self, ds, num_views: int):
        """(frame, view) pairs of one validation: every held-out view and
        frame with trainer.val_full_sweep, else `num_views` views, at up to
        4 evenly spaced frames of a dynamic scene."""
        if self.cfg.trainer.val_full_sweep:
            frames = range(getattr(ds, "num_frames", 1)) if (
                self.articulated) else [0]
            return [(int(f), v) for f in frames for v in range(ds.num_views)]
        views = range(min(num_views, ds.num_views)) if num_views else range(
            ds.num_views)
        if not self.articulated:
            return [(0, v) for v in views]
        n_frames = min(getattr(ds, "num_frames", 1), 4)
        frames = np.unique(np.linspace(0, ds.num_frames - 1,
                                       n_frames).astype(int))
        return [(int(f), v) for f in frames for v in views]

    def _eval_item(self, ds, f: int, vi: int):
        """One held-out (frame, view) item through the eval step."""
        raw = ds.get_batch(f, np.asarray([vi]))
        rgb = torch.as_tensor(np.asarray(raw["rgb"][0], np.float32),
                              device=self.device)
        mask = torch.as_tensor(np.asarray(raw["mask"][0], np.float32),
                               device=self.device)
        extra = dict(bone_tf=self._bone_tf(f, ds)) if self.articulated else {}
        out = self.eval_step(self.state.model, index_camera(ds.cameras, vi),
                             rgb, mask, self._bg_dev, **extra)
        return raw, out

    def validate(self, step: int, num_views: int = 2,
                 dump_artifacts: bool = True):
        log = self.log
        ds = self.val_dataset
        if ds is None:
            ds = self.dataset
            if not self._warned_train_val:
                log("[val] WARNING: no held-out val dataset — validating on "
                    "TRAIN views (numbers are train PSNR)")
                self._warned_train_val = True
        val_dir = os.path.join(self.out_dir, "results", "val_results")
        per_item_rows = self.cfg.trainer.val_full_sweep
        items = self._val_items(ds, num_views)
        if not self._eval_warmed:
            # one untimed item first, so that the first timed one does not
            # carry the kernels' first launch (the rendering_time column)
            _, out0 = self._eval_item(ds, *items[0])
            out0["render"].cpu()
            self._eval_warmed = True
        psnrs, ssims, lpipss, times, ovfs = [], [], [], [], []
        for idx, (f, vi) in enumerate(items):
            t0 = time.time()
            raw, out = self._eval_item(ds, f, vi)
            pred = out["render"].cpu().numpy()
            times.append(time.time() - t0)
            psnrs.append(float(out["psnr"]))
            ssims.append(float(out["ssim"]))
            lpipss.append(float(out["lpips"]))
            ovfs.append(int(out["pair_overflow"]))
            if per_item_rows:
                self.val_csv.write(
                    [f"{self.cfg.trainer.exp_name}/f{f}_v{vi}", step,
                     psnrs[-1], ssims[-1], lpipss[-1], times[-1], ovfs[-1],
                     self.lpips_eval_mode])
            if dump_artifacts and self.writer:
                # pred | gt | diff strip (reference base.py:112-131)
                gt = np.asarray(raw["rgb"][0], np.float32)
                diff = np.abs(gt - np.clip(pred, 0, 1))
                dump_image(concat_images(np.clip(pred, 0, 1), gt, diff),
                           os.path.join(val_dir, "images", f"{step}_{idx}.png"))
                if idx == 0:
                    self._dump_gaussians(out, val_dir, step)
        self.val_csv.write(
            [self.cfg.trainer.exp_name, step, np.mean(psnrs), np.mean(ssims),
             np.mean(lpipss), np.mean(times), int(np.max(ovfs)),
             self.lpips_eval_mode])
        # the held-out metric that keys "best" (not the train-view fallback)
        if self.val_dataset is not None:
            self._val_psnr, self._val_step = float(np.mean(psnrs)), step
        log(f"[val] step {step}: psnr={np.mean(psnrs):.2f} "
            f"ssim={np.mean(ssims):.4f} lpips={np.mean(lpipss):.4f} "
            f"t={np.mean(times)*1e3:.1f}ms ovf={int(np.max(ovfs))}")
        self.loggers.log_scalars(
            step, {"val/psnr": float(np.mean(psnrs)),
                   "val/ssim": float(np.mean(ssims)),
                   "val/lpips": float(np.mean(lpipss))})
        return np.mean(psnrs)

    def _dump_gaussians(self, out, results_dir: str, step: int):
        """Posed (and, for the hand, canonical) PLYs of the active
        gaussians, coloured by skin weight when skinned (reference
        dump_gaussians, base.py:271-290)."""
        active = self.state.model.active.cpu().numpy()
        colors = None
        if self.articulated:
            sw = resolve_skin_weights(self.state.model, self.voxel_grid)
            if sw is not None:
                colors = visualize_skin_weights(sw.cpu().numpy())[active]
        gdir = os.path.join(results_dir, "gaussians")
        posed = out["posed_xyz"].cpu().numpy()[active]
        dump_points(posed, os.path.join(gdir, f"{step}_0_posed.ply"), colors)
        if self.articulated:
            cano = self.state.model.params.xyz.cpu().numpy()[active]
            dump_points(cano, os.path.join(gdir, f"{step}_0_cano.ply"),
                        colors)

    # ---- checkpointing --------------------------------------------------
    def save(self, step: int, loss: float):
        """Write a checkpoint; over a mesh, check first that every rank
        holds the same state, and let the first rank write while the
        others wait. Returns the path (None on a rank that does not
        write)."""
        if self.mesh is not None:
            check_replicated(self.state, self.mesh, f"states at step {step}")
        path = self._save(step, loss) if self.writer else None
        if self.mesh is not None:
            dist.barrier(group=self.mesh.group)
        return path

    def _save(self, step: int, loss: float):
        extra = dict(num_active=np.asarray(
            int(self.state.model.active.sum()), np.int32))
        if self.voxel_grid is not None:
            extra.update(
                vg_center=self.voxel_grid.center.cpu().numpy(),
                vg_scale=self.voxel_grid.scale.cpu().numpy(),
                vg_weights=self.voxel_grid.weights.cpu().numpy(),
            )
        # keyed on the held-out PSNR when a validation ran at this step
        val_psnr = (self._val_psnr if getattr(self, "_val_step", None) == step
                    else None)
        path = ckpt_mod.save_checkpoint(self.ckpt_dir, self.state, step, loss,
                                        extra=extra, val_psnr=val_psnr)
        return path

    def load(self, path: Optional[str] = None):
        if path in (None, "best"):
            path = ckpt_mod.find_best_checkpoint(self.ckpt_dir)
        if path is None:
            raise FileNotFoundError(f"no checkpoint in {self.ckpt_dir}")
        self.state, _ = ckpt_mod.load_checkpoint(path, self.state)
        model, n_bad = ckpt_mod.scrub_nan_slots(self.state.model)
        self.state = self.state._replace(model=model)
        return path, int(n_bad)
