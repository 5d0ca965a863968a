"""The training CLI: pick an experiment config by name, apply dotted
overrides, snapshot the config into the run directory, resolve a
checkpoint to resume ("best" too), seed, and train.

  python -m manus_tpu_torch.main --config-name OBJ_GAUSSIAN \\
      trainer.max_steps=2000 trainer.exp_name=run1
  python -m manus_tpu_torch.main --config-name HAND_GAUSSIAN \\
      dataset.width=512 dataset.height=512 trainer.exp_name=hand
  python -m manus_tpu_torch.main --config-name outputs/manus_tpu/synthetic/hand \\
      trainer.max_steps=20 checkpoint=best
  python -m manus_tpu_torch.main --device cpu --config-name OBJ_GAUSSIAN ...

The JAX package's CLI (main.py) has the same shape, and a run directory
of either package resumes under the other. Runs go to the CUDA card
unless --device names another device. The synthetic datasets are the
ported data; the other modes and workloads raise NotImplementedError with
the ROADMAP item (Queue A) that ports them.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from manus_tpu_torch.config import (
    CONFIGS,
    apply_overrides,
    load_config_snapshot,
    resolve_raster_backend,
    save_config,
)
from manus_tpu_torch.data import synthetic
from manus_tpu_torch.data.voxel import (
    MANO_REST,
    MANO_TO_OURS,
    load_mano_rest,
    make_voxel_grid,
)
from manus_tpu_torch.models.gaussians import init_gaussian_model
from manus_tpu_torch.ops.knn import knn_indices
from manus_tpu_torch.train.trainer import Trainer
from manus_tpu_torch.utils.device import resolve_device

# what is not ported -> the ROADMAP Queue A item that ports it
EVALUATION, CONTACTS, DATA = ("A6 (evaluation)", "A5 (compositing and "
                              "contacts)", "A7 (data and preprocessing)")
NOT_PORTED_MODES = {
    "render_path": EVALUATION, "make_path": EVALUATION,
    "eval_contacts": CONTACTS, "make_pose": DATA, "validate_data": DATA,
}


def _not_ported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported yet: ROADMAP Queue A item {item}")


def build_dataset(cfg, device=None):
    """The synthetic scene of the workload on `device` (the BRICS loaders
    are not ported); run_train splits it in memory."""
    d = cfg.dataset
    if d.kind != "synthetic":
        _not_ported(f"dataset.kind={d.kind!r}", DATA)
    if cfg.workload == "object":
        return synthetic.build_synthetic_static(
            width=d.width, height=d.height, num_cameras=d.num_cameras,
            bg_color=d.bg_color, device=device)
    return synthetic.build_synthetic_dynamic(
        width=d.width, height=d.height, num_cameras=d.num_cameras,
        num_frames=max(d.num_frames, 2), bg_color=d.bg_color, device=device)


def build_hand_pieces(cfg, dataset, device=None):
    """The hand's init model and, with skin_init "mano_init_voxel", its
    voxel skinning grid. Point weights are the mean of the 20 nearest
    MANO vertices' when the MANO rest mesh is at MANO_REST, else uniform."""
    device = resolve_device(device)
    pts, cols = dataset.sample_gaussians_on_bones(cfg.dataset.sample_size)
    mano = load_mano_rest(MANO_REST) if os.path.exists(MANO_REST) else None
    num_bones = dataset.bones_rest.num_bones
    voxel_grid = make_voxel_grid(
        cfg, dataset.bones_rest.keypoints().cpu().numpy(), mano=mano,
        num_bones=num_bones, device=device)
    skin = None
    if voxel_grid is None:  # mano_init_points
        if mano is not None:
            idx = knn_indices(torch.as_tensor(pts, device=device),
                              torch.as_tensor(mano["verts"], device=device),
                              20).cpu().numpy()
            w = mano["weights"][:, MANO_TO_OURS]
            skin = w[idx].mean(axis=1)
            skin = skin / np.maximum(skin.sum(-1, keepdims=True), 1e-8)
        else:
            skin = np.full((pts.shape[0], num_bones), 1.0 / num_bones,
                           np.float32)
    model = init_gaussian_model(pts, cols, cfg.capacity, opts=cfg.model,
                                skin_weights=skin, device=device)
    return model, voxel_grid


def run_train(cfg, out_dir, device=None) -> Trainer:
    """Build the scene and its held-out split (static: the first 2
    cameras; dynamic: the tail frames), the init model, train, and print
    the final val PSNR. Returns the Trainer."""
    device = resolve_device(device)
    dataset = build_dataset(cfg, device)
    if cfg.workload == "object":
        dataset, val_dataset = synthetic.split_synthetic_static(dataset)
        pts, cols = dataset.sample_gaussians(cfg.dataset.sample_size)
        model = init_gaussian_model(pts, cols, cfg.capacity, opts=cfg.model,
                                    device=device)
        voxel_grid, articulated = None, False
    else:
        dataset, val_dataset = synthetic.split_synthetic_dynamic(
            dataset, cfg.dataset.split_ratio)
        model, voxel_grid = build_hand_pieces(cfg, dataset, device)
        articulated = True
    tr = Trainer(cfg, dataset, model, articulated, voxel_grid,
                 out_dir=out_dir, val_dataset=val_dataset)
    if cfg.checkpoint:
        path, n_bad = tr.load(cfg.checkpoint)
        print(f"resumed from {path} (scrubbed {n_bad} NaN slots)")
    tr.fit()
    psnr = tr.final_val_psnr(cfg.trainer.max_steps)
    print(f"final val psnr: {psnr:.2f}")
    return tr


def main(argv=None):
    """Parse the CLI and run. Returns the Trainer of the run."""
    parser = argparse.ArgumentParser(prog="python -m manus_tpu_torch.main")
    parser.add_argument(
        "--config-name", required=True,
        help="experiment name (%s) or a run directory / config.json "
        "snapshot to resume from" % "|".join(CONFIGS),
    )
    parser.add_argument(
        "--device", default="cuda",
        help="torch device of the run (default cuda; the CPU only when "
        "named, e.g. --device cpu)")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda":
        resolve_device()  # raises where there is no card
    if args.config_name in CONFIGS:
        cfg = CONFIGS[args.config_name]()
    elif os.path.exists(args.config_name):
        # resume from a run directory: its snapshot, refined by overrides
        cfg = load_config_snapshot(args.config_name)
        print(f"resumed config snapshot from {args.config_name}")
    else:
        parser.error(
            f"--config-name must be one of {sorted(CONFIGS)} or an "
            f"existing run dir / config.json (got {args.config_name!r})")
    apply_overrides(cfg, args.overrides)
    resolve_raster_backend(cfg.raster.backend, device)  # raises early

    if cfg.trainer.distributed:
        _not_ported("trainer.distributed", "A8 (multi-GPU)")
    if cfg.trainer.mode == "debug":
        # the reference's fast_dev_run (main.py:81-82): a one-step run
        cfg.trainer.max_steps = 1
        cfg.trainer.val_every = 0
        cfg.trainer.checkpoint_every = 0
        cfg.trainer.mode = "train"
    # the JAX CLI's order: these modes first, then the workload, then test
    mode = cfg.trainer.mode
    if mode in NOT_PORTED_MODES:
        _not_ported(f"trainer.mode={mode!r}", NOT_PORTED_MODES[mode])
    if cfg.workload == "composite":
        _not_ported("the COMPOSITE workload", CONTACTS)
    if mode == "test":
        _not_ported("trainer.mode='test'", EVALUATION)
    if cfg.trainer.mode != "train":
        raise ValueError(f"unknown trainer.mode {cfg.trainer.mode!r}")

    out_dir = os.path.join(
        cfg.trainer.output_dir, cfg.trainer.project,
        cfg.dataset.subject or "synthetic", cfg.trainer.exp_name,
    )
    os.makedirs(out_dir, exist_ok=True)
    save_config(cfg, os.path.join(out_dir, "config.json"))
    np.random.seed(cfg.trainer.seed)
    torch.manual_seed(cfg.trainer.seed)
    if cfg.trainer.debug_nans:
        torch.autograd.set_detect_anomaly(True)
    return run_train(cfg, out_dir, device)


if __name__ == "__main__":
    main()
