"""Dataclass config tree with dotted CLI overrides.

The same dataclasses, field names and defaults as the JAX package's
config, so a config.json snapshot written by either package loads in the
other: three experiment roots (object, hand, composite) composing
trainer, dataset, model, loss and raster options, `key.sub=value`
overrides, and a snapshot in the run directory.

The raster backend names differ. The JAX package names "auto", "xla" and
"pallas"; the port "cuda" (the hand-written kernels), "torch" (their
plain version) and "oracle". The raster resolves either against its
tensors' device (ops/rasterizer/api.py).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Optional, Tuple

from manus_tpu_torch.models.gaussians import GaussianOpts


@dataclasses.dataclass
class TrainerConfig:
    seed: int = 42
    max_steps: int = 10000
    exp_name: str = "test"
    # the JAX package's name, so both packages' run directories have the
    # same layout: {output_dir}/{project}/{subject or synthetic}/{exp_name}
    project: str = "manus_tpu"
    mode: str = "train"  # train | test | debug
    log_every: int = 50
    val_every: int = 1000
    checkpoint_every: int = 1000
    batch_views: int = 1  # views per step (the reference's accum_iter)
    output_dir: str = "outputs"
    # device mesh sizes; the port runs one device (1, 1)
    data_axis: int = 1
    gauss_axis: int = 1
    # multi-host bring-up (not ported)
    distributed: bool = False
    coordinator: str = ""
    num_processes: int = -1
    process_id: int = -1
    log_losses: bool = True
    debug_nans: bool = False
    # sweep every held-out view and frame at each validation, instead of
    # 2 views at up to 4 frames
    val_full_sweep: bool = False
    # cap (MiB; 0 = off) on the [F, V, H, W, rgb+mask] images kept on the
    # device, so a step's batch is a gather there
    device_cache_mb: int = 2048
    # metric sinks: "csv" (always), "wandb" (when importable), "jsonl"
    # (logs/events.jsonl, one JSON event per log step)
    loggers: Tuple[str, ...] = ("csv",)


@dataclasses.dataclass
class DatasetConfig:
    kind: str = "synthetic"  # synthetic | brics_static | brics_dynamic
    root: str = ""
    subject: str = ""
    width: int = 128
    height: int = 128
    num_cameras: int = 20
    num_frames: int = 1  # dynamic only
    split_ratio: float = 0.1  # the val share of a dynamic scene's frames
    bg_color: str = "black"  # black | white | random
    sample_size: int = 2000  # init points (per bone for the hand)
    # hand voxel grid (read by data/voxel.py make_voxel_grid as
    # build_voxel_grid's res, ratio, offset): the reference's
    # hand_model.yaml values
    grid_res: int = 64
    grid_size: Tuple[float, float, float] = (1.1, 0.9, 0.65)
    grid_offset: Tuple[float, float, float] = (0.0, 0.0, -0.03)
    # test-epoch modes (trainer.mode=test, not ported)
    test_on_train_dataset: bool = False
    test_on_canonical_pose: bool = False
    worst_cases: bool = False
    frame_sample_rate: int = 1


@dataclasses.dataclass
class LossConfig:
    losses: Tuple[str, ...] = ("rgb_loss", "ssim_loss", "isotropic_reg")
    loss_weight: Tuple[float, ...] = (0.8, 0.2, 0.1)
    # VGG16-LPIPS weights npz (scripts/convert_lpips_weights.py); empty
    # with lpips_fallback on: the seeded random-feature VGG16
    lpips_weights: str = ""
    # AlexNet weights for the val metric; empty with lpips_fallback on:
    # the seeded random-feature AlexNet (val_results.csv's lpips_mode)
    lpips_eval_weights: str = ""
    lpips_fallback: bool = True
    # with random-feature weights only, the trainer leaves lpips_loss out
    # of the training loss unless this is set
    lpips_random_in_loss: bool = False
    # k > 1 average-pools pred and gt k x k before the VGG (opt-in; the
    # reference runs LPIPS at full resolution).
    lpips_downsample: int = 1
    # conv engine: "auto" (the layout conv chain for VGG16) or one of
    # train/lpips.py ENGINES (lpips.resolve_lpips_engine).
    lpips_conv: str = "auto"
    # budget (MB) of the trainer's gt LPIPS feature cache; 0 = off
    lpips_gt_cache_mb: int = 4096


@dataclasses.dataclass
class RasterOptions:
    # max tiles per gaussian in binning; 0 keeps every pair (graphdeco's
    # rule: no cut, no budget, no per-tile cap)
    tg_max: int = 64
    chunk: int = 64  # pairs per chunk of the plain torch composite
    pallas_chunk: int = 128  # the JAX package's; kept so snapshots load
    max_pairs_per_tile: int = 4096
    # "cuda" (the hand-written kernels), "torch" (their plain version) or
    # "oracle" (dense per-pixel compositing); the JAX package's names map
    # onto these as ops/rasterizer/api.py says
    backend: str = "cuda"
    lane_align: int = 128
    # aligned pair-buffer cap as a multiple of N (0 = off)
    pair_budget_factor: int = 8
    # static multi-tile gaussian capacity as a fraction of N (binning.py)
    multi_frac: float = 1.0
    # the gauss-axis composite split (parallel/raster.py)
    tile_shard_mode: str = "owner"
    hot_split_tiles: int = 8


@dataclasses.dataclass
class ExperimentConfig:
    workload: str = "object"  # object | hand | composite
    capacity: int = 1 << 17  # N_max gaussian slots
    trainer: TrainerConfig = dataclasses.field(default_factory=TrainerConfig)
    dataset: DatasetConfig = dataclasses.field(default_factory=DatasetConfig)
    model: GaussianOpts = dataclasses.field(default_factory=GaussianOpts)
    loss: LossConfig = dataclasses.field(default_factory=LossConfig)
    raster: RasterOptions = dataclasses.field(default_factory=RasterOptions)
    # hand skin weights: "mano_init_voxel" (sampled every step from the
    # grid that data/voxel.py make_voxel_grid builds) or
    # "mano_init_points" (stored per point); make_train_step checks that
    # its voxel_grid argument agrees
    skin_init: str = "mano_init_voxel"
    # composite (main.run_composite) and its contact evaluation
    # (trainer.mode=eval_contacts, gt_contact_dir); novel poses and path
    # rendering are not ported (kept so that a snapshot loads and
    # overrides parse)
    hand_ckpt_dir: str = ""
    object_ckpt_dir: str = ""
    contact_render_type: str = "results"
    optimize_hand: bool = False
    optimize_object: bool = False
    finetune_steps: int = 500
    # resume: a checkpoint path, or "best" in the run's checkpoints/
    checkpoint: Optional[str] = None
    gt_contact_dir: str = ""
    novel_pose_path: str = ""
    # render_path's and the composite's camera path pkl (not ported: the
    # composite runs without one)
    camera_path: str = ""
    render_ckpt_dir: str = ""
    render_frames: int = 60


def _tuned_raster(raster: RasterOptions) -> RasterOptions:
    """Production raster settings: full tg_max=64 rect coverage, a 2N pair
    budget and a quarter of N as multi-tile capacity."""
    return dataclasses.replace(
        raster, tg_max=64, pair_budget_factor=2, multi_frac=0.25
    )


def object_config() -> ExperimentConfig:
    """OBJ_GAUSSIAN (config/OBJ_GAUSSIAN.yaml +
    scripts/train/train_object.sh)."""
    cfg = ExperimentConfig(workload="object")
    cfg.model = dataclasses.replace(
        cfg.model, densify_grad_threshold=3e-5, sh_degree=3
    )
    cfg.loss = LossConfig(
        losses=("rgb_loss", "ssim_loss", "isotropic_reg"),
        loss_weight=(0.8, 0.2, 0.1),
    )
    cfg.trainer.max_steps = 10000
    cfg.raster = _tuned_raster(cfg.raster)
    return cfg


def hand_config() -> ExperimentConfig:
    """HAND_GAUSSIAN (config/HAND_GAUSSIAN.yaml + scripts/train/train_hands.sh).

    Its loss list names lpips_loss at weight 0.1: the step runs the
    VGG16-LPIPS term from model.start_lpips_iter (1000) on, given
    lpips_params (make_train_step), and adds 0 before that.
    """
    cfg = ExperimentConfig(workload="hand")
    cfg.loss = LossConfig(
        losses=("rgb_loss", "ssim_loss", "isotropic_reg", "lpips_loss"),
        loss_weight=(0.8, 0.2, 0.1, 0.1),
    )
    cfg.trainer.max_steps = 15000
    cfg.dataset.sample_size = 10000
    cfg.dataset.grid_res = 128
    cfg.raster = _tuned_raster(cfg.raster)
    return cfg


def composite_config() -> ExperimentConfig:
    """COMPOSITE: the trained hand and object rendered together, their
    contacts captured (main.run_composite); the raster options are the
    defaults (pair_budget_factor 8, multi_frac 1.0), as in the JAX
    package."""
    cfg = ExperimentConfig(workload="composite")
    cfg.trainer.mode = "test"
    cfg.loss = LossConfig(
        losses=("rgb_loss", "ssim_loss"), loss_weight=(0.8, 0.2)
    )
    return cfg


CONFIGS = {
    "OBJ_GAUSSIAN": object_config,
    "HAND_GAUSSIAN": hand_config,
    "COMPOSITE": composite_config,
}

def _tuple_element_type(old: tuple, ftype: str):
    """Element type for a tuple override: the current value's, or from the
    field annotation (e.g. "Tuple[float, ...]") when it is empty."""
    if old:
        return type(old[0])
    t = (ftype or "").lower()
    if "float" in t:
        return float
    if "int" in t:
        return int
    if "bool" in t:
        return lambda v: v.lower() in ("1", "true", "yes")
    return str


def _coerce(value: str, old: Any, ftype: str = "") -> Any:
    if isinstance(old, bool):
        return value.lower() in ("1", "true", "yes")
    if isinstance(old, int):
        return int(value)
    if isinstance(old, float):
        return float(value)
    if isinstance(old, tuple):
        parts = [p for p in value.strip("[]()").split(",") if p]
        elt = _tuple_element_type(old, ftype)
        return tuple(elt(p.strip()) for p in parts)
    return value


def apply_overrides(cfg: ExperimentConfig,
                    overrides: list[str]) -> ExperimentConfig:
    """Apply `a.b.c=value` dotted overrides in place (frozen dataclasses,
    such as the model options, are set through object.__setattr__)."""
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override must be key=value: {ov}")
        key, value = ov.split("=", 1)
        parts = key.split(".")
        obj = cfg
        for p in parts[:-1]:
            obj = getattr(obj, p)
        leaf = parts[-1]
        old = getattr(obj, leaf)
        if dataclasses.is_dataclass(obj) and obj.__dataclass_fields__[leaf].type:
            new = _coerce(value, old, str(obj.__dataclass_fields__[leaf].type))
        else:
            new = value
        object.__setattr__(obj, leaf, new)
    return cfg


def config_to_dict(cfg) -> dict:
    return dataclasses.asdict(cfg)


def save_config(cfg: ExperimentConfig, path: str):
    with open(path, "w") as f:
        json.dump(config_to_dict(cfg), f, indent=2, default=str)


def _apply_dict(obj, data: dict):
    """Restore a dataclass tree from a config_to_dict dict in place (JSON
    lists become tuples, nested dicts nested dataclasses); unknown keys
    are ignored, so older snapshots keep loading."""
    for key, val in data.items():
        if not hasattr(obj, key):
            continue
        cur = getattr(obj, key)
        if dataclasses.is_dataclass(cur) and isinstance(val, dict):
            _apply_dict(cur, val)
            continue
        if isinstance(cur, tuple) and isinstance(val, list):
            val = tuple(val)
        object.__setattr__(obj, key, val)
    return obj


def load_config_snapshot(path: str) -> ExperimentConfig:
    """A run's config.json snapshot (the file, or the run directory that
    holds it), as written by either package."""
    if os.path.isdir(path):
        path = os.path.join(path, "config.json")
    with open(path) as f:
        data = json.load(f)
    return _apply_dict(ExperimentConfig(), data)
