"""The part of the experiment config tree that the training step reads.

Same dataclasses, field names and defaults as the JAX package's config,
cut to what this port runs.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from manus_tpu_torch.models.gaussians import GaussianOpts


@dataclasses.dataclass
class DatasetConfig:
    """The image size and the hand's voxel grid; the loaders' fields arrive
    with the loaders."""

    width: int = 128
    height: int = 128
    # hand voxel grid (read by data/voxel.py make_voxel_grid as
    # build_voxel_grid's res, ratio, offset):
    # the reference's hand_model.yaml values
    grid_res: int = 64
    grid_size: Tuple[float, float, float] = (1.1, 0.9, 0.65)
    grid_offset: Tuple[float, float, float] = (0.0, 0.0, -0.03)


@dataclasses.dataclass
class LossConfig:
    losses: Tuple[str, ...] = ("rgb_loss", "ssim_loss", "isotropic_reg")
    loss_weight: Tuple[float, ...] = (0.8, 0.2, 0.1)
    # k > 1 average-pools pred and gt k x k before the VGG (opt-in; the
    # reference runs LPIPS at full resolution).
    lpips_downsample: int = 1
    # conv engine: "auto" or "pallas", both the layout conv chain (the
    # port's only one; make_train_step rejects any other).
    lpips_conv: str = "auto"


@dataclasses.dataclass
class RasterOptions:
    tg_max: int = 64
    chunk: int = 64  # pairs per chunk of the plain torch composite
    max_pairs_per_tile: int = 4096
    # "cuda" (the hand-written kernels), "torch" (their plain version) or
    # "oracle" (dense per-pixel compositing)
    backend: str = "cuda"
    lane_align: int = 128
    # aligned pair-buffer cap as a multiple of N (0 = off)
    pair_budget_factor: int = 8
    # static multi-tile gaussian capacity as a fraction of N (binning.py)
    multi_frac: float = 1.0


@dataclasses.dataclass
class ExperimentConfig:
    workload: str = "object"  # object | hand
    capacity: int = 1 << 17  # N_max gaussian slots
    dataset: DatasetConfig = dataclasses.field(default_factory=DatasetConfig)
    model: GaussianOpts = dataclasses.field(default_factory=GaussianOpts)
    loss: LossConfig = dataclasses.field(default_factory=LossConfig)
    raster: RasterOptions = dataclasses.field(default_factory=RasterOptions)
    # hand skin weights: "mano_init_voxel" (sampled every step from the
    # grid that data/voxel.py make_voxel_grid builds) or
    # "mano_init_points" (stored per point); make_train_step checks that
    # its voxel_grid argument agrees
    skin_init: str = "mano_init_voxel"


def _tuned_raster(raster: RasterOptions) -> RasterOptions:
    """Production raster settings: full tg_max=64 rect coverage, a 2N pair
    budget and a quarter of N as multi-tile capacity."""
    return dataclasses.replace(
        raster, tg_max=64, pair_budget_factor=2, multi_frac=0.25
    )


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
    cfg.dataset.grid_res = 128
    cfg.raster = _tuned_raster(cfg.raster)
    return cfg
