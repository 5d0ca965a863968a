"""Run the PyTorch port on one NVIDIA card: the HAND_GAUSSIAN training step
and its kernels, the training CLI, the render, test and pose entry points
with the preprocessing pipeline, the contact stage (COMPOSITE), training
on BRICS captures read from disk, and sharded training over ranks.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

  1. build: nvcc compiles manus_tpu_torch/csrc/*.cu (composite, conv3x3,
     lpips_head, knn, project, ssim, deform) for sm_90a into manus_tpu_torch/_build/ (one nvcc per
     source, in parallel, beside g++ for the host assembly of
     csrc/image_ops.cpp); ptxas's report of every library, read from the
     log kept beside it (also for one built earlier), must show no spill;
  2. scene: bench.py's primary hand workload built with the port:
     65,536 gaussians at 512x512, one view, procedural_skeleton(8), point
     skin weights, random weights from fixed seeds. The ground truth is
     rendered from the clean model with the CUDA kernels, then the model
     is perturbed;
  3. oracle: a 64x64 render of a small cut of the scene through the CUDA
     kernels against the dense per-pixel oracle;
  4. kernels: on the scene's real payload and on a spread one (the same
     gaussians scattered over the image from a fixed seed, so that every
     tile holds about a hundred pairs), each composite kernel against its
     plain PyTorch version (the forward on rgb and T_final, the backward
     on d_payload under a random image cotangent and a non-zero
     background), two launches of each against each other (equal bits),
     the (tile, chunk) items the payload gives, the chunk size and the
     CTAs an SM holds, and both kernels' times from CUDA-graph replays
     (at the bench shape rotating over copies of their inputs past
     COLD_BYTES, so that every launch reads HBM, and of one input);
  5. slice: STEPS training steps through make_train_step under bench.py's
     raster configuration, without LPIPS; the loss must be finite and
     fall, and each composite kernel's launch count over the run must
     equal the number of steps;
  6. lpips kernels: the seeded random-feature VGG16 (bench.py's
     random_lpips_params(0, "vgg")) on a perturbed copy of the scene's
     512x512 gt image and on the gt: each of the 13 conv layers' kernel
     against its plain version on the same input, the dx kernel under a
     random bf16 cotangent (per layer: the plan conv_plan chose, its
     working CTAs and waves of the card's SMs, device time from CUDA-graph
     replays rotating over copies of the inputs past COLD_BYTES and of
     one input, TFLOP/s, the host time of one launch call, and,
     for a split-K plan, that two launches give equal bits), the head
     kernels at each of the 5 stages as the step calls them (the stage
     layout's pixel span; equal bits over two launches and, for the
     forward, over two CUDA-graph replays; the backward with both
     outputs and with da alone, whose da must equal the other's; times
     from graph replays rotating over copies of the features past
     COLD_BYTES, so that every launch reads HBM),
     the image conv (kernel 7) at one layer's shape, and lpips_distance
     with its image gradient through the kernels against the plain chain
     (run on the CPU); per-layer times, plain times, library times and
     bounds;
  7. lpips slice: STEPS steps with lpips_loss on from step 0 (losses
     rgb/ssim/isotropy/lpips at 0.8/0.2/0.1/0.1, the gt features built
     once with lpips_features, as bench.py does); the loss must be finite
     and fall, loss/lpips_loss > 0 at every step, and the launches over
     the run must be 13 conv, 13 dx, 5 head forward and 5 head backward
     per step, and one of each composite kernel;
  8. flagship: bench.py's flagship leg: FLAGSHIP_CAPACITY gaussians at
     512x512 with the skin weights sampled every step from a VOXEL_RES
     voxel grid built on the card; STEPS steps as in 5; then densify
     events through make_densify_step on the trained state, (a) as it
     stands (every slot live) and (b) after a mask prune of every fourth
     slot (at least one clone or split), each under
     torch.cuda.set_sync_debug_mode("error") (no host sync) and held to
     the same event on the CPU (the activity invariant, equal masks and
     values); the opacity reset; the LoOP outlier mask over every slot,
     held to the CPU's;
  9. trainer: the training CLI in process, `manus_tpu_torch.main.main`,
     on the HAND_GAUSSIAN default at full width (TRAINER_CAPACITY
     gaussians, voxel skinning on a 128-resolution grid, 512x512, 8
     cameras, 4 frames of which 3 train, TRAINER_SAMPLE_SIZE init
     points a bone, the most that fit the capacity), into
     chiprun_out/trainer/; only the cadence and the LPIPS switches are
     overridden, so that in TRAINER_STEPS steps the densify events (200,
     300), the opacity reset (250), the LoOP outlier prune (300),
     validation and checkpoints (200, 400) all fire and the LPIPS loss
     runs from step 100 through the gt feature cache. The loss must fall,
     the gt feature cache must be built, the last checkpoint must load
     back equal leaf for leaf, and every kernel's launches over the run
     must be what the run implies (the composite backward once a step,
     so the raster took the kernels; the dx and the heads once a layer
     or stage and LPIPS step); then the run is resumed from its
     directory with checkpoint=best for TRAINER_RESUME_STEPS steps. The
     run's checkpoints and PLYs (about 0.8 GB) are deleted afterwards;
     its config, CSVs and images stay;
 11. render (runs after 9 and before 10, on phase 9's hand, into
     chiprun_out/render/): through the CLI, make_path writes a
     PATH_FRAMES-camera orbit at 512x512 (it loads back through
     load_camera_path); render_path sweeps it, kernel 1 launched once a
     frame, frame 0 through the kernel against the plain composite, the
     video read back equal to the frames; test with worst_cases (one
     render a frame besides the dataset's gt renders, worst_cases.json
     ranked ascending, PSNRs finite, their mean within TEST_PSNR_DB of
     phase 9's last validation), then test_on_canonical_pose over
     CANO_FRAMES frames;
     make_pose's pkl loads back through load_skeleton. Then the
     preprocessing pipeline through its CLI in process on a capture of a
     20-bone hand (hand20_skeleton) by PIPE_VIEWS cameras over
     PIPE_FRAMES frames with noise and outliers (see PIPE_*), its IK
     iterations under torch.cuda.set_sync_debug_mode("error"), its first
     frames against the CPU; and lpips_distance with its image gradient
     on the xla, xla_dx and xla_dx_bf16 engines at 512x512 against the
     layout chain, with the head kernels' fp32 form against the plain
     head on this input. Times: ms a path frame, triangulation ms, IK ms
     an iteration and s a frame, each engine's ms. Its videos are
     deleted after the checks;
 10. composite: the contact stage through the CLI at full width. An
     OBJ_GAUSSIAN object trained through the CLI (131,072 slots, 512x512,
     20 cameras, 65,536 init points, OBJECT_STEPS steps with the densify
     event at OBJECT_DENSIFY_AT only), its checkpoint moved to touch phase
     9's hand where camera 0 sees the contact (place_object: the
     synthetic object is a hollow shell about the hand, which touches
     nothing as trained); then COMPOSITE at 512x512 over
     COMPOSITE_FRAMES frames of COMPOSITE_VIEWS cameras in each
     contact_render_type (results, gt_eval, then acc_gt_eval on the
     gt_eval run's contacts, nocs), once with optimize_hand and
     FINETUNE_STEPS fine-tune steps, and once in results along phase 11's
     camera path. Checks: acc_contacts.npy finite in [0, frames], a PNG
     a frame and the run's video equal to them frame for frame (then
     deleted), the path run's frames not the rig's, composite_fwd
     launched once a gt render,
     panel and step and composite_bwd once a step; frame 0's contact
     maps both ways against float64 on the CPU on CONTACT_ROWS rows; a
     results frame through the kernels against the plain composite;
     both composite kernels against their plain version on the full
     scene's payload of the fine-tune's first batch (the backward's
     shapes on this path); hand points in contact; the fine-tune lowers
     the composite loss over the scene's images; the MANO baseline
     (mano_baseline_contacts on an icosphere across the object's wall,
     rendered per eval frame): each frame's contacts and the accumulated
     map against the CPU's within the conditioning bound per vertex;
     trainer.mode=eval_contacts against ground truth made from
     the acc_gt_eval frames that show contact: "ours" scores IoU = F1 =
     1 and the table has the mano column. Times: ms a frame in each mode,
     one contact search, fine-tune ms a step, eval_contacts seconds,
     peak MiB a run. Phase 9's and 10's checkpoints, the frames but the
     first of each run and the baseline's meshes are deleted afterwards.

 12. brics: BRICS captures at 1280x720 through the port's own readers
     (no h5py, no OpenCV), into chiprun_out/brics/: a dynamic capture of
     the 20-bone hand (hand20_skeleton) rendered by BRICS_VIEWS cameras
     over BRICS_FRAMES frames, each view cropped to its alpha's bbox and
     written as two action files by hdf5.write_tree, and a static one of
     the synthetic object by BRICS_STATIC_VIEWS cameras with BRICS names
     (RGBA PNGs, a zero-distortion calibration, its points as the NGP
     mesh). trainer.mode=validate_data through the CLI exits 0 on both and
     non-zero on a copy with one bbox broken; the loaders' load seconds
     and a 1280x720 view's get_batch ms (HDF5 read, C++ assembly), the C++
     assembly against numpy; HAND_GAUSSIAN on the dynamic capture through
     the CLI (BRICS_CAPACITY slots, BRICS_STEPS steps, LPIPS with random
     features from BRICS_LPIPS_FROM, the device image cache off so that
     every batch is read and assembled in the prefetch thread): the loss
     falls, each kernel's launches are what the run implies (the
     composite backward once a step; the gt's VGG16 forward every LPIPS
     step), and on one batch
     both composite kernels against their plain version and
     lpips_distance with its image gradient against the plain chain on
     the CPU; OBJ_GAUSSIAN on the static capture (BRICS_OBJ_STEPS steps
     over the device image cache): the loss falls and validation runs on
     the 2 held-out cameras. Then the committed fixtures that h5py wrote
     (tests/data/hdf5_forms/, scripts/torch_hdf5_fixtures.py): (a) every
     file read by the port's reader equal to manifest.json (key order,
     shapes, dtypes, value digests), the lzf decoder's MB/s on the
     capture's crops; (b) validate_data exits 0 on its capture/ (libver
     "latest", creation order, dense groups, lzf and gzip + shuffle +
     fletcher32 crops); (c) HAND_GAUSSIAN on capture/ through the CLI as
     above but for FORMS_STEPS steps with LPIPS from FORMS_LPIPS_FROM:
     the loss falls, the launches are what the run implies, and the
     batch checks above on one batch; (d) a 1280x720
     view's get_batch ms from capture/ beside the write_tree capture's.
     The captures, checkpoints and PLYs are deleted afterwards.

 14. knn (runs after 7 and before 8): the contact search kernel
     (csrc/knn.cu) at the composite's shape, KNN_POINTS queries against
     KNN_POINTS references of which KNN_VALID are valid, hand-scale
     clouds with a third of the references within a few mm of a query:
     CONTACT_ROWS rows against float64 on the card (the expansion's
     bound, the exact nearest where it is unique), the plain blockwise
     path on the same card (the same bound), equal bits under one slice
     and under knn_plan's; the kernel's ms (CUDA events over KNN_REPS
     launches), the plain path's, one slice's, and the bound of its 3
     FFMA a pair at FP32_FLOP_PER_S; ptxas's registers and spills and
     the search kernel's SASS (FFMA, FMNMX and the instructions of a
     pair in its run loop, from cuobjdump). Phase 10 counts its launches,
     two a frame at least.

 15. project (runs after 14): the projection kernels (csrc/project.cu,
     projection.project_gaussians_cuda) at the cells' shapes, PROJECT_ROWS
     gaussians under a 1280x720 view: the hand's 131,072 with SH 3 and
     voxel-blended tf (no gradient), the object's 1,048,576 with SH 3 and
     no tf. Against the plain chain (calculate_colors_from_sh +
     project_gaussians) on the same card: the projected fields bit for
     bit, the colours within PROJECT_COLOR_TOL and every input gradient
     within PROJECT_GRAD_TOL of autograd's; the forward's and the
     backward's HBM-cold ms (CUDA-graph replays rotating over copies of
     their inputs past 100 MB) beside their bytes bound, the plain chain's
     forward ms without and with grad and its forward + backward ms (its
     backward: the latter two's difference), and ptxas's registers. Every
     CLI run of phases 9, 10, 11, 12 and 13 (each rank) checks that both
     kernels launched as often as the composite kernels, forward and
     backward: one projection a render.

 16. ssim (runs after 15): the SSIM kernels (csrc/ssim.cu,
     losses.ssim_fwd_cuda and ssim_bwd_cuda) at the training view's
     SSIM_SHAPE: the value and the gradient against the plain banded
     chain (ssim_torch and autograd) on the same card within
     SSIM_VALUE_ATOL and SSIM_GRAD_RTOL; the forward's (with the partial
     maps, the training form, and without, the eval form) and the
     backward's ms HBM-cold (CUDA-graph replays rotating over copies of
     their inputs past 100 MB) and of one input, beside their bytes and
     operations bound; the plain chain's forward ms without and with
     grad and its forward + backward ms; ptxas's registers. The trainer
     phase's CLI run checks that the forward launched once a trained view
     and once an eval render, and the backward once a trained view.

 17. deform (runs after 16): the deformation kernels (csrc/deform.cu,
     ops/deform.py) at the cells' shapes, DEFORM_ROWS: the hand's
     131,072 rows (covariance, skinning by DEFORM_BONES transforms, the
     sample of a DEFORM_GRID^3 grid, 2% of the rows outside it) and the
     object's 1,048,576 (covariance alone). Against the plain chain on
     the same card: the forward bit for bit, every input gradient
     against autograd of the plain chain in float64 within twice the
     float32 chain's own gap (or DEFORM_GRAD_RTOL); each kernel's ms
     HBM-cold (CUDA-graph replays rotating over copies of its inputs past
     100 MB) and of one input beside its bytes bound (skinning's backward
     in a train step's form and in the fine-tune's, with tf's and the
     weights' gradient), the plain chain's forward ms and its backward
     (forward + backward less the forward with grad); ptxas's registers.
     The trainer phase's CLI run checks one skinning forward a trained
     view and eval render (and one a synthetic gt frame), the covariance
     and skinning backward once a step, no grid-sample backward; the
     composite phase's fine-tune one covariance, skinning and grid-sample
     backward a step.

 13. parallel: the sharded training path (manus_tpu_torch/parallel/).
     (a) The composite kernels' tile-id form on the bench scene's view at
     each of PAR_SHAPES (512x512 and 1280x720) with PAR_G owners: each
     owner's tiles as the sharded render bins them (owner-mode
     bin_gaussians) against the plain version, equal bits over two
     launches, HBM-cold times beside the full grid's; the full binning's
     segments dealt to the owners, gathered and un-permuted, equal to the
     full-grid launch's rows bit for bit; each owner's depth ranges of the
     PAR_HOT deepest tiles (hybrid) against the plain version, composed
     (parallel/raster.py's _over_compose) within HYBRID_ATOL of the full
     grid. (b) The
     training CLI as ranks that share the card, each its own process,
     over gloo (NCCL refuses two ranks on one card), every collective on
     a CUDA tensor staged through the host by the group's backend and
     counted; what the installed gloo does with a CUDA tensor itself is
     probed and printed. Two ranks: one owner step over gauss 2 at
     FLAGSHIP_CAPACITY gaussians with voxel skinning against the
     single-process step on the same batch (STEP_RTOL, PARAM_NORM_TOL),
     then PAR_RUNS[0]; four ranks: PAR_RUNS[1]. Each run: PAR_STEPS steps
     of the trainer phase's HAND_GAUSSIAN default at full width with
     LPIPS from step 0; the ranks' losses and state digests equal, the
     loss falling, the tile-id launches once a local view and step in
     owner mode. (c) The collectives over NCCL at world size 1 in this
     process, and across the cards where the machine has several.

Every composite check prints, for Queue C1, the pixels it leaves out of
the backward comparison with their log T_final in both walks and
whether each sits at log 1e-4 or at the 1/255 gate.

The last lines are a {"kernels": [...]} JSON line (the launches of phase
13's CLI runs, summed over their ranks), the card's name and power limit
from nvidia-smi, and {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import math
import os
import re
import shutil
import socket
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from manus_tpu_torch.config import (
    apply_overrides,
    composite_config,
    hand_config,
    load_config_snapshot,
)
from manus_tpu_torch.data import hdf5, hdf5_filters
from manus_tpu_torch.data import prefetch as prefetch_mod
from manus_tpu_torch.data.brics import BricsDynamicDataset, BricsStaticDataset
from manus_tpu_torch.data.synthetic import (
    gt_object_gaussians,
    hemisphere_cameras,
    load_skeleton,
    perturb_model,
    procedural_skeleton,
    sample_gaussians_on_bones,
)
from manus_tpu_torch.data.voxel import make_voxel_grid
from manus_tpu_torch.models import densify as densify_mod
from manus_tpu_torch.models.gaussians import (
    GaussianOpts,
    get_features,
    get_opacity,
    get_scaling,
    init_gaussian_model,
)
from manus_tpu_torch.ops import conv as conv_mod
from manus_tpu_torch.ops import deform as deform_mod
from manus_tpu_torch.ops import knn as knn_mod
from manus_tpu_torch.ops import outliers
from manus_tpu_torch.ops.contacts import CONTACT_THRESHOLD, contact_map
from manus_tpu_torch.ops.grid_sample import (
    skinning_weights_from_voxel_grid_torch,
)
from manus_tpu_torch.ops.rasterizer import composite
from manus_tpu_torch.ops.rasterizer.api import (
    RasterConfig,
    calculate_colors_from_sh,
    render_gaussians,
)
from manus_tpu_torch.ops.rasterizer.binning import (
    bin_gaussians,
    tile_owner_tables,
)
from manus_tpu_torch.ops.rasterizer.payload import NUM_LIVE, build_payload
from manus_tpu_torch.ops.rasterizer import projection as proj_mod
from manus_tpu_torch.ops.rasterizer.projection import TILE, project_gaussians
from manus_tpu_torch.ops.skinning import (
    bone_deformation_transforms,
    skin_gaussians,
    skin_gaussians_torch,
)
from manus_tpu_torch import main as cli
from manus_tpu_torch.parallel import collectives
from manus_tpu_torch.parallel import raster as par_raster
from manus_tpu_torch.parallel.distributed import initialize_distributed
from manus_tpu_torch.parallel.mesh import (
    check_replicated,
    make_mesh,
    replicate_state,
    shard_batch,
    state_digest,
)
from manus_tpu_torch.preprocess import ik as ik_mod
from manus_tpu_torch.preprocess import pipeline as pipeline_mod
from manus_tpu_torch.preprocess.novel_pose import generate_flexion_sequence
from manus_tpu_torch.preprocess.triangulate import batch_triangulate
from manus_tpu_torch.train import checkpoint as ckpt_mod
from manus_tpu_torch.train import lpips as lpips_mod
from manus_tpu_torch.train.baselines import (
    mano_baseline_contacts,
    subdivide_mesh,
)
from manus_tpu_torch.train.composite import (
    PANELS,
    make_composite_finetune_step,
    make_composite_render,
)
from manus_tpu_torch.train.workloads import (
    forward_gaussians,
    init_train_state,
    make_densify_step,
    make_raster_config,
    make_train_step,
    resolve_skin_weights,
)
from manus_tpu_torch.utils import cuda_build
from manus_tpu_torch.utils import losses as loss_mod
from manus_tpu_torch.utils import trace
from manus_tpu_torch.utils.camera import (
    index_camera,
    make_camera,
    stack_cameras,
)
from manus_tpu_torch.utils.colormap import apply_colormap
from manus_tpu_torch.utils.io import (
    dump_image,
    dump_points,
    load_camera_path,
    read_png,
    read_video,
)
from manus_tpu_torch.utils.transforms import (
    covariance_from_scaling_rotation,
    covariance_from_scaling_rotation_torch,
    matrix_to_quaternion,
)

CAPACITY, WIDTH, HEIGHT, VIEWS = 65536, 512, 512, 1
STEPS, WARMUP = 20, 3
# The kernels against their plain version. Forward: the same float32 math
# summed in another order (a running sum against chunked cumsums), 1e-4 on
# rgb and T_final, except at pixels whose walk ends one pair apart because
# log T lands within rounding of log(1e-4): at most 0.1% of the pixels,
# each off by at most the T (<= 0.0101) of the pair in question. Backward:
# d_payload per field, max abs error over the field's max abs value 1e-3
# (each column is a sum over up to 256 pixels, with cancellation), from
# the pixels at which both versions walked the same pairs. A pixel where
# one version includes a pair that the other drops (a walk's end, or the
# 1/255 gate, decided within rounding) computes another function there:
# its gradient changes for every pair before the flip, by up to the T of
# the flipped pair over 1 - alpha (0.99 alpha: 100 times). Such a pixel's
# log T_final differs by |log(1 - alpha)| >= -log(1 - 1/255) = 3.9e-3,
# against rounding of some 5e-5 for a sum of at most 4,096 logs in
# another order, so WALK_LOG_TOL finds it; it gets no cotangent in the
# backward comparison, and at most FLIP_SHARE of the pixels may be such.
FWD_ATOL, FLIP_SHARE, FLIP_ATOL, BWD_NORM_TOL = 1e-4, 1e-3, 0.0101, 1e-3
WALK_LOG_TOL = 1e-3
# Pairs a pass of the plain backward takes at most: 2^18 pairs of 256
# pixels at some twenty saved floats a pixel-pair is about 5 GiB.
PLAIN_PAIRS = 1 << 18
ORACLE_ATOL = 1e-4
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and float32 FLOP/s
# outside the tensor cores.
HBM_BYTES_PER_S, FP32_FLOP_PER_S = 3.35e12, 67e12
# Float operations per walked pixel-pair, counted from csrc/composite.cu
# (transcendentals count one each): the forward's gates, alpha, log-T
# step and colour accumulation; the backward's recomputation, gradient
# terms and its share of the nine-value warp reduction.
FWD_FLOP_PER_PAIR, BWD_FLOP_PER_PAIR = 32, 61
# The LPIPS kernels against their plain version on the same inputs (bf16
# outputs, fp32 sums in another order): a value may round one bf16 ulp
# (at most 2^-7 of it) the other way, and a ReLU output may be 0 on one
# side where the pre-activation is within fp32 rounding of 0, which
# BF16_FLOOR of the layer's largest value covers. The head forward: fp32
# sums of up to 17M terms in another order, 1e-4 relative. The distance
# through 13 bf16 layers, kernels against the plain chain: a one-ulp
# rounding moves one value by 2^-8 and the head averages over every pixel
# and channel, so the rare flips of each layer move the distance far less
# than 1e-3 relative. The image gradient also goes through the dx chain's
# ReLU masks, where a pre-activation within rounding of 0 flips a mask:
# an O(1) change at that pixel, so a cosine of at least 0.998 and a norm
# within 1e-2.
BF16_REL, BF16_FLOOR, HEAD_FWD_RTOL = 2.0 ** -7, 1e-3, 1e-4
DIST_RTOL, GRAD_COS, GRAD_NORM_RTOL = 1e-3, 0.998, 1e-2
# H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet).
BF16_FLOP_PER_S = 989e12
# fp32 operations per feature element in csrc/lpips_head.cu: the forward's
# two squared norms (2 FMAs), the unit difference a ia - b ib (a product
# and an FMA), its square and the weighted sum (an FMA): 10; the
# backward's norms (4), g = w2 (a ia - b ib) (4), the dot products with a
# and b (2 FMAs), g again for the stores (4) and each output (a product
# and an FMA): 22, or 17 for da alone (one dot product, one output).
HEAD_FWD_FLOP, HEAD_BWD_FLOP, HEAD_BWD_DA_FLOP = 10, 22, 17
# The head kernels are timed rotating over copies of a stage's features
# whose pixel spans add up to more than this (twice the 50 MB L2), so
# that every launch reads them from HBM, as the step's launches do.
COLD_BYTES = 100e6
LPIPS_SEED = 0
# bench.py's flagship leg: the canonical hand configuration at 512x512
# with the skin weights sampled every step from a 96-resolution grid.
FLAGSHIP_CAPACITY, VOXEL_RES = 131072, 96
# Densify events on the card against the CPU: the same float32 operations
# on the same inputs, parameters and moments within 1e-6; a slot whose
# activity differs must have a compared value (mean gradient, largest
# scale, opacity) within one float32 ulp of its threshold, where the two
# devices' exp or sigmoid may round apart. LoOP: float32 distance sums in
# another order, probabilities within 1e-4; masks equal but where a
# probability lies within 1e-4 of the 0.8 cut. k = 32 as outlier_mask's
# default.
DENSIFY_ATOL, LOOP_ATOL, LOOP_PROB, LOOP_K = 1e-6, 1e-4, 0.8, 32
# The trainer phase: the HAND_GAUSSIAN default at full width, the cadence
# cut so that every event fires in TRAINER_STEPS steps.
TRAINER_CAPACITY, TRAINER_STEPS, TRAINER_RESUME_STEPS = 131072, 400, 20
TRAINER_LPIPS_FROM, TRAINER_DIR = 100, os.path.join("chiprun_out", "trainer")
# HAND_GAUSSIAN's sample_size, 10,000 a bone, draws 1.5 x 10,000 x 13 =
# 195,000 init points on the 13-bone procedural skeleton, more than the
# capacity, and both packages refuse that (the JAX init asserts): 6,720 a
# bone (131,040 points) is the most that fits.
TRAINER_SAMPLE_SIZE = 6720
TRAINER_ARGS = [
    "--config-name", "HAND_GAUSSIAN", f"capacity={TRAINER_CAPACITY}",
    "skin_init=mano_init_voxel", "dataset.grid_res=128",
    "dataset.width=512", "dataset.height=512", "dataset.num_cameras=8",
    "dataset.num_frames=4", f"dataset.sample_size={TRAINER_SAMPLE_SIZE}",
    f"trainer.max_steps={TRAINER_STEPS}",
    "trainer.val_every=200", "trainer.checkpoint_every=200",
    "model.densify_from_step=100", "model.densification_interval=100",
    "model.opacity_reset_interval=250", "model.remove_outliers_step=300",
    f"model.start_lpips_iter={TRAINER_LPIPS_FROM}",
    "loss.lpips_random_in_loss=true", "loss.lpips_gt_cache_mb=8192",
    f"trainer.output_dir={TRAINER_DIR}", "trainer.exp_name=hand",
]
# The composite phase: the trainer phase's hand and an OBJ_GAUSSIAN
# object trained through the CLI at full width (131,072 slots, 512x512, 20
# cameras) from 65,536 init points without the seg-phase mask prune (on
# the synthetic scene it keeps 1,919 of them, a shell of points ~4 cm
# apart whose contacts light no pixel of the contact panel), the densify
# event at step OBJECT_DENSIFY_AT only (densify runs past
# densify_from_step, every 100 steps); then COMPOSITE at 512x512 over COMPOSITE_FRAMES
# frames of 8 cameras in each contact mode, and a fine-tune of the hand.
OBJECT_STEPS, OBJECT_DENSIFY_AT = 250, 200
COMPOSITE_DIR = os.path.join("chiprun_out", "composite")
OBJECT_ARGS = [
    "--config-name", "OBJ_GAUSSIAN", "capacity=131072", "dataset.width=512",
    "dataset.height=512", "dataset.sample_size=65536",
    "model.remove_seg_end=0",
    f"trainer.max_steps={OBJECT_STEPS}", "trainer.val_every=0",
    f"trainer.checkpoint_every={OBJECT_STEPS}",
    f"model.densify_from_step={OBJECT_DENSIFY_AT - 100}",
    f"trainer.output_dir={TRAINER_DIR}", "trainer.exp_name=obj",
]
COMPOSITE_SIZE, COMPOSITE_FRAMES, COMPOSITE_VIEWS, FINETUNE_STEPS = (
    512, 8, 8, 100)
# The render phase (11): a PATH_FRAMES-camera orbit at 512x512 from
# make_path, which the composite phase's "path" run sweeps too.
RENDER_DIR = os.path.join("chiprun_out", "render")
PATH_PKL = os.path.join(RENDER_DIR, "path.pkl")
PATH_FRAMES, CANO_FRAMES = 60, 8
# The test epoch's mean PSNR over every frame (the train frames too, one
# view each, unmasked) against phase 9's last validation (the held-out
# frame, masked): within TEST_PSNR_DB. A frame's PSNR swings with how
# much of its view the hand fills (30-41 dB in the first chip run).
TEST_PSNR_DB = 5.0
# (experiment, contact_render_type, overrides): acc_gt_eval renders the
# contacts the gt_eval run of its experiment saved; "path" sees each
# frame from the camera path of phase 11
COMPOSITE_RUNS = [
    ("results", "results", []), ("eval", "gt_eval", []),
    ("eval", "acc_gt_eval", []), ("nocs", "nocs", []),
    ("finetune", "results", ["optimize_hand=true",
                             f"finetune_steps={FINETUNE_STEPS}"]),
    ("path", "results", [f"camera_path={PATH_PKL}"]),
]
# The preprocessing pipeline at a capture's width: a 20-bone hand seen by
# PIPE_VIEWS hemisphere cameras at 512x512 (3 m away, a 549 px focal:
# 1 px is ~5.5 mm there) over PIPE_FRAMES frames of a flexion cycle,
# +-PIPE_NOISE px of uniform noise on every keypoint and, in each frame,
# PIPE_OUTLIER_PX on PIPE_OUTLIER_JOINTS joints of 2 views; PIPE_ITERS IK
# iterations a frame (the CLI's default). Cut: 32 frames, not a
# sequence's hundreds. Checks: triangulated keypoints with at most one
# outlier view within PIPE_TRI_TOL of the truth (the noise over 100
# equations; 1.77 mm measured on the CPU), every frame's IK loss (the
# weighted mean squared keypoint error, m^2) under PIPE_IK_LOSS (~3 mm
# RMS) plus what the truth itself scores against the triangulated
# keypoints (2 x their mean squared error: a keypoint whose two outlier
# views are kept is off by ~1.5 cm), the first PIPE_CPU_FRAMES frames on the
# CPU: triangulation within PIPE_CPU_TRI (two SVD libraries) and the IK
# keypoints within PIPE_CPU_KP (IK is chaotic past ~50 iterations: the
# solutions differ within the fit's noise).
PIPE_VIEWS, PIPE_FRAMES, PIPE_NOISE, PIPE_ITERS = 50, 32, 1.0, 300
PIPE_OUTLIER_PX, PIPE_OUTLIER_JOINTS = 50.0, 3
PIPE_TRI_TOL, PIPE_IK_LOSS = 2.5e-3, 1e-5
PIPE_CPU_FRAMES, PIPE_CPU_TRI, PIPE_CPU_KP = 4, 1e-5, 2e-3
# fp32 head kernel's form against the plain head: the forward's sum in
# another order (1e-5 relative), the gradients fp32 (1e-5 of the largest)
HEAD_F32_RTOL = 1e-5
# The LPIPS engines against the layout chain: fp32 (or differently
# rounded bf16) activations against the chain's bf16 ones through 13
# layers move the distance by a few bf16 roundings (2^-6 relative; 2-3e-3
# measured on the CPU at 128-256 px, 9.1e-3 on the card at 512x512) and
# turn its image gradient by the ReLU masks that flip (cosine 0.994-0.996
# on the CPU, 0.9926 on the card). Each engine's own arithmetic is held
# tighter: xla against xla_dx (the same fp32 math, its backward by
# autograd or by hand) and xla_dx against itself on the CPU, fp32 sums in
# another order.
ENGINE_REL, ENGINE_COS = 2.0 ** -6, 0.98
FP32_REL, FP32_COS, FP32_NORM = 1e-4, 0.9999, 1e-3
# The brics phase (12): BRICS captures at the README's 1280x720, made
# here and read back through the port's own readers. Dynamic: the 20-bone
# hand (hand20_skeleton; the CLI's loader reads 20 bones) flexing over
# BRICS_FRAMES frames, rendered by BRICS_VIEWS cameras (a BRICS rig has
# 50+) 0.6 m away with a 40 degree field of view, each view cropped to
# its alpha's bbox plus BRICS_MARGIN px, written as two action files by
# hdf5.write_tree. Static: the synthetic object at a quarter of its size
# seen by BRICS_STATIC_VIEWS cameras named as BRICS names them, so that
# the 12-camera skip list bites, as RGBA PNGs with a zero-distortion
# calibration and the object's points as its NGP mesh. HAND_GAUSSIAN
# trains on the dynamic capture with the device image cache off, so every
# step's batch is read from HDF5 and assembled in C++ in the prefetch
# thread; BRICS_SAMPLE_SIZE a bone draws 1.5 x 4,369 = 6,553 init points a
# bone, 131,060 for the 20 bones, the most that fit BRICS_CAPACITY.
BRICS_DIR = os.path.join("chiprun_out", "brics")
BRICS_W, BRICS_H, BRICS_VIEWS, BRICS_FRAMES = 1280, 720, 50, 8
BRICS_STATIC_VIEWS, BRICS_MARGIN, BRICS_GT_PER_BONE = 53, 16, 400
BRICS_CAPACITY, BRICS_SAMPLE_SIZE = 131072, 4369
BRICS_STEPS, BRICS_LPIPS_FROM, BRICS_OBJ_STEPS = 150, 50, 100
BRICS_TIMED_BATCHES = 20
# the h5py-written fixtures and their capture (scripts/torch_hdf5_fixtures)
FORMS_DIR = os.path.join("tests", "data", "hdf5_forms")
FORMS_STEPS, FORMS_LPIPS_FROM, FORMS_LZF_REPS = 30, 10, 20
# query rows of each direction held to float64; the baseline mesh (an
# icosphere of 162 vertices, 10,242 after the baseline's 3 subdivisions;
# MANO's 778 give 49,000) and its posed frames (the CPU's contacts, its
# reference, take ~2 s a frame)
CONTACT_ROWS, BASELINE_LEVEL, BASELINE_FRAMES = 4096, 2, 4
# The contact search at the composite's shape (phase 14): the hand's and
# the object's slots, the share of the references that are valid, and
# the kernel's timed launches.
KNN_POINTS, KNN_VALID, KNN_REPS = 131072, 0.9, 20
# The projection kernels at the cells' shapes (phase 15): the hand's and
# the object's slots; colours within float32 rounding of a 16-term sum in
# another order, gradients within rounding of the closed form evaluated
# in another order than autograd's (tests/test_torch_project_cuda.py).
PROJECT_ROWS = {"hand": 131072, "object": 1048576}
# The deformation kernels at the cells' shapes (phase 17): the hand's rows
# (covariance, skinning by DEFORM_BONES transforms, the sample of a
# DEFORM_GRID^3 grid of DEFORM_BONES channels) and the object's
# (covariance alone); the forward held to the chain's bits, the backward
# to autograd of the chain in float64: within twice the float32 chain's
# own gap of each leaf's largest entry, or DEFORM_GRAD_RTOL
# (tests/test_torch_cuda.py DEFORM_FWD_ULPS, DEFORM_GRAD_RTOL).
DEFORM_ROWS = {"hand": 131072, "object": 1048576}
DEFORM_BONES, DEFORM_GRID, DEFORM_GRAD_RTOL = 21, 128, 1e-6
PROJECT_COLOR_TOL, PROJECT_GRAD_TOL = 1e-5, 1e-4
# The SSIM kernels at a training view's size (phase 16), held to the plain
# chain as tests/test_torch_cuda.py holds them (SSIM_VALUE_ATOL and
# SSIM_GRAD_RTOL there), and their float operations a pixel channel as the
# kernels run them (an FMA two): forward, the horizontal pass's 3 products
# and 5 FMAs a tap, the vertical pass's 5 FMAs a tap and ~25 for s and its
# maps; backward, 3 FMAs a tap each way and 5 to combine.
SSIM_SHAPE = (720, 1280)
SSIM_VALUE_ATOL, SSIM_GRAD_RTOL = 2e-6, 1e-5
SSIM_FWD_FLOP, SSIM_BWD_FLOP = 11 * 13 + 11 * 10 + 25, 11 * 6 * 2 + 5
REPLACES = {
    "composite_fwd": "manus_tpu/ops/rasterizer/pallas_backend.py:105",
    "composite_bwd": "manus_tpu/ops/rasterizer/pallas_backend.py:258",
    "conv3x3_layout": "manus_tpu/ops/conv_pallas.py:325",
    "conv3x3_layout_dx": "manus_tpu/ops/conv_pallas.py:422",
    "lpips_head_fwd": "manus_tpu/ops/conv_pallas.py:574",
    "lpips_head_bwd": "manus_tpu/ops/conv_pallas.py:590",
    "conv3x3": "manus_tpu/ops/conv_pallas.py:82",
}
SOURCES = {
    "composite_fwd": "manus_tpu_torch/csrc/composite.cu",
    "composite_bwd": "manus_tpu_torch/csrc/composite.cu",
    "conv3x3_layout": "manus_tpu_torch/csrc/conv3x3.cu",
    "conv3x3_layout_dx": "manus_tpu_torch/csrc/conv3x3.cu",
    "lpips_head_fwd": "manus_tpu_torch/csrc/lpips_head.cu",
    "lpips_head_bwd": "manus_tpu_torch/csrc/lpips_head.cu",
    "conv3x3": "manus_tpu_torch/csrc/conv3x3.cu",
}
# The wrapper whose count says how often each kernel ran.
COUNTERS = {
    "composite_fwd": composite.composite_fwd_cuda,
    "composite_bwd": composite.composite_bwd_cuda,
    "conv3x3_layout": conv_mod.conv3x3_layout_cuda,
    "conv3x3_layout_dx": conv_mod.conv3x3_layout_dx_cuda,
    "lpips_head_fwd": conv_mod.head_fwd_cuda,
    "lpips_head_bwd": conv_mod.head_bwd_cuda,
    "conv3x3": conv_mod.conv3x3_image_cuda,
}
# The projection kernels' wrappers: one forward a render through backend
# "cuda", and one backward a render whose gradient reaches them.
PROJECT_COUNTERS = {"project_fwd": proj_mod.project_fwd_cuda,
                    "project_bwd": proj_mod.project_bwd_cuda}
# The SSIM kernels' wrappers: one forward a view a step and an eval
# render, one backward a view a step.
SSIM_COUNTERS = {"ssim_fwd": loss_mod.ssim_fwd_cuda,
                 "ssim_bwd": loss_mod.ssim_bwd_cuda}
# The deformation kernels' wrappers: a train step's covariance, skinning
# and grid sample forward, and the first two backward (the sample's
# positions are detached); the fine-tune's sample backward too.
DEFORM_COUNTERS = {
    "covariance_fwd": deform_mod.covariance_fwd_cuda,
    "covariance_bwd": deform_mod.covariance_bwd_cuda,
    "skin_fwd": deform_mod.skin_fwd_cuda,
    "skin_bwd": deform_mod.skin_bwd_cuda,
    "skin_sample_fwd": deform_mod.skin_sample_fwd_cuda,
    "skin_sample_bwd": deform_mod.skin_sample_bwd_cuda,
}
# Every count _run_cli reads: the kernels' above, the search kernel's, the
# projection kernels', the SSIM kernels' and the deformation kernels'.
COUNTED = (*COUNTERS, "nearest_neighbor", *PROJECT_COUNTERS, *SSIM_COUNTERS,
           *DEFORM_COUNTERS)
# Launches per view and step of each kernel on the LPIPS step.
PER_STEP = {"composite_fwd": 1, "composite_bwd": 1, "conv3x3_layout": 13,
            "conv3x3_layout_dx": 13, "lpips_head_fwd": 5, "lpips_head_bwd": 5,
            "conv3x3": 0}


class PhaseFailed(Exception):
    pass


def check(ok: bool, what: str):
    if not ok:
        raise PhaseFailed(what)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean ms of fn() over reps launches, by CUDA events, after a warmup."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_graph_ms(fn, reps: int) -> float:
    """Mean device ms of fn() over reps launches replayed from a CUDA
    graph: the host's cost of a launch call (tens of microseconds, more
    than a small conv layer takes) is not in the time."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    return cuda_ms(graph.replay, 3) / reps


def rotated_graph_ms(launch, copies, reps: int = 20) -> float:
    """Device ms per launch(*copy) from CUDA-graph replays of at least
    reps launches that cycle through `copies` (a multiple of their count).
    Every launch's outputs are kept, so each writes its own memory; where
    the copies' bytes exceed L2, every launch reads and writes HBM."""
    n = len(copies)
    reps = -(-max(reps, n) // n) * n
    cycle = itertools.cycle(copies)
    kept = []
    return cuda_graph_ms(lambda: kept.append(launch(*next(cycle))), reps)


def host_us(fn, reps: int = 100) -> float:
    """Host microseconds of one fn() call, the card's queue drained before
    and after."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / reps * 1e6


def build_scene(dev):
    """bench.py build_workload's primary leg, with the port."""
    return hand_scene(dev, CAPACITY)[:3]


def scene_cameras(width, height, dev):
    """hand_scene's cameras at width x height: hemisphere cameras about
    procedural_skeleton(8)'s rest pose, far enough to see all of it."""
    skel = procedural_skeleton(8)
    center = skel["rest_heads"].mean(axis=0)
    span = np.linalg.norm(skel["rest_tails"] - skel["rest_heads"], axis=1).sum()
    return hemisphere_cameras(max(VIEWS, 4), width, height,
                              dist=max(1.0, 2.0 * span / 4), center=center,
                              device=dev)


def hand_scene(dev, capacity, voxel_res=0):
    """bench.py build_workload with the port: capacity gaussians on
    procedural_skeleton(8) at WIDTH x HEIGHT, the gt rendered from the
    clean model, the model perturbed. Point skin weights (Dirichlet 0.1)
    or, with voxel_res, bench.py's flagship leg: the skin weights sampled
    every step from a voxel_res grid built on the card, the bone
    transforms with the background channel's identity. Returns (cfg,
    model, batch, grid or None)."""
    skel = procedural_skeleton(8)
    j = len(skel["bnames"])
    per_bone = capacity // (j + j // 2)
    pts, cols = sample_gaussians_on_bones(
        skel["rest_heads"], skel["rest_tails"], skel["rest_transforms"],
        per_bone, seed=0)
    pts, cols = pts[:capacity], cols[:capacity]
    skin = np.random.RandomState(0).dirichlet(
        np.ones(j) * 0.1, size=pts.shape[0]).astype(np.float32)

    cfg = hand_config()
    cfg.capacity = capacity
    cfg.dataset.width, cfg.dataset.height = WIDTH, HEIGHT
    cfg.loss = dataclasses.replace(
        cfg.loss, losses=("rgb_loss", "ssim_loss", "isotropic_reg"),
        loss_weight=(0.8, 0.2, 0.1))
    cfg.model = dataclasses.replace(cfg.model, remove_seg_end=0,
                                    start_lpips_iter=0)
    cfg.raster = dataclasses.replace(
        cfg.raster, backend="cuda", tg_max=64, max_pairs_per_tile=4096,
        chunk=64, pair_budget_factor=2, multi_frac=0.25)
    if voxel_res:  # hand_config's skin_init is "mano_init_voxel"
        cfg.dataset.grid_res = voxel_res
    else:
        cfg.skin_init = "mano_init_points"
    kp_rest = np.concatenate([skel["rest_heads"][:1], skel["rest_tails"]])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grid = make_voxel_grid(cfg, kp_rest, num_bones=j, device=dev)
    if grid is not None:
        torch.cuda.synchronize()
        print(f"voxel grid: res {voxel_res}, weights {tuple(grid.weights.shape)}"
              f" ({grid.weights.numel() * 4 / 2**20:.1f} MiB) built on the "
              f"card in {time.perf_counter() - t0:.3f} s")
        skin = None
    model = init_gaussian_model(pts, cols, capacity, skin_weights=skin,
                                device=dev)

    cams = stack_cameras(scene_cameras(WIDTH, HEIGHT, dev))
    frame = 3 % skel["pose_transforms"].shape[0]
    bone_tf = bone_deformation_transforms(
        torch.tensor(skel["pose_transforms"][frame], device=dev),
        torch.tensor(skel["rest_transforms"], device=dev),
        append_identity=grid is not None)
    kp = np.concatenate([skel["pose_heads"][frame][:1],
                         skel["pose_tails"][frame]]).astype(np.float32)

    raster = make_raster_config(cfg)
    with torch.no_grad():
        gts = []
        for i in range(VIEWS):
            posed, cov, tf = forward_gaussians(
                model.params, model.active,
                resolve_skin_weights(model, grid), bone_tf, cfg.model)
            out = render_gaussians(
                posed, cov, model.params.xyz, get_features(model.params),
                get_opacity(model.params), index_camera(cams, i),
                torch.zeros(3, device=dev), sh_degree=3, tf=tf,
                active=model.active, config=raster)
            gts.append(out.render.clamp(0, 1))
    batch = {
        "rgb": torch.stack(gts),
        "mask": torch.ones(VIEWS, HEIGHT, WIDTH, 1, device=dev),
        "cameras": index_camera(cams, slice(0, VIEWS)),
        "bg": torch.zeros(3, device=dev),
        "bone_tf": bone_tf,
        "keypoints": torch.tensor(kp, device=dev),
    }
    return cfg, perturb_model(model), batch, grid


def spread_projection(proj, seed=0):
    """The projected gaussians with their centres scattered uniformly over
    the image from a fixed seed (conics, radii, depths, colours and
    opacities kept), and the tile rectangles that project_gaussians would
    give them there: most tiles then hold tens to hundreds of pairs."""
    dev = proj.means2d.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    size = torch.tensor([WIDTH, HEIGHT], device=dev, dtype=torch.float32)
    m2d = torch.rand(proj.means2d.shape, device=dev, generator=gen) * size - 0.5
    m2d = torch.where(proj.visible[:, None], m2d, torch.zeros_like(m2d))
    r = proj.radius.to(torch.float32)

    def tile_index(v, limit):
        return torch.clamp(v.to(torch.int32), 0, limit)

    rect = torch.stack([
        tile_index((m2d[:, 0] - r) / TILE, WIDTH // TILE),
        tile_index((m2d[:, 1] - r) / TILE, HEIGHT // TILE),
        tile_index((m2d[:, 0] + r + TILE - 1) / TILE, WIDTH // TILE),
        tile_index((m2d[:, 1] + r + TILE - 1) / TILE, HEIGHT // TILE)], dim=-1)
    return proj._replace(means2d=m2d, tile_rect=rect)


def scene_payload(cfg, model, batch, dev, spread=False):
    """The payload and tile segments the first view's render builds; with
    `spread`, those of the same gaussians scattered over the image."""
    cam = index_camera(batch["cameras"], 0)
    p = model.params
    with torch.no_grad():
        posed, cov, tf = forward_gaussians(
            p, model.active, model.skin_weights, batch["bone_tf"], cfg.model)
        colors = calculate_colors_from_sh(posed, get_features(p), p.xyz, cam,
                                          3, tf)
        proj = project_gaussians(posed, cov, cam, active=model.active)
        if spread:
            proj = spread_projection(proj)
        r = cfg.raster
        bins = bin_gaussians(proj, WIDTH // TILE, HEIGHT // TILE, r.tg_max,
                             r.lane_align, r.pair_budget_factor,
                             r.max_pairs_per_tile, r.multi_frac)
        pay = build_payload(proj, colors, get_opacity(p).reshape(-1), bins)
    return pay, bins


def oracle_phase(model, batch, dev):
    """CUDA render of a small cut against the dense oracle at 64x64."""
    keep = torch.arange(model.capacity, device=dev) % (model.capacity // 2048) == 0
    cam = hemisphere_cameras(4, 64, 64, dist=1.0, center=(0.0, 0.05, 0.0),
                             device=dev)[1]
    p = model.params
    with torch.no_grad():
        posed, cov, tf = forward_gaussians(
            p, model.active, model.skin_weights, batch["bone_tf"],
            hand_config().model)
        outs = [render_gaussians(
            posed, cov, p.xyz, get_features(p), get_opacity(p), cam,
            torch.tensor([0.3, 0.2, 0.1], device=dev), tf=tf,
            active=model.active & keep,
            config=RasterConfig(backend=b, max_pairs_per_tile=4096))
            for b in ("cuda", "oracle")]
    err = (outs[0].render - outs[1].render).abs().max().item()
    covered = (outs[1].t_final < 0.5).float().mean().item()
    print(f"oracle: 64x64 cut of {int((model.active & keep).sum())} gaussians, "
          f"cuda vs oracle max abs err {err:.3e} (tolerance {ORACLE_ATOL}), "
          f"covered share {covered:.3f}")
    check(covered > 0.01, "oracle scene covers no pixel")
    check(err <= ORACLE_ATOL, f"cuda render differs from the oracle by {err}")


def composite_graph_ms(pay, bins, dev, reps=20):
    """Device ms per launch of the composite forward and backward wrappers
    on one payload, from CUDA-graph replays, with the count of pairs in
    segments and the deepest tile."""
    ntx, nty = WIDTH // TILE, HEIGHT // TILE
    offs, cnts = bins.tile_offsets, bins.tile_counts
    gen = torch.Generator(device=dev).manual_seed(0)
    d_rgb = torch.rand(ntx * nty, 3, 256, device=dev, generator=gen)
    d_tf = torch.rand(ntx * nty, 256, device=dev, generator=gen)
    saved = composite.composite_fwd_cuda(pay, offs, cnts, ntx, nty)[1:]
    fwd_ms = cuda_graph_ms(lambda: composite.composite_fwd_cuda(
        pay, offs, cnts, ntx, nty), reps)
    bwd_ms = cuda_graph_ms(lambda: composite.composite_bwd_cuda(
        pay, offs, cnts, ntx, nty, d_rgb, d_tf, *saved), reps)
    with_pairs = cnts[cnts > 0]
    return dict(fwd_ms=fwd_ms, bwd_ms=bwd_ms, pairs=int(cnts.sum()),
                tiles_with_pairs=with_pairs.numel(),
                median_tile=int(with_pairs.median()) if with_pairs.numel() else 0,
                deepest_tile=int(cnts.max()))


def composite_cold_ms(pay, bins, dev, reps=20, width=WIDTH, height=HEIGHT,
                      tile_ids=None):
    """Device ms per launch of the composite forward and backward from
    CUDA-graph replays rotating over copies of the payload, the
    cotangents and the forward's saved state, whose bytes exceed
    COLD_BYTES: every launch reads them from HBM, as the step's do. With
    tile_ids, over those slots of the width x height grid."""
    ntx, nty = width // TILE, height // TILE
    offs, cnts = bins.tile_offsets, bins.tile_counts
    t = offs.shape[0]
    n_px = t * 256
    gen = torch.Generator(device=dev).manual_seed(0)
    copies = []
    for _ in range(int(COLD_BYTES // (4 * (pay.numel() + 4 * n_px))) + 1):
        p = pay.clone()
        copies.append((p, torch.rand(t, 3, 256, device=dev, generator=gen),
                       torch.rand(t, 256, device=dev, generator=gen),
                       composite.composite_fwd_cuda(p, offs, cnts, ntx, nty,
                                                    tile_ids)[1:]))
    fwd_ms = rotated_graph_ms(lambda p, *_: composite.composite_fwd_cuda(
        p, offs, cnts, ntx, nty, tile_ids), copies, reps)
    bwd_ms = rotated_graph_ms(
        lambda p, d_rgb, d_tf, saved: composite.composite_bwd_cuda(
            p, offs, cnts, ntx, nty, d_rgb, d_tf, *saved, tile_ids=tile_ids),
        copies, reps)
    return fwd_ms, bwd_ms, len(copies)


def image_to_tiles(img, ntx, nty):
    """[H, W, 3] (tile-aligned) -> [T, 3, 256], tiles_to_image's inverse."""
    return img.reshape(nty, TILE, ntx, TILE, 3).permute(0, 2, 4, 1, 3) \
        .reshape(ntx * nty, 3, TILE * TILE)


# Queue C1: a pixel left out of the backward comparison ends its walk a
# pair apart in the two versions. Where the stop rule decided it, the walk
# that took the pair ends at log T within rounding (STOP_ROUNDING) of
# log(1e-4); where the 1/255 gate did, the two log T differ by
# |log(1 - 1/255)| within rounding. Anywhere else is a fault.
STOP_ROUNDING = 2e-4
GATE_LOG = -math.log1p(-1.0 / 255.0)


def walk_flips(tag, tf_k, tf_p, differ):
    """Print each left-out pixel's log T_final in both walks and where it
    sits (Queue C1). Returns the count of those that sit elsewhere."""
    slot, pix = torch.nonzero(differ, as_tuple=True)
    lk, lp = torch.log(tf_k[slot, pix]), torch.log(tf_p[slot, pix])
    at_stop = (torch.minimum(lk, lp) - composite.LOG_T_EPS).abs() \
        <= STOP_ROUNDING
    at_gate = ((lk - lp).abs() - GATE_LOG).abs() <= STOP_ROUNDING
    where = ["stop" if a else "gate" if g else "ELSEWHERE"
             for a, g in zip(at_stop.tolist(), at_gate.tolist())]
    print(f"C1 {tag}: {slot.numel()} pixels left out of the backward "
          f"comparison: {where.count('stop')} at log 1e-4, "
          f"{where.count('gate')} at the 1/255 gate, "
          f"{where.count('ELSEWHERE')} elsewhere")
    for i in range(slot.numel()):
        print(f"C1 {tag}: slot {int(slot[i])} pixel {int(pix[i])}: log "
              f"T_final kernel {lk[i].item():.7f} plain {lp[i].item():.7f} "
              f"({where[i]})")
    return where.count("ELSEWHERE")


def composite_check(pay, bins, dev, tag, width=WIDTH, height=HEIGHT,
                    tile_ids=None):
    """Both composite kernels against their plain version on one payload
    of a width x height image (with tile_ids, on those tile slots), and
    two launches of each against each other (equal bits). Returns the max
    abs errors and what the forward gave."""
    ntx, nty = width // TILE, height // TILE
    offs, cnts = bins.tile_offsets, bins.tile_counts
    n_tiles = offs.shape[0]
    fwd = composite.composite_fwd_cuda(pay, offs, cnts, ntx, nty, tile_ids)
    rgb_k, tf_k, log_t, n_walk, state = fwd
    with torch.no_grad():
        rgb_p, tf_p = composite.composite_tiles_torch(pay, offs, cnts, ntx, nty,
                                                      tile_ids=tile_ids)
    err_px = torch.maximum((rgb_k - rgb_p).abs().amax(1), (tf_k - tf_p).abs())
    fwd_err = err_px.max().item()
    flips = int((err_px > FWD_ATOL).sum())
    items = int(state.item_start[-1])
    print(f"composite_fwd {tag}: P={pay.shape[1]} pairs in segments="
          f"{int(cnts.sum())} in {int((cnts > 0).sum())} tiles (deepest "
          f"{int(cnts.max())}), {items} items of at most "
          f"{composite.chunk_size()} pairs (grid {state.item_tile.shape[0]}), "
          f"walked pixel-pairs={int(n_walk.sum())} max abs err "
          f"{fwd_err:.3e}; pixels beyond {FWD_ATOL}: {flips}")
    check(flips <= FLIP_SHARE * n_tiles * 256 and fwd_err <= FLIP_ATOL,
          f"forward kernel disagrees ({tag}): max err {fwd_err}, {flips} pixels")
    check((tf_k < 0.5).any().item(), f"the {tag} scene covers no pixel")
    again = composite.composite_fwd_cuda(pay, offs, cnts, ntx, nty, tile_ids)
    check(all(torch.equal(a, b) for a, b in zip(fwd[:4], again[:4])),
          f"two launches of the forward differ ({tag})")

    # the pixels whose walks took other pairs: see WALK_LOG_TOL
    differ = (torch.log(tf_k) - torch.log(tf_p)).abs() > WALK_LOG_TOL
    n_differ = int(differ.sum())
    print(f"composite {tag}: {n_differ} pixels whose walks differ by a pair "
          f"(log T_final apart by more than {WALK_LOG_TOL}) get no cotangent "
          f"in the backward comparison")
    walk_flips(tag, tf_k, tf_p, differ)
    check(n_differ <= FLIP_SHARE * n_tiles * 256,
          f"{n_differ} pixels walk other pairs in the kernel ({tag})")

    gen = torch.Generator(device=dev).manual_seed(0)
    r_img = torch.rand(height, width, 3, device=dev, generator=gen) - 0.5
    ids = torch.arange(ntx * nty, device=dev) if tile_ids is None \
        else tile_ids.long()
    # the image cotangent on the slots' pixels, none where the walks differ
    r_tiles = image_to_tiles(r_img, ntx, nty)[ids] * (~differ)[:, None, :]
    bg = torch.tensor([0.3, 0.2, 0.1], device=dev)

    def d_payload(fn, counts):
        x = pay.detach().requires_grad_(True)
        rgb, tfin = fn(x, counts)
        out = rgb + tfin[:, None, :] * bg[None, :, None]
        (g,) = torch.autograd.grad((out * r_tiles).sum(), [x])
        return g

    dk = d_payload(lambda x, c: composite.CompositeFn.apply(
        x, offs, c, ntx, nty, tile_ids), cnts)
    # the plain backward's autograd graph grows with the pairs, so it runs
    # over groups of whole tiles, a group those whose segments start in
    # one span of PLAIN_PAIRS pairs: the segments are disjoint, a tile
    # left out of a pass has no pairs there and gives no gradient, so the
    # passes' gradients add up to the whole one exactly
    group = (torch.cumsum(cnts, 0) - cnts) // PLAIN_PAIRS
    dp = sum(d_payload(lambda x, c: composite.composite_tiles_torch(
        x, offs, c, ntx, nty, tile_ids=tile_ids), torch.where(group == g, cnts, 0))
        for g in group[cnts > 0].unique().tolist())
    bwd_err = (dk - dp).abs().max().item()
    norm = ((dk - dp).abs().amax(1) / dp.abs().amax(1).clamp(min=1e-30))[:NUM_LIVE]
    print(f"composite_bwd {tag}: max abs err {bwd_err:.3e}; per-field "
          f"normalised {[float(f'{v:.2e}') for v in norm.tolist()]}")
    check(bool((norm <= BWD_NORM_TOL).all()),
          f"backward kernel disagrees ({tag}): normalised errors {norm.tolist()}")
    d_rgb = torch.rand(n_tiles, 3, 256, device=dev, generator=gen)
    d_tf = torch.rand(n_tiles, 256, device=dev, generator=gen)
    d1, d2 = (composite.composite_bwd_cuda(
        pay, offs, cnts, ntx, nty, d_rgb, d_tf, *fwd[1:], tile_ids=tile_ids)
        for _ in range(2))
    check(torch.equal(d1, d2) and bool(d1.abs().max() > 0),
          f"two launches of the backward differ ({tag})")
    print(f"composite {tag}: two launches of each kernel gave equal bits")
    return fwd_err, bwd_err, n_walk, d_rgb, d_tf


def kernel_phase(pay, bins, spread_pay, spread_bins, dev):
    """Each composite kernel against its plain version on the scene's
    payload and on the spread one, and their times from CUDA-graph
    replays (one launch takes the card no longer than the host needs to
    make the call)."""
    ntx, nty = WIDTH // TILE, HEIGHT // TILE
    offs, cnts = bins.tile_offsets, bins.tile_counts
    n_tiles = ntx * nty
    occ = composite.kernel_occupancy()
    print(f"composite: CTAs of 256 threads an SM: {occ}")
    composite_check(spread_pay, spread_bins, dev, "spread")
    sp = composite_graph_ms(spread_pay, spread_bins, dev)
    print(f"times (ms, spread payload: {sp['pairs']} pairs in "
          f"{sp['tiles_with_pairs']} tiles, median tile {sp['median_tile']}, "
          f"deepest {sp['deepest_tile']}): fwd kernel {sp['fwd_ms']:.4f} bwd "
          f"kernel {sp['bwd_ms']:.4f}")
    fwd_err, bwd_err, n_walk, d_rgb, d_tf = composite_check(pay, bins, dev,
                                                            "bench")

    # times at the bench shape
    walk_max = n_walk.amax(1).long()
    pairs = int(walk_max.sum())
    times = composite_graph_ms(pay, bins, dev)
    fwd_ms, bwd_ms, n_copies = composite_cold_ms(pay, bins, dev)
    with torch.no_grad():
        fwd_plain_ms = cuda_ms(lambda: composite.composite_tiles_torch(
            pay, offs, cnts, ntx, nty), 3)
    bwd_plain_ms = plain_backward_ms(pay, offs, cnts, ntx, nty, d_rgb, d_tf)

    (fwd_bound, fwd_by), (bwd_bound, bwd_by) = composite_bounds(n_walk)
    print(f"times (ms, bench shape, CUDA-graph replays over {n_copies} "
          f"copies past {COLD_BYTES:.0e} bytes, HBM-cold; replays of one "
          f"input in brackets): fwd kernel {fwd_ms:.4f} "
          f"({times['fwd_ms']:.4f}) plain "
          f"{fwd_plain_ms:.3f} bound {fwd_bound:.4f} ({fwd_by}); bwd kernel "
          f"{bwd_ms:.4f} ({times['bwd_ms']:.4f}) plain {bwd_plain_ms:.3f} "
          f"bound {bwd_bound:.4f} "
          f"({bwd_by}); tiles walked {int((walk_max > 0).sum())}/{n_tiles}, "
          f"pairs walked {pairs}, deepest tile {int(walk_max.max())}")
    return {
        "composite_fwd": dict(max_abs_err=fwd_err, ms=fwd_ms,
                              plain_ms=fwd_plain_ms, bound_ms=fwd_bound,
                              bound_by=fwd_by),
        "composite_bwd": dict(max_abs_err=bwd_err, ms=bwd_ms,
                              plain_ms=bwd_plain_ms, bound_ms=bwd_bound,
                              bound_by=bwd_by),
    }


def knn_clouds(n, m, dev, seed=0):
    """A query and a reference cloud at the hand's scale on the card, a
    third of the references within a few mm of a query, and KNN_VALID of
    the references valid."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    centre = torch.tensor([0.1, 0.2, 0.05], device=dev)
    x = (torch.rand(n, 3, device=dev, generator=gen) - 0.5) * 0.3 + centre
    y = (torch.rand(m, 3, device=dev, generator=gen) - 0.5) * 0.3 + centre
    k = m // 3
    near = torch.randint(0, n, (k,), device=dev, generator=gen)
    y[:k] = x[near] + 0.002 * torch.randn(k, 3, device=dev, generator=gen)
    valid = torch.rand(m, device=dev, generator=gen) < KNN_VALID
    return x, y, valid


def nn_reference(x, y, valid, dist, idx, rows):
    """A search's (dist, idx) on `rows` held to float64 on the card:
    |d - d_exact| <= min(sqrt(eps), eps / (d + d_exact)), eps = 8 u (|x|
    + max |y|)^2, and idx the exact nearest wherever it beats the second
    by more than 2 eps in d^2. Returns (largest error over its bound,
    share of rows with a unique nearest)."""
    xs, ys = x[rows].double(), y.double()
    best, second, arg = [], [], []
    for i in range(0, len(rows), 256):
        d2 = ((xs[i:i + 256, None, :] - ys[None]) ** 2).sum(-1)
        d2[:, ~valid] = math.inf
        top = torch.topk(d2, 2, dim=1, largest=False)
        best.append(top.values[:, 0])
        second.append(top.values[:, 1])
        arg.append(top.indices[:, 0])
    best, second, arg = torch.cat(best), torch.cat(second), torch.cat(arg)
    eps = 8 * 2.0 ** -24 * (xs.norm(dim=1) + ys[valid].norm(dim=1).max()) ** 2
    d_exact, d = best.sqrt(), dist[rows].double()
    bound = torch.minimum(eps.sqrt(), eps / (d + d_exact).clamp(
        min=1e-30)) + 1e-12
    excess = ((d - d_exact).abs() / bound).max().item()
    unique = second - best > 2 * eps
    check(bool((idx[rows].long()[unique] == arg[unique]).all()),
          "knn: a nearest index differs from float64's")
    return excess, unique.double().mean().item()


def sass_report(lib_path, kernel="knn_search_kernel"):
    """Opcode counts of `kernel` in a library's SASS (cuobjdump -sass),
    and its run loop's: the loop (a backward branch's span) with the most
    FMNMX, one a pair, and its instructions a pair. None without
    cuobjdump."""
    tool = os.path.join(os.environ.get("CUDA_HOME") or "/usr/local/cuda",
                        "bin", "cuobjdump")
    if not os.path.exists(tool):
        return None
    out = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    ins, inside = [], False  # (address, opcode, operands)
    for line in out.splitlines():
        if "Function :" in line:
            inside = kernel in line
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                      r"([A-Z][A-Z0-9_.]*)(.*?);", line)
        if inside and m:
            ins.append((int(m.group(1), 16), m.group(2).split(".")[0],
                        m.group(3)))
    ops = [op for _, op, _ in ins]
    report = {"instructions": len(ops),
              **{op: ops.count(op) for op in ("FFMA", "FMNMX", "LDS")}}
    loops = []
    for addr, op, args in ins:
        target = re.search(r"0x([0-9a-f]+)", args) if op == "BRA" else None
        if target and int(target.group(1), 16) <= addr:
            body = [o for a, o, _ in ins
                    if int(target.group(1), 16) <= a <= addr]
            loops.append((body.count("FMNMX"), -len(body), body))
    if loops:
        pairs, _, body = max(loops)
        report.update(loop_instructions=len(body), loop_pairs=pairs,
                      loop_FFMA=body.count("FFMA"),
                      per_pair=len(body) / max(pairs, 1))
    return report


def knn_phase(dev, ptxas_log):
    """The contact search kernel at the composite's shape (docstring
    phase 14). ptxas_log: the build's output for csrc/knn.cu."""
    n = m = KNN_POINTS
    x, y, valid = knn_clouds(n, m, dev)
    plan = knn_mod.knn_plan(n, m, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    one = knn_mod.KnnPlan(plan.query_blocks, 1, m)
    dist, idx = knn_mod.nearest_neighbor_cuda(x, y, valid)
    d1, i1 = knn_mod.nearest_neighbor_cuda(x, y, valid, plan=one)
    check(torch.equal(dist, d1) and torch.equal(idx, i1),
          f"knn: one slice and {plan.slices} give other bits")
    with torch.no_grad():
        d_p, i_p = knn_mod.nearest_neighbor_torch(x, y, pt2_valid=valid)
    gen = torch.Generator().manual_seed(1)
    near = torch.nonzero(dist < CONTACT_THRESHOLD).reshape(-1).cpu()
    near = near[torch.randperm(len(near), generator=gen)[:CONTACT_ROWS // 2]]
    rest = torch.randperm(n, generator=gen)[:CONTACT_ROWS - len(near)]
    rows = torch.cat([near, rest]).to(dev)
    excess, unique = nn_reference(x, y, valid, dist, idx, rows)
    p_excess, _ = nn_reference(x, y, valid, d_p, i_p, rows)
    check(excess <= 1.0, f"knn: the kernel is {excess:.3f} of its bound "
          "from float64")
    check(p_excess <= 1.0, f"knn: the plain path is {p_excess:.3f} of its "
          "bound from float64")
    same_idx = (idx == i_p).double().mean().item()
    diff = (dist - d_p).abs().max().item()

    ms = cuda_ms(lambda: knn_mod.nearest_neighbor_cuda(x, y, valid),
                 KNN_REPS)
    one_ms = cuda_ms(lambda: knn_mod.nearest_neighbor_cuda(x, y, valid,
                                                           plan=one), 5)
    with torch.no_grad():
        plain_ms = cuda_ms(lambda: knn_mod.nearest_neighbor_torch(
            x, y, pt2_valid=valid), 2)
    # 3 FFMA a pair, 2 operations each; the bytes: both clouds read once,
    # dist and idx written once
    bound, by_bytes, by_ops = bound_ms(12 * (n + m) + m + 8 * n, 6 * n * m,
                                       FP32_FLOP_PER_S)
    ptxas = [ln.strip() for ln in ptxas_log.splitlines()
             if "registers" in ln or "spill" in ln]
    sass = sass_report(cuda_build.library_path("knn"))
    print(f"knn: {n} x {m} ({int(valid.sum())} valid), plan {plan}: kernel "
          f"{ms:.4f} ms (one slice {one_ms:.4f}), plain {plain_ms:.3f} ms, "
          f"bound {bound:.4f} ms (3 FFMA a pair at {FP32_FLOP_PER_S:.3g} "
          f"FLOP/s; bytes {by_bytes:.4f}), {ms / bound:.2f}x the bound; "
          f"{CONTACT_ROWS} rows against float64: kernel {excess:.3f}, plain "
          f"{p_excess:.3f} of the bound, {unique:.4f} with a unique nearest; "
          f"against the plain path: {same_idx:.6f} of the indices equal, "
          f"largest |d| gap {diff:.3e}")
    print(f"knn ptxas: {ptxas}")
    print(f"knn SASS (knn_search_kernel): {sass}")
    return {"nearest_neighbor": dict(
        max_abs_err=diff, ms=ms, plain_ms=plain_ms, bound_ms=bound,
        bound_by="operations" if by_ops >= by_bytes else "bytes",
        one_slice_ms=one_ms, sass=sass)}


def project_inputs(n, articulated, dev, seed=0):
    """A cell's projection inputs on the card: n gaussians in a 0.3 m ball
    seen by a 1280x720 camera 2 m away, SH 3 (K = 16), 90% live; for the
    hand a rigid transform a gaussian (as the voxel grid blends them: no
    gradient) and canonical means near the posed ones."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    cam = make_camera([[1000.0, 0, 639.5], [0, 1000.0, 359.5], [0, 0, 1]],
                      [[1.0, 0, 0, 0], [0, 1.0, 0, 0], [0, 0, 1.0, 2.0]],
                      1280, 720, device=dev)
    means = (torch.rand(n, 3, device=dev, generator=gen) - 0.5) * 0.6
    scales = torch.rand(n, 3, device=dev, generator=gen) * 0.02 + 0.002
    quats = torch.randn(n, 4, device=dev, generator=gen)
    inp = dict(cam=cam, means=means,
               cov=covariance_from_scaling_rotation(scales, quats),
               feat=torch.randn(n, 16, 3, device=dev, generator=gen) * 0.3,
               active=torch.rand(n, device=dev, generator=gen) < 0.9)
    if articulated:
        rot = torch.linalg.qr(torch.randn(n, 3, 3, device=dev,
                                          generator=gen))[0]
        tf = torch.zeros(n, 4, 4, device=dev)
        tf[:, :3, :3] = rot
        tf[:, :3, 3] = torch.randn(n, 3, device=dev, generator=gen) * 0.05
        tf[:, 3, 3] = 1.0
        inp["tf"] = tf
        inp["cano"] = means + torch.randn(n, 3, device=dev,
                                          generator=gen) * 0.02
    return inp


def project_check(inp, dev):
    """The kernels against the plain chain on inp: (largest colour gap,
    largest gradient gap over its leaf's largest entry)."""
    leaves = {k: inp[k].clone().requires_grad_(True)
              for k in ("means", "cov", "feat", "cano") if k in inp}
    tf, cam = inp.get("tf"), inp["cam"]
    gen = torch.Generator(device=dev).manual_seed(1)
    n = inp["means"].shape[0]
    cot = [torch.randn(n, w, device=dev, generator=gen) for w in (2, 3, 3)]

    def grads(p, colors):
        loss = (p.means2d * cot[0]).sum() + (p.conic * cot[1]).sum() \
            + (colors * cot[2]).sum()
        return torch.autograd.grad(loss, list(leaves.values()))

    colors = calculate_colors_from_sh(leaves["means"], leaves["feat"],
                                      leaves.get("cano"), cam, 3, tf)
    want = project_gaussians(leaves["means"], leaves["cov"], cam,
                             active=inp["active"])
    got, got_colors = proj_mod.project_gaussians_cuda(
        leaves["means"], leaves["cov"], cam, active=inp["active"],
        cano_means=leaves.get("cano"), features=leaves["feat"], sh_degree=3,
        tf=tf)
    for g, w, name in zip(got, want, want._fields):
        check(torch.equal(g, w), f"project: {name} differs from the plain "
              f"chain in {int((g != w).sum())} of {g.numel()} entries")
    color_gap = ((got_colors - colors).abs().max()
                 / colors.abs().max()).item()
    check(color_gap <= PROJECT_COLOR_TOL,
          f"project: colours {color_gap:.2e} from the plain chain")
    grad_gap = 0.0
    for name, g, w in zip(leaves, grads(got, got_colors),
                          grads(want, colors)):
        gap = ((g - w).abs().max() / w.abs().max()).item()
        check(gap <= PROJECT_GRAD_TOL,
              f"project: d {name} {gap:.2e} from autograd's")
        grad_gap = max(grad_gap, gap)
    return color_gap, grad_gap


def project_phase(dev, ptxas_log):
    """The projection kernels at the cells' shapes (docstring phase 15).
    ptxas_log: the build's output for csrc/project.cu."""
    out = {"project_fwd": {}, "project_bwd": {}}
    for cell, n in PROJECT_ROWS.items():
        inp = project_inputs(n, cell == "hand", dev)
        color_gap, grad_gap = project_check(inp, dev)
        cam = proj_mod.camera_tensors(inp["cam"], inp["means"].device)
        size = (inp["cam"].width, inp["cam"].height)
        tf, cano = inp.get("tf"), inp.get("cano")
        gen = torch.Generator(device=dev).manual_seed(2)
        cot = [torch.randn(n, w, device=dev, generator=gen)
               for w in (2, 3, 3)]
        fwd_args = (inp["means"], inp["cov"], inp["feat"], inp["active"],
                    cano, tf)
        bwd_args = fwd_args + tuple(cot)
        # bytes: each input read once, each output written once
        extra = 0 if tf is None else 12 + 64
        fwd_bytes = n * (12 + 24 + 192 + 1 + extra + 8 + 12 + 4 + 4 + 16
                         + 1 + 12)
        bwd_bytes = n * (12 + 24 + 192 + 1 + extra + 8 + 12 + 12 + 12 + 24
                         + 192 + (0 if tf is None else 12))
        need = (True, True, tf is not None, True, False)

        def fwd(means, cov, feat, active, cano_, tf_):
            return proj_mod.project_fwd_cuda(means, cov, cam, *size, active,
                                             cano_, feat, tf_, 3)

        def bwd(means, cov, feat, active, cano_, tf_, gm, gc, gcol):
            return proj_mod.project_bwd_cuda(
                means, cov, cam, *size, active, cano_, feat, tf_, 3, gm, gc,
                gcol, need)

        def copies(args):
            nbytes = sum(a.numel() * a.element_size() for a in args
                         if a is not None)
            k = max(2, -(-100 * 2**20 // nbytes) + 1)
            return [tuple(None if a is None else a.clone() for a in args)
                    for _ in range(k)]

        fwd_ms = rotated_graph_ms(fwd, copies(fwd_args))
        bwd_ms = rotated_graph_ms(bwd, copies(bwd_args))
        leaves = {k: inp[k].clone().requires_grad_(True)
                  for k in ("means", "cov", "feat", "cano") if k in inp}

        def plain_fwd():
            colors = calculate_colors_from_sh(
                leaves["means"], leaves["feat"], leaves.get("cano"),
                inp["cam"], 3, tf)
            return project_gaussians(leaves["means"], leaves["cov"],
                                     inp["cam"], active=inp["active"]), colors

        def plain_step():
            p, colors = plain_fwd()
            loss = (p.means2d * cot[0]).sum() + (p.conic * cot[1]).sum() \
                + (colors * cot[2]).sum()
            return torch.autograd.grad(loss, list(leaves.values()))

        with torch.no_grad():
            plain_fwd_ms = cuda_ms(plain_fwd, 5)
        # with grad, the forward also builds the graph the backward walks
        plain_graph_ms = cuda_ms(plain_fwd, 5)
        plain_step_ms = cuda_ms(plain_step, 5)
        fwd_bound = bound_ms(fwd_bytes, 0, FP32_FLOP_PER_S)[0]
        bwd_bound = bound_ms(bwd_bytes, 0, FP32_FLOP_PER_S)[0]
        print(f"project {cell}: {n} rows at {size[0]}x{size[1]}, SH 3, "
              f"{'tf' if tf is not None else 'no tf'}: forward {fwd_ms:.4f} "
              f"ms (bound {fwd_bound:.4f}, {fwd_bytes / 1e6:.1f} MB), "
              f"backward {bwd_ms:.4f} ms (bound {bwd_bound:.4f}, "
              f"{bwd_bytes / 1e6:.1f} MB), HBM-cold; plain chain forward "
              f"{plain_fwd_ms:.3f} ms ({plain_graph_ms:.3f} with grad), "
              f"forward + backward {plain_step_ms:.3f} ms; colours "
              f"{color_gap:.2e}, gradients "
              f"{grad_gap:.2e} from the plain chain's")
        out["project_fwd"][cell] = dict(
            rows=n, ms=fwd_ms, bound_ms=fwd_bound, bound_by="bytes",
            plain_ms=plain_fwd_ms, max_rel_err=color_gap)
        out["project_bwd"][cell] = dict(
            rows=n, ms=bwd_ms, bound_ms=bwd_bound, bound_by="bytes",
            plain_ms=plain_step_ms - plain_graph_ms, max_rel_err=grad_gap)
        del inp, leaves
        torch.cuda.empty_cache()
    ptxas = [ln.strip() for ln in ptxas_log.splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"project ptxas: {ptxas}")
    return out


def ssim_images(h, w, dev, seed=0):
    """(pred, gt) [h, w, 3] float32 in [0, 1]: uniform noise and a noisy
    copy, a black quarter (the background) in both."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    gt = torch.rand(h, w, 3, device=dev, generator=gen)
    pred = (gt + 0.1 * torch.randn(h, w, 3, device=dev, generator=gen))
    pred = pred.clamp(0, 1)
    for img in (pred, gt):
        img[: h // 2, : w // 2] = 0.0
    return pred, gt


def ssim_check(pred, gt):
    """The kernel pair against the plain chain: (value gap, gradient gap
    over the largest term of the closed form, as the tests scale it)."""
    leaf = pred.clone().requires_grad_(True)
    want = loss_mod.ssim_torch(leaf, gt)
    want_g, = torch.autograd.grad(want, leaf)
    leaf = pred.clone().requires_grad_(True)
    got = loss_mod.ssim_cuda(leaf, gt)
    got_g, = torch.autograd.grad(got, leaf)
    value_gap = abs(got.item() - want.item())
    _, part = loss_mod.ssim_partials(pred, gt)
    b = [loss_mod._depthwise_blur(p, 11, 1.5) for p in part]
    terms = (b[0].abs() + (2 * pred * b[1]).abs() + (gt * b[2]).abs()).max()
    grad_gap = ((got_g - want_g).abs().max() * pred.numel() / terms).item()
    check(value_gap <= SSIM_VALUE_ATOL,
          f"ssim: value {got.item()} against the plain {want.item()}")
    check(grad_gap <= SSIM_GRAD_RTOL,
          f"ssim: gradient {grad_gap:.2e} of its largest term from autograd's")
    return value_gap, grad_gap


def ssim_phase(dev, ptxas_log):
    """The SSIM kernels at a training view's size (docstring phase 16).
    ptxas_log: the build's output for csrc/ssim.cu."""
    h, w = SSIM_SHAPE
    pred, gt = ssim_images(h, w, dev)
    value_gap, grad_gap = ssim_check(pred, gt)
    n = pred.numel()
    _, part = loss_mod.ssim_fwd_cuda(pred, gt)
    grad = torch.ones((), device=dev)
    forms = {
        "fwd": (lambda p, g: loss_mod.ssim_fwd_cuda(p, g), (pred, gt),
                5 * 4 * n, SSIM_FWD_FLOP * n),
        "fwd_eval": (lambda p, g: loss_mod.ssim_fwd_cuda(p, g,
                                                         partials=False),
                     (pred, gt), 2 * 4 * n, SSIM_FWD_FLOP * n),
        "bwd": (lambda m, p, g, c: loss_mod.ssim_bwd_cuda(m, p, g, c),
                (part, pred, gt, grad), 6 * 4 * n, SSIM_BWD_FLOP * n),
    }
    ms = {}
    for form, (launch, args, nbytes, flops) in forms.items():
        cold = rotated_graph_ms(launch, cold_copies(*args))
        one = cuda_graph_ms(lambda: launch(*args), 20)
        bound, by_bytes, by_flops = bound_ms(nbytes, flops, FP32_FLOP_PER_S)
        ms[form] = dict(ms=cold, one_input_ms=one, bound_ms=bound,
                        bound_by="bytes" if by_bytes >= by_flops
                        else "operations", mbytes=nbytes / 1e6,
                        gflop=flops / 1e9)
    leaf = pred.clone().requires_grad_(True)

    def plain_fwd():
        return loss_mod.ssim_torch(leaf, gt)

    def plain_step():
        return torch.autograd.grad(plain_fwd(), leaf)

    with torch.no_grad():
        plain_fwd_ms = cuda_ms(plain_fwd, 5)
    plain_graph_ms = cuda_ms(plain_fwd, 5)
    plain_step_ms = cuda_ms(plain_step, 5)
    for form, m in ms.items():
        print(f"ssim {form}: {h}x{w}x3: {m['ms']:.4f} ms HBM-cold, "
              f"{m['one_input_ms']:.4f} one input (bound {m['bound_ms']:.4f} "
              f"by {m['bound_by']}: {m['mbytes']:.1f} MB, "
              f"{m['gflop']:.3f} GFLOP)")
    print(f"ssim plain chain: forward {plain_fwd_ms:.3f} ms "
          f"({plain_graph_ms:.3f} with grad), forward + backward "
          f"{plain_step_ms:.3f} ms; value {value_gap:.2e}, gradient "
          f"{grad_gap:.2e} of its largest term from the plain chain's")
    ptxas = [ln.strip() for ln in ptxas_log.splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"ssim ptxas: {ptxas}")
    return {
        "ssim_fwd": dict(shape=[h, w, 3], ms=ms["fwd"]["ms"],
                         one_input_ms=ms["fwd"]["one_input_ms"],
                         bound_ms=ms["fwd"]["bound_ms"],
                         bound_by=ms["fwd"]["bound_by"],
                         eval_ms=ms["fwd_eval"]["ms"],
                         eval_bound_ms=ms["fwd_eval"]["bound_ms"],
                         plain_ms=plain_fwd_ms, max_abs_err=value_gap),
        "ssim_bwd": dict(shape=[h, w, 3], ms=ms["bwd"]["ms"],
                         one_input_ms=ms["bwd"]["one_input_ms"],
                         bound_ms=ms["bwd"]["bound_ms"],
                         bound_by=ms["bwd"]["bound_by"],
                         plain_ms=plain_step_ms - plain_graph_ms,
                         max_rel_err=grad_gap)}


def deform_inputs(n, dev, seed=0):
    """A hand's rows at the cells' widths (tests/test_torch_cuda.py's too):
    positions over a DEFORM_GRID^3 grid of DEFORM_BONES channels, 2% of
    them outside it and a slab of it all zeros (the background channel),
    log-normal scales, unnormalised quaternions, near-rigid transforms."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    f32 = dict(device=dev, dtype=torch.float32)

    def rand(*shape):
        return torch.rand(*shape, generator=gen, **f32)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, **f32)

    center = torch.tensor([0.02, -0.01, 0.05], **f32)
    scale = torch.tensor([0.12, 0.1, 0.09], **f32)
    xyz = center + (rand(n, 3) * 2 - 1) * scale
    out = n // 50
    xyz[:out] = center + (rand(out, 3) * 2 - 1) * scale * 1.6
    grid = rand(DEFORM_GRID, DEFORM_GRID, DEFORM_GRID, DEFORM_BONES) ** 4
    grid[:, :, :8] = 0.0
    tf = torch.eye(4, **f32).repeat(DEFORM_BONES, 1, 1)
    tf[:, :3, :] += 0.2 * randn(DEFORM_BONES, 3, 4)
    x = dict(xyz=xyz, center=center, scale=scale, grid=grid,
             scaling=torch.exp(randn(n, 3) - 4.0), rotation=randn(n, 4),
             transforms=tf)
    # the skinning's other inputs as a step makes them, by the plain chain
    x["weights"] = skinning_weights_from_voxel_grid_torch(xyz, center, scale,
                                                          grid)
    x["cov"] = covariance_from_scaling_rotation_torch(x["scaling"],
                                                      x["rotation"])
    return x


def _ulps(x):
    i = x.contiguous().view(torch.int32).long()
    return torch.where(i < 0, -(i & 0x7FFFFFFF), i)


def deform_forms(kind, x, dev):
    """{form: (launch, args, bytes)} of one kind's kernels, each input
    read once and each output written once; (plain forward, kernel
    forward) over the differentiated leaves, and the leaves' names."""
    n = x["xyz"].shape[0]
    gen = torch.Generator(device=dev).manual_seed(5)
    b = DEFORM_BONES

    def cot(*shape):
        return torch.randn(n, *shape, device=dev, generator=gen)

    if kind == "covariance":
        g = cot(6)
        args = (x["scaling"], x["rotation"])
        forms = {
            "fwd": (deform_mod.covariance_fwd_cuda, args, n * (28 + 24)),
            "bwd": (lambda s, r, g_: deform_mod.covariance_bwd_cuda(
                s, r, 1.0, g_), args + (g,), n * (28 + 24 + 28))}
        return forms, (covariance_from_scaling_rotation_torch,
                       deform_mod.covariance_cuda), ("scaling", "rotation")
    if kind == "skin":
        gx, gc, gt = cot(3), cot(6), cot(4, 4)
        args = (x["xyz"], x["cov"], x["weights"], x["transforms"])
        rows = 12 + 24 + 4 * b

        def step_bwd(*a):  # a train step's: no weights' or tf's gradient
            return deform_mod.skin_bwd_cuda(*a, None, (True, True, False))

        forms = {
            "fwd": (deform_mod.skin_fwd_cuda, args, n * (rows + 100)),
            "bwd": (step_bwd, args + (gx, gc), n * (rows + 36 + 36)),
            "bwd_finetune": (deform_mod.skin_bwd_cuda, args + (gx, gc, gt),
                             n * (rows + 100 + rows))}
        return forms, (
            lambda *a: tuple(skin_gaussians_torch(*a, x["transforms"])),
            lambda *a: deform_mod.skin_cuda(*a, x["transforms"])), (
            "xyz", "cov", "weights")
    c = DEFORM_BONES
    args = (x["xyz"], x["center"], x["scale"], x["grid"])
    forms = {
        "fwd": (deform_mod.skin_sample_fwd_cuda, args,
                n * (12 + 8 * 4 * c + 4 * c)),
        "bwd": (deform_mod.skin_sample_bwd_cuda, args + (cot(c),),
                n * (12 + 8 * 4 * c + 4 * c + 12))}
    place = (x["center"], x["scale"], x["grid"])
    return forms, (
        lambda p: skinning_weights_from_voxel_grid_torch(p, *place),
        lambda p: deform_mod.skin_sample_cuda(p, *place)), ("xyz",)


def deform_phase(dev, ptxas_log):
    """The deformation kernels at the cells' shapes (docstring phase 17).
    ptxas_log: the build's output for csrc/deform.cu."""
    out = {name: {} for name in DEFORM_COUNTERS}
    for cell, n in DEFORM_ROWS.items():
        x = deform_inputs(n, dev)
        kinds = ("covariance", "skin", "skin_sample") if cell == "hand" \
            else ("covariance",)
        for kind in kinds:
            forms, (plain, kernel), names = deform_forms(kind, x, dev)

            def run(fn, backward=True, dtype=torch.float32):
                leaves = [x[k].to(dtype).clone().requires_grad_(True)
                          for k in names]
                outs = fn(*leaves)
                outs = outs if isinstance(outs, tuple) else (outs,)
                if not backward:
                    return outs, None
                gen = torch.Generator(device=dev).manual_seed(7)
                loss = sum((o * torch.randn(o.shape, device=dev,
                                            generator=gen).to(dtype)).sum()
                           for o in outs)
                return outs, torch.autograd.grad(loss, leaves)

            got, got_g = run(kernel)
            want, want_g = run(plain)
            # autograd of the plain chain in float64, the yardstick of both
            plain64 = deform_forms(
                kind, {k: v.double() for k, v in x.items()}, dev)[1][0]
            exact_g = run(plain64, dtype=torch.float64)[1]
            ulps = max(int((_ulps(g.detach()) - _ulps(w.detach())).abs()
                           .max()) for g, w in zip(got, want))
            gaps = [((g.double() - e).abs().max() / e.abs().max()).item()
                    for g, e in zip((*got_g, *want_g), exact_g * 2)]
            grad_gap = max(gaps[:len(exact_g)])
            plain_gap = max(gaps[len(exact_g):])
            check(ulps == 0, f"deform {kind} {cell}: the forward is {ulps} "
                  "ulps from the plain chain")
            check(grad_gap <= max(2 * plain_gap, DEFORM_GRAD_RTOL),
                  f"deform {kind} {cell}: gradients {grad_gap:.2e} from "
                  f"float64's (the plain chain's {plain_gap:.2e})")
            with torch.no_grad():
                plain_fwd_ms = cuda_ms(lambda: plain(*[x[k] for k in names]),
                                       5)
            # with grad the forward also builds the graph the backward walks
            plain_graph_ms = cuda_ms(lambda: run(plain, False), 5)
            plain_step_ms = cuda_ms(lambda: run(plain), 5)
            for form, (launch, args, nbytes) in forms.items():
                cold = rotated_graph_ms(launch, cold_copies(*args))
                one = cuda_graph_ms(lambda: launch(*args), 20)
                bound = bound_ms(nbytes, 0, FP32_FLOP_PER_S)[0]
                name = f"{'skin_sample' if kind == 'skin_sample' else kind}"\
                    f"_{'fwd' if form == 'fwd' else 'bwd'}"
                plain_ms = plain_fwd_ms if form == "fwd" \
                    else plain_step_ms - plain_graph_ms
                print(f"deform {kind} {form} {cell}: {n} rows: "
                      f"{cold:.4f} ms HBM-cold, {one:.4f} one input (bound "
                      f"{bound:.4f} by bytes, {nbytes / 1e6:.1f} MB); plain "
                      f"chain {plain_ms:.3f} ms; forward {ulps} ulps from "
                      f"the plain chain; gradients {grad_gap:.2e} from "
                      f"float64's (the plain chain's {plain_gap:.2e})")
                key = cell if form != "bwd_finetune" else "hand_finetune"
                out[name][key] = dict(
                    rows=n, ms=cold, one_input_ms=one, bound_ms=bound,
                    bound_by="bytes", plain_ms=plain_ms, max_ulps=ulps,
                    max_rel_err=grad_gap, plain_rel_err=plain_gap)
        del x
        torch.cuda.empty_cache()
    ptxas = [ln.strip() for ln in ptxas_log.splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"deform ptxas: {ptxas}")
    return out


def composite_bounds(n_walk):
    """((ms, "bytes" or "operations") of the forward, of the backward):
    the least time the card could take for the work of this payload's
    walks (n_walk: [T, 256] pairs each pixel walked). The pairs a tile
    walks are read once (36 bytes forward, 72 with the cotangent rows
    backward), the offsets and counts (and ids) once, the outputs written
    once; FWD_FLOP_PER_PAIR and BWD_FLOP_PER_PAIR a walked pixel-pair."""
    n_tiles = n_walk.shape[0]
    walked = int(n_walk.sum())
    pairs = int(n_walk.amax(1).long().sum())
    px_out = n_tiles * 256

    def bound(nbytes, flops):
        t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
        return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations"

    return (bound(36 * pairs + 8 * n_tiles + 24 * px_out,
                  FWD_FLOP_PER_PAIR * walked),
            bound(72 * pairs + 4 * n_tiles + 28 * px_out,
                  BWD_FLOP_PER_PAIR * walked))


def plain_backward_ms(pay, offs, cnts, ntx, nty, d_rgb, d_tf, reps=3):
    """Mean ms of autograd's backward through the plain composite."""
    total = 0.0
    for _ in range(reps + 1):
        x = pay.detach().requires_grad_(True)
        rgb, tfin = composite.composite_tiles_torch(x, offs, cnts, ntx, nty)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.autograd.grad([rgb, tfin], [x], [d_rgb, d_tf])
        end.record()
        torch.cuda.synchronize()
        if _ > 0:  # the first is warmup
            total += start.elapsed_time(end)
    return total / reps


def slice_phase(cfg, state, batch, lpips_params=None, voxel_grid=None,
                tag=None):
    """STEPS train steps through the CUDA kernels, the LPIPS term on when
    lpips_params is given, the skin weights from voxel_grid when given.
    Returns ({kernel: launches}, median ms/step, the last state)."""
    train_step = make_train_step(cfg, extent=1.0, articulated=True,
                                 voxel_grid=voxel_grid,
                                 lpips_params=lpips_params)
    tag = tag or ("slice" if lpips_params is None else "lpips slice")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in COUNTERS.values():
        fn.launches = 0
    losses, lpips_parts, times, metrics = [], [], [], {}
    for _ in range(STEPS):
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(metrics["loss"].item())
        if lpips_params is not None:
            lpips_parts.append(metrics["loss/lpips_loss"].item())
    launches = {name: fn.launches for name, fn in COUNTERS.items()}
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    ms = statistics.median(times[WARMUP:])
    print(f"{tag}: {STEPS} steps, loss {losses[0]:.6f} -> {losses[-1]:.6f}, "
          f"median {ms:.3f} ms/step after {WARMUP} warmup (min "
          f"{min(times[WARMUP:]):.3f}, max {max(times[WARMUP:]):.3f}), "
          f"pair_overflow {int(metrics['pair_overflow'])} far "
          f"{int(metrics['pair_overflow_far'])}, psnr "
          f"{metrics['psnr'].item():.3f}, active {int(metrics['num_active'])}, "
          f"peak {peak_mb:.1f} MiB, launches {launches}")
    check(all(math.isfinite(x) for x in losses), f"{tag}: non-finite loss")
    check(losses[-1] < losses[0], f"{tag}: the loss did not fall")
    if lpips_params is not None:
        print(f"{tag}: loss/lpips_loss {lpips_parts[0]:.6f} -> "
              f"{lpips_parts[-1]:.6f} (min {min(lpips_parts):.6f})")
        check(all(x > 0 and math.isfinite(x) for x in lpips_parts),
              "loss/lpips_loss is not > 0 at every step")
    for name, n in launches.items():
        per_step = PER_STEP[name] if lpips_params is not None \
            else PER_STEP[name] * name.startswith("composite")
        check(n == per_step * STEPS * VIEWS,
              f"{tag}: {name} launched {n} times in {STEPS} steps")
    return launches, ms, state


def bf16_check(got, want, what):
    """Max abs error of a bf16 kernel output against its plain version,
    and the share of values that differ; fails beyond the bf16 rule
    (BF16_REL of the larger magnitude, plus BF16_FLOOR of want's max)."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    limit = BF16_REL * torch.maximum(got.abs(), want.abs()) \
        + BF16_FLOOR * want.abs().max()
    over = int((err > limit).sum())
    check(over == 0, f"{what}: {over} values beyond the bf16 tolerance, "
                     f"max abs err {err.max().item()}")
    return err.max().item(), (err > 0).float().mean().item()


def bound_ms(nbytes, flops, peak_flop_per_s):
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / peak_flop_per_s
    return max(t_b, t_f) * 1e3, t_b * 1e3, t_f * 1e3


def conv_library_ms(x_hwc, w_hwio, b, reps=20):
    """F.conv2d on channels-last bf16 for one layer (a yardstick only)."""
    x = x_hwc.permute(2, 0, 1)[None].to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    w = w_hwio.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    b = b.to(torch.bfloat16)
    return cuda_graph_ms(
        lambda: torch.nn.functional.conv2d(x, w, b, padding=1), reps)


def dx_library_ms(g_hwc, w_hwio, reps=20):
    """torch.nn.grad.conv2d_input on channels-last bf16 (a yardstick)."""
    g = g_hwc.permute(2, 0, 1)[None].to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    w = w_hwio.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    size = (1, w.shape[1], g.shape[2], g.shape[3])
    return cuda_graph_ms(
        lambda: torch.nn.grad.conv2d_input(size, w, g, padding=1), reps)


class Sweep:
    """Per-launch numbers of one kernel over the layers of a sweep."""

    def __init__(self, name):
        self.name, self.rows = name, []

    def add(self, layer, err, share, ms, plain_ms, bounds, library_ms,
            warm_ms=None):
        """ms is HBM-cold (rotated_graph_ms); warm_ms, where given, the
        replays of one input."""
        self.rows.append(dict(layer=layer, err=err, share=share, ms=ms,
                              plain_ms=plain_ms, bound=bounds,
                              library_ms=library_ms, warm_ms=warm_ms))
        lib = "-" if library_ms is None else f"{library_ms:.4f}"
        warm = "" if warm_ms is None else f" (one input {warm_ms:.4f})"
        print(f"  {self.name} {layer}: err {err:.3e} (differing share "
              f"{share:.2e}) ms {ms:.4f}{warm} plain {plain_ms:.4f} bound "
              f"{bounds[0]:.4f} (bytes {bounds[1]:.4f}, ops {bounds[2]:.4f}) "
              f"library {lib}")

    def result(self):
        tot = lambda k: sum(r[k] for r in self.rows)  # noqa: E731
        libs = [r["library_ms"] for r in self.rows]
        t_b = sum(r["bound"][1] for r in self.rows)
        t_f = sum(r["bound"][2] for r in self.rows)
        out = dict(max_abs_err=max(r["err"] for r in self.rows),
                   ms=tot("ms"), plain_ms=tot("plain_ms"),
                   bound_ms=sum(r["bound"][0] for r in self.rows),
                   bound_by="bytes" if t_b >= t_f else "operations",
                   library_ms=None if None in libs else sum(libs))
        warm = [r["warm_ms"] for r in self.rows]
        warm = "" if None in warm else f" (one input {sum(warm):.4f})"
        print(f"{self.name}: sweep of {len(self.rows)} launches: ms "
              f"{out['ms']:.4f}{warm} plain {out['plain_ms']:.3f} bound "
              f"{out['bound_ms']:.4f} ({out['bound_by']}) library "
              f"{out['library_ms']} max abs err {out['max_abs_err']:.3e}")
        return out


def lpips_inputs(batch, dev):
    """The LPIPS phase's inputs: the random-feature VGG16 of LPIPS_SEED,
    the scene's gt image, a copy perturbed from seed 1, and the generator
    that drew it (its later draws are the kernels' cotangents)."""
    params = lpips_mod.random_lpips_params(LPIPS_SEED, device=dev)
    gt = batch["rgb"][0]
    gen = torch.Generator(device=dev).manual_seed(1)
    pred = (gt + 0.1 * torch.randn(gt.shape, device=dev, generator=gen)
            ).clamp(0, 1)
    return params, gt, pred, gen


def lpips_kernel_phase(batch, dev):
    """The LPIPS kernels against their plain versions at 512x512."""
    params, gt, pred, gen = lpips_inputs(batch, dev)
    packed = lpips_mod.pack_lpips_params(params)
    layouts = lpips_mod._vgg_stage_layouts(HEIGHT, WIDTH)
    sweeps = {n: Sweep(n) for n in ("conv3x3_layout", "conv3x3_layout_dx",
                                    "lpips_head_fwd", "lpips_head_bwd",
                                    "conv3x3")}
    da_only = Sweep("lpips_head_bwd da-only")
    feats = {}
    with torch.no_grad():
        for tag, img in (("gt", gt), ("pred", pred)):
            x = (img * 2.0 - 1.0 - packed.shift) / packed.scale
            xl, out = None, []
            for si, stage in enumerate(lpips_mod.VGG_PLAN["stages"]):
                L = layouts[si]
                xl = conv_mod.maxpool2x2_layout(xl, layouts[si - 1], L) \
                    if si else conv_mod.build_layout(x, L)
                for li in range(len(stage)):
                    p = packed.conv(si, li)
                    y = conv_mod.conv3x3_layout_cuda(xl, p.w, p.b, True, L)
                    if tag == "pred":
                        conv_layer_checks(sweeps, params, si, li, xl, y, p, L,
                                          gen)
                    if (si, li) == (1, 0) and tag == "pred":
                        image_conv_check(sweeps["conv3x3"], params, xl, p, L)
                    xl = y
                out.append(xl)
            feats[tag] = out
        for si, L in enumerate(layouts):
            head_checks(sweeps, da_only, feats["pred"][si], feats["gt"][si],
                        packed.lin_eff(si, L), si, L, gen)
    results = {n: sw.result() for n, sw in sweeps.items()}
    da_only.result()
    distance_check(params, pred, gt)
    return params, results


def plan_line(form, plan, flops, ms, launch):
    """The plan of one layer and form, its rate and its host cost; a
    split-K plan must give the same bits twice."""
    line = (f"  plan {form}: tile {plan.bm}x{plan.bn}, K-chunk {plan.kc}, "
            f"split {plan.split_k}, working CTAs {plan.grid} "
            f"({plan.waves:.2f} waves of {conv_mod.SM_COUNT}), "
            f"{flops / ms / 1e9:.1f} TFLOP/s, host "
            f"{host_us(launch):.1f} us/launch")
    if plan.split_k > 1:
        same = torch.equal(launch(), launch())
        line += f", two launches equal bits: {same}"
        check(same, f"{form}: two launches of a split-K plan differ")
    print(line)


def cold_copies(*tensors):
    """The tensors and copies of them, together past COLD_BYTES, for
    rotated_graph_ms."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    return [tensors] + [tuple(t.clone() for t in tensors)
                        for _ in range(int(COLD_BYTES // nbytes))]


def conv_layer_checks(sweeps, params, si, li, xl, y, p, L, gen):
    """One layer: the conv kernel and the dx kernel against their plain
    versions, with times and bounds. The bounds count the bytes of the
    h*w pixels' real channels, not the layout's zero rows and padding
    channels, which only this layout needs."""
    layer = f"conv{si}_{li}"
    w_hwio = params[f"{layer}_w"]
    ci, co = w_hwio.shape[2], w_hwio.shape[3]
    px = L.h * L.w
    flops = 2.0 * px * 9 * ci * co
    w_bytes = 2 * 9 * ci * co
    y_ref = conv_mod.conv3x3_layout_torch(xl, p.w, p.b, True, L)
    err, share = bf16_check(y, y_ref, f"{layer} conv")
    launch = lambda: conv_mod.conv3x3_layout_cuda(xl, p.w, p.b, True, L)  # noqa: E731
    warm = cuda_graph_ms(launch, 20)
    ms = rotated_graph_ms(
        lambda x, w: conv_mod.conv3x3_layout_cuda(x, w, p.b, True, L),
        cold_copies(xl, p.w))
    plain = cuda_ms(lambda: conv_mod.conv3x3_layout_torch(xl, p.w, p.b, True, L), 3)
    nbytes = 2 * px * (ci + co) + w_bytes + 4 * co
    lib = conv_library_ms(conv_mod.unlayout(xl, L)[..., :ci], w_hwio,
                          params[f"{layer}_b"])
    sweeps["conv3x3_layout"].add(layer, err, share, ms, plain,
                                 bound_ms(nbytes, flops, BF16_FLOP_PER_S), lib,
                                 warm)
    plan_line(f"{layer} conv", conv_mod.conv_plan(L, p.ci, p.co), flops, ms,
              launch)

    g = torch.randn(L.rows, p.co, device=y.device, generator=gen).to(
        torch.bfloat16)
    dx = conv_mod.conv3x3_layout_dx_cuda(g, y, p.w_t, L)
    dx_ref = conv_mod.conv3x3_layout_torch(g, p.w_t, None, False, L,
                                           mask_by=y)
    err, share = bf16_check(dx, dx_ref, f"{layer} dx")
    launch = lambda: conv_mod.conv3x3_layout_dx_cuda(g, y, p.w_t, L)  # noqa: E731
    warm = cuda_graph_ms(launch, 20)
    ms = rotated_graph_ms(
        lambda gg, yy, w: conv_mod.conv3x3_layout_dx_cuda(gg, yy, w, L),
        cold_copies(g, y, p.w_t))
    plain = cuda_ms(lambda: conv_mod.conv3x3_layout_torch(
        g, p.w_t, None, False, L, mask_by=y), 3)
    nbytes = 2 * px * (2 * co + ci) + w_bytes
    gm = torch.where(y > 0, g, 0)
    lib = dx_library_ms(conv_mod.unlayout(gm, L), w_hwio)
    sweeps["conv3x3_layout_dx"].add(layer, err, share, ms, plain,
                                    bound_ms(nbytes, flops, BF16_FLOP_PER_S),
                                    lib, warm)
    plan_line(f"{layer} dx", conv_mod.conv_plan(L, p.co, p.ci), flops,
              ms, launch)


def image_conv_check(sweep, params, xl, p, L):
    """Kernel 7, the conv of a plain [H, W, Ci] image, at this layer's
    shape, against build_layout -> plain conv -> unlayout."""
    x = conv_mod.unlayout(xl, L).float()
    y = conv_mod.conv3x3_raw(x, p, True)
    Li = conv_mod._image_layout(x, p)
    xi = conv_mod.build_layout(x, Li)
    y_ref = conv_mod.unlayout(conv_mod.conv3x3_layout_torch(
        xi, p.w, p.b, True, Li), Li)[..., : p.n_out]
    err, share = bf16_check(y, y_ref, "conv3x3 image")
    ms = cuda_graph_ms(lambda: conv_mod.conv3x3_raw(x, p, True), 20)
    plain = cuda_ms(lambda: conv_mod.unlayout(conv_mod.conv3x3_layout_torch(
        conv_mod.build_layout(x, Li), p.w, p.b, True, Li), Li), 3)
    h, w, ci = x.shape
    flops = 2.0 * h * w * 9 * p.n_in * p.n_out
    nbytes = (4 * h * w * ci + 2 * 9 * p.n_in * p.n_out + 4 * p.n_out
              + 2 * h * w * p.n_out)
    lib = conv_library_ms(x, params["conv1_0_w"], params["conv1_0_b"])
    sweep.add(f"conv1_0 image {h}x{w}x{ci}", err, share, ms, plain,
              bound_ms(nbytes, flops, BF16_FLOP_PER_S), lib)


def head_checks(sweeps, da_only, a, b, lin_eff, si, L, gen):
    """One stage's head kernels as the step calls them, with the stage's
    layout L (only its pixel span is read), against their plain versions
    on the same span: equal bits over two launches of each, and over two
    replays of a CUDA graph of the forward (its ticket's reset), and the
    da-only backward's da equal to the two-output form's. Times from
    CUDA-graph replays rotating over copies of (a, b) whose spans exceed
    COLD_BYTES: HBM-cold. The bounds count the h*w pixels' features
    (every stage's channels are real), not the layout's zero rows. The
    backward's row is the two-output form; the da-only form, which the
    step runs (the gt features are detached), goes to `da_only`."""
    px, c = L.h * L.w, a.shape[1]
    copies = [(a, b)] + [(a.clone(), b.clone()) for _ in range(
        int(COLD_BYTES // (4 * L.n_valid * c)))]

    def fwd(x, y):
        return conv_mod.head_fwd_cuda(x, y, lin_eff, L)

    got = fwd(a, b)
    want = conv_mod.head_fwd_torch(a, b, lin_eff, L).item()
    err = abs(got.item() - want)
    check(err <= HEAD_FWD_RTOL * abs(want) and want > 0,
          f"stage {si} head forward {got.item()} against {want}")
    check(torch.equal(fwd(a, b), got),
          f"stage {si}: two launches of the head forward differ")
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fwd(a, b)
    replays = []
    for _ in range(2):
        graph.replay()
        replays.append(out.clone())
    check(all(torch.equal(r, got) for r in replays),
          f"stage {si}: replays of the head forward differ from a launch")
    ms = rotated_graph_ms(fwd, copies)
    plain = cuda_ms(lambda: conv_mod.head_fwd_torch(a, b, lin_eff, L), 3)
    sweeps["lpips_head_fwd"].add(
        f"stage {si}", err, 0.0, ms, plain,
        bound_ms(4 * px * c + 4 * c, HEAD_FWD_FLOP * px * c, FP32_FLOP_PER_S),
        None)

    ct = torch.rand((), device=a.device, generator=gen) + 0.5

    def bwd(x, y, need_db=True):
        return conv_mod.head_bwd_cuda(x, y, lin_eff, ct, L, need_db)

    da, db = bwd(a, b)
    da_ref, db_ref = conv_mod.head_bwd_torch(a, b, lin_eff * ct, L)
    err_a, share_a = bf16_check(da, da_ref, f"stage {si} head da")
    err_b, share_b = bf16_check(db, db_ref, f"stage {si} head db")
    da2, db2 = bwd(a, b)
    check(torch.equal(da, da2) and torch.equal(db, db2),
          f"stage {si}: two launches of the head backward differ")
    da_alone, none = bwd(a, b, False)
    check(none is None and torch.equal(da_alone, da),
          f"stage {si}: the da-only backward's da differs")
    ms = rotated_graph_ms(bwd, copies)
    plain = cuda_ms(lambda: conv_mod.head_bwd_torch(a, b, lin_eff * ct, L), 3)
    sweeps["lpips_head_bwd"].add(
        f"stage {si}", max(err_a, err_b), max(share_a, share_b), ms, plain,
        bound_ms(8 * px * c + 4 * c + 4, HEAD_BWD_FLOP * px * c,
                 FP32_FLOP_PER_S), None)
    ms = rotated_graph_ms(lambda x, y: bwd(x, y, False), copies)
    plain = cuda_ms(lambda: conv_mod.head_bwd_torch(
        a, b, lin_eff * ct, L, need_db=False), 3)
    da_only.add(f"stage {si}", err_a, share_a, ms, plain,
                bound_ms(6 * px * c + 4 * c + 4, HEAD_BWD_DA_FLOP * px * c,
                         FP32_FLOP_PER_S), None)
    print(f"  head stage {si}: {L.n_valid} span rows of {L.rows}, {c} "
          f"channels, timed over {len(copies)} copies; two launches and two "
          f"graph replays gave equal bits, da-only da equal")


def distance_check(params, pred, gt, tag="512x512"):
    """lpips_distance and its image gradient through the kernels against
    the plain chain, which runs on the CPU (the wrappers take the plain
    versions for CPU tensors)."""
    def value_and_grad(p, img, ref):
        x = img.detach().clone().requires_grad_(True)
        d = lpips_mod.lpips_distance(p, x, ref)
        (g,) = torch.autograd.grad(d, [x])
        return d.item(), g.float().cpu().reshape(-1)

    t0 = time.perf_counter()
    d_k, g_k = value_and_grad(params, pred, gt)
    cpu_params = {k: v.cpu() for k, v in params.items()}
    d_p, g_p = value_and_grad(cpu_params, pred.cpu(), gt.cpu())
    rel = abs(d_k - d_p) / abs(d_p)
    cos = (g_k @ g_p / (g_k.norm() * g_p.norm())).item()
    norm_err = abs(g_k.norm().item() / g_p.norm().item() - 1)
    print(f"lpips_distance {tag}: kernels {d_k:.7f} plain (CPU) {d_p:.7f} "
          f"rel err {rel:.3e} (tolerance {DIST_RTOL}); image gradient cosine "
          f"{cos:.6f} (>= {GRAD_COS}), relative norm error {norm_err:.3e} "
          f"(<= {GRAD_NORM_RTOL}); {time.perf_counter() - t0:.1f} s")
    check(d_p > 0 and rel <= DIST_RTOL, f"lpips_distance rel err {rel}")
    check(cos >= GRAD_COS and norm_err <= GRAD_NORM_RTOL,
          f"lpips image gradient: cosine {cos}, norm error {norm_err}")


def lpips_batch(cfg, batch, params):
    """The scene's config and batch with the LPIPS term on, the gt
    features built once (as bench.py's step does)."""
    cfg = dataclasses.replace(
        cfg, loss=dataclasses.replace(
            cfg.loss, losses=("rgb_loss", "ssim_loss", "isotropic_reg",
                              "lpips_loss"),
            loss_weight=(0.8, 0.2, 0.1, 0.1)))
    with torch.no_grad():
        per_view = [lpips_mod.lpips_features(params, batch["rgb"][i])
                    for i in range(VIEWS)]
    feats = tuple(torch.stack([f[s] for f in per_view])
                  for s in range(len(per_view[0])))
    return cfg, dict(batch, lpips_gt_feats=feats)


def tree_to(x, device):
    """Every tensor of a tree of named tuples (a TrainState) on device."""
    if torch.is_tensor(x):
        return x.to(device)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(tree_to(v, device) for v in x))
    return x


def near_threshold(x, threshold):
    """x within one float32 ulp of the threshold."""
    t = torch.tensor(threshold, dtype=torch.float32)
    return (x - t).abs() <= torch.nextafter(t, torch.tensor(math.inf)) - t


def max_abs_diff(got, want, rows):
    """Max |got - want| over `rows` of two tensors (a NaN on both sides is
    equal); got on the card, want on the CPU."""
    d = (got.cpu() - want).abs()
    d = torch.where(torch.isnan(d) & torch.isnan(want), 0.0, d)
    return d[rows].max().item()


def densify_event(tag, state, densify_step, opts):
    """One densify event through make_densify_step on the card under
    set_sync_debug_mode("error"), so that any host sync fails it, held to
    the same event on the CPU from the same state and the same noise.
    Returns (the new state, its info as ints)."""
    dev = state.model.active.device
    cap = state.model.capacity
    use_size = state.step > opts.opacity_reset_interval
    gen = torch.Generator(device=dev)
    gen.set_state(state.gen.get_state())
    noise = torch.randn((2, cap, 3), generator=gen, device=dev)
    before = int(state.model.active.sum())
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        new, info = densify_step(state)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    info = {k: int(v) for k, v in info.items()}
    ms = cuda_ms(lambda: densify_mod.densify_and_prune(
        state.model, state.opt, state.stats, opts, 1.0, noise, use_size), 5)

    c = tree_to(state, "cpu")
    t0 = time.perf_counter()
    want, want_opt, _, want_info = densify_mod.densify_and_prune(
        c.model, c.opt, c.stats, opts, 1.0, noise.cpu(), use_size)
    cpu_s = time.perf_counter() - t0
    want_info = {k: int(v) for k, v in want_info.items()}
    diff = new.model.active.cpu() != want.active
    # what each slot's decisions compare, from the CPU's side
    iso = opts.isotropic_scaling
    near = (near_threshold(densify_mod.mean_gradient(c.stats),
                           opts.densify_grad_threshold)
            | near_threshold(get_scaling(c.model.params, iso).amax(1),
                             opts.percent_dense * 1.0)
            | near_threshold(get_opacity(want.params)[:, 0],
                             opts.min_opacity_threshold)
            | near_threshold(get_scaling(want.params, iso).amax(1), 0.1))
    n_diff, unexplained = int(diff.sum()), int((diff & ~near).sum())
    err = max(max_abs_diff(a, b, ~diff) for a, b in zip(
        (*new.model.params, *new.opt.m, *new.opt.v),
        (*want.params, *want_opt.m, *want_opt.v)))
    print(f"densify ({tag}): active {before} -> {info['num_active']}, clones "
          f"{info['clones']} splits {info['splits']} pruned {info['pruned']} "
          f"alloc_dropped {info['alloc_dropped']} (size prune "
          f"{'on' if use_size else 'off'}); no host sync under "
          f"set_sync_debug_mode('error'); densify_and_prune {ms:.3f} ms on the "
          f"card (mean of 5, CUDA events), {cpu_s:.2f} s on the CPU; against "
          f"the CPU: {n_diff} slots' activity differs ({n_diff - unexplained} "
          f"within one ulp of a threshold), info "
          f"{'equal' if info == want_info else want_info}, max abs err "
          f"{err:.3e} (tolerance {DENSIFY_ATOL})")
    check(info["num_active"] == before + info["clones"] + info["splits"]
          - info["pruned"], f"densify ({tag}): num_active does not add up")
    check(unexplained == 0, f"densify ({tag}): {unexplained} slots differ "
                            "from the CPU away from every threshold")
    check(n_diff > 0 or info == want_info,
          f"densify ({tag}): info {info} against the CPU's {want_info}")
    check(err <= DENSIFY_ATOL, f"densify ({tag}): max abs err {err}")
    return new, info


def flagship_phase(dev):
    """bench.py's flagship leg with the port: FLAGSHIP_CAPACITY gaussians
    at WIDTH x HEIGHT with skin weights from a VOXEL_RES grid, STEPS steps,
    densify events (a) and (b), the opacity reset and the LoOP outlier
    prune. Returns the median ms/step."""
    t0 = time.perf_counter()
    cfg, model, batch, grid = hand_scene(dev, FLAGSHIP_CAPACITY, VOXEL_RES)
    torch.cuda.synchronize()
    print(f"flagship scene: {FLAGSHIP_CAPACITY} gaussians at {WIDTH}x{HEIGHT},"
          f" {VIEWS} view(s), on procedural_skeleton(8) (bench.py's own "
          f"fallback: its reference skeleton, novel_pose.pkl, is not in the "
          f"repo), {time.perf_counter() - t0:.1f} s")
    _, ms, state = slice_phase(cfg, init_train_state(model), batch,
                               voxel_grid=grid, tag="flagship")
    cap = state.model.capacity
    densify_step, reset_step = make_densify_step(cfg, extent=1.0)

    # (a): the state as it stands, every slot live
    densify_event("a", state, densify_step, cfg.model)

    # (b): every fourth slot pruned first, so that children find room, and
    # the slots after them shrunk to half of percent_dense, so that those
    # of them that pass the gradient threshold clone rather than split
    slot = torch.arange(cap, device=dev)
    model_b, opt_b, n_kill = densify_mod.prune_by_mask(state.model,
                                                       state.opt, slot % 4 == 0)
    opts = cfg.model
    small = slot % 4 == 1
    p = model_b.params
    scaling = torch.where(small[:, None], math.log(opts.percent_dense * 0.5),
                          p.scaling)
    model_b = model_b._replace(params=p._replace(scaling=scaling))
    state_b = state._replace(model=model_b, opt=opt_b)
    grads = densify_mod.mean_gradient(state_b.stats)
    if not bool(((grads >= opts.densify_grad_threshold)
                 & model_b.active).any()):
        thr = torch.quantile(grads[model_b.active], 0.9).item()
        print(f"densify (b): no slot reaches densify_grad_threshold "
              f"{opts.densify_grad_threshold} after {STEPS} steps; threshold "
              f"set to the 90th percentile of the live slots' mean viewspace "
              f"gradient, {thr:.6g}")
        opts = dataclasses.replace(opts, densify_grad_threshold=thr)
        densify_step = make_densify_step(
            dataclasses.replace(cfg, model=opts), extent=1.0)[0]
    print(f"densify (b): prune_by_mask of every fourth slot removed "
          f"{int(n_kill)}; {int((small & model_b.active).sum())} live slots "
          f"shrunk below percent_dense {opts.percent_dense}")
    after, info = densify_event("b", state_b, densify_step, opts)
    check(info["clones"] >= 1 and info["splits"] >= 1,
          f"densify (b): {info['clones']} clones, {info['splits']} splits")

    reset_ms = cuda_ms(lambda: reset_step(after), 5)
    after = reset_step(after)
    top = get_opacity(after.model.params)[after.model.active].max().item()
    print(f"opacity reset: {reset_ms:.3f} ms (mean of 5), the largest live "
          f"opacity {top:.6f}")
    check(top <= 0.01 * (1 + 1e-5), f"opacity reset left {top}")

    pts, valid = after.model.params.xyz, after.model.active
    torch.cuda.synchronize()
    base_mb = torch.cuda.memory_allocated() / 2**20
    torch.cuda.reset_peak_memory_stats()
    out_ms = cuda_ms(lambda: outliers.outlier_mask(
        pts, valid, prob=LOOP_PROB, k=LOOP_K), 2)
    loop_mb = torch.cuda.max_memory_allocated() / 2**20 - base_mb
    mask = outliers.outlier_mask(pts, valid, prob=LOOP_PROB, k=LOOP_K)
    prob = outliers.outlier_probability(pts, valid, k=LOOP_K).cpu()
    t0 = time.perf_counter()
    prob_cpu = outliers.outlier_probability(pts.cpu(), valid.cpu(), k=LOOP_K)
    cpu_s = time.perf_counter() - t0
    err = (prob - prob_cpu).abs().max().item()
    diff = mask.cpu() != (prob_cpu > LOOP_PROB)
    near = (prob_cpu - LOOP_PROB).abs() <= LOOP_ATOL
    pruned, _, n_out = densify_mod.prune_by_mask(after.model, after.opt, mask)
    print(f"outliers: LoOP k={LOOP_K} over {cap} slots ({int(valid.sum())} "
          f"live): {out_ms:.3f} ms on the card (mean of 2, CUDA events; "
          f"{loop_mb:.1f} MiB of device memory at its peak), "
          f"{cpu_s:.1f} s on the CPU; {int(mask.sum())} outliers, "
          f"prune_by_mask removed {int(n_out)}, {int(pruned.active.sum())} "
          f"live; against the CPU: probabilities max abs err {err:.3e} "
          f"(tolerance {LOOP_ATOL}), {int(diff.sum())} masks differ, all "
          f"within {LOOP_ATOL} of {LOOP_PROB}: {bool((~diff | near).all())}")
    check(err <= LOOP_ATOL, f"LoOP probabilities differ by {err}")
    check(bool((~diff | near).all()), "outlier masks differ from the CPU's")
    return ms


class Tee:
    """Standard output that also keeps its lines (the trainer's log)."""

    def __init__(self, out):
        self.out, self.lines, self._part = out, [], ""

    def write(self, text):
        self.out.write(text)
        self._part += text
        *done, self._part = self._part.split("\n")
        self.lines.extend(done)

    def flush(self):
        self.out.flush()


def _run_cli(argv):
    """cli.main(argv) with every kernel count of COUNTED set to 0 just
    before and read just after. Returns (trainer, {kernel: launches}, log
    lines, peak device MiB, wall s)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in (*COUNTERS.values(), *PROJECT_COUNTERS.values(),
               *SSIM_COUNTERS.values(), *DEFORM_COUNTERS.values()):
        fn.launches = 0
    knn_mod.nearest_neighbor_cuda.launches = 0
    tee = Tee(sys.stdout)
    sys.stdout = tee
    t0 = time.perf_counter()
    try:
        tr = cli.main(argv)
        torch.cuda.synchronize()
    finally:
        sys.stdout = tee.out
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in COUNTERS.items()}
    launches["nearest_neighbor"] = knn_mod.nearest_neighbor_cuda.launches
    launches.update({name: fn.launches
                     for name, fn in (*PROJECT_COUNTERS.items(),
                                      *SSIM_COUNTERS.items(),
                                      *DEFORM_COUNTERS.items())})
    return (tr, launches, tee.lines,
            torch.cuda.max_memory_allocated() / 2**20, wall)


def check_projection(launches, what: str):
    """One projection a render: the projection kernels of a _run_cli run
    launched as often as the composite kernels, forward and backward
    (both run in render_gaussians under backend "cuda", and no other
    caller launches the composite kernels there)."""
    got = (launches["project_fwd"], launches["project_bwd"])
    want = (launches["composite_fwd"], launches["composite_bwd"])
    check(got == want, f"{what}: the projection kernels launched {got[0]} "
          f"/ {got[1]} times (forward / backward), the composite kernels "
          f"{want[0]} / {want[1]}")


def cache_mb(cache) -> float:
    """MiB of a Trainer cache (a tuple of tensors, or None when off)."""
    return sum(x.numel() * x.element_size() for x in cache or ()) / 2**20


def _csv_rows(path):
    with open(path) as f:
        rows = [line.strip().split(",") for line in f if line.strip()]
    return rows[0], rows[1:]


def trainer_phase(bare_ms):
    """The training CLI on the card (docstring phase 9). bare_ms: the
    flagship phase's median bare step, from the same call. Returns the
    run's {kernel: launches} and its run directory, whose checkpoints the
    composite phase reads."""
    shutil.rmtree(TRAINER_DIR, ignore_errors=True)
    tr, launches, lines, peak_mb, wall = _run_cli(TRAINER_ARGS)
    run_dir = tr.out_dir
    t = tr.timings
    check(tr.device.type == "cuda", f"trainer: ran on {tr.device}")
    ds = tr.dataset
    n_img = ds.num_frames * ds.num_views
    step_ms = [x * 1e3 for x in t["step_s"]]
    plain = statistics.median(step_ms[WARMUP:TRAINER_LPIPS_FROM])
    with_lpips = statistics.median(step_ms[TRAINER_LPIPS_FROM + WARMUP:])
    print(f"trainer: {TRAINER_STEPS} steps through python -m "
          f"manus_tpu_torch.main in {wall:.1f} s, {TRAINER_CAPACITY} "
          f"gaussians, {ds.width}x{ds.height}, {n_img} train images "
          f"({ds.num_frames} frames x {ds.num_views} cameras); fit loop "
          f"median {plain:.3f} ms/step before step {TRAINER_LPIPS_FROM} "
          f"and {with_lpips:.3f} with LPIPS (min {min(step_ms):.3f}, max "
          f"{max(step_ms):.3f}), against the flagship bare step's "
          f"{bare_ms:.3f}; peak {peak_mb:.1f} MiB")
    header, rows = _csv_rows(os.path.join(run_dir, "logs",
                                          "train_metrics.csv"))
    loss = [float(r[1]) for r in rows]
    print(f"trainer: train_metrics.csv {header}: loss {loss[0]:.6f} at step "
          f"{rows[0][0]} -> {loss[-1]:.6f} at step {rows[-1][0]}, "
          f"iters_per_s {rows[-1][4]} (last row), num_active "
          f"{rows[0][3]} -> {rows[-1][3]}")
    check(all(math.isfinite(x) for x in loss), "trainer: non-finite loss")
    check(loss[-1] < loss[0], "trainer: the loss did not fall")
    vheader, vrows = _csv_rows(os.path.join(run_dir, "results",
                                            "val_results.csv"))
    for r in vrows:
        print(f"trainer: val step {r[1]}: psnr {float(r[2]):.4f} ssim "
              f"{float(r[3]):.4f} lpips {float(r[4]):.6f} rendering_time "
              f"{float(r[5]) * 1e3:.2f} ms pair_overflow {r[6]} ({r[7]})")
    check([r[1] for r in vrows] == ["200", "400"],
          f"trainer: validations at {[r[1] for r in vrows]}")
    events = [ln for ln in lines if ln.startswith(("[densify]", "[reset]",
                                                   "[outliers]"))]
    for ln in events:
        print(f"trainer event: {ln}")
    check(any(ln.startswith("[reset] step 250") for ln in events),
          "trainer: no opacity reset at 250")
    check(sum(ln.startswith("[densify] step") for ln in events) == 2,
          "trainer: densify events are not at 200 and 300")
    ckpt_mb = [os.path.getsize(os.path.join(tr.ckpt_dir, p)) / 2**20
               for p in sorted(os.listdir(tr.ckpt_dir)) if p.endswith(".npz")]
    lpips_mb = cache_mb(tr._lpips_feat_cache)
    print(f"trainer: caches: images {cache_mb(tr._device_cache):.1f} MiB, "
          f"gt LPIPS features {lpips_mb:.1f} MiB; checkpoints "
          f"{[round(x, 1) for x in ckpt_mb]} MiB each")
    check(lpips_mb > 0, "trainer: the gt LPIPS cache was skipped")

    # the last checkpoint is the state fit() ended with
    last = max(p for p in os.listdir(tr.ckpt_dir) if p.endswith(".npz"))
    back, _ = ckpt_mod.load_checkpoint(os.path.join(tr.ckpt_dir, last),
                                       tr.state)
    want = ckpt_mod.state_to_arrays(tr.state)
    got = ckpt_mod.state_to_arrays(back)
    want["gen"], got["gen"] = (x.gen.get_state().numpy()
                               for x in (tr.state, back))
    same = [k for k in want if np.array_equal(got[k], want[k])
            and got[k].dtype == want[k].dtype]
    print(f"trainer: {last} loads back: {len(same)} of {len(want)} leaves "
          f"equal")
    check(len(same) == len(want) and set(got) == set(want),
          f"trainer: {last} does not load back equal")

    n_lpips = TRAINER_STEPS - TRAINER_LPIPS_FROM
    # the gt renders cover every frame, the val frames too
    n_gt = tr.cfg.dataset.num_frames * tr.cfg.dataset.num_cameras
    n_eval = launches["composite_fwd"] - TRAINER_STEPS - n_gt
    print(f"trainer: launches over the run {launches} (composite forward: "
          f"{TRAINER_STEPS} steps, {n_gt} gt renders, {n_eval} eval "
          f"renders; LPIPS kernels: {n_lpips} steps from step "
          f"{TRAINER_LPIPS_FROM}, and {n_img} gt feature images)")
    want_n = {"composite_bwd": TRAINER_STEPS,
              "conv3x3_layout": 13 * (n_lpips + n_img),
              "conv3x3_layout_dx": 13 * n_lpips,
              "lpips_head_fwd": 5 * n_lpips, "lpips_head_bwd": 5 * n_lpips,
              "conv3x3": 0}
    for name, n in want_n.items():
        check(launches[name] == n,
              f"trainer: {name} launched {launches[name]} times, not {n}")
    check(n_eval >= 4, f"trainer: {n_eval} eval renders")
    check_projection(launches, "trainer")
    # the SSIM term: a forward a trained view and eval render, a backward
    # a trained view (the composite backward's count)
    ssim_want = (launches["composite_bwd"] + n_eval, launches["composite_bwd"])
    ssim_got = (launches["ssim_fwd"], launches["ssim_bwd"])
    check(ssim_got == ssim_want, f"trainer: the SSIM kernels launched "
          f"{ssim_got} times (forward, backward), not {ssim_want}")
    # the deformation stage: one skinning forward a trained view and eval
    # render (and one a synthetic gt frame, whose renders share it), its
    # covariance and skinning backward once a step, no sample backward
    # (a step's positions are detached)
    renders = launches["composite_fwd"] - n_gt
    deform_want = {"skin_fwd": renders + tr.cfg.dataset.num_frames,
                   "covariance_fwd": renders,
                   "skin_bwd": launches["composite_bwd"],
                   "covariance_bwd": launches["composite_bwd"],
                   "skin_sample_bwd": 0}
    deform_got = {k: launches[k] for k in deform_want}
    check(deform_got == deform_want, f"trainer: the deformation kernels "
          f"launched {deform_got} times, not {deform_want}")
    check(launches["skin_sample_fwd"] >= renders, "trainer: "
          f"{launches['skin_sample_fwd']} grid samples for {renders} renders")
    del tr, back

    rtr, rlaunches, rlines, rpeak, rwall = _run_cli([
        "--config-name", run_dir, f"trainer.max_steps={TRAINER_RESUME_STEPS}",
        "checkpoint=best"])
    resumed = [ln for ln in rlines if ln.startswith("resumed from")]
    rms = statistics.median(x * 1e3 for x in rtr.timings["step_s"][WARMUP:])
    print(f"trainer resume: {resumed}; {TRAINER_RESUME_STEPS} steps in "
          f"{rwall:.1f} s (dataset, grid and caches rebuilt), median "
          f"{rms:.3f} ms/step with LPIPS, state step {rtr.state.step}, peak "
          f"{rpeak:.1f} MiB, launches {rlaunches}")
    check(len(resumed) == 1 and rtr.state.step > TRAINER_RESUME_STEPS,
          "trainer: the resume did not start from a checkpoint")
    check(rlaunches["lpips_head_bwd"] == 5 * TRAINER_RESUME_STEPS,
          "trainer resume: LPIPS is not on from the first step")
    check_projection(rlaunches, "trainer resume")
    del rtr
    return launches, run_dir


def _cli_args(*args):
    return ["--config-name", "COMPOSITE", f"dataset.width={COMPOSITE_SIZE}",
            f"dataset.height={COMPOSITE_SIZE}",
            f"dataset.num_cameras={COMPOSITE_VIEWS}",
            f"dataset.num_frames={COMPOSITE_FRAMES}",
            f"trainer.output_dir={COMPOSITE_DIR}", *args]


def _ours_dir(exp):
    return os.path.join(COMPOSITE_DIR, "manus_tpu", "synthetic", exp,
                        "results", "eval_results", "ours")


def place_object(hand, vg, ds, obj_ckpt_dir, out_dir):
    """The trained object's best checkpoint moved to touch the hand, as a
    grasped object does, where camera 0 sees the contact.

    The synthetic object is a hollow shell of radius 0.375-0.625 m about
    the origin and the synthetic hand lies inside it, within 0.21 m of
    the origin: as trained, no point of one is within 4 mm of the other.
    The object moves along the direction u from the posed hand's centre
    at frame 0 toward camera 0, in 5 mm steps from 10 cm inside to 15 cm
    beyond the reach of its wall facing the hand (where the hand is in
    reach). At each step the hand's contacts are accumulated over the
    dataset's frames and rendered as acc_gt_eval's contact panel renders
    frame 0 (grey, on the posed hand, from camera 0); the step that
    lights the most pixels above 0.5 is taken, the nearer on a tie. The
    searches at each step take only the object's points within the 4 mm
    threshold of the box about the posed hand's (no other point can be a
    hand point's neighbour within it). Writes the moved checkpoint into
    out_dir; returns (shift, hand points in contact at frame 0, lit
    pixels)."""
    with np.load(ckpt_mod.find_best_checkpoint(obj_ckpt_dir)) as z:
        obj = {k: z[k] for k in z.files}
    dev = hand.active.device
    xyz = torch.as_tensor(obj[".model/.params/.xyz"], device=dev)
    live = xyz[torch.as_tensor(obj[".model/.active"], device=dev)]
    p, opts = hand.params, GaussianOpts()
    skin_w = resolve_skin_weights(hand, vg)
    with torch.no_grad():
        posed = [forward_gaussians(p, hand.active, skin_w,
                                   cli._bone_tf(ds, f, vg), opts)
                 for f in range(ds.num_frames)]
    h_xyz, h_cov, h_tf = posed[0]
    cam = index_camera(ds.cameras, 0)
    centre = h_xyz[hand.active].mean(0)
    u = cam.camera_center - centre
    u = u / u.norm()
    rel = live - live.mean(0)
    # the object's wall facing the hand: its points within ~10 degrees of
    # -u about its centre
    cos = -(rel @ u) / rel.norm(dim=1)
    wall = rel.norm(dim=1)[cos > 0.985].median().item()
    bg = torch.zeros(3, device=dev)
    h_live = torch.cat([x[hand.active] for x, _, _ in posed])
    lo = h_live.amin(0) - CONTACT_THRESHOLD
    hi = h_live.amax(0) + CONTACT_THRESHOLD

    def touch(t):
        o = rel + centre + u * t
        o = o[((o >= lo) & (o <= hi)).all(1)]
        if not len(o):
            return 0, 0
        d01 = [contact_map(x, o, hand.active)[0] for x, _, _ in posed]
        gray = apply_colormap(torch.stack(d01).sum(0).clamp(0, 1), "gray")
        with torch.no_grad():
            img = render_gaussians(
                h_xyz, h_cov, p.xyz, get_features(p), get_opacity(p), cam,
                bg, colors_precomp=gray, tf=h_tf, active=hand.active).render
        return int((d01[0] > 0).sum()), int((img.mean(-1) > 0.5).sum())

    ts = [wall - 0.1 + 0.005 * k for k in range(51)]
    found = [touch(t) for t in ts]
    print("composite: object placements (m along u past its wall's reach, "
          "hand points in contact at frame 0, lit pixels): "
          f"{[(round(t - wall, 3), *x) for t, x in zip(ts, found) if x[0]]}")
    t = ts[int(np.argmax([lit for _, lit in found]))]
    shift = (centre + u * t - live.mean(0)).cpu().numpy()
    obj[".model/.params/.xyz"] = (obj[".model/.params/.xyz"]
                                  + shift).astype(np.float32)
    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(out_dir, "step000001-loss0.000000.npz"), **obj)
    return (shift, *touch(t))


def contact_reference(x, y, y_valid, d01, idx, rows):
    """The card's contact map of queries x against y (d01, idx) on `rows`,
    held to float64 on the CPU: |d - d_exact| <= min(sqrt(eps),
    eps / (d + d_exact)) on the clipped distances, eps = 8 u (|x| +
    max |y|)^2 (the float32 expansion's rounding,
    tests/test_torch_colormap_contacts.py), and the index the exact
    nearest wherever it beats the second by more than 2 eps in d^2.
    Returns (largest error over its bound, share of rows with a unique
    nearest, contacts among the rows)."""
    xs = x[rows].double().cpu()
    ys = y[y_valid].double().cpu()
    valid_idx = torch.nonzero(y_valid).reshape(-1).cpu()
    best, second, arg = [], [], []
    for i in range(0, len(rows), 64):
        d2 = ((xs[i:i + 64, None, :] - ys[None]) ** 2).sum(-1)
        top = torch.topk(d2, 2, dim=1, largest=False)
        best.append(top.values[:, 0])
        second.append(top.values[:, 1])
        arg.append(valid_idx[top.indices[:, 0]])
    best, second, arg = torch.cat(best), torch.cat(second), torch.cat(arg)
    eps = (8 * 2.0 ** -24 * (xs.norm(dim=1) + ys.norm(dim=1).max()) ** 2)
    c = CONTACT_THRESHOLD
    d_exact = best.sqrt().clamp(max=c)
    d_card = c * (1.0 - d01[rows].double().cpu())
    bound = torch.minimum(eps.sqrt(), eps / (d_card + d_exact).clamp(
        min=1e-30)) + 1e-12
    excess = ((d_card - d_exact).abs() / bound).max().item()
    unique = second - best > 2 * eps
    check(bool((idx[rows].cpu().long()[unique] == arg[unique]).all()),
          "contact map: a nearest index differs from float64's")
    return excess, unique.double().mean().item(), int((d01[rows] > 0).sum())


def icosphere(level):
    """A unit icosphere: the icosahedron, midpoint-subdivided `level`
    times (train/baselines.subdivide_mesh) and projected on the sphere."""
    t = (1.0 + 5 ** 0.5) / 2
    v = np.array([[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
                  [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
                  [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], np.float64)
    f = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
                  [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
                  [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
                  [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]],
                 np.int32)
    for _ in range(level):
        v, f = subdivide_mesh(v, f)
        v = v / np.linalg.norm(v, axis=1, keepdims=True)
    return v.astype(np.float32), f


def finetune_payload(cfg, models, ds, dev):
    """The composite payload of the fine-tune's first batch (frame and
    view drawn as run_composite draws them) on `models`: the full scene,
    hand and object, binned with the COMPOSITE raster options, as
    make_composite_finetune_step renders it. Returns (payload, bins,
    frame, view)."""
    rng = np.random.RandomState(cfg.trainer.seed)
    f = rng.randint(ds.num_frames)
    v = rng.randint(ds.num_views)
    hand, obj, vg = models
    cam = index_camera(ds.cameras, v)
    opts, r = GaussianOpts(), make_raster_config(cfg)
    with torch.no_grad():
        h_xyz, h_cov, h_tf = forward_gaussians(
            hand.params, hand.active, resolve_skin_weights(hand, vg),
            cli._bone_tf(ds, f, vg), opts)
        o_xyz, o_cov, _ = forward_gaussians(obj.params, obj.active, None,
                                            None, opts)
        tf = torch.cat([h_tf, torch.eye(4, device=dev).expand(
            o_xyz.shape[0], 4, 4)])
        posed = torch.cat([h_xyz, o_xyz])
        cano = torch.cat([hand.params.xyz, obj.params.xyz])
        colors = calculate_colors_from_sh(
            posed, torch.cat([get_features(hand.params),
                              get_features(obj.params)]), cano, cam, 3, tf)
        proj = project_gaussians(posed, torch.cat([h_cov, o_cov]), cam,
                                 active=torch.cat([hand.active, obj.active]))
        bins = bin_gaussians(proj, cam.width // TILE, cam.height // TILE,
                             r.tg_max, r.lane_align, r.pair_budget_factor,
                             r.max_pairs_per_tile, r.multi_frac)
        opac = torch.cat([get_opacity(hand.params), get_opacity(obj.params)])
        pay = build_payload(proj, colors, opac.reshape(-1), bins)
    return pay, bins, f, v


def composite_phase(dev, hand_run_dir):
    """COMPOSITE through the CLI on the card (docstring phase 10). Returns
    the summed {kernel: launches} of its composite runs."""
    shutil.rmtree(COMPOSITE_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    otr, _, olines, opeak, owall = _run_cli(OBJECT_ARGS)
    obj_events = [ln for ln in olines if ln.startswith("[densify]")]
    print(f"composite: object trained through the CLI: {OBJECT_STEPS} steps "
          f"in {owall:.1f} s, {int(otr.state.model.active.sum())} of "
          f"{otr.state.model.capacity} slots live, events {obj_events}, "
          f"peak {opeak:.1f} MiB")
    check(any(ln.startswith(f"[densify] step {OBJECT_DENSIFY_AT}")
              for ln in obj_events), "composite: the object's densify event "
          f"did not fire at step {OBJECT_DENSIFY_AT}")
    hand_ckpts = os.path.join(hand_run_dir, "checkpoints")
    cfg = composite_config()
    apply_overrides(cfg, _cli_args()[2:])
    ds = cli.build_dataset(cfg, "test", dev)
    hand0, vg0 = cli._load_model(hand_ckpts, dev)
    bone_tf = cli._bone_tf(ds, 0, vg0)
    placed = os.path.join(COMPOSITE_DIR, "object_placed", "checkpoints")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    shift, touching, lit = place_object(hand0, vg0, ds, otr.ckpt_dir, placed)
    torch.cuda.synchronize()
    del otr
    print(f"composite: placement scan {time.perf_counter() - t1:.2f} s; "
          f"the object moved by {np.round(shift, 4).tolist()} m "
          f"toward camera 0: {touching} of the hand's "
          f"{int(hand0.active.sum())} live points in contact at frame 0, "
          f"{lit} pixels of frame 0's accumulated contact panel above 0.5")
    check(lit > 0, "composite: no placement of the object lights a pixel "
          "of the contact panel")
    ckpts = [f"hand_ckpt_dir={hand_ckpts}", f"object_ckpt_dir={placed}"]

    total = dict.fromkeys(COUNTED, 0)
    runs = {}
    n_gt = COMPOSITE_FRAMES * COMPOSITE_VIEWS
    for exp, mode, extra in COMPOSITE_RUNS:
        run, launches, lines, peak, wall = _run_cli(_cli_args(
            *ckpts, f"trainer.exp_name={exp}",
            f"contact_render_type={mode}", *extra))
        runs[exp if mode != "acc_gt_eval" else mode] = run
        steps = len(run.finetune_loss)
        for name in total:
            total[name] += launches[name]
        frames = len(run.frames)
        ms = [x * 1e3 for x in run.frame_s]
        print(f"composite {mode} ({exp}): {frames} frames, {wall:.1f} s "
              f"through the CLI; ms a frame (contacts both ways, "
              f"{PANELS[mode]} panels, copy to the host) median "
              f"{statistics.median(ms):.3f} (first {ms[0]:.3f}, max "
              f"{max(ms):.3f}); pair_overflow {run.pair_overflow}; peak "
              f"{peak:.1f} MiB; launches {launches}")
        want_fwd = n_gt + PANELS[mode] * frames + steps
        check(launches["composite_fwd"] == want_fwd,
              f"composite {mode}: composite_fwd launched "
              f"{launches['composite_fwd']} times, not {n_gt} gt renders + "
              f"{PANELS[mode]} x {frames} panels + {steps} steps")
        check(launches["composite_bwd"] == steps,
              f"composite {mode}: composite_bwd launched "
              f"{launches['composite_bwd']} times, not {steps}")
        # a fine-tune step differentiates the hand's covariance, skinning
        # and grid sample (to its positions, where a grid gives the
        # weights) once each; the object is frozen
        deform_want = {"covariance_bwd": steps, "skin_bwd": steps,
                       "skin_sample_bwd": 0 if run.models.voxel_grid is None
                       else steps}
        deform_got = {n: launches[n] for n in deform_want}
        check(deform_got == deform_want, f"composite {mode}: the "
              f"deformation backwards launched {deform_got} times, not "
              f"{deform_want}")
        check(launches["nearest_neighbor"] >= 2 * frames,
              f"composite {mode}: the search kernel launched "
              f"{launches['nearest_neighbor']} times for {frames} frames")
        check(all(launches[n] == 0 for n in COUNTERS
                  if not n.startswith("composite")),
              f"composite {mode}: an LPIPS kernel ran")
        check_projection(launches, f"composite {mode}")
        acc = np.load(os.path.join(_ours_dir(exp), "acc_contacts.npy"))
        check(acc.shape == (run.models.hand.capacity,) and acc.dtype ==
              np.float32, f"composite {mode}: acc_contacts.npy {acc.shape}")
        bound = frames if mode != "acc_gt_eval" else COMPOSITE_FRAMES
        check(bool(np.isfinite(acc).all() and (acc >= 0).all()
                   and (acc <= bound).all()),
              f"composite {mode}: acc_contacts.npy not in [0, {bound}]")
        pngs = [f for f in os.listdir(_ours_dir(exp)) if f.endswith(".png")]
        check(len(pngs) == frames, f"composite {mode}: {len(pngs)} PNGs for "
              f"{frames} frames")
        video = read_video(run.video)
        check(len(video) == frames and all(
            np.array_equal(v, read_png(os.path.join(_ours_dir(exp),
                                                    f"{f:04d}.png")))
            for v, f in zip(video, run.frames)),
            f"composite {mode}: {run.video} is not its PNG frames")
        os.remove(run.video)
        if steps:
            ft_ms = run.finetune_s / steps * 1e3
            first, last = (statistics.mean(run.finetune_loss[sl])
                           for sl in (slice(0, 10), slice(-10, None)))
            print(f"composite fine-tune (optimize_hand): {steps} steps, "
                  f"{ft_ms:.3f} ms/step; loss mean of the first 10 steps "
                  f"{first:.6f}, of the last 10 {last:.6f}")

    # the path run saw its frames from the camera path, not the rig
    check(not np.array_equal(
        read_png(os.path.join(_ours_dir("path"), "0000.png")),
        read_png(os.path.join(_ours_dir("results"), "0000.png"))),
        "composite: the camera-path run rendered the rig's cameras")

    res = runs["results"]
    hand, obj, vg = res.models

    # one frame's contact maps on the card against float64 on the CPU
    opts = GaussianOpts()
    with torch.no_grad():
        h_xyz, _, _ = forward_gaussians(hand.params, hand.active,
                                        resolve_skin_weights(hand, vg),
                                        bone_tf, opts)
    o_xyz = obj.params.xyz
    search_ms = cuda_ms(lambda: contact_map(h_xyz, o_xyz, hand.active,
                                            obj.active), 3)
    h_d01, h_idx, _ = contact_map(h_xyz, o_xyz, hand.active, obj.active)
    o_d01, o_idx, _ = contact_map(o_xyz, h_xyz, obj.active, hand.active)
    gen = torch.Generator().manual_seed(0)
    n_contact = int((h_d01 > 0).sum())
    for tag, x, y, xv, yv, d01, idx in (
            ("hand->object", h_xyz, o_xyz, hand.active, obj.active, h_d01,
             h_idx),
            ("object->hand", o_xyz, h_xyz, obj.active, hand.active, o_d01,
             o_idx)):
        live = torch.nonzero(xv).reshape(-1).cpu()
        # half the rows from the points in contact, so the near-contact
        # conditioning is exercised
        near = torch.nonzero(d01 > 0).reshape(-1).cpu()
        near = near[torch.randperm(len(near), generator=gen)[
            :CONTACT_ROWS // 2]]
        rest = live[~torch.isin(live, near)]
        rest = rest[torch.randperm(len(rest), generator=gen)[
            :CONTACT_ROWS - len(near)]]
        rows = torch.cat([near, rest]).to(dev)
        excess, unique, in_contact = contact_reference(x, y, yv, d01, idx,
                                                       rows)
        print(f"composite contacts {tag}: {int(xv.sum())} x {int(yv.sum())} "
              f"live of {x.shape[0]} x {y.shape[0]} slots; {len(rows)} rows "
              f"against float64 on the CPU: largest error {excess:.3f} of "
              f"its bound, {unique:.4f} of the rows with a unique nearest; "
              f"{in_contact} of the rows in contact; "
              f"{int((d01 > 0).sum())} points in contact")
        check(excess <= 1.0, f"composite contacts {tag}: beyond the bound")
    print(f"composite: one contact search (131,072 x 131,072 slots, hand "
          f"-> object) {search_ms:.3f} ms; hand points in contact at frame "
          f"0: {n_contact}")
    check(n_contact > 0, "composite: no hand point is in contact")

    # one results frame through the kernels against the plain composite
    raster = make_raster_config(cfg)
    aux = torch.zeros(hand.capacity, 3, device=dev)
    acc0 = torch.zeros(hand.capacity, device=dev)
    out = {}
    for backend in ("cuda", "torch"):
        fn = make_composite_render(cfg, raster._replace(backend=backend),
                                   "results")
        out[backend] = fn(res.models, bone_tf, index_camera(ds.cameras, 0),
                          index_camera(ds.cameras, 0), torch.zeros(3,
                                                                   device=dev),
                          acc0, aux)
    (rk, ak, dk), (rp, ap, dp) = out["cuda"], out["torch"]
    err = (rk - rp).abs().amax(-1)
    flips = int((err > FWD_ATOL).sum())
    print(f"composite results frame 0, kernels against the plain composite: "
          f"max abs err {err.max().item():.3e}, {flips} of {err.numel()} "
          f"pixels beyond {FWD_ATOL}")
    check(err.max().item() <= FLIP_ATOL and flips <= FLIP_SHARE * err.numel()
          and torch.equal(ak, ap) and torch.equal(dk, dp),
          "composite: the kernels' frame disagrees with the plain one")

    # the backward kernel at the fine-tune's shapes: the full scene's
    # payload of its first batch, against the plain backward
    pay, bins, f, v = finetune_payload(cfg, res.models, ds, dev)
    print(f"composite fine-tune batch 0 (frame {f}, view {v}): "
          f"{pay.shape[1]} payload columns for "
          f"{hand.capacity + obj.capacity} slots, pair_overflow "
          f"{int(bins.overflow_count)}")
    torch.cuda.reset_peak_memory_stats()
    composite_check(pay, bins, dev, "fine-tune scene", COMPOSITE_SIZE,
                    COMPOSITE_SIZE)
    print(f"composite fine-tune scene check: peak "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    del pay, bins

    # the fine-tune lowers the composite loss over the images it draws
    # from (each loss from a step on a fresh state, before its update)
    ft = runs["finetune"]
    step = make_composite_finetune_step(cfg, raster, "hand", voxel_grid=vg)

    def batch_of(f, v):
        raw = ds.get_batch(f, np.asarray([v]))
        return dict(rgb=torch.as_tensor(raw["rgb"][0], device=dev),
                    mask=torch.as_tensor(raw["mask"][0], dtype=torch.float32,
                                         device=dev),
                    camera=index_camera(ds.cameras, v),
                    bg=torch.zeros(3, device=dev),
                    bone_tf=cli._bone_tf(ds, f, vg))

    def scene_loss(h):
        losses = [step(init_train_state(h), obj, batch_of(f, v))[1]["loss"]
                  for f in range(ds.num_frames) for v in range(ds.num_views)]
        return torch.stack(losses).mean().item()

    before, after = scene_loss(hand0), scene_loss(ft.models.hand)
    print(f"composite fine-tune: loss over the {ds.num_frames} x "
          f"{ds.num_views} images {before:.6f} with the trained hand, "
          f"{after:.6f} after {len(ft.finetune_loss)} steps")
    check(after < before, "composite: the fine-tune loss did not fall")

    # a traced fine-tune step: the slots the trained model places in the
    # scene, and the rows the projection kernel's one backward launch
    # covers (the frozen object's among them)
    trace.clear()
    trace.enable()
    try:
        step(init_train_state(hand0), obj, batch_of(0, 0))
    finally:
        trace.disable()
    counted = {}
    for c in trace.counters():
        counted.setdefault(c.name, []).append(c.value)
    trace.clear()
    rows = hand0.capacity + obj.capacity
    print(f"composite fine-tune traced step: counters {counted}")
    check(counted.get("composite.rows_trained") == [hand0.capacity]
          and counted.get("raster.grad_rows") == [rows],
          f"composite: a traced fine-tune step counted {counted}, not "
          f"{hand0.capacity} trained rows and one projection backward of "
          f"{rows}")

    # the MANO baseline on a procedural mesh, against the CPU
    verts, faces = icosphere(BASELINE_LEVEL)
    # about the hand's points in contact at frame 0, through the object's
    # 200th nearest point to there (so it crosses the object's wall)
    obj_pts = obj.params.xyz[obj.active]
    centre = h_xyz[h_d01 > 0].mean(0)
    radius = torch.kthvalue((obj_pts - centre).norm(dim=1), 200).values
    rest = verts * radius.item() + centre.cpu().numpy()
    posed = [rest + np.float32([0, 0, 0.004 * f])
             for f in range(BASELINE_FRAMES)]
    obj_pts = obj_pts.cpu().numpy()
    mano_dir = os.path.join(os.path.dirname(_ours_dir("eval")), "mano")
    eval_frames = runs["acc_gt_eval"].frames
    cams = [index_camera(ds.cameras, f % ds.num_views) for f in eval_frames]
    for fn_ in COUNTERS.values():
        fn_.launches = 0
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    acc_g = mano_baseline_contacts(
        rest, faces, posed, obj_pts, mano_dir, cameras=cams,
        camera_names=[f"{f:04d}" for f in eval_frames],
        raster_config=raster, device=dev)
    base_s = time.perf_counter() - t1
    base_launches = composite.composite_fwd_cuda.launches
    # each frame's contacts of the subdivided mesh on the card and on the
    # CPU: d01 within the expansion's conditioning bound per vertex,
    # min(sqrt(2 eps), 2 eps / (d_card + d_cpu)) / c with eps = 8 u
    # (max |x| + max |y|)^2 from this frame's norms (contact_reference),
    # plus 1e-6 for the float32 rounding of each d01; the accumulated
    # map within the sum of its frames' bounds of the CPU's sum
    c = CONTACT_THRESHOLD
    acc_c, tol, excess = np.zeros(len(acc_g)), np.zeros(len(acc_g)), 0.0
    for pv in posed:
        fv = faces
        for _ in range(3):  # mano_baseline_contacts' subdiv_iters
            pv, fv = subdivide_mesh(pv, fv)
        d_g, d_c = (contact_map(torch.as_tensor(pv, device=d),
                                torch.as_tensor(obj_pts, device=d))[0]
                    .double().cpu().numpy() for d in (dev, "cpu"))
        eps = 8 * 2.0 ** -24 * (np.linalg.norm(pv, axis=1).max()
                                + np.linalg.norm(obj_pts, axis=1).max()) ** 2
        da, db = c * (1.0 - d_g), c * (1.0 - d_c)
        bound = np.minimum(np.sqrt(2 * eps), 2 * eps / np.maximum(
            da + db, 1e-30)) / c + 1e-6
        excess = max(excess, float((np.abs(d_g - d_c) / bound).max()))
        acc_c += d_c
        tol += bound
    diff = np.abs(acc_g - acc_c)
    print(f"composite baseline: icosphere level {BASELINE_LEVEL} of radius "
          f"{radius.item():.4f} m subdivided 3 times ({len(acc_g)} vertices), "
          f"{BASELINE_FRAMES} frames, "
          f"{base_s:.2f} s on the card with {len(cams)} renders "
          f"({base_launches} composite_fwd launches); {int((acc_g > 0).sum())}"
          f" vertices in contact; against the CPU: each frame's largest "
          f"error {excess:.3f} of its bound, the accumulated map's max abs "
          f"{diff.max():.3e} ({(diff / tol).max():.3f} of its bound), mean "
          f"{diff.mean():.3e}")
    check(base_launches == len(cams), "composite baseline: launches")
    check(excess <= 1.0 and bool((diff <= tol).all()) and diff.mean() < 1e-4
          and (acc_g > 0).any(),
          "composite baseline: contacts disagree with the CPU's")

    # the evaluation against ground truth made from the acc_gt_eval frames
    # that show contact (a frame without, where IoU is 0 / 0, scores 0)
    gt_dir = os.path.join(COMPOSITE_DIR, "gt")
    lit = []
    for f in eval_frames:
        name = f"{f:04d}.png"
        fr = read_png(os.path.join(_ours_dir("eval"), name))
        w = fr.shape[1] // 2
        skin, contact = fr[:, :w], fr[:, w:]
        seg = contact.mean(-1) > 127.5
        if not seg.any():
            continue
        lit.append(f)
        dump_image(seg.astype(np.uint8) * 255,
                   os.path.join(gt_dir, "gt_contacts_seg", name))
        dump_image(np.dstack([skin, (skin.max(-1) > 0).astype(np.uint8)
                              * 255]),
                   os.path.join(gt_dir, "gt_contacts", name))
    print(f"composite eval: frames {lit} of {eval_frames} show contact")
    check(len(lit) > 0, "composite eval: no acc_gt_eval frame shows contact")
    scores, _, _, epeak, ewall = _run_cli([
        "--config-name", "COMPOSITE", "trainer.mode=eval_contacts",
        "trainer.exp_name=eval", f"trainer.output_dir={COMPOSITE_DIR}",
        f"gt_contact_dir={gt_dir}"])
    with open(os.path.join(os.path.dirname(_ours_dir("eval")),
                           "eval_metric.csv")) as f:
        table = [ln.split(",")[0] for ln in f.read().splitlines()]
    print(f"composite eval_contacts: {ewall:.2f} s for {len(lit)} frames, "
          f"scores {scores}, rows {table}, peak {epeak:.1f} MiB")
    check(scores["ours"] == {"iou": 1.0, "f1": 1.0},
          f"composite eval: ours scores {scores['ours']}, not 1")
    check("mano" in scores and "mano" in table,
          "composite eval: no mano column")
    print(f"composite: phase {time.perf_counter() - t0:.1f} s")

    # keep one frame a run and the tables; drop the rest
    for exp in {e for e, _, _ in COMPOSITE_RUNS}:
        ours = _ours_dir(exp)
        for name in sorted(os.listdir(ours))[1:]:
            if name.endswith(".png"):
                os.remove(os.path.join(ours, name))
    for sub in ("gt_eval", "acc_eval", "acc_eval_rendered"):
        shutil.rmtree(os.path.join(mano_dir, sub), ignore_errors=True)
    for name in ("eval_collage.png",):
        path = os.path.join(os.path.dirname(_ours_dir("eval")), name)
        if os.path.exists(path):
            os.remove(path)
    return total


def hand20_skeleton() -> dict:
    """A 20-bone hand in preprocess.ik.default_hand_dof's layout, from
    fixed numbers (metres, the wrist at the origin, fingers along +y):
    bones 0-3 the thumb from the wrist, then four fingers of metacarpal,
    proximal, middle and distal bones, each finger a chain from the
    wrist. Its 21 keypoints are the wrist and the 20 tails."""
    names, parents, heads, tails = [], [], [], []
    thumb = [[0, 0, 0], [0.025, 0.02, 0.005], [0.045, 0.045, 0.01],
             [0.06, 0.065, 0.012], [0.072, 0.085, 0.013]]
    for i in range(4):
        names.append(f"thumb_{i}")
        parents.append(-1 if i == 0 else i - 1)
        heads.append(thumb[i])
        tails.append(thumb[i + 1])
    for k, (x, lens) in enumerate([(0.025, [0.07, 0.04, 0.025, 0.02]),
                                   (0.005, [0.075, 0.045, 0.028, 0.022]),
                                   (-0.015, [0.07, 0.042, 0.026, 0.02]),
                                   (-0.033, [0.065, 0.032, 0.02, 0.018])]):
        base, y = len(names), 0.0
        for j, length in enumerate(lens):
            names.append(f"finger{k}_{j}")
            parents.append(-1 if j == 0 else base + j - 1)
            heads.append([x if j else 0.0, y, 0.0])
            y += length
            tails.append([x, y, 0.0])
    heads = np.asarray(heads, np.float32)
    tails = np.asarray(tails, np.float32)
    rest = np.tile(np.eye(4, dtype=np.float32), (20, 1, 1))
    rest[:, :3, 3] = heads
    return dict(bnames=names, parents=np.asarray(parents),
                bnames_parent=["None" if p < 0 else names[p]
                               for p in parents],
                rest_transforms=rest, rest_heads=heads, rest_tails=tails)


def pipeline_capture(dev):
    """The capture of the pipeline check: its keypoints2d [F, V, 21, 3],
    projections [V, 3, 4], the true keypoints [F, 21, 3], the number of
    views with an outlier on each keypoint [F, 21] and the skeleton. The
    two views of a frame draw their joints independently, so a joint may
    carry an outlier in both."""
    skel = hand20_skeleton()
    seq = generate_flexion_sequence(skel, num_frames=PIPE_FRAMES,
                                    device=dev)
    truth = np.concatenate([seq["pose_heads"][:, :1], seq["pose_tails"]],
                           axis=1).astype(np.float64)
    cams = hemisphere_cameras(PIPE_VIEWS, 512, 512, seed=3, device="cpu")
    P = np.stack([c.K.double().numpy() @ c.extr.double().numpy()[:3]
                  for c in cams])
    homo = np.concatenate([truth, np.ones(truth.shape[:2] + (1,))], -1)
    proj = np.einsum("vab,fjb->fvja", P, homo)
    rng = np.random.RandomState(7)
    xy = proj[..., :2] / proj[..., 2:] + rng.uniform(
        -PIPE_NOISE, PIPE_NOISE, proj.shape[:-1] + (2,))
    n_out = np.zeros((PIPE_FRAMES, 21), np.int64)
    for f in range(PIPE_FRAMES):
        for v in rng.choice(PIPE_VIEWS, 2, replace=False):
            joints = rng.choice(21, PIPE_OUTLIER_JOINTS, replace=False)
            n_out[f, joints] += 1
            xy[f, v, joints] += PIPE_OUTLIER_PX * np.stack(
                [np.cos(a := rng.uniform(0, 2 * np.pi, len(joints))),
                 np.sin(a)], -1)
    kp2d = np.concatenate([xy, np.ones(xy.shape[:-1] + (1,))], -1)
    return kp2d.astype(np.float32), P.astype(np.float32), truth, n_out, skel


def pipeline_check(dev):
    """The preprocessing pipeline through its CLI in process, on the card
    (docstring phase 11, item 5). Returns its times."""
    kp2d, P, truth, n_out, skel = pipeline_capture(dev)
    src = os.path.join(RENDER_DIR, "capture.npz")
    out_npz = os.path.join(RENDER_DIR, "pose.npz")
    np.savez(src, keypoints2d=kp2d, projections=P,
             bnames=np.asarray(skel["bnames"]), parents=skel["parents"],
             rest_matrices=skel["rest_transforms"], heads=skel["rest_heads"],
             tails=skel["rest_tails"])
    loop, guarded_runs = ik_mod.adabelief_loop, []

    def guarded(*args, **kw):  # every frame's iterations: no host sync
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = loop(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        guarded_runs.append(out[1].device.type)
        return out

    ik_mod.adabelief_loop = guarded
    try:
        res = pipeline_mod.main([src, out_npz, "--max-iter",
                                 str(PIPE_ITERS)])
    finally:
        ik_mod.adabelief_loop = loop
    t = res["timings"]
    # iterative_triangulate drops one view a pass, the one whose removal
    # lowers the joint's worst reprojection error most: one outlier view
    # goes, but with two of equal size dropping a clean view can lower
    # the worst error as much, and the joint keeps them (the JAX
    # package's algorithm; ROADMAP Queue C). Those joints are reported.
    err = np.abs(res["keypoints3d"][..., :3] - truth).max(-1)
    tri_err = err[n_out <= 1].max()
    two_err = err[n_out == 2].max(initial=0.0)
    plain = batch_triangulate(torch.as_tensor(kp2d, device=dev),
                              torch.as_tensor(P, device=dev)).cpu().numpy()
    plain_err = np.abs(plain[..., :3] - truth).max()
    losses = res["ik_losses"]
    sq = ((res["keypoints3d"][..., :3] - truth) ** 2).sum(-1).mean(-1)
    loss_bound = PIPE_IK_LOSS + 2 * sq
    it_ms = t["ik_s"] / (PIPE_FRAMES * PIPE_ITERS) * 1e3
    print(f"pipeline: {PIPE_FRAMES} frames x {PIPE_VIEWS} views x 21 "
          f"keypoints at 512x512 through python -m "
          f"manus_tpu_torch.preprocess.pipeline: triangulation "
          f"{t['triangulate_s'] * 1e3:.1f} ms (all frames in one batch), "
          f"largest error {tri_err * 1e3:.3f} mm at the keypoints with at "
          f"most one outlier view, {two_err * 1e3:.3f} mm at the "
          f"{int((n_out == 2).sum())} with two (kept, Queue C), the plain "
          f"DLT with the outliers in {plain_err * 1e3:.1f} mm; IK "
          f"{t['ik_s']:.2f} s, "
          f"{t['ik_s'] / PIPE_FRAMES:.3f} s a frame, {it_ms:.3f} ms an "
          f"iteration ({PIPE_ITERS} a frame, {len(guarded_runs)} loops "
          f"under set_sync_debug_mode('error') on "
          f"{sorted(set(guarded_runs))}); losses {losses.min():.3e} - "
          f"{losses.max():.3e}; smoothing {t['smooth_s'] * 1e3:.1f} ms")
    check(tri_err <= PIPE_TRI_TOL and plain_err > 2 * PIPE_TRI_TOL,
          f"pipeline: triangulation {tri_err} m from the truth "
          f"(outliers in the plain DLT: {plain_err} m)")
    check(bool((losses < loss_bound).all()),
          f"pipeline: IK losses {losses} over {loss_bound}")
    check(bool(np.isfinite(res["angles_smooth"]).all()),
          "pipeline: non-finite smoothed angles")
    check(guarded_runs == ["cuda"] * PIPE_FRAMES,
          f"pipeline: {len(guarded_runs)} guarded IK loops")

    # the first frames again on the CPU, from the card's inputs: the
    # triangulation from the same 2D keypoints, the IK from the card's
    # triangulated keypoints and bone lengths, warm-started alike
    n = PIPE_CPU_FRAMES
    tri = np.abs(pipeline_mod.triangulate_sequence(kp2d[:n], P, device="cpu")
                 - res["keypoints3d"][:n]).max()
    chain = ik_mod.make_chain(skel["bnames"], skel["parents"],
                              skel["rest_transforms"], skel["rest_heads"],
                              skel["rest_tails"], res["bone_lengths"])
    trans_c, angles_c, losses_c = pipeline_mod.fit_sequence(
        chain, res["keypoints3d"][:n], max_iter=PIPE_ITERS, device="cpu")
    kps = [np.stack([ik_mod.chain_forward(
        chain, torch.as_tensor(tr[f]), torch.as_tensor(an[f]))[0].numpy()
        for f in range(n)])
        for tr, an in ((trans_c, angles_c),
                       (res["trans"][:n], res["angles"][:n]))]
    kp_err = np.abs(kps[0] - kps[1]).max()
    print(f"pipeline: the first {n} frames again on the CPU: triangulation "
          f"within {tri:.3e} m of the card's, IK keypoints within "
          f"{kp_err * 1e3:.4f} mm, losses {losses_c} / {losses[:n]}")
    check(tri <= PIPE_CPU_TRI and kp_err <= PIPE_CPU_KP
          and bool((losses_c < loss_bound[:n]).all()),
          "pipeline: the CPU and the card disagree")
    return dict(triangulate_ms=t["triangulate_s"] * 1e3,
                ik_ms_per_iter=it_ms, ik_s_per_frame=t["ik_s"] / PIPE_FRAMES)


def engines_check(img, dev):
    """lpips_distance and its image gradient at 512x512 on the xla, xla_dx
    and xla_dx_bf16 engines, on a render and a noisy copy of it (as phase
    6's inputs), against the layout chain on the card (the random-feature
    VGG16 of LPIPS_SEED) within ENGINE_REL and ENGINE_COS, xla against
    xla_dx and xla_dx against itself on the CPU within FP32_*, with each
    engine's ms; then the head kernel's fp32 form against the plain head
    on the xla_dx features of this input."""
    params = lpips_mod.random_lpips_params(LPIPS_SEED, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    noisy = (img + 0.1 * torch.randn(img.shape, device=dev, generator=gen)
             ).clamp(0, 1)

    def value_and_grad(engine, p=params, a=noisy, b=img):
        x = a.detach().clone().requires_grad_(True)
        d = lpips_mod.lpips_distance(p, x, b, engine)
        (g,) = torch.autograd.grad(d, [x])
        return d.item(), g.float().reshape(-1)

    def agree(d, g, d_ref, g_ref):
        cos = (g @ g_ref / (g.norm() * g_ref.norm())).item()
        return (abs(d - d_ref) / d_ref, cos,
                abs(g.norm().item() / g_ref.norm().item() - 1))

    d_ref, g_ref = value_and_grad("pallas")
    out, fp32 = {}, {}
    for engine in ("xla", "xla_dx", "xla_dx_bf16"):
        for fn in COUNTERS.values():
            fn.launches = 0
        d, g = value_and_grad(engine)
        heads = (conv_mod.head_fwd_cuda.launches,
                 conv_mod.head_bwd_cuda.launches)
        if engine != "xla_dx_bf16":
            fp32[engine] = (d, g)
        rel, cos, norm_err = agree(d, g, d_ref, g_ref)
        out[engine] = cuda_ms(lambda: value_and_grad(engine), 5)
        print(f"lpips engine {engine} 512x512: {d:.7f} against the layout "
              f"chain's {d_ref:.7f}, rel err {rel:.3e} (<= {ENGINE_REL:.3e})"
              f"; gradient cosine {cos:.6f} (>= {ENGINE_COS}), norm error "
              f"{norm_err:.3e} (<= {GRAD_NORM_RTOL}); {out[engine]:.3f} ms "
              f"distance and gradient; head kernel launches fwd/bwd {heads}")
        check(rel <= ENGINE_REL and cos >= ENGINE_COS
              and norm_err <= GRAD_NORM_RTOL,
              f"lpips engine {engine} disagrees with the layout chain")
        check(heads == ((0, 0) if engine == "xla" else (5, 5)),
              f"lpips engine {engine}: head launches {heads}")
    rel, cos, norm_err = agree(*fp32["xla"], *fp32["xla_dx"])
    print(f"lpips engine xla against xla_dx: rel err {rel:.3e}, gradient "
          f"cosine {cos:.7f}, norm error {norm_err:.3e}")
    check(rel <= FP32_REL and cos >= FP32_COS and norm_err <= FP32_NORM,
          "lpips engines xla and xla_dx disagree")
    out["pallas"] = cuda_ms(lambda: value_and_grad("pallas"), 5)
    print(f"lpips engine pallas (the layout chain) 512x512: "
          f"{out['pallas']:.3f} ms distance and gradient")
    t0 = time.perf_counter()
    cpu = {k: v.cpu() for k, v in params.items()}
    d_c, g_c = value_and_grad("xla_dx", cpu, noisy.cpu(), img.cpu())
    d, g = value_and_grad("xla_dx")
    rel, cos, norm_err = agree(d, g.cpu(), d_c, g_c)
    print(f"lpips engine xla_dx on the card against the CPU: {d:.7f} / "
          f"{d_c:.7f}, rel err {rel:.3e}, gradient cosine {cos:.7f}, norm "
          f"error {norm_err:.3e}; {time.perf_counter() - t0:.1f} s")
    check(rel <= FP32_REL and cos >= FP32_COS and norm_err <= FP32_NORM,
          "lpips engine xla_dx: the card disagrees with the CPU")
    img1, img2 = noisy, img

    # the fp32 head form at this path's shapes, against the plain head
    with torch.no_grad():
        fa = lpips_mod.vgg16_features_xla_dx(params, img1 * 2 - 1)
        fb = lpips_mod.vgg16_features_xla_dx(params, img2 * 2 - 1)
    worst, rows = 0.0, []
    for k, (a, b) in enumerate(zip(fa, fb)):
        c = a.shape[-1]
        a, b = a.reshape(-1, c).contiguous(), b.reshape(-1, c).contiguous()
        lin = params[f"lin{k}_w"].float() * (1.0 / a.shape[0])
        rows.append((a, b, lin))
        got = conv_mod.head_fwd_cuda(a, b, lin).item()
        want = conv_mod.head_fwd_torch(a, b, lin).item()
        ct = torch.ones((), device=dev)
        da, db = conv_mod.head_bwd_cuda(a, b, lin, ct)
        da_p, db_p = conv_mod.head_bwd_torch(a, b, lin)
        errs = [abs(got - want) / abs(want)] + [
            ((x - y).abs().max() / y.abs().max()).item()
            for x, y in ((da, da_p), (db, db_p))]
        worst = max(worst, *errs)
        check(max(errs) <= HEAD_F32_RTOL,
              f"head fp32 stage {k}: errors {errs}")
    # the fp32 form's 5-launch sweeps: the features (256 MB of a and b,
    # five times the L2) are read from HBM on every launch
    ct = torch.ones((), device=dev)
    n_el = sum(a.numel() for a, _, _ in rows)
    fwd_ms = cuda_ms(lambda: [conv_mod.head_fwd_cuda(a, b, lin)
                              for a, b, lin in rows], 5)
    bwd_ms = cuda_ms(lambda: [conv_mod.head_bwd_cuda(a, b, lin, ct)
                              for a, b, lin in rows], 5)
    fwd_plain = cuda_ms(lambda: [conv_mod.head_fwd_torch(a, b, lin)
                                 for a, b, lin in rows], 3)
    bwd_plain = cuda_ms(lambda: [conv_mod.head_bwd_torch(a, b, lin)
                                 for a, b, lin in rows], 3)
    fwd_bound = bound_ms(8 * n_el, HEAD_FWD_FLOP * n_el, FP32_FLOP_PER_S)
    bwd_bound = bound_ms(16 * n_el, HEAD_BWD_FLOP * n_el, FP32_FLOP_PER_S)
    print(f"head kernels' fp32 form on the xla_dx features at 512x512, 5 "
          f"stages: largest relative error {worst:.3e} (<= {HEAD_F32_RTOL});"
          f" sweep of 5 launches, forward {fwd_ms:.4f} ms (plain "
          f"{fwd_plain:.4f}, bound {fwd_bound[0]:.4f}, bytes), backward "
          f"with da and db {bwd_ms:.4f} ms (plain {bwd_plain:.4f}, bound "
          f"{bwd_bound[0]:.4f}, bytes)")
    out.update(head_f32_fwd_ms=fwd_ms, head_f32_bwd_ms=bwd_ms,
               head_f32_fwd_bound_ms=fwd_bound[0],
               head_f32_bwd_bound_ms=bwd_bound[0],
               head_f32_fwd_plain_ms=fwd_plain,
               head_f32_bwd_plain_ms=bwd_plain)
    return out


def render_phase(dev, hand_run_dir, val_psnr):
    """The render, test and pose entry points through the CLI on phase 9's
    hand, the pipeline at a capture's width, and the LPIPS engines
    (docstring phase 11). val_psnr: phase 9's last validation PSNR.
    Returns the composite forward's launches on this phase's path."""
    shutil.rmtree(RENDER_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    ckpts = os.path.join(hand_run_dir, "checkpoints")
    base = ["--config-name", hand_run_dir, f"trainer.output_dir={RENDER_DIR}",
            "trainer.exp_name=hand", f"render_ckpt_dir={ckpts}",
            f"camera_path={PATH_PKL}"]

    cfg = load_config_snapshot(hand_run_dir)
    size = (cfg.dataset.width, cfg.dataset.height)
    path, _, _, _, _ = _run_cli([*base, "trainer.mode=make_path",
                                 f"render_frames={PATH_FRAMES}"])
    cams = load_camera_path(path, *size, device=dev)
    check(len(cams) == PATH_FRAMES, f"make_path: {len(cams)} cameras")

    run, launches, _, peak, wall = _run_cli([
        *base, "trainer.mode=render_path", f"render_frames={PATH_FRAMES}"])
    path_fwd = launches["composite_fwd"]
    ms = [x * 1e3 for x in run.frame_s]
    lit = float(np.mean([(f.max(-1) > 0).mean() for f in run.frames]))
    print(f"render_path: {len(run.frames)} frames at {size[0]}x{size[1]} in "
          f"{wall:.1f} s "
          f"through the CLI; ms a frame (render, copy to the host) median "
          f"{statistics.median(ms):.3f} (first {ms[0]:.3f}, max "
          f"{max(ms):.3f}); {lit:.4f} of the pixels lit; peak {peak:.1f} "
          f"MiB; launches {launches}; video {run.video} "
          f"({os.path.getsize(run.video) / 2**20:.1f} MiB)")
    check(path_fwd == PATH_FRAMES and all(
        launches[n] == 0 for n in COUNTERS if n != "composite_fwd"),
          f"render_path: launches {launches}")
    check_projection(launches, "render_path")
    check(lit > 0.005, "render_path: the hand is not in the frames")
    video = read_video(run.video)
    check(len(video) == PATH_FRAMES and all(
        np.array_equal(a, b) for a, b in zip(video, run.frames)),
        "render_path: the video does not read back equal to the frames")

    # one path frame through the kernel against the plain composite
    model, vg = cli._load_model(ckpts, dev)
    raster = make_raster_config(cfg)
    imgs = {}
    for backend in ("cuda", "torch"):
        render_one = cli._make_render_one(cfg, model, vg,
                                          raster._replace(backend=backend))
        imgs[backend] = render_one(cams[0], None)[0]
    err = (imgs["cuda"] - imgs["torch"]).abs().amax(-1)
    flips = int((err > FWD_ATOL).sum())
    print(f"render_path frame 0, the kernel against the plain composite: "
          f"max abs err {err.max().item():.3e}, {flips} of {err.numel()} "
          f"pixels beyond {FWD_ATOL}")
    check(err.max().item() <= FLIP_ATOL and flips <= FLIP_SHARE * err.numel(),
          "render_path: the kernel's frame disagrees with the plain one")

    trun, tl, _, tpeak, twall = _run_cli([*base, "trainer.mode=test",
                                          "dataset.worst_cases=true"])
    n_gt = cfg.dataset.num_frames * cfg.dataset.num_cameras
    with open(trun.worst_cases) as f:
        ranked = json.load(f)
    psnrs = [r["psnr"] for r in trun.records]
    print(f"test (worst_cases): {len(trun.records)} frames in {twall:.1f} s, "
          f"ms a frame median {statistics.median(trun.frame_s) * 1e3:.3f}; "
          f"psnr {[round(x, 3) for x in psnrs]} (phase 9's last val psnr "
          f"{val_psnr:.3f}); worst {ranked[0]}; launches {tl} ({n_gt} gt "
          f"renders and one a frame); peak {tpeak:.1f} MiB")
    check(tl["composite_fwd"] == n_gt + len(trun.records),
          f"test: {tl['composite_fwd']} composite launches")
    check_projection(tl, "test (worst_cases)")
    check([r["psnr"] for r in ranked] == sorted(psnrs),
          "test: worst_cases.json is not ranked ascending")
    mean_psnr = statistics.mean(psnrs)
    check(all(math.isfinite(x) for x in psnrs)
          and abs(mean_psnr - val_psnr) < TEST_PSNR_DB,
          f"test: psnrs {psnrs} (mean {mean_psnr}) against the val psnr "
          f"{val_psnr}")
    crun, cl, _, _, cwall = _run_cli([*base, "trainer.mode=test",
                                      "dataset.test_on_canonical_pose=true",
                                      f"render_frames={CANO_FRAMES}"])
    print(f"test (canonical pose): {len(crun.frames)} frames in "
          f"{cwall:.1f} s, video {crun.video}; launches {cl}")
    check(cl["composite_fwd"] == CANO_FRAMES and len(crun.frames) ==
          CANO_FRAMES and crun.video.endswith("test_cano.apng"),
          "test canonical: frames or launches")
    check_projection(cl, "test canonical")
    check(all(np.array_equal(a, b) for a, b in zip(crun.frames,
                                                   read_video(crun.video))),
          "test canonical: the video does not read back")

    pose_pkl = os.path.join(RENDER_DIR, "novel_pose.pkl")
    got, _, _, _, _ = _run_cli([*base, "trainer.mode=make_pose",
                                f"novel_pose_path={pose_pkl}",
                                f"render_frames={PATH_FRAMES}"])
    skel = load_skeleton(got)
    print(f"make_pose: {got}, pose_transforms "
          f"{skel['pose_transforms'].shape} loads back through load_skeleton")
    check(skel["pose_transforms"].shape[0] == PATH_FRAMES
          and np.isfinite(skel["pose_transforms"]).all(),
          "make_pose: the pkl does not load back")

    times = pipeline_check(dev)
    engines = engines_check(
        torch.as_tensor(run.frames[0], device=dev).float() / 255, dev)
    for path_ in (run.video, trun.video, crun.video):
        os.remove(path_)  # the frames were checked; keep the output small
    print(f"render phase: {time.perf_counter() - t0:.1f} s")
    return dict(path_fwd=path_fwd, test_fwd=tl["composite_fwd"],
                cano_fwd=cl["composite_fwd"],
                path_ms=statistics.median(ms), **times,
                **{k if k.startswith("head") else f"lpips_{k}_ms": v
                   for k, v in engines.items()})


def render_rgba(means, cov6, colors, opacity, cam, dev, backend="cuda"):
    """A render through the kernels (backend "torch": the plain
    composite, on the CPU), un-premultiplied, as RGBA uint8 [H, W, 4]
    (alpha: 1 - the final transmittance), with no pair budget (a budget
    cut truncates the frame); checks that binning dropped no pair but the
    farthest of a tile over the 4,096-pair cap."""
    n = means.shape[0]
    with torch.no_grad():
        out = render_gaussians(
            means, cov6, means, torch.zeros(n, 16, 3, device=dev), opacity,
            cam, torch.zeros(3, device=dev), colors_precomp=colors,
            config=RasterConfig(backend=backend, pair_budget_factor=0))
        dropped = int(out.overflow) - int(out.overflow_far)
        check(dropped == 0, f"brics capture: a render dropped {dropped} "
              "pairs short of the per-tile cap")
        alpha = (1.0 - out.t_final).clamp(0, 1)
        rgb = (out.render / alpha.clamp(min=1e-6)[..., None]).clamp(0, 1)
        return (torch.cat([rgb, alpha[..., None]], -1) * 255).round().to(
            torch.uint8)


def crop_rgba(rgba, margin=BRICS_MARGIN):
    """The bbox [xmin, ymin, xmax, ymax] of the lit pixels plus margin
    px, clipped to the frame, and the crop as numpy."""
    lit = rgba[..., 3] > 0
    rows = torch.nonzero(lit.any(1)).flatten().tolist()
    cols = torch.nonzero(lit.any(0)).flatten().tolist()
    h, w = lit.shape
    if not rows:
        rows, cols = [0], [0]
    x0, y0 = max(cols[0] - margin, 0), max(rows[0] - margin, 0)
    x1 = min(cols[-1] + 1 + margin, w)
    y1 = min(rows[-1] + 1 + margin, h)
    return (np.asarray([x0, y0, x1, y1], np.int64),
            rgba[y0:y1, x0:x1].cpu().numpy())


def brics_names(n):
    return [f"brics-sbc-{i // 2 + 1:03d}_cam{i % 2}" for i in range(n)]


def brics_dynamic_capture(root, dev):
    """The dynamic capture (see BRICS_*): two action files of
    BRICS_FRAMES // 2 frames each. Returns (crop bytes, crop count)."""
    skel = hand20_skeleton()
    seq = generate_flexion_sequence(skel, num_frames=BRICS_FRAMES,
                                    device=dev)
    heads, tails, rest = (seq["rest_heads"], seq["rest_tails"],
                          seq["rest_matrixs"])
    pts, cols = sample_gaussians_on_bones(heads, tails, rest,
                                          BRICS_GT_PER_BONE, seed=11)
    j, n = heads.shape[0], pts.shape[0]
    bone_of = np.concatenate([np.tile(np.arange(j), BRICS_GT_PER_BONE),
                              np.tile(np.arange(j), BRICS_GT_PER_BONE // 2)])
    rng = np.random.RandomState(12)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    cov = covariance_from_scaling_rotation(
        t(rng.uniform(0.002, 0.005, (n, 3))), t(rng.normal(size=(n, 4))))
    skin, colors = t(np.eye(j)[bone_of]), t(cols)
    opacity = t(rng.uniform(0.7, 0.98, n))
    center = (heads.mean(0) + tails.mean(0)) / 2
    cams = hemisphere_cameras(BRICS_VIEWS, BRICS_W, BRICS_H, dist=0.6,
                              fov_deg=40.0, seed=13, center=center,
                              device=dev)
    names = brics_names(BRICS_VIEWS)
    nbytes = count = 0
    os.makedirs(root)
    per_action = BRICS_FRAMES // 2
    for a, action in enumerate(("grasp_a", "grasp_b")):
        tree = {"K": {m: c.K.double().cpu().numpy()
                      for m, c in zip(names, cams)},
                "extr": {m: c.extr.double().cpu().numpy()[:3]
                         for m, c in zip(names, cams)},
                "frames": {}}
        for k in range(per_action):
            f = a * per_action + k
            sk = skin_gaussians(t(pts), cov, skin, bone_deformation_transforms(
                t(seq["pose_matrixs"][f]), t(rest)))
            images, bbox = {}, {}
            for m, cam in zip(names, cams):
                bbox[m], images[m] = crop_rgba(render_rgba(
                    sk.posed_xyz, sk.posed_cov, colors, opacity, cam, dev))
                nbytes += images[m].nbytes
                count += 1
            md = dict(
                bnames=np.asarray(
                    [b.encode() for b in skel["bnames"]])[:, None],
                bnames_parent=np.asarray(
                    [b.encode() for b in skel["bnames_parent"]])[:, None],
                rest_heads=heads, rest_tails=tails, rest_matrixs=rest,
                pose_heads=seq["pose_heads"][f],
                pose_tails=seq["pose_tails"][f],
                pose_matrixs=seq["pose_matrixs"][f],
                eulers=np.zeros((j, 3), np.float32),
                root_translation=np.zeros(3, np.float32),
                root_rotation=np.zeros(3, np.float32))
            tree["frames"][str(5 * k)] = dict(images=images, bbox=bbox,
                                              metadata=md)
        hdf5.write_tree(os.path.join(root, f"{action}.hdf5"), tree)
    return nbytes, count


def brics_static_capture(root, dev):
    """The static capture (see BRICS_*): RGBA PNGs, calib/optim_params.txt
    (zero distortion) and mesh/ngp_mesh/mesh.ply."""
    obj = gt_object_gaussians(n=40000, seed=0)
    # a quarter of the size, gaussians a third as wide again (at 0.8 m a
    # wider one spans more than binning's 64 tiles and is cut)
    s, k = 0.25, 0.25 * 0.35

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    means = obj["means"] * s
    cams = hemisphere_cameras(BRICS_STATIC_VIEWS, BRICS_W, BRICS_H,
                              dist=0.8, fov_deg=40.0, seed=14, device=dev)
    rows = []
    for i, (name, cam) in enumerate(zip(brics_names(BRICS_STATIC_VIEWS),
                                        cams)):
        K = cam.K.double().cpu()
        extr = cam.extr.double().cpu()
        q = matrix_to_quaternion(extr[:3, :3]).tolist()  # wxyz
        tv = extr[:3, 3].tolist()
        rows.append(" ".join(map(str, [
            i, BRICS_W, BRICS_H, repr(K[0, 0].item()), repr(K[1, 1].item()),
            repr(K[0, 2].item()), repr(K[1, 2].item()), 0, 0, 0, 0, name,
            *map(repr, q), *map(repr, tv)])))
        rgba = render_rgba(t(means), t(obj["cov6"] * k * k),
                            t(obj["colors"]), t(obj["opacity"]), cam, dev)
        dump_image(rgba.cpu().numpy(), os.path.join(
            root, "images", "refined_seg", name, "000000.png"))
    os.makedirs(os.path.join(root, "calib"))
    with open(os.path.join(root, "calib", "optim_params.txt"), "w") as f:
        f.write("\n".join(rows) + "\n")
    dump_points(means, os.path.join(root, "mesh", "ngp_mesh", "mesh.ply"))


def _validate(kind, root, config):
    """trainer.mode=validate_data through the CLI: (exit code, the
    report's last line)."""
    rc, _, lines, _, wall = _run_cli([
        "--config-name", config, f"dataset.kind={kind}",
        f"dataset.root={root}", f"dataset.width={BRICS_W}",
        f"dataset.height={BRICS_H}", "trainer.mode=validate_data",
        f"trainer.output_dir={BRICS_DIR}", "trainer.exp_name=validate"])
    return rc, f"{lines[-1]} ({wall:.1f} s)"


def _step_ms(tr, lo, hi):
    return statistics.median(x * 1e3 for x in tr.timings["step_s"][lo:hi])


def _loss_falls(run_dir, tag):
    header, rows = _csv_rows(os.path.join(run_dir, "logs",
                                          "train_metrics.csv"))
    loss = [float(r[1]) for r in rows]
    print(f"brics {tag}: loss {loss[0]:.6f} at step {rows[0][0]} -> "
          f"{loss[-1]:.6f} at step {rows[-1][0]}")
    check(all(math.isfinite(x) for x in loss) and loss[-1] < loss[0],
          f"brics {tag}: the loss did not fall: {loss}")


def _loss_falls_in_segments(run_dir, tag, lpips_from, k=5):
    """A short run logged every step: before and after LPIPS joins the
    loss at lpips_from, the mean of each segment's last k losses below
    that of its first k (single steps differ by the view they draw)."""
    _, rows = _csv_rows(os.path.join(run_dir, "logs", "train_metrics.csv"))
    for seg in ([r for r in rows if int(r[0]) < lpips_from],
                [r for r in rows if int(r[0]) >= lpips_from]):
        loss = [float(r[1]) for r in seg]
        first, last = statistics.mean(loss[:k]), statistics.mean(loss[-k:])
        print(f"brics {tag}: steps {seg[0][0]}-{seg[-1][0]}: mean loss of "
              f"the first {k} {first:.6f} -> of the last {k} {last:.6f}")
        check(all(math.isfinite(x) for x in loss) and len(loss) >= 2 * k
              and last < first, f"brics {tag}: the loss did not fall: "
              f"{loss}")


def brics_batch_checks(tr, dev):
    """On one batch of the trained hand at 1280x720: both composite
    kernels against their plain version, lpips_distance and its image
    gradient through the kernels against the plain chain on the CPU."""
    cfg, model = tr.cfg, tr.state.model
    p = model.params
    batch = tr.sample_batch()
    cam = index_camera(batch["cameras"], 0)
    with torch.no_grad():
        posed, cov, tf = forward_gaussians(
            p, model.active, resolve_skin_weights(model, tr.voxel_grid),
            batch["bone_tf"], cfg.model)
        colors = calculate_colors_from_sh(posed, get_features(p), p.xyz, cam,
                                          cfg.model.sh_degree, tf)
        proj = project_gaussians(posed, cov, cam, active=model.active)
        r = cfg.raster
        bins = bin_gaussians(proj, BRICS_W // TILE, BRICS_H // TILE,
                             r.tg_max, r.lane_align, r.pair_budget_factor,
                             r.max_pairs_per_tile, r.multi_frac)
        pay = build_payload(proj, colors, get_opacity(p).reshape(-1), bins)
        pred = render_gaussians(
            posed, cov, p.xyz, get_features(p), get_opacity(p), cam,
            torch.zeros(3, device=dev), sh_degree=cfg.model.sh_degree, tf=tf,
            active=model.active,
            config=make_raster_config(cfg)).render  # cfg's: "cuda"
    composite_check(pay, bins, dev, f"brics {BRICS_W}x{BRICS_H}",
                    width=BRICS_W, height=BRICS_H)
    distance_check(lpips_mod.random_lpips_params(cfg.trainer.seed, "vgg",
                                                 device=dev),
                   pred.clamp(0, 1), batch["rgb"][0],
                   tag=f"{BRICS_W}x{BRICS_H}")


def brics_phase(dev):
    """BRICS captures through the CLI on the card (docstring phase 12).
    Returns the hand run's {kernel: launches}."""
    shutil.rmtree(BRICS_DIR, ignore_errors=True)
    dyn = os.path.join(BRICS_DIR, "capture_dynamic")
    static = os.path.join(BRICS_DIR, "capture_static")
    try:
        return _brics_runs(dev, dyn, static)
    finally:  # the captures (~130 MB) never come back from the card
        for d in (dyn, static, os.path.join(BRICS_DIR, "capture_bad")):
            shutil.rmtree(d, ignore_errors=True)


def _brics_runs(dev, dyn, static):
    t0 = time.perf_counter()
    nbytes, count = brics_dynamic_capture(dyn, dev)
    brics_static_capture(static, dev)
    files = sorted(os.listdir(dyn))
    mib = sum(os.path.getsize(os.path.join(dyn, f)) for f in files) / 2**20
    print(f"brics: captures made in {time.perf_counter() - t0:.1f} s: "
          f"{files}, {mib:.1f} MiB, {count} crops of {nbytes / count / 2**10:.0f} KiB on "
          f"average ({BRICS_VIEWS} cameras x {BRICS_FRAMES} frames); "
          f"{BRICS_STATIC_VIEWS} static PNGs")

    # validate_data: both clean, and a copy with one bbox broken
    for kind, root, config in (("brics_dynamic", dyn, "HAND_GAUSSIAN"),
                               ("brics_static", static, "OBJ_GAUSSIAN")):
        rc, last = _validate(kind, root, config)
        print(f"brics validate_data {kind}: exit {rc}; {last}")
        check(rc == 0, f"brics: validate_data finds {rc} errors in {kind}")
    bad = os.path.join(BRICS_DIR, "capture_bad")
    os.makedirs(bad)
    shutil.copy(os.path.join(dyn, "grasp_a.hdf5"), bad)
    with hdf5.File(os.path.join(bad, "grasp_a.hdf5")) as f:
        at = f["frames/0/bbox"][brics_names(1)[0]].offset()
    with open(os.path.join(bad, "grasp_a.hdf5"), "r+b") as f:
        f.seek(at)
        f.write(np.asarray([500, 0, 400, BRICS_H], "<i8").tobytes())
    rc, last = _validate("brics_dynamic", bad, "HAND_GAUSSIAN")
    print(f"brics validate_data with xmin > xmax in one bbox: exit {rc}; "
          f"{last}")
    check(rc >= 1, "brics: validate_data misses a broken bbox")
    shutil.rmtree(bad)

    # the loaders alone: load seconds, get_batch ms, C++ against numpy
    t1 = time.perf_counter()
    ds = BricsDynamicDataset(dyn, BRICS_W, BRICS_H, device=dev)
    dyn_load = time.perf_counter() - t1
    t1 = time.perf_counter()
    sds = BricsStaticDataset(static, os.path.join(static, "calib"), BRICS_W,
                             BRICS_H, device=dev)
    static_load = time.perf_counter() - t1
    rng = np.random.RandomState(15)
    read_ms, asm_ms, get_ms = [], [], []
    bg = np.zeros(3, np.float32)
    for _ in range(BRICS_TIMED_BATCHES):
        f, v = rng.randint(ds.num_frames), rng.randint(ds.num_views)
        t1 = time.perf_counter()
        crops, bboxes = ds.read_crops(f, [v])
        t2 = time.perf_counter()
        prefetch_mod.assemble_batch_native(crops, bboxes, BRICS_H, BRICS_W,
                                           bg)
        t3 = time.perf_counter()
        ds.get_batch(f, [v])
        t4 = time.perf_counter()
        read_ms.append((t2 - t1) * 1e3)
        asm_ms.append((t3 - t2) * 1e3)
        get_ms.append((t4 - t3) * 1e3)
    # the trainer's copy of such a batch to the card without the image
    # cache: a pageable 14.7 MB (rgb and mask float32), once a step
    raw = ds.get_batch(0, [0])
    h2d_ms = cuda_ms(lambda: [torch.as_tensor(raw[k], device=dev)
                              for k in ("rgb", "mask")], 20)
    crops, bboxes = ds.read_crops(0, np.arange(ds.num_views))
    got = prefetch_mod.assemble_batch_native(crops, bboxes, BRICS_H,
                                             BRICS_W, bg)
    want = prefetch_mod.assemble_batch_numpy(crops, bboxes, BRICS_H,
                                             BRICS_W, bg)
    asm_err = max(float(np.abs(a - b).max()) for a, b in zip(got, want))
    print(f"brics loaders: dynamic train split {ds.num_frames} frames x "
          f"{ds.num_views} cameras loaded in {dyn_load:.3f} s; static "
          f"{sds.num_views} train cameras of {BRICS_STATIC_VIEWS} (skip list "
          f"and val split) loaded in {static_load:.3f} s; get_batch of one "
          f"{BRICS_W}x{BRICS_H} view median {statistics.median(get_ms):.3f} "
          f"ms (HDF5 read {statistics.median(read_ms):.3f}, C++ assembly "
          f"{statistics.median(asm_ms):.3f}; {BRICS_TIMED_BATCHES} random "
          f"views); its pageable copy to the card "
          f"({sum(a.nbytes for a in raw.values()) / 1e6:.1f} MB) {h2d_ms:.3f} "
          f"ms; C++ against numpy on frame 0's {ds.num_views} views: "
          f"max abs err {asm_err:.3e} (tolerance 1e-6)")
    check(sds.num_views == BRICS_STATIC_VIEWS - 12 - 2,
          f"brics: {sds.num_views} static train cameras")
    check(asm_err <= 1e-6, "brics: the C++ assembly differs from numpy")
    del sds
    forms_get_ms = brics_forms_read(dev)
    write_tree_ms = _get_batch_ms(ds)
    print(f"brics get_batch of one {BRICS_W}x{BRICS_H} view, median of "
          f"{BRICS_TIMED_BATCHES} random views: {forms_get_ms:.3f} ms from "
          f"{FORMS_DIR}/capture (h5py, libver latest, lzf and gzip + "
          f"shuffle + fletcher32 crops), {write_tree_ms:.3f} ms from the "
          f"hdf5.write_tree capture (contiguous crops)")
    ds.close()
    del ds

    # HAND_GAUSSIAN on the dynamic capture, every batch from HDF5
    calls = prefetch_mod.assemble_batch_native.calls
    tr, launches, _, peak, wall = _run_cli([
        "--config-name", "HAND_GAUSSIAN", "dataset.kind=brics_dynamic",
        f"dataset.root={dyn}", "dataset.subject=brics_smoke",
        f"dataset.width={BRICS_W}", f"dataset.height={BRICS_H}",
        f"dataset.num_frames={BRICS_FRAMES}", f"capacity={BRICS_CAPACITY}",
        f"dataset.sample_size={BRICS_SAMPLE_SIZE}",
        "trainer.device_cache_mb=0", f"trainer.max_steps={BRICS_STEPS}",
        "trainer.val_every=0", "trainer.checkpoint_every=0",
        "trainer.log_every=10", f"model.start_lpips_iter={BRICS_LPIPS_FROM}",
        "loss.lpips_random_in_loss=true", f"trainer.output_dir={BRICS_DIR}",
        "trainer.exp_name=hand"])
    calls = prefetch_mod.assemble_batch_native.calls - calls
    n_lpips = BRICS_STEPS - BRICS_LPIPS_FROM
    n_eval = launches["composite_fwd"] - BRICS_STEPS
    print(f"brics hand: {BRICS_STEPS} steps through the CLI in {wall:.1f} s, "
          f"{int(tr.state.model.active.sum())} of {BRICS_CAPACITY} slots "
          f"live, {tr.dataset.num_frames} train frames x "
          f"{tr.dataset.num_views} cameras at {tr.dataset.width}x"
          f"{tr.dataset.height}; fit loop median "
          f"{_step_ms(tr, WARMUP, BRICS_LPIPS_FROM):.3f} ms/step before step "
          f"{BRICS_LPIPS_FROM} and "
          f"{_step_ms(tr, BRICS_LPIPS_FROM + WARMUP, None):.3f} "
          f"with LPIPS; peak {peak:.1f} MiB; {calls} C++ assemblies; "
          f"launches {launches} (composite forward: {BRICS_STEPS} steps, "
          f"{n_eval} eval renders; LPIPS kernels: {n_lpips} steps, the gt's "
          f"VGG16 forward each step without the image cache)")
    check(tr.device.type == "cuda", f"brics hand: ran on {tr.device}")
    check(tr._device_cache is None and calls >= BRICS_STEPS,
          f"brics hand: {calls} assemblies for {BRICS_STEPS} steps")
    _loss_falls(tr.out_dir, "hand")
    want_n = {"composite_bwd": BRICS_STEPS, "conv3x3_layout": 26 * n_lpips,
              "conv3x3_layout_dx": 13 * n_lpips,
              "lpips_head_fwd": 5 * n_lpips, "lpips_head_bwd": 5 * n_lpips,
              "conv3x3": 0}
    for name, n in want_n.items():
        check(launches[name] == n,
              f"brics hand: {name} launched {launches[name]} times, not {n}")
    check(n_eval >= 1, f"brics hand: {n_eval} eval renders")
    check_projection(launches, "brics hand")
    brics_batch_checks(tr, dev)
    hand_dir = tr.out_dir
    tr.dataset.close()
    tr.val_dataset.close()
    del tr

    # OBJ_GAUSSIAN on the static capture, over the device image cache
    otr, olaunches, _, opeak, owall = _run_cli([
        "--config-name", "OBJ_GAUSSIAN", "dataset.kind=brics_static",
        f"dataset.root={static}", "dataset.subject=brics_smoke",
        f"dataset.width={BRICS_W}", f"dataset.height={BRICS_H}",
        "capacity=131072", "dataset.sample_size=65536",
        f"trainer.max_steps={BRICS_OBJ_STEPS}", "trainer.val_every=50",
        "trainer.checkpoint_every=0", "trainer.log_every=10",
        f"trainer.output_dir={BRICS_DIR}", "trainer.exp_name=obj"])
    _, vrows = _csv_rows(os.path.join(otr.out_dir, "results",
                                      "val_results.csv"))
    images = os.listdir(os.path.join(otr.out_dir, "results", "val_results",
                                     "images"))
    print(f"brics object: {BRICS_OBJ_STEPS} steps through the CLI in "
          f"{owall:.1f} s, {int(otr.state.model.active.sum())} of 131072 "
          f"slots live, over a {cache_mb(otr._device_cache):.1f} MiB "
          f"image cache ({otr.dataset.num_views} cameras); fit loop median "
          f"{_step_ms(otr, WARMUP, None):.3f} ms/step; peak {opeak:.1f} MiB; "
          f"val on {otr.val_dataset.num_views} held-out cameras: psnr "
          f"{[r[2] for r in vrows]} at steps {[r[1] for r in vrows]}, "
          f"{len(images)} images; launches {olaunches}")
    check(otr._device_cache is not None, "brics object: no image cache")
    check(int(otr.state.model.active.sum()) > 0,
          "brics object: the mask prune left no gaussian")
    check(otr.val_dataset.num_views == 2 and vrows and all(
        math.isfinite(float(r[2])) for r in vrows) and len(images) >= 2,
        "brics object: validation on the 2 held-out cameras")
    check(olaunches["composite_bwd"] == BRICS_OBJ_STEPS,
          f"brics object: composite_bwd {olaunches['composite_bwd']}")
    check_projection(olaunches, "brics object")
    _loss_falls(otr.out_dir, "object")
    obj_dir = otr.out_dir
    del otr
    forms_dir = brics_forms_train(dev)
    for run in (hand_dir, obj_dir, forms_dir):  # configs, CSVs, an image
        for sub in ("checkpoints", os.path.join("results", "val_results",
                                                "gaussians")):
            shutil.rmtree(os.path.join(run, sub), ignore_errors=True)
        img_dir = os.path.join(run, "results", "val_results", "images")
        for name in sorted(os.listdir(img_dir))[1:] if os.path.isdir(
                img_dir) else []:
            os.remove(os.path.join(img_dir, name))
    print(f"brics phase: {time.perf_counter() - t0:.1f} s")
    return launches


def _get_batch_ms(ds, seed=15):
    """The median ms of get_batch on one view over BRICS_TIMED_BATCHES
    random (frame, view) pairs."""
    rng = np.random.RandomState(seed)
    ms = []
    for _ in range(BRICS_TIMED_BATCHES):
        f, v = rng.randint(ds.num_frames), rng.randint(ds.num_views)
        t1 = time.perf_counter()
        ds.get_batch(f, [v])
        ms.append((time.perf_counter() - t1) * 1e3)
    return statistics.median(ms)


def brics_forms_read(dev):
    """Phase 12 (a) and (d): every fixture read by the port's reader
    against the manifest h5py's reads made, the lzf decoder's rate on the
    capture's crops; returns capture/'s get_batch ms."""
    from scripts.torch_hdf5_fixtures import FORMS, manifest

    with open(os.path.join(FORMS_DIR, "manifest.json")) as f:
        want = json.load(f)
    t0 = time.perf_counter()
    ndata = 0
    for name, records in sorted(want.items()):
        with hdf5.File(os.path.join(FORMS_DIR, name)) as h:
            got = manifest(h)
        bad = sorted(k for k in set(got) | set(records)
                     if got.get(k) != records.get(k))
        check(not bad, f"brics forms: {name} differs from the manifest at "
              f"{bad[:5]}")
        ndata += sum("sha256" in r for r in records.values())
    read_s = time.perf_counter() - t0
    # the lzf chunks of one action file, as the reader meets them
    chunks, real = [], hdf5_filters.lzf_decompress

    def keep(data, size):
        chunks.append((data, size))
        return real(data, size)

    hdf5_filters.lzf_decompress = keep
    try:
        with hdf5.File(os.path.join(FORMS_DIR, "capture",
                                    "grasp_a.hdf5")) as h:
            manifest(h)
    finally:
        hdf5_filters.lzf_decompress = real
    out_bytes = sum(size for _, size in chunks)
    t1 = time.perf_counter()
    for _ in range(FORMS_LZF_REPS):
        for data, size in chunks:
            real(data, size)
    lzf_s = (time.perf_counter() - t1) / FORMS_LZF_REPS
    print(f"brics forms: {len(want)} files of {FORMS_DIR} ({ndata} datasets; "
          f"forms {sorted(FORMS)} and capture/) read by the port equal to "
          f"h5py's manifest in {read_s:.3f} s; lzf (csrc/hdf5_filters.cpp, "
          f"host) {len(chunks)} chunks, {out_bytes / 1e6:.3f} MB out in "
          f"{lzf_s * 1e3:.3f} ms: {out_bytes / 1e6 / lzf_s:.1f} MB/s")
    check(len(chunks) > 0, "brics forms: no lzf chunk in capture/")
    ds = BricsDynamicDataset(os.path.join(FORMS_DIR, "capture"), BRICS_W,
                             BRICS_H, device=dev)
    try:
        return _get_batch_ms(ds)
    finally:
        ds.close()


def brics_forms_train(dev):
    """Phase 12 (b) and (c) on the fixtures' capture/; returns the run's
    directory."""
    capture = os.path.join(FORMS_DIR, "capture")
    rc, last = _validate("brics_dynamic", capture, "HAND_GAUSSIAN")
    print(f"brics forms validate_data on {capture}: exit {rc}; {last}")
    check(rc == 0, f"brics forms: validate_data finds {rc} errors")
    calls = prefetch_mod.assemble_batch_native.calls
    tr, launches, _, peak, wall = _run_cli([
        "--config-name", "HAND_GAUSSIAN", "dataset.kind=brics_dynamic",
        f"dataset.root={capture}", "dataset.subject=brics_forms",
        f"dataset.width={BRICS_W}", f"dataset.height={BRICS_H}",
        "dataset.num_frames=4", f"capacity={BRICS_CAPACITY}",
        f"dataset.sample_size={BRICS_SAMPLE_SIZE}",
        "trainer.device_cache_mb=0", f"trainer.max_steps={FORMS_STEPS}",
        "trainer.val_every=0", "trainer.checkpoint_every=0",
        "trainer.log_every=1", f"model.start_lpips_iter={FORMS_LPIPS_FROM}",
        "loss.lpips_random_in_loss=true", f"trainer.output_dir={BRICS_DIR}",
        "trainer.exp_name=forms"])
    calls = prefetch_mod.assemble_batch_native.calls - calls
    n_lpips = FORMS_STEPS - FORMS_LPIPS_FROM
    n_eval = launches["composite_fwd"] - FORMS_STEPS
    print(f"brics forms hand: {FORMS_STEPS} steps through the CLI in "
          f"{wall:.1f} s, {int(tr.state.model.active.sum())} of "
          f"{BRICS_CAPACITY} slots live, {tr.dataset.num_frames} train "
          f"frames x {tr.dataset.num_views} cameras "
          f"({tr.dataset.cam_names[:3]}... in creation order) at "
          f"{tr.dataset.width}x{tr.dataset.height}; fit loop median "
          f"{_step_ms(tr, WARMUP, FORMS_LPIPS_FROM):.3f} ms/step before step "
          f"{FORMS_LPIPS_FROM} and "
          f"{_step_ms(tr, FORMS_LPIPS_FROM + WARMUP, None):.3f} with LPIPS; "
          f"peak {peak:.1f} MiB; {calls} C++ assemblies; launches {launches}")
    check(tr.device.type == "cuda", f"brics forms: ran on {tr.device}")
    check(tr._device_cache is None and calls >= FORMS_STEPS,
          f"brics forms: {calls} assemblies for {FORMS_STEPS} steps")
    _loss_falls_in_segments(tr.out_dir, "forms hand", FORMS_LPIPS_FROM)
    want_n = {"composite_bwd": FORMS_STEPS, "conv3x3_layout": 26 * n_lpips,
              "conv3x3_layout_dx": 13 * n_lpips,
              "lpips_head_fwd": 5 * n_lpips, "lpips_head_bwd": 5 * n_lpips,
              "conv3x3": 0}
    for name, n in want_n.items():
        check(launches[name] == n, f"brics forms: {name} launched "
              f"{launches[name]} times, not {n}")
    check(n_eval >= 1, f"brics forms: {n_eval} eval renders")
    check_projection(launches, "brics forms")
    brics_batch_checks(tr, dev)
    tr.dataset.close()
    tr.val_dataset.close()
    return tr.out_dir


# Phase 13 (parallel): the sharded training path of parallel/.
# (a) The tile-id form of the composite kernels: PAR_G owners of the bench
# scene's view at each of PAR_SHAPES. (b) The training CLI as ranks that
# share the card: PAR_RUNS, each for PAR_STEPS steps with LPIPS on from
# step 0, on the trainer phase's HAND_GAUSSIAN default at full width. (c)
# NCCL at world size 1, and across the cards where there are several.
PAR_G, PAR_SHAPES = 4, ((WIDTH, HEIGHT), (1280, 720))
PAR_HOT = 8  # hybrid's hot_split_tiles, the config's default
PAR_DIR = os.path.join("chiprun_out", "parallel")
PAR_STEPS = 12
# (name, data_axis, gauss_axis, tile_shard_mode, batch_views)
PAR_RUNS = [("gauss2_owner", 1, 2, "owner", 1),
            ("data2_gauss2_pairslice", 2, 2, "pairslice", 2)]
PAR_ARGS = [
    "--config-name", "HAND_GAUSSIAN", f"capacity={TRAINER_CAPACITY}",
    "skin_init=mano_init_voxel", "dataset.grid_res=128",
    "dataset.width=512", "dataset.height=512", "dataset.num_cameras=8",
    "dataset.num_frames=4", f"dataset.sample_size={TRAINER_SAMPLE_SIZE}",
    f"trainer.max_steps={PAR_STEPS}", "trainer.val_every=0",
    "trainer.checkpoint_every=0", "trainer.log_every=1",
    "model.start_lpips_iter=0", "loss.lpips_random_in_loss=true",
    "loss.lpips_gt_cache_mb=8192",
]
# Hybrid's hot tiles are composed of the ranks' depth ranges with the
# 1e-4 stop applied per part (par_raster._over_compose), as in JAX: a part that
# starts above T = 1e-4 is added whole, so a pixel may take pairs beyond
# the one-walk stop, each weighted by T < 1e-4 (colours <= ~1), and its
# T_final may end lower by up to 1e-4. Besides that, FWD_ATOL's rounding
# and, on FLIP_SHARE of the pixels, FLIP_ATOL's walk-end flips.
HYBRID_ATOL = 1e-4 + FWD_ATOL
# The sharded step against the single-process step on one batch: the
# same float32 function, with the view and gaussian sums split over the
# ranks and the payload's gradient summed with atomics (index_add_): the
# loss within rtol 1e-5; each parameter leaf within 1e-5 of its largest
# value, except slots whose gradient is below 1e-4 of the leaf's largest
# (Adam moves a slot by its learning rate whatever the gradient's size,
# so rounding decides their direction), at most 1% of them.
STEP_RTOL, PARAM_NORM_TOL, UNRESOLVED, UNRESOLVED_SHARE = 1e-5, 1e-5, 1e-4, 0.01


def par_bins(cfg, proj, ntx, nty, **kw):
    r = cfg.raster
    return bin_gaussians(proj, ntx, nty, r.tg_max, r.lane_align,
                         r.pair_budget_factor, r.max_pairs_per_tile,
                         r.multi_frac, **kw)


def hot_slots(bins, col, n, k):
    """Column col's depth ranges of the k deepest tiles (the hybrid rule
    of parallel/raster.py): (offsets, counts, tile ids)."""
    hot = torch.argsort(-bins.tile_counts, stable=True)[:k]
    cnt, off = bins.tile_counts[hot], bins.tile_offsets[hot]
    share = -(-cnt // n)
    lo = off + torch.minimum(col * share, cnt)
    hi = off + torch.minimum((col + 1) * share, cnt)
    return lo.contiguous(), (hi - lo).contiguous(), hot.to(torch.int32)


def tile_id_kernels(cfg, model, batch, dev):
    """Phase 13 (a). Returns {shape: per-column numbers} for PERF.md."""
    out = {}
    for w, h in PAR_SHAPES:
        ntx, nty = w // TILE, h // TILE
        tag = f"{w}x{h}"
        cam = scene_cameras(w, h, dev)[0]
        p = model.params
        with torch.no_grad():
            posed, cov, tf = forward_gaussians(
                p, model.active, model.skin_weights, batch["bone_tf"],
                cfg.model)
            colors = calculate_colors_from_sh(posed, get_features(p), p.xyz,
                                              cam, 3, tf)
            proj = project_gaussians(posed, cov, cam, active=model.active)
            opac = get_opacity(p).reshape(-1)
            full = par_bins(cfg, proj, ntx, nty)
            pay = build_payload(proj, colors, opac, full)
        fwd = composite.composite_fwd_cuda(pay, full.tile_offsets,
                                           full.tile_counts, ntx, nty)
        rgb_f, t_f = fwd[:2]
        full_ms = composite_cold_ms(pay, full, dev, width=w, height=h)[:2]
        (fb, _), (bb, _) = composite_bounds(fwd[3])
        _, _, owned, perm = tile_owner_tables(ntx, nty, PAR_G)
        perm = torch.as_tensor(perm, device=dev).long()
        cols = []
        for c in range(PAR_G):
            # the column as the sharded render bins it: its dealt tiles
            ids = torch.as_tensor(owned[c], device=dev)
            with torch.no_grad():
                b = par_bins(cfg, proj, ntx, nty, owner=c, num_owners=PAR_G)
                p_c = build_payload(proj, colors, opac, b)
            fe, be, n_walk, _, _ = composite_check(
                p_c, b, dev, f"{tag} owner {c}/{PAR_G}", w, h, tile_ids=ids)
            ms = composite_cold_ms(p_c, b, dev, width=w, height=h,
                                   tile_ids=ids)[:2]
            (fbc, _), (bbc, _) = composite_bounds(n_walk)
            cols.append(dict(pairs=int(b.tile_counts.sum()),
                             fwd_ms=ms[0], bwd_ms=ms[1], fwd_bound_ms=fbc,
                             bwd_bound_ms=bbc, fwd_err=fe, bwd_err=be))
        for c, r in enumerate(cols):
            print(f"tile ids {tag} owner {c}/{PAR_G}: {r['pairs']} pairs, "
                  f"HBM-cold fwd {r['fwd_ms']:.4f} ms (bound "
                  f"{r['fwd_bound_ms']:.4f}) bwd {r['bwd_ms']:.4f} ms "
                  f"(bound {r['bwd_bound_ms']:.4f})")
        print(f"tile ids {tag}: the full grid, {int(full.tile_counts.sum())} "
              f"pairs in {ntx * nty} tiles: HBM-cold fwd {full_ms[0]:.4f} ms "
              f"(bound {fb:.4f}) bwd {full_ms[1]:.4f} ms (bound {bb:.4f}); "
              f"slowest column fwd {max(r['fwd_ms'] for r in cols):.4f} bwd "
              f"{max(r['bwd_ms'] for r in cols):.4f}")

        # the full binning's segments dealt to the owners: gathered and put
        # back in grid order, the full-grid launch's rows bit for bit
        parts = []
        for c in range(PAR_G):
            ids = torch.as_tensor(owned[c], device=dev)
            parts.append(composite.composite_fwd_cuda(
                pay, full.tile_offsets[ids.long()].contiguous(),
                full.tile_counts[ids.long()].contiguous(), ntx, nty, ids)[:2])
        rgb_o = torch.cat([x[0] for x in parts])[perm]
        t_o = torch.cat([x[1] for x in parts])[perm]
        same = torch.equal(rgb_o, rgb_f) and torch.equal(t_o, t_f)
        print(f"tile ids {tag}: the {PAR_G} owners' tiles gathered and "
              f"un-permuted equal the full-grid kernel's rows: {same}")
        check(same, f"{tag}: the owners' gathered tiles differ from the grid's")

        # hybrid: each column's depth ranges of the hot tiles, composed
        hot_rgb, hot_t = [], []
        for c in range(PAR_G):
            offs, cnts, hot = hot_slots(full, c, PAR_G, PAR_HOT)
            composite_check(pay, full._replace(tile_offsets=offs,
                                               tile_counts=cnts), dev,
                            f"{tag} hybrid hot slots {c}/{PAR_G}", w, h,
                            tile_ids=hot)
            r, t = composite.composite_fwd_cuda(pay, offs, cnts, ntx, nty,
                                                hot)[:2]
            hot_rgb.append(r)
            hot_t.append(t)
        rgb_h, t_h = par_raster._over_compose(torch.stack(hot_rgb),
                                              torch.stack(hot_t))
        hot = hot.long()
        err = torch.maximum((rgb_h - rgb_f[hot]).abs().amax(1),
                            (t_h - t_f[hot]).abs())
        n_off = int((err > HYBRID_ATOL).sum())
        print(f"tile ids {tag}: the {PAR_HOT} hot tiles ({[int(full.tile_counts[i]) for i in hot]} pairs) composed from "
              f"{PAR_G} depth ranges against the full grid: max abs err "
              f"{err.max().item():.3e}, pixels beyond {HYBRID_ATOL:.0e}: "
              f"{n_off}")
        check(n_off <= FLIP_SHARE * err.numel()
              and err.max().item() <= FLIP_ATOL,
              f"{tag}: hybrid's composed hot tiles differ from the grid's")
        out[tag] = dict(columns=cols, full_fwd_ms=full_ms[0],
                        full_bwd_ms=full_ms[1], full_fwd_bound_ms=fb,
                        full_bwd_bound_ms=bb)
    return out


def _param_errors(leaves):
    """Over (got, want, want's first moment) of each leaf: (the largest
    normalised error over the resolved slots, the largest share of slots
    off by more than PARAM_NORM_TOL)."""
    worst, off_share = 0.0, 0.0
    for g, w, m in leaves:
        scale = w.abs().max().clamp(min=1e-8)
        err = (g - w).abs() / scale
        unresolved = m.abs() < UNRESOLVED * m.abs().max()
        worst = max(worst, err[~unresolved].max().item()
                    if (~unresolved).any() else 0.0)
        off_share = max(off_share, (err > PARAM_NORM_TOL).float().mean().item())
    return worst, off_share


def _step_check(dev, mesh, rank):
    """One gauss-sharded (owner) flagship step on one batch against the
    single-process step on rank 0. Returns what rank 0 found."""
    cfg, model, batch, grid = hand_scene(dev, FLAGSHIP_CAPACITY, VOXEL_RES)
    state = init_train_state(model)
    step = make_train_step(cfg, 1.0, True, grid, mesh=mesh)
    composite.composite_fwd_cuda.tile_id_launches = 0
    new, m = step(replicate_state(state, mesh), shard_batch(batch, mesh))
    check_replicated(new, mesh, "states after the step")
    n_ids = composite.composite_fwd_cuda.tile_id_launches
    if rank != 0:
        return {}
    one, m1 = make_train_step(cfg, 1.0, True, grid)(state, batch)
    worst, off = _param_errors([
        (getattr(new.model.params, k), getattr(one.model.params, k),
         getattr(one.opt.m, k)) for k in one.model.params._fields])
    rel = abs(float(m["loss"]) - float(m1["loss"])) / abs(float(m1["loss"]))
    print(f"parallel (b): one owner step over gauss 2 at {FLAGSHIP_CAPACITY} "
          f"gaussians: loss {float(m['loss']):.7f} against the single "
          f"process's {float(m1['loss']):.7f} (rel {rel:.2e}); params worst "
          f"normalised err over resolved slots {worst:.2e}, slots off "
          f"{off:.2e}; grad_accum max abs err "
          f"{(new.stats.grad_accum - one.stats.grad_accum).abs().max().item():.2e}"
          f"; overflow {int(m['pair_overflow'])} / {int(m1['pair_overflow'])}; "
          f"tile-id forward launches {n_ids}")
    check(rel <= STEP_RTOL, "parallel: the sharded step's loss differs")
    check(worst <= PARAM_NORM_TOL and off <= UNRESOLVED_SHARE,
          "parallel: the sharded step's parameters differ")
    check(n_ids == 1, "parallel: the tile-id forward did not run")
    return dict(loss=float(m["loss"]), single_loss=float(m1["loss"]),
                param_err=worst, off_share=off)


def _rank_main(rank, world, port, runs, step_check, out_dir):
    """One rank of phase 13 (b), in its own process: join the world
    (gloo: the ranks share the card), probe gloo on a CUDA tensor, the
    step check, then each run through the CLI. Writes its findings to
    {out_dir}/rank{rank}.json."""
    os.environ.update(LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    initialize_distributed(f"localhost:{port}", world, rank,
                           device_type="cuda")
    res = dict(rank=rank, backend=str(torch.distributed.get_backend()))
    # what the installed torch's gloo does with a CUDA tensor itself (the
    # port stages it through the host by the group's backend)
    x = torch.full((4,), float(rank + 1), device=dev)
    try:
        torch.distributed.all_reduce(x)
        res["gloo_cuda_all_reduce"] = f"ran: {x.tolist()} on {x.device}"
    except Exception as e:  # the probe's answer, printed
        res["gloo_cuda_all_reduce"] = f"refused: {str(e).splitlines()[0]}"
    if step_check:
        mesh = make_mesh(1, world)
        res["step"] = _step_check(dev, mesh, rank)
    for name, n_data, n_gauss, mode, views in runs:
        argv = [*PAR_ARGS, f"trainer.data_axis={n_data}",
                f"trainer.gauss_axis={n_gauss}",
                f"raster.tile_shard_mode={mode}",
                f"trainer.batch_views={views}", "trainer.distributed=true",
                f"trainer.coordinator=localhost:{port}",
                f"trainer.num_processes={world}",
                f"trainer.process_id={rank}",
                f"trainer.output_dir={os.path.join(out_dir, name)}"]
        collectives.STATS.update(calls=0, host_staged=0)
        composite.composite_fwd_cuda.tile_id_launches = 0
        composite.composite_bwd_cuda.tile_id_launches = 0
        tr, launches, lines, peak, wall = _run_cli(argv)
        losses = [float(m.group(1)) for m in
                  (re.search(r"step \d+: loss=([0-9.]+)", ln) for ln in lines)
                  if m]
        res[name] = dict(
            launches=launches, losses=losses, digest=state_digest(tr.state),
            tile_id_launches=[composite.composite_fwd_cuda.tile_id_launches,
                              composite.composite_bwd_cuda.tile_id_launches],
            collectives=dict(collectives.STATS), peak_mib=peak, wall_s=wall,
            step_ms=statistics.median(x * 1e3 for x in
                                      tr.timings["step_s"][WARMUP:]),
            views=[ln for ln in lines if "[mesh]" in ln])
        shutil.rmtree(os.path.join(out_dir, name, "manus_tpu", "synthetic",
                                   "test", "checkpoints"), ignore_errors=True)
        del tr
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    torch.distributed.destroy_process_group()


def shared_card_ranks(world, runs, step_check):
    """Phase 13 (b) for one world: `world` ranks on this card, each its own
    process. Returns their findings, rank by rank."""
    out_dir = os.path.join(PAR_DIR, f"world{world}")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    torch.multiprocessing.spawn(_rank_main, args=(world, port, runs,
                                                  step_check, out_dir),
                                nprocs=world, join=True)
    res = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            res.append(json.load(f))
    return res


def collective_check(group, dev, rank, world, tag):
    """Each collective of parallel/collectives.py on CUDA tensors over
    `group`, against what it must give; with the gathers' backward (the
    sum-scatter). Returns the calls staged through the host."""
    staged = collectives.STATS["host_staged"]
    x = (torch.arange(6.0, device=dev).reshape(3, 2) + 10 * rank) \
        .requires_grad_(True)
    want = torch.cat([torch.arange(6.0, device=dev).reshape(3, 2) + 10 * r
                      for r in range(world)])
    y = collectives.all_gather_tiled(x, group)
    w = torch.arange(want.numel(), device=dev, dtype=torch.float32) \
        .reshape(want.shape)
    (g,) = torch.autograd.grad((y * w).sum(), [x])
    ok = torch.equal(y, want) and torch.equal(g, world * w[3 * rank:3 * rank + 3])
    s = collectives.all_gather_stack(x.detach(), group)
    ok &= torch.equal(s, want.reshape(world, 3, 2))
    mean = collectives.all_reduce_mean(x.detach(), group)
    ok &= torch.allclose(mean, want.reshape(world, 3, 2).mean(0))
    total = collectives.all_reduce_sum(x.detach(), group)
    ok &= torch.equal(total, want.reshape(world, 3, 2).sum(0))
    b = collectives.broadcast(x.detach(), 0, group)
    ok &= torch.equal(b, want[:3])
    staged = collectives.STATS["host_staged"] - staged
    print(f"parallel (c) {tag} rank {rank}: all_gather (tiled, its "
          f"sum-scatter backward; stacked), mean, sum, broadcast over "
          f"{world} rank(s): {'right' if ok else 'WRONG'}; host-staged "
          f"calls {staged}")
    return bool(ok), staged


def _nccl_rank(rank, world, port):
    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    torch.distributed.init_process_group(
        "nccl", init_method=f"tcp://localhost:{port}", world_size=world,
        rank=rank)
    ok, staged = collective_check(torch.distributed.group.WORLD, dev, rank,
                                  world, f"NCCL across {world} cards")
    torch.distributed.destroy_process_group()
    if not ok or staged:
        raise RuntimeError("NCCL collectives across cards are wrong")


def nccl_phase(dev):
    """Phase 13 (c): the collectives over NCCL at world size 1 in this
    process, and across the cards when there are several. Returns what
    ran."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    torch.distributed.init_process_group(
        "nccl", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    ok, staged = collective_check(torch.distributed.group.WORLD, dev, 0, 1,
                                  "NCCL world size 1")
    backend = str(torch.distributed.get_backend())
    torch.distributed.destroy_process_group()
    check(ok and staged == 0 and backend == "nccl",
          "parallel: NCCL collectives at world size 1")
    ran = ["NCCL at world size 1"]
    cards = torch.cuda.device_count()
    if cards > 1:
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        torch.multiprocessing.spawn(_nccl_rank, args=(cards, port),
                                    nprocs=cards, join=True)
        ran.append(f"NCCL across {cards} cards")
    else:
        print("parallel (c): NCCL across cards not run: this machine has "
              "one card")
    return ran


def parallel_phase(cfg, model, batch, dev):
    """Phase 13. Returns the kernels' launches over (b)'s CLI runs, summed
    over their ranks, and (a)'s numbers."""
    t0 = time.perf_counter()
    numbers = tile_id_kernels(cfg, model, batch, dev)
    t_a = time.perf_counter() - t0
    t0 = time.perf_counter()
    runs = [shared_card_ranks(2, PAR_RUNS[:1], step_check=True),
            shared_card_ranks(4, PAR_RUNS[1:], step_check=False)]
    t_b = time.perf_counter() - t0
    launches = dict.fromkeys(COUNTED, 0)
    for ranks, (name, n_data, n_gauss, mode, views) in zip(runs, PAR_RUNS):
        world = n_data * n_gauss
        r0 = ranks[0]
        print(f"parallel (b) {name}: {world} ranks on one card, backend "
              f"{r0['backend']} (NCCL refuses two ranks on one card); "
              f"gloo's own all_reduce of a CUDA tensor: "
              f"{r0['gloo_cuda_all_reduce']}")
        for r in ranks:
            run = r[name]
            print(f"parallel (b) {name} rank {r['rank']}: {run['views']}; "
                  f"losses {[round(x, 6) for x in run['losses']]}; median "
                  f"{run['step_ms']:.3f} ms/step; peak {run['peak_mib']:.1f} "
                  f"MiB; collectives {run['collectives']} (host-staged: "
                  f"the CUDA tensors over gloo; the others are the state "
                  f"checks' digests, on the host); launches "
                  f"{run['launches']}, tile-id form "
                  f"fwd/bwd {run['tile_id_launches']}")
            for k, n in run["launches"].items():
                launches[k] += n
        first = r0[name]
        check(all(r[name]["losses"] == first["losses"]
                  and r[name]["digest"] == first["digest"] for r in ranks),
              f"parallel {name}: the ranks disagree")
        loss = first["losses"]
        check(len(loss) == PAR_STEPS and all(map(math.isfinite, loss)),
              f"parallel {name}: {len(loss)} losses")
        k = PAR_STEPS // 3
        check(sum(loss[-k:]) < sum(loss[:k]),
              f"parallel {name}: the loss did not fall")
        local_views = views // n_data
        for r in ranks:
            fwd_ids, bwd_ids = r[name]["tile_id_launches"]
            want = PAR_STEPS * local_views if mode == "owner" else 0
            check(fwd_ids == want and bwd_ids == want,
                  f"parallel {name}: tile-id launches {fwd_ids}/{bwd_ids}, "
                  f"not {want}")
            check(r[name]["launches"]["composite_bwd"] == PAR_STEPS
                  * local_views, f"parallel {name}: backward launches")
            check_projection(r[name]["launches"],
                             f"parallel {name} rank {r['rank']}")
            # every collective on a CUDA tensor; the state checks' digests
            # are gathered from the host
            check(r[name]["collectives"]["host_staged"] > 0,
                  f"parallel {name}: no collective staged through gloo")
    t0 = time.perf_counter()
    ran = nccl_phase(dev)
    print(f"parallel: ran (a) the tile-id kernels at {list(numbers)}, "
          f"(b) {[n for n, *_ in PAR_RUNS]} as ranks sharing one card over "
          f"gloo with host-staged collectives, (c) {ran}; "
          f"{t_a:.1f} s + {t_b:.1f} s + {time.perf_counter() - t0:.1f} s")
    print(f"parallel numbers: {json.dumps(numbers)}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = gpu_name_and_power()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    # the kernel sources (nvcc) and the host assembly (g++)
    names = ["composite", "conv3x3", "lpips_head", "knn", "project", "ssim",
             "deform", "image_ops"]
    cached = [n for n in names if cuda_build.library_path(n).exists()
              and cuda_build.log_path(n).exists()]
    logs = cuda_build.build(names)
    print(f"build: {time.perf_counter() - t0:.1f} s into {cuda_build.BUILD_DIR}"
          f" (built earlier, their ptxas reports read from the logs beside "
          f"them: {cached or 'none'})")
    spills = 0
    for log in logs.values():
        for line in log.splitlines():
            if "registers" in line or "Compiling entry" in line:
                print("  " + line.strip())
            if "spill" in line and "0 bytes spill stores, 0 bytes spill " \
                    "loads" not in line:
                print("  " + line.strip())
                spills += 1
    check(spills == 0, f"ptxas reports register spills in {spills} kernels")

    t0 = time.perf_counter()
    cfg, model, batch = build_scene(dev)
    torch.cuda.synchronize()
    print(f"scene: {CAPACITY} gaussians at {WIDTH}x{HEIGHT}, {VIEWS} view(s), "
          f"{time.perf_counter() - t0:.1f} s")

    oracle_phase(model, batch, dev)
    pay, bins = scene_payload(cfg, model, batch, dev)
    spread = scene_payload(cfg, model, batch, dev, spread=True)
    results = kernel_phase(pay, bins, *spread, dev)
    del pay, bins, spread
    launches, plain_step_ms, _ = slice_phase(cfg, init_train_state(model),
                                             batch)

    print(f"lpips kernels at {WIDTH}x{HEIGHT}, random-feature VGG16 seed "
          f"{LPIPS_SEED}:")
    params, lpips_results = lpips_kernel_phase(batch, dev)
    results.update(lpips_results)
    lcfg, lbatch = lpips_batch(cfg, batch, params)
    lpips_launches, lpips_step_ms, _ = slice_phase(
        lcfg, init_train_state(model), lbatch, params)
    print(f"lpips part of the step: {lpips_step_ms - plain_step_ms:.3f} ms "
          f"(median {lpips_step_ms:.3f} with LPIPS, {plain_step_ms:.3f} "
          "without)")
    launches.update({n: lpips_launches[n] for n in lpips_results})
    results.update(knn_phase(dev, logs["knn"]))
    results.update(project_phase(dev, logs["project"]))
    results.update(ssim_phase(dev, logs["ssim"]))
    results.update(deform_phase(dev, logs["deform"]))

    flagship_ms = flagship_phase(dev)
    print(f"flagship step: median {flagship_ms:.3f} ms (the primary plain "
          f"step {plain_step_ms:.3f})")

    trainer_launches, hand_run_dir = trainer_phase(flagship_ms)
    launches.update(trainer_launches)
    _, vrows = _csv_rows(os.path.join(hand_run_dir, "results",
                                      "val_results.csv"))
    try:
        # phase 11's path: render_path and test run kernel 1, counted on
        # a line of their own (the kernels line keeps the COMPOSITE runs')
        rend = render_phase(dev, hand_run_dir, float(vrows[-1][2]))
        print(f"render phase launches: composite_fwd {rend['path_fwd']} "
              f"(render_path, {PATH_FRAMES} frames), {rend['test_fwd']} "
              f"(test worst_cases, gt renders included), "
              f"{rend['cano_fwd']} (test canonical); composite_bwd 0; "
              f"times {json.dumps(rend)}")
        # the contact stage's path: the COMPOSITE runs, counted on a line
        # of their own below
        comp_launches = composite_phase(dev, hand_run_dir)
    finally:
        for sub in ("checkpoints", os.path.join("results", "val_results",
                                                "gaussians")):
            shutil.rmtree(os.path.join(hand_run_dir, sub), ignore_errors=True)
        shutil.rmtree(os.path.join(TRAINER_DIR, "manus_tpu", "synthetic",
                                   "obj"), ignore_errors=True)
        shutil.rmtree(os.path.join(COMPOSITE_DIR, "object_placed"),
                      ignore_errors=True)
    print(f"composite phase launches over its {len(COMPOSITE_RUNS)} "
          f"COMPOSITE runs: {comp_launches}")
    # the BRICS path: HAND_GAUSSIAN on a capture at 1280x720, counted on a
    # line of its own
    print(f"brics phase launches: {brics_phase(dev)}")
    # the sharded path: the trainer's ranks through the CLI; the
    # kernels line carries its counts (the earlier paths' are on their
    # own lines above)
    torch.cuda.empty_cache()
    launches.update(parallel_phase(cfg, model, batch, dev))

    kernels = [
        dict(name=name, route="cuda", source=SOURCES[name],
             replaces=REPLACES[name], launches=launches[name],
             **{"library_ms": None, **results[name]})
        for name in COUNTERS
    ] + [dict(name="nearest_neighbor", route="cuda",
              source="manus_tpu_torch/csrc/knn.cu",
              replaces="none (the JAX package's nearest_neighbor is plain "
                       "JAX)", launches=comp_launches["nearest_neighbor"],
              library_ms=None, **results["nearest_neighbor"])] + [
        dict(name=name, route="cuda", source="manus_tpu_torch/csrc/project.cu",
             replaces="none (the JAX package's calculate_colors_from_sh and "
                      "project_gaussians are plain JAX)",
             launches=launches[name], library_ms=None, **results[name])
        for name in PROJECT_COUNTERS] + [
        dict(name=name, route="cuda", source="manus_tpu_torch/csrc/ssim.cu",
             replaces="none (the JAX package's ssim is plain JAX, banded "
                      "matrix products)",
             launches=launches[name], library_ms=None, **results[name])
        for name in SSIM_COUNTERS] + [
        dict(name=name, route="cuda", source="manus_tpu_torch/csrc/deform.cu",
             replaces="none (the JAX package's covariance_from_scaling_"
                      "rotation, skin_gaussians and skinning_weights_from_"
                      "voxel_grid are plain JAX)",
             launches=launches[name], library_ms=None, **results[name])
        for name in DEFORM_COUNTERS]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseFailed as exc:
        print(f"chip_smoke FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
