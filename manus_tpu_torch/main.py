"""The CLI: pick an experiment config by name, apply dotted overrides,
snapshot the config into the run directory, resolve a checkpoint to
resume ("best" too), seed, and train; or composite two trained models
and capture their contacts (COMPOSITE), or score a composite run's
contacts (trainer.mode=eval_contacts); or write a camera path
(make_path) or a novel-pose pkl (make_pose), render a trained model along
a camera path (render_path), or run a test epoch (test).

  python -m manus_tpu_torch.main --config-name OBJ_GAUSSIAN \\
      trainer.max_steps=2000 trainer.exp_name=run1
  python -m manus_tpu_torch.main --config-name HAND_GAUSSIAN \\
      dataset.width=512 dataset.height=512 trainer.exp_name=hand
  python -m manus_tpu_torch.main --config-name outputs/manus_tpu/synthetic/hand \\
      trainer.max_steps=20 checkpoint=best
  python -m manus_tpu_torch.main --device cpu --config-name OBJ_GAUSSIAN ...
  python -m manus_tpu_torch.main --config-name COMPOSITE \\
      hand_ckpt_dir=.../hand/checkpoints object_ckpt_dir=.../obj/checkpoints \\
      contact_render_type=acc_gt_eval trainer.exp_name=comp
  python -m manus_tpu_torch.main --config-name COMPOSITE \\
      trainer.mode=eval_contacts trainer.exp_name=comp gt_contact_dir=...
  python -m manus_tpu_torch.main --config-name HAND_GAUSSIAN \\
      trainer.mode=make_path camera_path=path.pkl render_frames=60
  python -m manus_tpu_torch.main --config-name HAND_GAUSSIAN \\
      trainer.mode=render_path camera_path=path.pkl \\
      render_ckpt_dir=.../hand/checkpoints trainer.exp_name=hand
  python -m manus_tpu_torch.main --config-name HAND_GAUSSIAN \\
      trainer.mode=test dataset.worst_cases=true render_ckpt_dir=...

  python -m manus_tpu_torch.main --config-name HAND_GAUSSIAN \\
      dataset.kind=brics_dynamic dataset.root=<dir of action .hdf5 files> \\
      dataset.width=1280 dataset.height=720 trainer.exp_name=hand
  python -m manus_tpu_torch.main --config-name OBJ_GAUSSIAN \\
      dataset.kind=brics_static dataset.root=<capture dir> \\
      dataset.width=1280 dataset.height=720 trainer.exp_name=obj
  python -m manus_tpu_torch.main --config-name OBJ_GAUSSIAN \\
      dataset.kind=brics_static dataset.root=... trainer.mode=validate_data

--trace-out PATH records the run's spans (the fit loop, the train step,
the prefetch thread, the composite frames; utils/trace.py) and writes
them to PATH as Chrome trace-event JSON, which Perfetto opens:

  python -m manus_tpu_torch.main --trace-out hand.trace.json \\
      --config-name HAND_GAUSSIAN trainer.max_steps=300

The JAX package's CLI (main.py) has the same shape, and a run directory
of either package resumes under the other. Runs go to the CUDA card
unless --device names another device; trainer.mode=validate_data checks
a capture on the host, touches no device, and exits with its error
count. Data comes from the synthetic scenes or from BRICS captures
(dataset.kind=brics_static: segmented PNGs with calib/optim_params.txt
under dataset.root; brics_dynamic: one HDF5 file an action), read without
h5py or OpenCV. A video the JAX CLI writes as an mp4 is an animated PNG
here, at the same stem (utils/io.dump_video).

Training over several cards: trainer.data_axis=D trainer.gauss_axis=G
trains on a D x G mesh of ranks (parallel/), one process a rank. Alone,
the CLI starts the D * G ranks on this node itself (rank r on card
r % cards; gloo when ranks share a card, NCCL when each has its own);
under torchrun (or SLURM, Open MPI), or with trainer.distributed=true
and trainer.coordinator=host:port trainer.num_processes=W
trainer.process_id=R, each process joins as one rank. Only rank 0
writes the run directory.

  python -m manus_tpu_torch.main --config-name HAND_GAUSSIAN \
      trainer.gauss_axis=2 raster.tile_shard_mode=owner
  torchrun --nproc-per-node 4 -m manus_tpu_torch.main \
      --config-name HAND_GAUSSIAN trainer.data_axis=2 trainer.gauss_axis=2 \
      trainer.batch_views=2
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import socket
import subprocess
import sys
import time
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from manus_tpu_torch.config import (
    CONFIGS,
    apply_overrides,
    load_config_snapshot,
    save_config,
)
from manus_tpu_torch.data import synthetic
from manus_tpu_torch.data.brics import BricsDynamicDataset, BricsStaticDataset
from manus_tpu_torch.data.validate import report, validate_capture
from manus_tpu_torch.data.voxel import (
    MANO_REST,
    MANO_TO_OURS,
    load_mano_rest,
    make_voxel_grid,
    visualize_skin_weights,
)
from manus_tpu_torch.models.gaussians import (
    get_covariance,
    get_features,
    get_opacity,
    init_gaussian_model,
)
from manus_tpu_torch.ops.knn import knn_indices
from manus_tpu_torch.ops.rasterizer.api import (
    render_gaussians,
    resolve_raster_backend,
)
from manus_tpu_torch.ops.skinning import (
    bone_deformation_transforms,
    skin_gaussians,
)
from manus_tpu_torch.parallel.distributed import (
    LAUNCHER_MARKERS,
    initialize_distributed,
    local_rank,
)
from manus_tpu_torch.preprocess.novel_pose import generate_flexion_sequence
from manus_tpu_torch.train import checkpoint as ckpt_mod
from manus_tpu_torch.train.composite import (
    CompositeModels,
    make_composite_finetune_step,
    make_composite_render,
)
from manus_tpu_torch.train.evaluate import evaluate_composite
from manus_tpu_torch.train.trainer import Trainer
from manus_tpu_torch.train.workloads import (
    init_train_state,
    make_raster_config,
    resolve_skin_weights,
)
from manus_tpu_torch.utils import trace
from manus_tpu_torch.utils.camera import index_camera
from manus_tpu_torch.utils.device import resolve_device
from manus_tpu_torch.utils.io import (
    concat_images,
    dump_image,
    dump_points,
    dump_video,
    generate_camera_path,
    load_camera_path,
)
from manus_tpu_torch.utils.losses import psnr as psnr_fn


def _rank_log(msg):
    """print, with the rank in front on every rank but the first."""
    if dist.is_initialized() and dist.get_rank() > 0:
        msg = f"[rank {dist.get_rank()}] {msg}"
    print(msg, flush=True)


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def launch_local_ranks(argv, world: int) -> int:
    """The CLI once a rank, `world` processes on this node: argv with
    trainer.distributed=true and a localhost coordinator, LOCAL_RANK and
    LOCAL_WORLD_SIZE set. When a rank fails the others are stopped.
    Returns the first non-zero exit code, else 0."""
    port = _free_port()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.pathsep.join(x for x in (root, os.environ.get("PYTHONPATH"))
                           if x)
    procs = []
    for r in range(world):
        env = dict(os.environ, LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(world),
                   PYTHONPATH=path)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "manus_tpu_torch.main", *argv,
             "trainer.distributed=true",
             f"trainer.coordinator=localhost:{port}",
             f"trainer.num_processes={world}", f"trainer.process_id={r}"],
            env=env))
    try:
        while True:
            codes = [p.poll() for p in procs]
            failed = [c for c in codes if c]
            if failed or all(c == 0 for c in codes):
                return failed[0] if failed else 0
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()


def build_dataset(cfg, split: str, device=None):
    """The dataset of cfg.dataset.kind on `device`: the synthetic scene of
    the workload (whole: run_train splits it in memory), or a BRICS
    capture under dataset.root in `split` ("train", "val" or "test": the
    static scene's first two cameras are val and test, the dynamic
    scene's tail frames; calib/ holds the static calibration)."""
    d = cfg.dataset
    if d.kind == "synthetic":
        if cfg.workload == "object":
            return synthetic.build_synthetic_static(
                width=d.width, height=d.height, num_cameras=d.num_cameras,
                bg_color=d.bg_color, device=device)
        return synthetic.build_synthetic_dynamic(
            width=d.width, height=d.height, num_cameras=d.num_cameras,
            num_frames=max(d.num_frames, 2), bg_color=d.bg_color,
            device=device)
    if d.kind == "brics_static":
        return BricsStaticDataset(
            root_dir=d.root, params_dir=os.path.join(d.root, "calib"),
            width=d.width, height=d.height, split=split, bg_color=d.bg_color,
            device=device)
    if d.kind == "brics_dynamic":
        return BricsDynamicDataset(
            root_dir=d.root, width=d.width, height=d.height, split=split,
            bg_color=d.bg_color, num_time_steps=d.num_frames,
            split_ratio=d.split_ratio, device=device)
    raise ValueError(f"unknown dataset kind {d.kind}")


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
    log = _rank_log if dist.is_initialized() else print
    dataset = build_dataset(cfg, "train", device)
    if cfg.dataset.kind != "synthetic":
        val_dataset = build_dataset(cfg, "val", device)
    elif cfg.workload == "object":
        dataset, val_dataset = synthetic.split_synthetic_static(dataset)
    else:
        dataset, val_dataset = synthetic.split_synthetic_dynamic(
            dataset, cfg.dataset.split_ratio)
    if cfg.workload == "object":
        pts, cols = dataset.sample_gaussians(cfg.dataset.sample_size)
        model = init_gaussian_model(pts, cols, cfg.capacity, opts=cfg.model,
                                    device=device)
        voxel_grid, articulated = None, False
    else:
        model, voxel_grid = build_hand_pieces(cfg, dataset, device)
        articulated = True
    tr = Trainer(cfg, dataset, model, articulated, voxel_grid,
                 out_dir=out_dir, val_dataset=val_dataset, log=log)
    if cfg.checkpoint:
        path, n_bad = tr.load(cfg.checkpoint)
        log(f"resumed from {path} (scrubbed {n_bad} NaN slots)")
    tr.fit()
    psnr = tr.final_val_psnr(cfg.trainer.max_steps)
    log(f"final val psnr: {psnr:.2f}")
    return tr


class CompositeRun(NamedTuple):
    """What run_composite did: its output directory, the models it
    rendered (after the fine-tune, if any), the frames, host seconds per
    frame (render and copy to the host), the fine-tune's per-step losses
    and seconds (empty without it), the largest binning pair overflow of
    any panel, and the path of its video."""

    out_dir: str
    models: CompositeModels
    frames: list
    frame_s: list
    finetune_loss: list
    finetune_s: float
    pair_overflow: int
    video: Optional[str] = None


def _load_model(ckpt_dir: str, device):
    path = ckpt_mod.find_best_checkpoint(ckpt_dir)
    if path is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    model, voxel_grid, _ = ckpt_mod.load_gaussian_model(path, device)
    print(f"loaded {path} ({int(model.active.sum())} gaussians)")
    return model, voxel_grid


def _bone_tf(dataset, f: int, voxel_grid):
    return bone_deformation_transforms(
        dataset.bones_posed[f].transforms, dataset.bones_rest.transforms,
        append_identity=voxel_grid is not None)


def run_composite(cfg, out_dir, device=None) -> CompositeRun:
    """The COMPOSITE workload (the JAX CLI's run_composite): load the best
    hand and object checkpoints, optionally fine-tune one of them on the
    full composite render (optimize_hand / optimize_object,
    finetune_steps; frame and view drawn from RandomState(trainer.seed) in
    the JAX CLI's order), then render every frame in
    cfg.contact_render_type (gt_eval: the last 250) from camera
    f % num_views, accumulating the hand's contacts. acc_gt_eval renders
    the acc_contacts.npy an earlier gt_eval or results run of the same
    experiment left, as the reference does (zeros without one). With a
    camera_path pkl (not in acc_gt_eval) frame f is seen from path camera
    f % len(path) instead. Writes results/eval_results/ours/{f:04d}.png,
    acc_contacts.npy and the frames as the video {mode}.apng (the JAX
    CLI's {mode}.mp4)."""
    device = resolve_device(device)
    mode = cfg.contact_render_type
    raster_cfg = make_raster_config(cfg)
    render_fn = make_composite_render(cfg, raster_cfg, mode)  # checks mode
    dataset = build_dataset(cfg, "test", device)
    hand, hand_vg = _load_model(cfg.hand_ckpt_dir, device)
    obj, _ = _load_model(cfg.object_ckpt_dir, device)

    ft_loss, ft_s = [], 0.0
    if cfg.optimize_hand or cfg.optimize_object:
        optimize = "hand" if cfg.optimize_hand else "object"
        state = init_train_state(hand if optimize == "hand" else obj,
                                 seed=cfg.trainer.seed)
        frozen = obj if optimize == "hand" else hand
        ft_step = make_composite_finetune_step(cfg, raster_cfg, optimize,
                                               voxel_grid=hand_vg)
        rng = np.random.RandomState(cfg.trainer.seed)
        bg = torch.zeros(3, device=device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for it in range(cfg.finetune_steps):
            with trace.span("composite.finetune_step", step=it):
                with trace.span("composite.finetune_batch"):
                    f = rng.randint(dataset.num_frames)
                    v = rng.randint(dataset.num_views)
                    raw = dataset.get_batch(f, np.asarray([v]))
                    batch = dict(
                        rgb=torch.as_tensor(raw["rgb"][0],
                                            dtype=torch.float32,
                                            device=device),
                        mask=torch.as_tensor(raw["mask"][0],
                                             dtype=torch.float32,
                                             device=device),
                        camera=index_camera(dataset.cameras, v), bg=bg,
                        bone_tf=_bone_tf(dataset, f, hand_vg))
                state, m = ft_step(state, frozen, batch)
                ft_loss.append(m["loss"])
                if it % 50 == 0 or it == cfg.finetune_steps - 1:
                    print(f"[finetune:{optimize}] step {it}: "
                          f"loss={float(m['loss']):.5f} "
                          f"psnr={float(m['psnr']):.2f}")
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        ft_s = time.perf_counter() - t0
        ft_loss = [float(x) for x in ft_loss]
        if optimize == "hand":
            hand = state.model
        else:
            obj = state.model

    models = CompositeModels(hand=hand, obj=obj, voxel_grid=hand_vg)
    out_imgs = os.path.join(out_dir, "results", "eval_results", "ours")
    os.makedirs(out_imgs, exist_ok=True)
    acc = torch.zeros(hand.capacity, device=device)
    acc_path = os.path.join(out_imgs, "acc_contacts.npy")
    if mode == "acc_gt_eval" and os.path.exists(acc_path):
        # the reference's acc_gt_eval renders the accumulated contacts an
        # earlier gt_eval or results run of this experiment saved (the
        # JAX CLI renders zeros; ROADMAP Queue C)
        saved = np.load(acc_path)
        if saved.shape != (hand.capacity,):
            raise ValueError(f"{acc_path} holds {saved.shape}, the hand "
                             f"has {hand.capacity} slots")
        acc = torch.as_tensor(saved, dtype=torch.float32, device=device)
        print(f"composite: acc_gt_eval renders the contacts in {acc_path}")
    elif mode == "acc_gt_eval":
        print(f"composite: WARNING: acc_gt_eval found no {acc_path} (run "
              f"gt_eval or results in this experiment first): its contact "
              f"panel renders zeros")
    skin_w = resolve_skin_weights(hand, hand_vg)
    aux_colors = torch.as_tensor(
        visualize_skin_weights(skin_w.cpu().numpy()) if skin_w is not None
        else np.zeros((hand.capacity, 3), np.float32), device=device)
    bg = torch.zeros(3, device=device)
    path_cams = None
    if mode != "acc_gt_eval" and cfg.camera_path and os.path.exists(
            cfg.camera_path):
        path_cams = load_camera_path(cfg.camera_path, cfg.dataset.width,
                                     cfg.dataset.height, device=device)
        print(f"composite: sweeping {len(path_cams)} path cameras")
    cano_cam = index_camera(dataset.cameras, 0)
    # gt_eval takes the tail of the sequence (the reference's TestDataset,
    # brics_dynamic.py:564-567); the other modes every frame
    frame_list = list(range(dataset.num_frames))
    if mode == "gt_eval":
        frame_list = frame_list[-250:]
    frame_s, overflow, stats, images = [], 0, {}, []
    for f in frame_list:
        with trace.span("composite.frame", frame=f):
            t0 = time.perf_counter()
            cam = (path_cams[f % len(path_cams)] if path_cams is not None
                   else index_camera(dataset.cameras, f % dataset.num_views))
            render, acc, _ = render_fn(
                models, _bone_tf(dataset, f, hand_vg), cam, cano_cam, bg,
                acc, aux_colors, stats=stats)
            img = render.clamp(0, 1).cpu().numpy()
            frame_s.append(time.perf_counter() - t0)
            overflow = max(overflow, int(stats["pair_overflow"]))
            with trace.span("composite.png"):
                images.append((img * 255).astype(np.uint8))
                dump_image(images[-1], os.path.join(out_imgs, f"{f:04d}.png"))
    np.save(acc_path, acc.cpu().numpy())
    video = dump_video(images, os.path.join(out_imgs, f"{mode}.mp4"), fps=10)
    print(f"composite: wrote {len(frame_list)} frames to {out_imgs} "
          f"(pair_overflow {overflow}); video {video}")
    return CompositeRun(out_dir=out_dir, models=models, frames=frame_list,
                        frame_s=frame_s, finetune_loss=ft_loss,
                        finetune_s=ft_s, pair_overflow=overflow, video=video)


class RenderRun(NamedTuple):
    """What run_render_path or run_test did: its output directory, the
    frames as written to the video ([H, W, 3] uint8; test: the pred | gt
    | diff^2 strips), host seconds per frame (render and copy to the
    host), the video's path, and for a test epoch on the train views its
    records ({frame, view, psnr}, in frame order) and the worst_cases.json
    path (None without worst_cases)."""

    out_dir: str
    frames: list
    frame_s: list
    video: str
    records: tuple = ()
    worst_cases: Optional[str] = None


def _load_render_model(cfg, device):
    model, voxel_grid = _load_model(cfg.render_ckpt_dir, device)
    return model, voxel_grid, make_raster_config(cfg)


def _make_render_one(cfg, model, voxel_grid, raster_cfg):
    """render(cam, bone_tf) -> (image [H, W, 3], posed means [N, 3]) of a
    loaded model on a zero background: skinned by bone_tf, or unposed
    when it is None."""
    params = model.params
    bg = torch.zeros(3, device=params.xyz.device)

    @torch.no_grad()
    def render_one(cam, bone_tf):
        cov = get_covariance(params, isotropic=cfg.model.isotropic_scaling)
        if bone_tf is not None:
            sk = skin_gaussians(params.xyz, cov,
                                resolve_skin_weights(model, voxel_grid),
                                bone_tf)
            posed, cov, tf = sk.posed_xyz, sk.posed_cov, sk.tf
        else:
            posed, tf = params.xyz, None
        out = render_gaussians(
            posed, cov, params.xyz, get_features(params),
            get_opacity(params), cam, bg, sh_degree=cfg.model.sh_degree,
            tf=tf, active=model.active, config=raster_cfg)
        return out.render, posed

    return render_one


def run_render_path(cfg, out_dir, device=None,
                    video_name: str = "novel_path.mp4",
                    canonical: bool = False) -> RenderRun:
    """Render the best checkpoint of render_ckpt_dir along the cameras of
    the camera_path pkl (the first render_frames of them). A hand is
    posed by the reference skeleton's frames when its pkl is present
    (data.synthetic.load_reference_skeleton; canonical: its rest pose
    every frame), else rendered unposed, as the JAX CLI does: the
    make_pose pkl is not read here. Writes results/{video_name}'s stem as
    a video at 15 frames a second."""
    device = resolve_device(device)
    model, voxel_grid, raster_cfg = _load_render_model(cfg, device)
    cams = load_camera_path(cfg.camera_path, cfg.dataset.width,
                            cfg.dataset.height, device=device)
    skel = (synthetic.load_reference_skeleton()
            if cfg.workload == "hand" else None)
    render_one = _make_render_one(cfg, model, voxel_grid, raster_cfg)
    frames, frame_s = [], []
    for i in range(min(cfg.render_frames, len(cams))):
        t0 = time.perf_counter()
        bone_tf = None
        if skel is not None:
            pose = (skel["rest_transforms"] if canonical else
                    skel["pose_transforms"][i % len(skel["pose_transforms"])])
            bone_tf = bone_deformation_transforms(
                torch.as_tensor(pose, device=device),
                torch.as_tensor(skel["rest_transforms"], device=device),
                append_identity=voxel_grid is not None)
        render, _ = render_one(cams[i], bone_tf)
        img = render.clamp(0, 1).cpu().numpy()
        frame_s.append(time.perf_counter() - t0)
        frames.append((img * 255).astype(np.uint8))
    video = dump_video(frames, os.path.join(out_dir, "results", video_name),
                       fps=15)
    print(f"wrote {len(frames)} path frames to {video}")
    return RenderRun(out_dir=out_dir, frames=frames, frame_s=frame_s,
                     video=video)


def run_test(cfg, out_dir, device=None) -> RenderRun:
    """The test epoch. With dataset.test_on_train_dataset or worst_cases:
    every frame_sample_rate-th frame of the whole dynamic scene (the
    split's share set to 0 on a copy of cfg; the JAX CLI sets it on the
    caller's) from view f % num_views, one render each, its PSNR against
    the gt, pred | gt | diff^2 strips as results/eval_results/test_train
    (a video at 10 frames a second), the first frame's posed gaussians as
    a PLY, and with worst_cases the records ranked by ascending PSNR in
    worst_cases.json. Otherwise a camera-path sweep (run_render_path):
    test_cano at the rest pose with test_on_canonical_pose, else
    test_novel."""
    device = resolve_device(device)
    if not (cfg.dataset.test_on_train_dataset or cfg.dataset.worst_cases):
        cano = cfg.dataset.test_on_canonical_pose
        return run_render_path(
            cfg, out_dir, device,
            video_name="test_cano.mp4" if cano else "test_novel.mp4",
            canonical=cano)
    if cfg.workload != "hand":
        # the JAX CLI fails here too (its static scene has no frames)
        raise ValueError("a test epoch on the train views needs the hand's "
                         "dynamic scene; the object's has no frames")
    cfg = copy.deepcopy(cfg)
    cfg.dataset.split_ratio = 0.0  # every frame (the reference's base.py)
    dataset = build_dataset(cfg, "train", device)
    model, voxel_grid, raster_cfg = _load_render_model(cfg, device)
    render_one = _make_render_one(cfg, model, voxel_grid, raster_cfg)
    res_dir = os.path.join(out_dir, "results", "eval_results")
    os.makedirs(res_dir, exist_ok=True)
    frames, frame_s, records = [], [], []
    for i, f in enumerate(range(0, dataset.num_frames,
                                max(cfg.dataset.frame_sample_rate, 1))):
        t0 = time.perf_counter()
        v = f % dataset.num_views
        raw = dataset.get_batch(f, np.asarray([v]))
        render, posed = render_one(index_camera(dataset.cameras, v),
                                   _bone_tf(dataset, f, voxel_grid))
        pred = render.clamp(0, 1)
        gt = torch.as_tensor(np.asarray(raw["rgb"][0], np.float32),
                             device=device)
        records.append(dict(frame=int(f), view=int(v),
                            psnr=float(psnr_fn(pred, gt))))
        pred, gt = pred.cpu().numpy(), gt.cpu().numpy()
        strip = concat_images(pred, gt, (gt - pred) ** 2)
        frame_s.append(time.perf_counter() - t0)
        frames.append((np.clip(strip, 0, 1) * 255).astype(np.uint8))
        if i == 0:
            colors = None
            sw = resolve_skin_weights(model, voxel_grid)
            active = model.active.cpu().numpy()
            if sw is not None:
                colors = visualize_skin_weights(sw.cpu().numpy())[active]
            dump_points(posed.cpu().numpy()[active],
                        os.path.join(res_dir, "gaussians",
                                     f"test_{f}_posed.ply"), colors)
    video = dump_video(frames, os.path.join(res_dir, "test_train.mp4"),
                       fps=10)
    mean_psnr = float(np.mean([r["psnr"] for r in records]))
    print(f"test epoch: {len(frames)} frames, mean psnr={mean_psnr:.2f}, "
          f"video {video}")
    worst = None
    if cfg.dataset.worst_cases:
        ranked = sorted(records, key=lambda r: r["psnr"])
        worst = os.path.join(res_dir, "worst_cases.json")
        with open(worst, "w") as fjson:
            json.dump(ranked, fjson, indent=2)
        print(f"worst case: frame {ranked[0]['frame']} "
              f"(psnr={ranked[0]['psnr']:.2f}) -> worst_cases.json")
    return RenderRun(out_dir=out_dir, frames=frames, frame_s=frame_s,
                     video=video, records=tuple(records), worst_cases=worst)


def run_make_path(cfg) -> str:
    """trainer.mode=make_path: an orbit of render_frames cameras at the
    dataset's size, written to camera_path (the pkl contract)."""
    out = generate_camera_path(cfg.camera_path,
                               num_frames=cfg.render_frames,
                               width=cfg.dataset.width,
                               height=cfg.dataset.height)
    print(f"wrote camera path: {out}")
    return out


def run_make_pose(cfg, out_dir, device=None) -> str:
    """trainer.mode=make_pose: a render_frames-frame flexion cycle of the
    reference skeleton (the procedural one without its pkl) in the
    meta_data pkl contract, at novel_pose_path or out_dir/novel_pose.pkl.
    Returns the path."""
    skel = synthetic.load_reference_skeleton() or \
        synthetic.procedural_skeleton()
    path = cfg.novel_pose_path or os.path.join(out_dir, "novel_pose.pkl")
    d = generate_flexion_sequence(skel, num_frames=cfg.render_frames,
                                  out_path=path, device=device)
    print(f"wrote {d['pose_matrixs'].shape[0]}-frame novel pose "
          f"({d['rest_matrixs'].shape[0]} bones): {path}")
    return path


def run_eval_contacts(cfg, out_dir, device=None) -> dict:
    """trainer.mode=eval_contacts: the three-way contact table of the
    composite run in out_dir against gt_contact_dir's gt_contacts_seg
    (masks) and gt_contacts (RGBA photos). Returns {method: {iou, f1}}."""
    scores = evaluate_composite(
        out_dir, os.path.join(cfg.gt_contact_dir, "gt_contacts_seg"),
        os.path.join(cfg.gt_contact_dir, "gt_contacts"),
        device=resolve_device(device))
    for m, sc in scores.items():
        print(f"[eval] {m}: iou={sc['iou']:.3f} f1={sc['f1']:.3f}")
    return scores


def _run_dir(cfg) -> str:
    """The run directory, made, with the config snapshot in it (by rank
    0 alone in a distributed run)."""
    out_dir = os.path.join(
        cfg.trainer.output_dir, cfg.trainer.project,
        cfg.dataset.subject or "synthetic", cfg.trainer.exp_name,
    )
    if not dist.is_initialized() or dist.get_rank() == 0:
        os.makedirs(out_dir, exist_ok=True)
        save_config(cfg, os.path.join(out_dir, "config.json"))
    return out_dir


def run_validate_data(cfg) -> int:
    """trainer.mode=validate_data: check the capture under dataset.root
    against the loaders' contracts on the host (no device), print every
    finding and return the number of errors."""
    _run_dir(cfg)
    return report(validate_capture(cfg))


def main(argv=None):
    """Parse the CLI and run. Returns the Trainer of a training run, the
    CompositeRun of COMPOSITE, eval_contacts' scores, the RenderRun of
    render_path and test, the path make_path or make_pose wrote, or
    validate_data's error count or, for a training run whose ranks were
    started here (launch_local_ranks), their exit code (the process's
    exit code)."""
    argv = sys.argv[1:] if argv is None else list(argv)
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
    parser.add_argument(
        "--trace-out", metavar="PATH",
        help="record the run's spans (utils/trace.py) and write them to "
        "PATH as Chrome trace-event JSON, for Perfetto; a rank of several "
        "writes PATH with .rank<r> before its suffix")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)

    device = torch.device(args.device)
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
    if cfg.trainer.mode == "validate_data":
        return run_validate_data(cfg)
    if device.type == "cuda":
        resolve_device()  # raises where there is no card
    resolve_raster_backend(cfg.raster.backend, device)  # raises early

    mode = cfg.trainer.mode
    world = cfg.trainer.data_axis * cfg.trainer.gauss_axis
    sharded = (world > 1 and mode in ("train", "debug")
               and cfg.workload != "composite")
    if sharded and not cfg.trainer.distributed and not any(
            m in os.environ for m in LAUNCHER_MARKERS):
        return launch_local_ranks(argv, world)
    if not args.trace_out:
        return _run(cfg, device, sharded)
    trace.enable()
    try:
        return _run(cfg, device, sharded)
    finally:
        trace.disable()
        trace.write_chrome_trace(_rank_path(args.trace_out))
        trace.clear()


def _rank_path(path: str) -> str:
    """`path`, or with .rank<r> before its suffix on a rank of several."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return path
    stem, ext = os.path.splitext(path)
    return f"{stem}.rank{dist.get_rank()}{ext}"


def _run(cfg, device, sharded: bool):
    """main's run of the parsed config on `device`: join the process group
    when a rank, then the mode's entry point."""
    if cfg.trainer.distributed or sharded:
        # one rank of several: the process group before any device use
        active = initialize_distributed(
            cfg.trainer.coordinator, cfg.trainer.num_processes,
            cfg.trainer.process_id, device_type=device.type)
        if active and device.type == "cuda":
            device = torch.device(
                "cuda", local_rank() % torch.cuda.device_count())
            torch.cuda.set_device(device)
        _rank_log(
            f"[distributed] active={active}" + (
                f" rank {dist.get_rank()}/{dist.get_world_size()} backend "
                f"{dist.get_backend()} device {device}" if active else ""))
    if cfg.trainer.mode == "debug":
        # the reference's fast_dev_run (main.py:81-82): a one-step run
        cfg.trainer.max_steps = 1
        cfg.trainer.val_every = 0
        cfg.trainer.checkpoint_every = 0
        cfg.trainer.mode = "train"
    # the JAX CLI's order: these modes first, then the workload, then test
    mode = cfg.trainer.mode
    early = ("make_path", "make_pose", "eval_contacts", "render_path")
    composite = mode not in early and cfg.workload == "composite"
    if mode not in early + ("train", "test") and not composite:
        raise ValueError(f"unknown trainer.mode {cfg.trainer.mode!r}")

    out_dir = _run_dir(cfg)
    np.random.seed(cfg.trainer.seed)
    torch.manual_seed(cfg.trainer.seed)
    if cfg.trainer.debug_nans:
        torch.autograd.set_detect_anomaly(True)
    if mode == "make_path":
        return run_make_path(cfg)
    if mode == "make_pose":
        return run_make_pose(cfg, out_dir, device)
    if mode == "eval_contacts":
        return run_eval_contacts(cfg, out_dir, device)
    if mode == "render_path":
        return run_render_path(cfg, out_dir, device)
    if composite:
        return run_composite(cfg, out_dir, device)
    if mode == "test":
        return run_test(cfg, out_dir, device)
    return run_train(cfg, out_dir, device)


if __name__ == "__main__":
    out = main()
    if dist.is_initialized():
        dist.destroy_process_group()
    sys.exit(out if isinstance(out, int) else 0)
