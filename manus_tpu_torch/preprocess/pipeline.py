"""The preprocessing pipeline: 2D keypoints -> a skeleton pose sequence
(the JAX package's preprocess/pipeline.py).

  input:  keypoints2d [F, V, J, 3] (x, y, confidence) and projection
          matrices P [V, 3, 4] (K @ [R|t])
  output: triangulated keypoints3d [F, J, 4], per-frame IK translations
          and joint angles [F, J, 3], the angles one-euro smoothed, the
          IK losses and the bone lengths.

Triangulation takes every frame in one batch; the IK frames stay
sequential, each warm-started from the last. Runs on the card unless a
device is named.

  python -m manus_tpu_torch.preprocess.pipeline kp2d.npz out.npz \\
      [--no-constraint] [--max-iter 300] [--device cpu]

kp2d.npz holds keypoints2d, projections and the skeleton (bnames,
parents, rest_matrices, heads, tails).
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from manus_tpu_torch.preprocess.ik import (
    HandChain,
    chain_tensors,
    make_chain,
    solve_ik,
    update_bone_lengths,
)
from manus_tpu_torch.preprocess.one_euro import filter_sequence
from manus_tpu_torch.preprocess.triangulate import iterative_triangulate
from manus_tpu_torch.utils.device import resolve_device


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def triangulate_sequence(keypoints2d: np.ndarray, projections: np.ndarray,
                         min_view: int = 2, device=None) -> np.ndarray:
    """[F, J, 4] robust triangulated keypoints (xyz, confidence), every
    frame in one batch (frames are independent: the same result as a
    loop over them)."""
    device = resolve_device(device)
    kp = torch.as_tensor(np.asarray(keypoints2d, np.float32), device=device)
    P = torch.as_tensor(np.asarray(projections, np.float32), device=device)
    return iterative_triangulate(kp, P, min_view=min_view).cpu().numpy()


def fit_sequence(chain: HandChain, keypoints3d: np.ndarray,
                 constraint: bool = True, limit: bool = True,
                 lr: float = 1e-1, max_iter: int = 300, device=None):
    """Per-frame IK, each frame warm-started from the last one's solution.
    Returns (trans [F, 3], angles [F, J+1, 3], losses [F])."""
    device = resolve_device(device)
    ct = chain_tensors(chain, device)
    kp = torch.as_tensor(np.asarray(keypoints3d, np.float32), device=device)
    all_trans, all_angles, losses = [], [], []
    trans, angles = None, None
    for f in range(kp.shape[0]):
        trans, angles, loss = solve_ik(
            chain, kp[f, :, :3], kp[f, :, 3] > 0, constraint=constraint,
            limit=limit, lr=lr, trans_init=trans, angles_init=angles,
            max_iter=max_iter, tensors=ct)
        all_trans.append(trans.cpu().numpy())
        all_angles.append(angles.cpu().numpy())
        losses.append(loss)
    return np.stack(all_trans), np.stack(all_angles), np.asarray(losses)


def smooth_sequence(angles: np.ndarray, min_cutoff: float = 0.6,
                    beta: float = 0.1, device=None) -> np.ndarray:
    """One-euro smoothing of [F, ...] angles over the frame axis."""
    device = resolve_device(device)
    ts = torch.arange(angles.shape[0], dtype=torch.float32, device=device)
    xs = torch.as_tensor(np.asarray(angles, np.float32), device=device)
    return filter_sequence(ts, xs, min_cutoff=min_cutoff,
                           beta=beta).cpu().numpy()


def run_pipeline(keypoints2d: np.ndarray, projections: np.ndarray,
                 chain: HandChain, constraint: bool = True,
                 max_iter: int = 300, device=None,
                 timings: dict = None) -> dict:
    """Triangulate, estimate the bone lengths, fit IK per frame, smooth.
    `timings`, when given, gets the seconds of each stage
    (triangulate_s, ik_s, smooth_s)."""
    device = resolve_device(device)
    times = {}
    _sync(device)
    t0 = time.perf_counter()
    kp3d = triangulate_sequence(keypoints2d, projections, device=device)
    times["triangulate_s"] = time.perf_counter() - t0
    chain = update_bone_lengths(chain, kp3d)
    t0 = time.perf_counter()
    trans, angles, losses = fit_sequence(chain, kp3d, constraint=constraint,
                                         max_iter=max_iter, device=device)
    times["ik_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    angles_smooth = smooth_sequence(angles, device=device)
    times["smooth_s"] = time.perf_counter() - t0
    if timings is not None:
        timings.update(times)
    return dict(keypoints3d=kp3d, trans=trans, angles=angles,
                angles_smooth=angles_smooth, ik_losses=losses,
                bone_lengths=chain.bone_lengths)


# The finger keypoint groups of the 21-joint halpe hand layout: the thumb
# chain [2..4], then four 4-joint chains; fingertips every 4th joint.
_FINGER_IDX = [list(range(2, 5))] + [list(range(i, i + 4))
                                     for i in range(5, 18, 4)]
_TIP_IDX = [4, 8, 12, 16, 20]


def filter_pose_frames(keypoints3d: np.ndarray, frame_ids=None,
                       bin_size: int = 5, ignore_missing_tip: bool = False,
                       start_frame: int = 0) -> list:
    """Bin-based frame selection: at most one frame per bin of bin_size
    frames. A frame missing a whole finger is rejected, one missing a
    fingertip too unless ignore_missing_tip; the survivor with the most
    detected keypoints wins (ties: the earliest). Frames before
    start_frame are dropped first. Returns the chosen global frame ids."""
    kyps = np.asarray(keypoints3d)
    if frame_ids is None:
        frame_ids = np.arange(kyps.shape[0])
    frame_ids = np.asarray(frame_ids)
    keep = frame_ids >= start_frame
    kyps, frame_ids = kyps[keep], frame_ids[keep]
    chosen = []
    for i in range(0, kyps.shape[0], bin_size):
        conf = kyps[i:i + bin_size, :, 3]
        to_use = np.ones(conf.shape[0], dtype=bool)
        for idx in _FINGER_IDX:
            to_use &= np.any(conf[:, idx], axis=1)
        if not ignore_missing_tip:
            to_use &= np.all(conf[:, _TIP_IDX], axis=1)
            if not np.any(to_use):
                continue
        unfound = conf.shape[1] * np.ones(conf.shape[0])
        unfound[to_use] = np.count_nonzero(np.isclose(conf[to_use], 0.0),
                                           axis=1)
        chosen.append(int(frame_ids[i + int(np.argmin(unfound))]))
    return chosen


def sequence_is_faulty(chosen_frames: list, last_capture_frame: int,
                       diff_ratio: float = 0.8) -> bool:
    """A capture is faulty when its last chosen frame covers no more than
    diff_ratio of the recorded frames (the hand left the rig, or tracking
    failed partway)."""
    if not chosen_frames or last_capture_frame <= 0:
        return True
    return (chosen_frames[-1] / last_capture_frame) <= diff_ratio


def visualize_ik_frames(result: dict, images: np.ndarray,
                        projections: np.ndarray, out_dir: str,
                        kintree: dict = None, max_views: int = 4):
    """The solved skeleton over the first views' frames ([F, V, H, W, 3]
    uint8), one PNG strip a frame, ik_{f:04d}.png, for QA of the fits."""
    from manus_tpu_torch.utils.io import dump_image
    from manus_tpu_torch.utils.vis import visualize_ik_overlay

    os.makedirs(out_dir, exist_ok=True)
    for f in range(min(len(images), result["keypoints3d"].shape[0])):
        strip = visualize_ik_overlay(images[f], result["keypoints3d"][f],
                                     projections, kintree,
                                     max_views=max_views)
        dump_image(strip, os.path.join(out_dir, f"ik_{f:04d}.png"))


def main(argv=None) -> dict:
    """The CLI; returns the pipeline's result (also saved to output_npz)
    with its stage seconds under "timings"."""
    parser = argparse.ArgumentParser(
        prog="python -m manus_tpu_torch.preprocess.pipeline")
    parser.add_argument("input_npz")
    parser.add_argument("output_npz")
    parser.add_argument("--no-constraint", action="store_true")
    parser.add_argument("--max-iter", type=int, default=300)
    parser.add_argument(
        "--device", default="cuda",
        help="torch device (default cuda; the CPU only when named)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device if args.device != "cuda" else None)

    data = np.load(args.input_npz, allow_pickle=True)
    chain = make_chain([str(b) for b in data["bnames"]], data["parents"],
                       data["rest_matrices"], data["heads"], data["tails"])
    timings = {}
    out = run_pipeline(data["keypoints2d"], data["projections"], chain,
                       constraint=not args.no_constraint,
                       max_iter=args.max_iter, device=device,
                       timings=timings)
    np.savez_compressed(args.output_npz, **out)
    n = out["angles"].shape[0]
    print(f"pipeline: {n} frames, mean IK loss {out['ik_losses'].mean():.2e}"
          f" -> {args.output_npz} (triangulate "
          f"{timings['triangulate_s'] * 1e3:.1f} ms, IK "
          f"{timings['ik_s'] / n:.3f} s a frame)")
    return dict(out, timings=timings)


if __name__ == "__main__":
    main()
