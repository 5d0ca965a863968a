"""Synced multi-camera video reader for raw BRICS captures.

The counterpart of the reference's video ingestion (src/utils/reader.py:
13-118) and its frame-extraction helper
(scripts/dataset_helpers/load_videos.py), copied from the JAX package's
manus_tpu/data/reader.py: each camera directory under a `synced/` capture
root holds one video per recording; the reader opens the i-th recording
of every (selected) camera, seeks to frame indices and yields each
camera's frame, undistorted through data/params.py when asked.

Decoding video needs OpenCV, which is imported only inside this module's
functions: on a machine without it (the card's) they raise ImportError.
This is dataset preparation on the host; training reads the extracted
PNG / HDF5 layout (data/brics.py).
"""
from __future__ import annotations

import os
from glob import glob
from typing import Dict, Iterable, Iterator, Optional, Sequence, Tuple

import numpy as np

from manus_tpu_torch.data import params as param_utils
from manus_tpu_torch.utils.io import dump_image
from manus_tpu_torch.utils.vis import plot_points_in_image, project_points


def _cv2():
    """OpenCV, for decoding video; ImportError without it."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError("decoding video needs OpenCV (cv2), which this "
                          "machine does not have") from e
    return cv2


def _natsort_key(s: str):
    import re

    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", s)]


class VideoReader:
    """Frame-indexed access to one recording across all cameras.

    Layout (reference reader.py:32-43): `root/<cam_name>/*.avi`, the
    `ith` recording per camera. `imu` directories are skipped. If
    `selected_cams` is given, only those cameras are opened.
    """

    def __init__(
        self,
        root: str,
        undistort: bool = False,
        cam_path: Optional[str] = None,
        selected_cams: Sequence[str] = (),
        ith: int = 0,
        extensions: Sequence[str] = (".avi", ".mp4", ".mkv"),
    ):
        self.root = root
        self.undistort = undistort
        self.cameras = None
        if undistort:
            if cam_path is None:
                raise ValueError("undistort=True requires cam_path")
            self.cameras = param_utils.read_params(cam_path)

        self.vids: list[str] = []
        selected = set(selected_cams)
        for cam in sorted(os.listdir(root), key=_natsort_key):
            if "imu" in cam or not os.path.isdir(os.path.join(root, cam)):
                continue
            if selected and cam not in selected:
                continue
            files = []
            for ext in extensions:
                files += glob(os.path.join(root, cam, f"*{ext}"))
            files = sorted(files, key=_natsort_key)
            if len(files) > ith:
                self.vids.append(files[ith])

        if not self.vids:
            raise ValueError(f"no videos found under {root}")

        self.streams: Dict[str, "object"] = {}
        self.frame_count = 1 << 62
        self._init_videos()
        self.cur_frame = 0

    def _init_videos(self):
        cv2 = _cv2()

        for vid in self.vids:
            cap = cv2.VideoCapture(vid)
            if not cap.isOpened():
                raise RuntimeError(f"cannot open {vid}")
            # The reference shells out to ffprobe for nb_frames
            # (reader.py:93); CAP_PROP_FRAME_COUNT is equivalent for the
            # fixed-rate BRICS avi containers and needs no subprocess.
            n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
            if n > 0:
                self.frame_count = min(self.frame_count, n)
            cam_name = os.path.basename(vid).split(".")[0]
            self.streams[cam_name] = cap
        if self.frame_count >= (1 << 62):
            raise ValueError("frame count unknown for all videos")

    def release(self):
        for cap in self.streams.values():
            cap.release()
        self.streams = {}

    def reinit(self):
        self.release()
        self._init_videos()
        self.cur_frame = 0

    def _undistort(self, cam_name: str, frame: np.ndarray) -> np.ndarray:
        idx = np.where(self.cameras[:]["cam_name"] == cam_name)[0][0]
        cam = self.cameras[idx]
        K, dist = param_utils.get_intr(cam)
        new_K, _ = param_utils.get_undistort_params(
            K, dist, (frame.shape[1], frame.shape[0])
        )
        return param_utils.undistort_image(K, new_K, dist, frame)

    def get_frames(self, frame_idx: int) -> Dict[str, np.ndarray]:
        """BGR frames from every camera at one index (reference
        reader.py:53-78)."""
        cv2 = _cv2()

        if frame_idx >= self.frame_count:
            return {}
        self.cur_frame = frame_idx
        frames = {}
        for cam_name, cap in self.streams.items():
            cap.set(cv2.CAP_PROP_POS_FRAMES, frame_idx)
            ok, frame = cap.read()
            if not ok:
                raise RuntimeError(
                    f"couldn't retrieve frame {frame_idx} from {cam_name}"
                )
            if self.undistort:
                frame = self._undistort(cam_name, frame)
            frames[cam_name] = frame
        return frames

    def __call__(
        self, frames: Iterable[int] = ()
    ) -> Iterator[Tuple[Dict[str, np.ndarray], int]]:
        for frame_idx in sorted(frames):
            out = self.get_frames(frame_idx)
            if not out:
                break
            yield out, self.cur_frame
        self.reinit()

    def __len__(self):
        return len(self.vids)


def extract_frames(
    root: str,
    out_dir: str,
    frame_ids: Sequence[int],
    cam_path: Optional[str] = None,
    undistort: bool = False,
    selected_cams: Sequence[str] = (),
    ith: int = 0,
    overlay_points: Optional[np.ndarray] = None,  # [J, 3] world points
) -> int:
    """Dump `out_dir/<cam>/<frame:06d>.png` for each camera/frame.

    The load_videos.py use case: pull undistorted frames out of a raw
    capture, optionally overlaying projected 3D points (its MANO-vertex
    sanity plot, load_videos.py:140-153). Returns #images written.
    """
    _cv2()  # fails before any work without OpenCV
    reader = VideoReader(
        root,
        undistort=undistort,
        cam_path=cam_path,
        selected_cams=selected_cams,
        ith=ith,
    )
    cams = None
    if overlay_points is not None:
        if cam_path is None:
            raise ValueError("overlay_points requires cam_path")
        cams = param_utils.read_params(cam_path)

    written = 0
    for frames, fno in reader(frame_ids):
        for cam_name, frame in frames.items():
            if cams is not None:
                idx = np.where(cams[:]["cam_name"] == cam_name)[0][0]
                K, dist = param_utils.get_intr(cams[idx])
                if undistort:
                    K, _ = param_utils.get_undistort_params(
                        K, dist, (frame.shape[1], frame.shape[0])
                    )
                extr = param_utils.get_extr(cams[idx])
                P = K @ extr[:3, :4]
                pts2d = project_points(np.asarray(overlay_points), P[None])[0]
                frame = plot_points_in_image(pts2d, frame)
            path = os.path.join(out_dir, cam_name, f"{fno:06d}.png")
            dump_image(frame[..., ::-1], path)  # BGR, as OpenCV decodes
            written += 1
    return written
