"""BRICS capture-rig datasets: static PNG captures and dynamic HDF5 ones.

The data contracts are the JAX package's loaders' (manus_tpu/data/brics.py,
after the reference's brics_static.py and brics_dynamic.py):

- static: segmented RGBA PNGs under images/refined_seg/<cam>/, the
  calibration in calib/optim_params.txt, undistortion, alpha compositing
  over the background before any resize, the val split of the first two
  cameras ([2:] / [:2]) and the lower-hemisphere skip list;
- dynamic: one HDF5 file per action with frames/<fno>/{images,bbox,
  metadata}, K/, extr/ and mano_rest; each view's RGBA bbox crop pasted
  back into its full frame; per-frame rest and posed Bones from the
  metadata blocks.

The files are read as they are, without h5py or OpenCV: HDF5 through
data/hdf5.py, PNG through utils/io.read_png, undistortion and area
resizing through data/params.py, and the crops are assembled in the C++
of csrc/image_ops.cpp (data/prefetch.assemble_batch_native). Cameras and
bones are tensors on the dataset's device (the card unless the caller
names another); get_batch returns numpy, as the trainer expects.
"""
from __future__ import annotations

import glob
import os
from typing import Optional

import numpy as np
import torch

from manus_tpu_torch.data import hdf5
from manus_tpu_torch.data import params as param_utils
from manus_tpu_torch.data.prefetch import assemble_batch_native
from manus_tpu_torch.data.synthetic import (
    get_scene_extent,
    sample_gaussians_on_bones,
)
from manus_tpu_torch.utils.camera import make_camera, stack_cameras
from manus_tpu_torch.utils.device import resolve_device
from manus_tpu_torch.utils.io import read_png
from manus_tpu_torch.utils.structures import Bones
from manus_tpu_torch.utils.transforms import build_kintree


def _bg_color(name: str, rng=None) -> np.ndarray:
    if name == "white":
        return np.ones(3, np.float32)
    if name == "random":
        rng = rng or np.random
        return rng.rand(3).astype(np.float32)
    return np.zeros(3, np.float32)


def _png_has_alpha(path: str) -> bool:
    """Whether a PNG's colour type carries alpha (grey+alpha or RGBA)."""
    with open(path, "rb") as f:
        head = f.read(26)
    return len(head) == 26 and head[25] in (4, 6)


def _extent(cams) -> float:
    return get_scene_extent(
        np.stack([c.camera_center.cpu().numpy() for c in cams], axis=1))


class BricsStaticDataset:
    """Static object scene from segmented multi-view PNGs."""

    def __init__(
        self,
        root_dir: str,
        params_dir: str,
        width: int,
        height: int,
        split: str = "train",
        bg_color: str = "black",
        resize_factor: float = 1.0,
        skip_cameras=param_utils.STATIC_SKIP_CAMERAS,
        image_subdir: str = os.path.join("images", "refined_seg"),
        device=None,
    ):
        device = resolve_device(device)
        self.bg_color = bg_color
        image_dir = os.path.join(root_dir, image_subdir)
        cameras = param_utils.read_params(
            os.path.join(params_dir, "optim_params.txt"))
        cameras = [c for c in cameras if c["cam_name"] not in skip_cameras]
        # the reference's split: the first two cameras for val
        cameras = cameras[2:] if split == "train" else cameras[:2]

        cams, images, masks = [], [], []
        self.root_dir = root_dir
        for cam in cameras:
            extr = param_utils.get_extr(cam)
            K, dist = param_utils.get_intr(cam)
            img_paths = sorted(
                glob.glob(os.path.join(image_dir, str(cam["cam_name"]), "*")))
            if not img_paths:
                continue
            image = read_png(img_paths[0], "rgba")
            new_K, _ = param_utils.get_undistort_params(K, dist,
                                                        (width, height))
            if _png_has_alpha(img_paths[0]):
                image = param_utils.undistort_image(K, new_K, dist, image)
                alpha = image[..., 3:] / 255.0
            else:  # the whole frame is foreground, its border too
                image = param_utils.undistort_image(K, new_K, dist,
                                                    image[..., :3])
                alpha = np.ones(image.shape[:2] + (1,), np.float32)
            cams.append(make_camera(new_K, extr, width, height,
                                    device=device,
                                    resize_factor=resize_factor))
            rgb = image[..., :3] / 255.0
            bg = _bg_color(bg_color)
            rgb = rgb * alpha + bg * (1.0 - alpha)
            if resize_factor != 1.0:
                size = (cams[-1].width, cams[-1].height)
                rgb = param_utils.resize_area(rgb, size)
                alpha = param_utils.resize_area(alpha, size)
            images.append(rgb.astype(np.float32))
            masks.append(alpha.astype(np.float32))

        self.images = np.stack(images)
        self.masks = np.stack(masks)
        self.cameras = stack_cameras(cams)
        self.extent = _extent(cams)
        self.width = cams[0].width
        self.height = cams[0].height

    @property
    def num_views(self) -> int:
        return self.images.shape[0]

    def get_batch(self, frame: int, views):
        return dict(rgb=self.images[views], mask=self.masks[views])

    def sample_gaussians(self, sample_size: int, seed: int = 0,
                         mesh_path: Optional[str] = None):
        """The init cloud: points of the NGP mesh with 5 mm noise when
        there is one (the reference's brics_static.py:130-150), else random
        points in the scene core. Returns numpy (points, colours)."""
        rng = np.random.RandomState(seed)
        if mesh_path is None:
            candidates = glob.glob(
                os.path.join(self.root_dir, "mesh", "ngp_mesh", "*.ply"))
            mesh_path = candidates[0] if candidates else None
        if mesh_path and os.path.exists(mesh_path):
            verts = _load_ply_vertices(mesh_path)
            idx = rng.randint(0, len(verts), sample_size)
            pts = verts[idx] + rng.normal(0, 0.005, (sample_size, 3))
        else:
            pts = rng.uniform(-0.15, 0.15, (sample_size, 3))
        colors = rng.uniform(0, 1, (sample_size, 3))
        return pts.astype(np.float32), colors.astype(np.float32)


def _load_ply_vertices(path: str) -> np.ndarray:
    """The vertices [N, 3] float32 of a binary or ASCII PLY."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii", errors="ignore").strip()
            header.append(line)
            if line == "end_header":
                break
        n_verts = 0
        fmt = "ascii"
        props = []
        in_vertex = False
        for line in header:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                in_vertex = parts[1] == "vertex"
                if in_vertex:
                    n_verts = int(parts[2])
            elif parts[0] == "property" and in_vertex:
                props.append((parts[2], parts[1]))
        type_map = {
            "float": "f4", "float32": "f4", "double": "f8",
            "uchar": "u1", "uint8": "u1", "int": "i4", "uint": "u4",
            "short": "i2", "ushort": "u2", "char": "i1",
        }
        if fmt == "ascii":
            data = np.loadtxt(f, max_rows=n_verts)
            cols = [i for i, (nm, _) in enumerate(props) if nm in "xyz"]
            return data[:, cols[:3]].astype(np.float32)
        endian = "<" if "little" in fmt else ">"
        dtype = np.dtype([(nm, endian + type_map[t]) for nm, t in props])
        data = np.frombuffer(f.read(n_verts * dtype.itemsize), dtype=dtype)
        return np.stack(
            [data["x"], data["y"], data["z"]], axis=-1).astype(np.float32)


def _names(ds) -> list:
    """Bone names from a fixed-length string dataset ([N] or [N, 1])."""
    return [
        n[0].decode() if isinstance(n, (list, np.ndarray))
        else (n.decode() if isinstance(n, bytes) else str(n))
        for n in ds[:].tolist()
    ]


class BricsDynamicDataset:
    """Articulated hand sequences from per-action HDF5 files."""

    def __init__(
        self,
        root_dir: str,
        width: int,
        height: int,
        split: str = "train",
        bg_color: str = "black",
        resize_factor: float = 1.0,
        num_time_steps: int = -1,
        split_ratio: float = 0.1,
        sequences="all",
        n_bones: int = 20,
        device=None,
    ):
        self.device = resolve_device(device)
        self.root_dir = root_dir
        self.bg_color = bg_color
        self.resize_factor = resize_factor
        self.n_bones = n_bones
        self.full_width, self.full_height = width, height

        actions = sorted(f for f in os.listdir(root_dir)
                         if f.endswith(".hdf5"))
        if sequences != "all":
            actions = [f"{a}.hdf5" for a in sequences
                       if f"{a}.hdf5" in actions]
        if not actions:
            raise FileNotFoundError(f"no .hdf5 actions under {root_dir}")
        self.actions = [a.split(".")[0] for a in actions]
        self.action = self.actions[0]

        # The flat frame index spans every action (the reference's
        # index_list of (action, frame, view)); a subject's actions share
        # one rig, so the cameras come from the first file.
        self._frame_index = []  # (action, fno)
        self._metadata = {}
        cams = None
        for action_file in actions:
            action = action_file.split(".")[0]
            with hdf5.File(os.path.join(root_dir, action_file)) as f:
                frames = f["frames"]
                frame_nos = sorted(frames.keys(), key=lambda s: int(s))
                if 0 < num_time_steps < len(frame_nos):
                    frame_nos = frame_nos[:: len(frame_nos) // num_time_steps]
                for fno in frame_nos:
                    self._frame_index.append((action, fno))
                    self._metadata[(action, fno)] = self._fetch_metadata(
                        frames[fno]["metadata"])
                if cams is None:
                    self.cam_names = list(f["K"].keys())
                    cams = [
                        make_camera(f["K"][c][:], f["extr"][c][:], width,
                                    height, device=self.device,
                                    resize_factor=resize_factor)
                        for c in self.cam_names
                    ]
                    self.mano_data = {
                        k: v[:] for k, v in (f.get("mano_rest") or {}).items()
                    }

        # the frame split (the reference splits the flat index list; this
        # splits frames, which is its split_by_action=False at one view a
        # batch); an empty split falls back to every frame
        n_val = max(1, int((1 - split_ratio) * len(self._frame_index))) \
            if split_ratio > 0 else len(self._frame_index)
        self._frame_index = (
            self._frame_index[:n_val] if split == "train"
            else self._frame_index[n_val:]
        ) or self._frame_index

        self.cameras = stack_cameras(cams)
        self.extent = _extent(cams)
        self.width = cams[0].width
        self.height = cams[0].height
        self.bones_rest = self._metadata[self._frame_index[0]]["bones_rest"]
        self.bones_posed = [
            self._metadata[key]["bones_posed"] for key in self._frame_index
        ]
        self._h5 = {}

    def _fetch_metadata(self, md) -> dict:
        """Rest and posed Bones of a frame's metadata block (the
        reference's brics_dynamic.py:280-327), on the device."""
        bnames = _names(md["bnames"])
        kintree = build_kintree(bnames, _names(md["bnames_parent"]))
        ids = np.arange(self.n_bones)

        def t(key, rows=True):
            x = md[key][:]
            return torch.as_tensor(np.asarray(x[ids] if rows else x,
                                              np.float32),
                                   device=self.device)

        rest = Bones(heads=t("rest_heads"), tails=t("rest_tails"),
                     transforms=t("rest_matrixs"), kintree=kintree,
                     bnames=tuple(bnames))
        posed = Bones(heads=t("pose_heads"), tails=t("pose_tails"),
                      transforms=t("pose_matrixs"),
                      eulers=t("eulers", rows=False),
                      root_translation=t("root_translation", rows=False),
                      root_rotation=t("root_rotation", rows=False),
                      kintree=kintree, bnames=tuple(bnames))
        return dict(bones_rest=rest, bones_posed=posed)

    @property
    def num_views(self) -> int:
        return len(self.cam_names)

    @property
    def num_frames(self) -> int:
        return len(self._frame_index)

    def _file(self, action: str) -> hdf5.File:
        f = self._h5.get(action)
        if f is None:  # two threads may open it; one copy is kept
            f = self._h5.setdefault(action, hdf5.File(
                os.path.join(self.root_dir, f"{action}.hdf5")))
        return f

    def read_crops(self, frame: int, views):
        """The RGBA uint8 bbox crops and [V, 4] int32 bboxes of `views` in
        frame `frame`, read from its action's file."""
        action, fno = self._frame_index[frame]
        grp = self._file(action)["frames"][fno]
        images, bbox = grp["images"], grp["bbox"]
        crops, bboxes = [], []
        for v in np.atleast_1d(views):
            cam = self.cam_names[int(v)]
            crops.append(images[cam][:])
            bboxes.append(bbox[cam][:])
        return crops, np.asarray(bboxes, np.int32).reshape(-1, 4)

    def get_batch(self, frame: int, views):
        """Full frames of `views`: the crops pasted at their bboxes,
        composited over the background and box-downscaled by
        round(1 / resize_factor) in the C++ assembly (the reference's
        fetch_images, brics_dynamic.py:343-373). numpy rgb [V, H, W, 3]
        and mask [V, H, W, 1]."""
        crops, bboxes = self.read_crops(frame, views)
        downscale = max(1, int(round(1.0 / self.resize_factor)))
        rgb, mask = assemble_batch_native(
            crops, bboxes, self.full_height, self.full_width,
            _bg_color(self.bg_color), downscale=downscale)
        return dict(rgb=rgb, mask=mask)

    def close(self):
        for f in self._h5.values():
            f.close()
        self._h5 = {}

    def sample_gaussians_on_bones(self, samples_per_bone: int,
                                  seed: int = 0):
        rest = self.bones_rest
        return sample_gaussians_on_bones(
            rest.heads.cpu().numpy(), rest.tails.cpu().numpy(),
            rest.transforms.cpu().numpy(), samples_per_bone, seed=seed)
