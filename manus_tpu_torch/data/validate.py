"""Device-free schema validation of real BRICS / MANUS-Grasps captures.

`trainer.mode=validate_data` walks a capture directory and reports every
contract violation before a long training run touches the device: a
corrupt calibration row or a missing HDF5 group should cost seconds on
the host, not a mid-run crash.

The checks and the findings are the JAX package's
(manus_tpu/data/validate.py), over the port's own readers: PNGs through
utils/io.read_png, HDF5 through data/hdf5.py. The contracts are the ones
the loaders consume:
  * static PNG layout and calibration: the reference's
    src/datasets/brics_static.py (images/refined_seg/<cam>/, alpha
    compositing, [2:]/[:2] split) and src/utils/params.py:28-105
    (optim_params.txt row dtype);
  * dynamic HDF5 layout: the reference's brics_dynamic.py:172-263
    (frames/<fno>/{images,bbox,metadata}, K/, extr/, mano_rest; RGBA bbox
    crops pasted into full frames; per-frame bone metadata blocks).

Findings are strings prefixed "[error]" (the loader would crash or
silently mistrain) or "[warn]" (degraded but loadable: a missing NGP
mesh falls back to random init). An image is decoded as the loader
decodes it (PNG only), and an HDF5 file that uses a form the reader does
not support is reported as an error; the text after "unreadable HDF5:"
is the reader's own.
"""
from __future__ import annotations

import glob
import os
import struct
import zlib
from typing import List, Optional, Sequence

import numpy as np

from manus_tpu_torch.data import hdf5
from manus_tpu_torch.data import params as param_utils
from manus_tpu_torch.utils.io import read_png

_MD_KEYS = (
    # metadata block of every frame (reference brics_dynamic.py:280-327)
    "bnames", "bnames_parent", "rest_heads", "rest_tails", "rest_matrixs",
    "pose_heads", "pose_tails", "pose_matrixs", "eulers",
    "root_translation", "root_rotation",
)


def _err(out: List[str], where: str, msg: str) -> None:
    out.append(f"[error] {where}: {msg}")


def _warn(out: List[str], where: str, msg: str) -> None:
    out.append(f"[warn] {where}: {msg}")


def _decoded_shape(path: str) -> Optional[tuple]:
    """The shape OpenCV's IMREAD_UNCHANGED gives a PNG that decodes ([H, W]
    greyscale, [H, W, 4] with alpha, else [H, W, 3]), or None when the
    file does not decode."""
    try:
        img = read_png(path, "rgba")
        with open(path, "rb") as f:
            color_type = f.read(26)[25]
    except (OSError, ValueError, IndexError, struct.error, zlib.error):
        return None
    h, w = img.shape[:2]
    return {0: (h, w), 4: (h, w, 4), 6: (h, w, 4)}.get(color_type, (h, w, 3))


# ---------------------------------------------------------------------------
# calibration (shared by static; optim_params.txt)
# ---------------------------------------------------------------------------


def validate_params_file(path: str, out: List[str]) -> Optional[np.ndarray]:
    """Parse + sanity-check optim_params.txt. Returns the parsed rows or
    None when unusable."""
    if not os.path.exists(path):
        _err(out, path, "calibration file missing (optim_params.txt)")
        return None
    try:
        cams = param_utils.read_params(path)
    except (ValueError, IndexError) as e:
        _err(out, path, f"calibration rows do not parse as the "
                        f"{len(param_utils.PARAM_DTYPE)}-column contract: {e}")
        return None
    if cams.size == 0:
        _err(out, path, "calibration file has no camera rows")
        return None
    names = [str(c["cam_name"]) for c in cams]
    dupes = {n for n in names if names.count(n) > 1}
    if dupes:
        _err(out, path, f"duplicate cam_name rows: {sorted(dupes)}")
    for c in cams:
        who = f"{path} (cam {c['cam_name']})"
        if c["width"] <= 0 or c["height"] <= 0:
            _err(out, who, f"non-positive image size "
                           f"{int(c['width'])}x{int(c['height'])}")
        if c["fx"] <= 0 or c["fy"] <= 0:
            _err(out, who, f"non-positive focal ({c['fx']}, {c['fy']})")
        q = np.asarray([c["qvecw"], c["qvecx"], c["qvecy"], c["qvecz"]])
        norm = float(np.linalg.norm(q))
        if not np.isfinite(norm) or abs(norm - 1.0) > 1e-2:
            _err(out, who, f"extrinsic quaternion is not unit-norm "
                           f"(|q|={norm:.4f})")
    return cams


# ---------------------------------------------------------------------------
# static capture
# ---------------------------------------------------------------------------


def validate_static_capture(
    root_dir: str,
    params_dir: Optional[str] = None,
    skip_cameras: Sequence[str] = param_utils.STATIC_SKIP_CAMERAS,
    image_subdir: str = os.path.join("images", "refined_seg"),
) -> List[str]:
    out: List[str] = []
    if not os.path.isdir(root_dir):
        _err(out, root_dir, "capture root is not a directory")
        return out
    params_dir = params_dir or os.path.join(root_dir, "calib")
    cams = validate_params_file(
        os.path.join(params_dir, "optim_params.txt"), out
    )

    image_dir = os.path.join(root_dir, image_subdir)
    if not os.path.isdir(image_dir):
        _err(out, image_dir, "segmented image directory missing")
        return out

    on_disk = {d for d in os.listdir(image_dir)
               if os.path.isdir(os.path.join(image_dir, d))}
    if cams is not None:
        expected = [str(c["cam_name"]) for c in cams
                    if str(c["cam_name"]) not in set(skip_cameras)]
        if len(expected) < 3:
            _err(out, image_dir,
                 f"only {len(expected)} non-skipped cameras; the loader "
                 "holds out the first 2 for val ([2:]/[:2] split)")
        sizes = {}
        for name in expected:
            cam_dir = os.path.join(image_dir, name)
            who = cam_dir
            if name not in on_disk:
                _err(out, who, "no image directory for calibrated camera")
                continue
            imgs = sorted(glob.glob(os.path.join(cam_dir, "*")))
            if not imgs:
                _err(out, who, "image directory is empty")
                continue
            shape = _decoded_shape(imgs[0])
            if shape is None:
                _err(out, imgs[0], "first image does not decode")
                continue
            if len(shape) != 3 or shape[-1] not in (3, 4):
                _err(out, imgs[0],
                     f"expected 3/4-channel image, got shape {shape}")
                continue
            if shape[-1] == 3:
                _warn(out, imgs[0],
                      "no alpha channel: the loader treats the whole "
                      "frame as foreground (mask == 1 everywhere)")
            sizes.setdefault(shape[:2], []).append(name)
        if len(sizes) > 1:
            _err(out, image_dir,
                 f"inconsistent image sizes across cameras: "
                 f"{ {k: v[:3] for k, v in sizes.items()} }")
        extra = on_disk - {str(c["cam_name"]) for c in cams}
        if extra:
            _warn(out, image_dir,
                  f"image dirs with no calibration row (ignored by the "
                  f"loader): {sorted(extra)[:5]}")

    mesh = glob.glob(os.path.join(root_dir, "mesh", "ngp_mesh", "*.ply"))
    if not mesh:
        _warn(out, os.path.join(root_dir, "mesh", "ngp_mesh"),
              "no NGP mesh PLY: gaussian init falls back to random "
              "points in the scene core")
    else:
        try:
            with open(mesh[0], "rb") as f:
                head = f.read(4096).decode("ascii", errors="ignore")
            if not head.startswith("ply") or "element vertex" not in head:
                _err(out, mesh[0], "PLY header missing 'element vertex'")
        except OSError as e:
            _err(out, mesh[0], f"unreadable: {e}")
    return out


# ---------------------------------------------------------------------------
# dynamic capture
# ---------------------------------------------------------------------------


def _check_metadata(md, who: str, n_bones: int, out: List[str]) -> None:
    missing = [k for k in _MD_KEYS if k not in md]
    if missing:
        _err(out, who, f"metadata block missing keys: {missing}")
        return
    try:
        bnames = [
            n[0].decode() if isinstance(n, (list, np.ndarray))
            else (n.decode() if isinstance(n, bytes) else str(n))
            for n in md["bnames"][:].tolist()
        ]
        parents = [
            n[0].decode() if isinstance(n, (list, np.ndarray))
            else (n.decode() if isinstance(n, bytes) else str(n))
            for n in md["bnames_parent"][:].tolist()
        ]
    except Exception as e:
        _err(out, who, f"bnames/bnames_parent do not decode: {e}")
        return
    if len(bnames) < n_bones:
        _err(out, who, f"{len(bnames)} bone names < n_bones={n_bones}")
    known = set(bnames) | {"None", "none", ""}
    bad_parents = [p for p in parents if p not in known]
    if bad_parents:
        _err(out, who, f"kintree parents reference unknown bones: "
                       f"{bad_parents[:5]}")
    for key, tail in (("rest_heads", (3,)), ("rest_tails", (3,)),
                      ("pose_heads", (3,)), ("pose_tails", (3,)),
                      ("rest_matrixs", (4, 4)), ("pose_matrixs", (4, 4))):
        shape = tuple(md[key].shape)
        if len(shape) != 1 + len(tail) or shape[0] < n_bones \
                or shape[1:] != tail:
            _err(out, who, f"{key} shape {shape} != [>= {n_bones}, "
                           f"{', '.join(map(str, tail))}]")
        elif not np.all(np.isfinite(md[key][:])):
            _err(out, who, f"{key} contains non-finite values")
    if tuple(md["root_translation"].shape) != (3,):
        _err(out, who, f"root_translation shape "
                       f"{tuple(md['root_translation'].shape)} != [3]")


def _check_frame(grp, who: str, cam_names: Sequence[str], width: int,
                 height: int, n_bones: int, out: List[str],
                 decode_images: bool) -> None:
    for sub in ("images", "bbox", "metadata"):
        if sub not in grp:
            _err(out, who, f"frame group missing '{sub}'")
            return
    img_keys = set(grp["images"].keys())
    bbox_keys = set(grp["bbox"].keys())
    missing_img = [c for c in cam_names if c not in img_keys]
    missing_bbox = [c for c in cam_names if c not in bbox_keys]
    if missing_img:
        _err(out, who, f"images missing for cameras {missing_img[:5]} "
                       f"(+{max(0, len(missing_img) - 5)} more)")
    if missing_bbox:
        _err(out, who, f"bbox missing for cameras {missing_bbox[:5]}")
    for cam in cam_names:
        if cam in missing_img or cam in missing_bbox:
            continue
        cwho = f"{who}/{cam}"
        bbox = grp["bbox"][cam][:]
        if bbox.shape != (4,):
            _err(out, cwho, f"bbox shape {tuple(bbox.shape)} != [4]")
            continue
        xmin, ymin, xmax, ymax = [int(v) for v in bbox]
        if not (0 <= xmin < xmax <= width and 0 <= ymin < ymax <= height):
            _err(out, cwho,
                 f"bbox [{xmin},{ymin},{xmax},{ymax}] outside the "
                 f"{width}x{height} frame (order is xmin,ymin,xmax,ymax)")
            continue
        if not decode_images:
            continue
        crop = grp["images"][cam]
        if crop.dtype != np.uint8:
            _err(out, cwho, f"crop dtype {crop.dtype} != uint8")
        shape = tuple(crop.shape)
        if len(shape) != 3 or shape[2] != 4:
            _err(out, cwho, f"crop shape {shape} != [h, w, 4] (RGBA)")
        elif shape[:2] != (ymax - ymin, xmax - xmin):
            _err(out, cwho, f"crop shape {shape[:2]} != bbox extent "
                            f"({ymax - ymin}, {xmax - xmin})")


def validate_dynamic_capture(
    root_dir: str,
    width: int,
    height: int,
    n_bones: int = 20,
    frames_per_action: int = 4,
) -> List[str]:
    """Validate every .hdf5 action under root_dir. Frame-level checks run
    on an evenly-spaced sample of `frames_per_action` frames (all frame
    keys are still verified to parse as ints); pass -1 to sweep every
    frame of every action."""
    out: List[str] = []
    if not os.path.isdir(root_dir):
        _err(out, root_dir, "capture root is not a directory")
        return out
    actions = sorted(f for f in os.listdir(root_dir) if f.endswith(".hdf5"))
    if not actions:
        _err(out, root_dir, "no .hdf5 action files")
        return out

    first_cams = None
    for action in actions:
        path = os.path.join(root_dir, action)
        try:
            f = hdf5.File(path)
        except OSError as e:
            _err(out, path, f"unreadable HDF5: {e}")
            continue
        try:
            first_cams = _check_action(f, path, width, height, n_bones,
                                       frames_per_action, first_cams, out)
        except NotImplementedError as e:
            _err(out, path, f"unsupported HDF5 form: {e}")
        finally:
            f.close()
    return out


def _check_action(f, path: str, width: int, height: int, n_bones: int,
                  frames_per_action: int, first_cams, out: List[str]):
    """The checks of one action file; returns the first action's camera
    names (this one's when it is the first readable one)."""
    missing = [g for g in ("frames", "K", "extr") if g not in f]
    if missing:
        _err(out, path, f"missing top-level groups: {missing}")
        return first_cams
    k_keys = sorted(f["K"].keys())
    e_keys = sorted(f["extr"].keys())
    if k_keys != e_keys:
        _err(out, path, f"K/extr camera sets differ: "
                        f"K-only={sorted(set(k_keys) - set(e_keys))[:5]} "
                        f"extr-only={sorted(set(e_keys) - set(k_keys))[:5]}")
    for c in k_keys:
        if tuple(f["K"][c].shape) != (3, 3):
            _err(out, f"{path}/K/{c}",
                 f"shape {tuple(f['K'][c].shape)} != [3,3]")
        if c in f["extr"] and tuple(f["extr"][c].shape) not in (
                (3, 4), (4, 4)):
            _err(out, f"{path}/extr/{c}",
                 f"shape {tuple(f['extr'][c].shape)} != [3,4]/[4,4]")
    if first_cams is None:
        first_cams = k_keys
    elif k_keys != first_cams:
        _warn(out, path,
              "camera set differs from the first action's — the "
              "loader uses the FIRST file's rig for every action")
    if "mano_rest" not in f:
        _warn(out, path, "no mano_rest group: MANO-shaped voxel "
                         "grids / baselines unavailable")

    frame_keys = list(f["frames"].keys())
    if not frame_keys:
        _err(out, path, "frames group is empty")
        return first_cams
    bad = [k for k in frame_keys if not k.lstrip("-").isdigit()]
    if bad:
        _err(out, path, f"non-integer frame keys: {bad[:5]} "
                        "(the loader sorts frames by int(key))")
        frame_keys = [k for k in frame_keys if k not in bad]
    frame_keys = sorted(frame_keys, key=lambda s: int(s))
    if frames_per_action > 0 and len(frame_keys) > frames_per_action:
        idx = np.linspace(0, len(frame_keys) - 1,
                          frames_per_action).astype(int)
        sample = [frame_keys[i] for i in np.unique(idx)]
    else:
        sample = frame_keys
    for fno in sample:
        _check_frame(
            f["frames"][fno], f"{path}/frames/{fno}", k_keys,
            width, height, n_bones, out, decode_images=True,
        )
        if "metadata" in f["frames"][fno]:
            _check_metadata(
                f["frames"][fno]["metadata"],
                f"{path}/frames/{fno}/metadata", n_bones, out,
            )
    return first_cams


# ---------------------------------------------------------------------------
# config-level entry (main.py trainer.mode=validate_data)
# ---------------------------------------------------------------------------


def validate_capture(cfg) -> List[str]:
    """Dispatch on cfg.dataset.kind; returns the full findings list."""
    d = cfg.dataset
    if d.kind == "brics_static":
        return validate_static_capture(d.root)
    if d.kind == "brics_dynamic":
        return validate_dynamic_capture(
            d.root, width=d.width, height=d.height,
        )
    return [f"[warn] dataset.kind={d.kind}: nothing to validate "
            "(synthetic data is generated in-process)"]


def report(findings: List[str], log=print) -> int:
    """Print all findings; returns the number of [error] entries (the
    CLI exit code)."""
    for line in findings:
        log(line)
    n_err = sum(1 for s in findings if s.startswith("[error]"))
    n_warn = len(findings) - n_err
    log(f"[validate_data] {n_err} error(s), {n_warn} warning(s)")
    return n_err
