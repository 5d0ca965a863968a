"""Contact evaluation: paint-transfer IoU/F1 of rendered accumulated
contacts against ground-truth contact masks (the reference's
scripts/train/eval.sh -> get_iou.py / get_iou_ours.py /
get_evaluation_numbers_ours.py), and the HSV keying that makes the masks
from photos of a painted hand.

The composite's acc_gt_eval renders ([skin-weight colours | accumulated
contact]) are thresholded into contact masks and scored per camera, per
bone and combined against the ground truth, beside the MANO/HARP
baselines' renders. Images are read and written as PNGs by utils/io.py;
the bone labels reproduce OpenCV's colour keying and morphology in numpy.
"""
from __future__ import annotations

import csv
import os
import warnings
from typing import Optional

import numpy as np
import torch

from manus_tpu_torch.ops.contacts import contact_iou_f1
from manus_tpu_torch.ops.knn import nearest_neighbor
from manus_tpu_torch.utils.device import resolve_device
from manus_tpu_torch.utils.io import dump_image, read_png


def contact_mask_from_render(render: np.ndarray,
                             threshold: float = 0.1) -> np.ndarray:
    """Binary contact mask of a grey-colormapped contact render [H, W, 3]:
    the channel mean above `threshold`."""
    return np.asarray(render).mean(axis=-1) > threshold


# OpenCV's 8-bit RGB -> HSV: 12-bit fixed point through two tables of
# rounded reciprocals, H in [0, 180).
_HSV_SHIFT = 12


def _hsv_tables():
    i = np.maximum(np.arange(256, dtype=np.float64), 1.0)
    sdiv = np.rint((255 << _HSV_SHIFT) / i).astype(np.int64)
    hdiv = np.rint((180 << _HSV_SHIFT) / (6.0 * i)).astype(np.int64)
    sdiv[0] = hdiv[0] = 0
    return sdiv, hdiv


_SDIV, _HDIV = _hsv_tables()


def rgb_to_hsv_u8(img: np.ndarray) -> np.ndarray:
    """[..., 3] uint8 RGB -> uint8 HSV as OpenCV's cvtColor(COLOR_RGB2HSV)
    gives it, bit for bit: V = max, S = round(255 (V - min) / V), H in
    [0, 180) = round(30 (hue sextant offset) / (V - min)), each a product
    with a rounded 12-bit reciprocal."""
    c = np.asarray(img).astype(np.int64)
    r, g, b = c[..., 0], c[..., 1], c[..., 2]
    v = np.maximum(np.maximum(r, g), b)
    diff = v - np.minimum(np.minimum(r, g), b)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + half) >> _HSV_SHIFT
    h = np.where(v == r, g - b,
                 np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV[diff] + half) >> _HSV_SHIFT  # arithmetic: floor
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], axis=-1).astype(np.uint8)


def _box_filter(m: np.ndarray, k: int, reduce, border: bool) -> np.ndarray:
    """min (erosion) or max (dilation) over a k x k square (odd k), rows
    then columns; pixels outside the image take `border`, OpenCV's
    default morphology border (erosion: true, dilation: false)."""
    r = k // 2
    p = np.pad(m, r, constant_values=border)
    rows = reduce.reduce([p[i:i + m.shape[0]] for i in range(k)])
    return reduce.reduce([rows[:, i:i + m.shape[1]] for i in range(k)])


def morph_close(mask: np.ndarray, k: int = 5) -> np.ndarray:
    """cv2.morphologyEx(mask, MORPH_CLOSE, ones((k, k))) of a boolean
    mask: dilation, then erosion."""
    m = np.asarray(mask, bool)
    return _box_filter(_box_filter(m, k, np.logical_or, False), k,
                       np.logical_and, True)


def skin_mask_from_color(image: np.ndarray, hsv_low=(0.45, 0.25, 0.2),
                         hsv_high=(0.75, 1.0, 1.0),
                         fill_holes: bool = True) -> np.ndarray:
    """Paint segmentation of a photo of a painted hand ([H, W, 3] float
    RGB in [0, 1]): the pixels whose HSV (OpenCV's 8-bit, H / 179, S and
    V / 255) lies in [hsv_low, hsv_high], holes closed by a 5 x 5
    closing. The range depends on the rig and paint (calibrate_hsv_range);
    the default is a blue/cyan paint."""
    img8 = (np.clip(image, 0, 1) * 255).astype(np.uint8)
    hsv = rgb_to_hsv_u8(img8).astype(np.float32)
    hsv[..., 0] /= 179.0
    hsv[..., 1:] /= 255.0
    mask = np.all((hsv >= np.asarray(hsv_low))
                  & (hsv <= np.asarray(hsv_high)), axis=-1)
    return morph_close(mask) if fill_holes else mask


def calibrate_hsv_range(images, paint_masks, coverage: float = 0.98,
                        margin: float = 0.02, sv_margin: float = 0.15):
    """(hsv_low, hsv_high) for skin_mask_from_color from labelled paint
    pixels (paint_masks [H, W] bool over images [H, W, 3] float in [0, 1]):
    the coverage percentiles of each channel, hue centred on its circular
    mean first (so a paint near the red wrap calibrates) and widened by
    margin, saturation and value by the wider sv_margin (they swing with
    the lighting). Plain float tuples."""
    hs, ss, vs = [], [], []
    for img, m in zip(images, paint_masks):
        img8 = (np.clip(np.asarray(img), 0, 1) * 255).astype(np.uint8)
        hsv = rgb_to_hsv_u8(img8).astype(np.float32)
        sel = np.asarray(m).astype(bool)
        if not sel.any():
            continue
        hs.append(hsv[..., 0][sel] / 179.0)
        ss.append(hsv[..., 1][sel] / 255.0)
        vs.append(hsv[..., 2][sel] / 255.0)
    if not hs:
        raise ValueError("no paint pixels in any provided mask")
    h, s, v = np.concatenate(hs), np.concatenate(ss), np.concatenate(vs)
    ang = h * 2 * np.pi
    mean = np.arctan2(np.sin(ang).mean(), np.cos(ang).mean()) / (2 * np.pi)
    h_cent = (h - mean + 0.5) % 1.0  # the paint's hues now near 0.5
    qlo, qhi = (1 - coverage) * 100, coverage * 100
    h_lo, h_hi = np.percentile(h_cent, [qlo, qhi])
    # back to absolute hue, clamped: a range across the wrap gets the
    # widest non-wrapping one
    h_lo = max(0.0, float(h_lo - 0.5 + mean) - margin)
    h_hi = min(1.0, float(h_hi - 0.5 + mean) + margin)
    s_lo, s_hi = np.percentile(s, [qlo, qhi])
    v_lo, v_hi = np.percentile(v, [qlo, qhi])
    low = (h_lo, max(0.0, float(s_lo) - sv_margin),
           max(0.0, float(v_lo) - sv_margin))
    high = (h_hi, min(1.0, float(s_hi) + sv_margin),
            min(1.0, float(v_hi) + sv_margin))
    return low, high


# The reference's 16 per-bone paint colours (get_iou_ours.py:93-110), the
# palette of its Blender-side skin renders.
BONE_COLORS = np.asarray(
    [
        [43, 159, 43], [31, 119, 178], [173, 198, 231], [254, 186, 119],
        [151, 222, 137], [213, 38, 39], [254, 151, 149], [196, 175, 212],
        [139, 85, 74], [195, 155, 147], [246, 181, 209], [126, 126, 126],
        [198, 199, 198], [218, 218, 140], [25, 190, 206], [156, 217, 228],
    ],
    np.float32,
)


def _cross_filter(m: np.ndarray, reduce, border: bool) -> np.ndarray:
    """min (erosion) or max (dilation) over the 3x3 cross, OpenCV's
    MORPH_ELLIPSE (3, 3) kernel; pixels outside the image take `border`
    (erosion: true, dilation: false), so the edge neither erodes nor
    grows, as OpenCV's default morphology border does."""
    p = np.pad(m, 1, constant_values=border)
    return reduce.reduce([p[1:-1, 1:-1], p[:-2, 1:-1], p[2:, 1:-1],
                          p[1:-1, :-2], p[1:-1, 2:]])


def skin_bone_masks(image: np.ndarray, gt_mask: np.ndarray,
                    color_offset: float = 10.0, device=None) -> np.ndarray:
    """Per-bone label image of a skin-coloured hand render (the
    reference's get_skin_mask, get_iou_ours.py:74-151): [H, W] ints in
    [0, 16], 0 the background.

    image: [H, W, 3] RGB, uint8 or float in [0, 1]; gt_mask: [H, W] hand
    silhouette. Each bone colour is keyed within +-color_offset on all
    three channels (inclusive, as cv2.inRange), eroded then dilated once
    with the 3x3 cross; the first bone that keys a pixel labels it, and
    labels outside the silhouette are dropped. Every silhouette pixel
    left without a label takes its nearest labelled pixel's (ops/knn on
    `device`; integer pixel coordinates, so the float32 distances are
    exact and the first of equidistant pixels wins).
    """
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    img = img.astype(np.float32)
    gt = np.asarray(gt_mask).astype(bool)
    layers = [np.zeros(gt.shape, bool)]  # the background layer
    for c in BONE_COLORS:
        m = np.all((img >= c - color_offset) & (img <= c + color_offset),
                   axis=-1)
        m = _cross_filter(_cross_filter(m, np.logical_and, True),
                          np.logical_or, False)
        layers.append(m)
    labels = np.argmax(np.stack(layers, axis=-1), axis=-1) * gt

    residual = np.logical_xor(gt, labels > 0)
    res_coord = np.argwhere(residual)
    lab_coord = np.argwhere(labels > 0)
    if len(res_coord) and len(lab_coord):
        device = resolve_device(device)

        def pts(coord):  # [y, x, 0] for the 3D nearest neighbour
            p = np.zeros((len(coord), 3), np.float32)
            p[:, :2] = coord
            return torch.as_tensor(p, device=device)

        _, idx = nearest_neighbor(pts(res_coord), pts(lab_coord))
        src = lab_coord[idx.cpu().numpy()]
        labels[res_coord[:, 0], res_coord[:, 1]] = labels[src[:, 0],
                                                          src[:, 1]]
    return labels


def per_bone_iou_f1(skin_labels: np.ndarray, gt_mask: np.ndarray,
                    pred_mask: np.ndarray, n_bones: int = 16):
    """Per-bone contact IoU and F1, both masks restricted to each bone's
    skin region (the reference's calculate_per_bone_iou). Returns
    (iou [B], f1 [B]), NaN where a bone has no contact pixel."""
    ious, f1s = [], []
    gt = np.asarray(gt_mask).astype(bool)
    pred = np.asarray(pred_mask).astype(bool)
    for b in range(1, n_bones + 1):
        region = skin_labels == b
        g, p = gt & region, pred & region
        inter = np.logical_and(g, p).sum()
        union = np.logical_or(g, p).sum()
        ious.append(inter / union if union else float("nan"))
        denom = g.sum() + p.sum()
        f1s.append(2 * inter / denom if denom else float("nan"))
    return np.asarray(ious), np.asarray(f1s)


def evaluate_contact_dir(pred_dir: str, gt_dir: str,
                         out_csv: Optional[str] = None,
                         threshold: float = 0.1) -> dict:
    """IoU/F1 over the PNGs of pred_dir (acc_gt_eval renders) that have a
    namesake in gt_dir (binary masks, read as greyscale, above 127).
    Returns {mean_iou, mean_f1, num_images} and writes a per-camera CSV
    with a closing "mean" row."""
    names = sorted(f for f in os.listdir(pred_dir)
                   if f.endswith(".png")
                   and os.path.exists(os.path.join(gt_dir, f)))
    rows, ious, f1s = [], [], []
    for name in names:
        pred_img = read_png(os.path.join(pred_dir, name)) / 255.0
        gt_mask = read_png(os.path.join(gt_dir, name), "gray") > 127
        iou, f1 = contact_iou_f1(contact_mask_from_render(pred_img, threshold),
                                 gt_mask)
        iou, f1 = float(iou), float(f1)
        rows.append([name, iou, f1])
        ious.append(iou)
        f1s.append(f1)
    summary = dict(
        mean_iou=float(np.mean(ious)) if ious else float("nan"),
        mean_f1=float(np.mean(f1s)) if f1s else float("nan"),
        num_images=len(rows),
    )
    if out_csv:
        os.makedirs(os.path.dirname(out_csv) or ".", exist_ok=True)
        with open(out_csv, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["camera", "iou", "f1"])
            w.writerows(rows)
            w.writerow(["mean", summary["mean_iou"], summary["mean_f1"]])
    return summary


def aggregate_subject_csvs(csv_paths: list, out_csv: str) -> dict:
    """The subjects' "mean" rows averaged (the reference's
    get_evaluation_numbers_ours.py); writes metric,value rows."""
    all_iou, all_f1 = [], []
    for path in csv_paths:
        with open(path) as f:
            for row in csv.reader(f):
                if row and row[0] == "mean":
                    all_iou.append(float(row[1]))
                    all_f1.append(float(row[2]))
    summary = dict(
        mean_iou=float(np.mean(all_iou)) if all_iou else float("nan"),
        mean_f1=float(np.mean(all_f1)) if all_f1 else float("nan"),
        num_subjects=len(all_iou),
    )
    with open(out_csv, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["metric", "value"])
        for k, v in summary.items():
            w.writerow([k, v])
    return summary


def evaluate_metric(skin_labels: np.ndarray, gt_mask: np.ndarray,
                    pred_mask: np.ndarray, n_bones: int = 16):
    """One method on one frame (the reference's evaluate_metric): returns
    (iou [B], f1 [B], combined iou, combined f1)."""
    iou_b, f1_b = per_bone_iou_f1(skin_labels, gt_mask, pred_mask, n_bones)
    iou, f1 = contact_iou_f1(np.asarray(pred_mask), np.asarray(gt_mask))
    return iou_b, f1_b, float(iou), float(f1)


def blend_masks(rgb: np.ndarray, alpha: np.ndarray, mask: np.ndarray,
                weight: float = 0.5, color=(0.0, 0.5, 0.0)) -> np.ndarray:
    """Green contact overlay on the photo [H, W, 3] in [0, 1], white
    outside the silhouette alpha [H, W, 1] (the reference's blend_masks)."""
    overlay = mask[..., None] * np.asarray(color, np.float32)
    final = rgb * weight + (1.0 - weight) * overlay
    return final * alpha + (1.0 - alpha) * 1.0


def combine_images(rgba: np.ndarray, gt_mask: np.ndarray,
                   method_masks: dict) -> np.ndarray:
    """One collage row, uint8: [photo | gt overlay | one overlay a method]
    (the reference's combine_images); rgba [H, W, 4] uint8."""
    alpha = (rgba[..., -1:] > 128).astype(np.float32)
    rgb = rgba[..., :3].astype(np.float32) / 255.0
    panels = [rgb * alpha + (1.0 - alpha) * 1.0,
              blend_masks(rgb, alpha, np.asarray(gt_mask, np.float32))]
    for m in method_masks.values():
        panels.append(blend_masks(rgb, alpha, np.asarray(m, np.float32)))
    row = np.concatenate(panels, axis=1)
    return np.clip(row * 255.0, 0, 255).astype(np.uint8)


def write_eval_table(out_csv: str, iou_rows: dict, f1_rows: dict,
                     n_bones: int = 16) -> None:
    """eval_metric.csv as the reference writes it (get_iou.py:366-378):
    header ["", bone1..boneB, combined], a row per method, then the
    `<method>_f1` rows, rounded to 3 decimals."""
    os.makedirs(os.path.dirname(out_csv) or ".", exist_ok=True)
    with open(out_csv, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow([""] + [f"bone{i + 1}" for i in range(n_bones)]
                   + ["combined"])
        for name, row in iou_rows.items():
            w.writerow([name] + np.around(np.asarray(row, float), 3).tolist())
        for name, row in f1_rows.items():
            w.writerow([f"{name}_f1"]
                       + np.around(np.asarray(row, float), 3).tolist())


def evaluate_composite(exp_dir: str, gt_seg_dir: str, gt_img_dir: str,
                       n_bones: int = 16, mask_threshold: float = 0.5,
                       device=None) -> dict:
    """The three-way contact table of a composite run (the reference's
    get_iou.py / get_iou_ours.py).

    ours: {exp_dir}/results/eval_results/ours/*.png, the acc_gt_eval
    layout [skin colours | accumulated contact]; baselines:
    {exp_dir}/results/eval_results/{mano,harp}/acc_eval_rendered/*.png
    (train/baselines.py), where present; ground truth: gt_seg_dir/*.png
    binary contact masks and gt_img_dir/*.png RGBA photos (alpha the
    hand's silhouette), the same names. Writes
    results/eval_results/eval_metric.csv (per-bone and combined IoU/F1
    rows a method, averaged over frames) and eval_collage.png; returns
    {method: {"iou", "f1"}}, the combined scores. The bone labels' nearest
    neighbour vote runs on `device`.
    """
    res_dir = os.path.join(exp_dir, "results", "eval_results")
    ours_dir = os.path.join(res_dir, "ours")
    names = sorted(
        f for f in os.listdir(ours_dir)
        if f.endswith(".png")
        and os.path.exists(os.path.join(gt_seg_dir, f))
        and os.path.exists(os.path.join(gt_img_dir, f)))
    if not names:
        raise FileNotFoundError(
            f"no matching (ours, gt_seg, gt_img) PNG triples between "
            f"{ours_dir} and {gt_seg_dir}")
    methods = ["ours"] + [
        m for m in ("mano", "harp")
        if os.path.isdir(os.path.join(res_dir, m, "acc_eval_rendered"))]
    cut = 255 * mask_threshold

    acc_iou = {m: [] for m in methods}
    acc_f1 = {m: [] for m in methods}
    collage = []
    for name in names:
        gt_rgba = read_png(os.path.join(gt_img_dir, name), "rgba")
        gt_mask = read_png(os.path.join(gt_seg_dir, name), "gray") > cut
        ours_img = read_png(os.path.join(ours_dir, name))
        half = ours_img.shape[1] // 2
        skin_img, ours_contact = ours_img[:, :half], ours_img[:, half:]
        skin_labels = skin_bone_masks(skin_img, gt_rgba[..., -1] > 128,
                                      device=device)
        masks = {"ours": ours_contact.mean(axis=-1) > cut}
        for m in methods[1:]:
            masks[m] = read_png(os.path.join(res_dir, m, "acc_eval_rendered",
                                             name), "gray") > cut
        for m in methods:
            iou_b, f1_b, iou, f1 = evaluate_metric(skin_labels, gt_mask,
                                                   masks[m], n_bones)
            acc_iou[m].append(np.concatenate([iou_b, [iou]]))
            acc_f1[m].append(np.concatenate([f1_b, [f1]]))
        collage.append(combine_images(gt_rgba, gt_mask, masks))

    # frame averages; a bone never in contact (all NaN) scores 0, as the
    # reference's fillna(0) downstream
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        iou_rows = {m: np.nan_to_num(np.nanmean(acc_iou[m], axis=0))
                    for m in methods}
        f1_rows = {m: np.nan_to_num(np.nanmean(acc_f1[m], axis=0))
                   for m in methods}
    write_eval_table(os.path.join(res_dir, "eval_metric.csv"), iou_rows,
                     f1_rows, n_bones)
    dump_image(np.vstack(collage), os.path.join(res_dir, "eval_collage.png"))
    return {m: dict(iou=float(iou_rows[m][-1]), f1=float(f1_rows[m][-1]))
            for m in methods}


def aggregate_eval_tables(csv_paths: list,
                          out_csv: Optional[str] = None) -> dict:
    """eval_metric.csv rows averaged key by key over the CSVs that exist
    (the reference's get_evaluation_numbers_ours.py): {row name: values
    [B+1]}."""
    sums: dict = {}
    count = 0
    for path in csv_paths:
        if not os.path.exists(path):
            continue
        count += 1
        with open(path) as f:
            rows = list(csv.reader(f))
        for row in rows[1:]:
            vals = np.nan_to_num(np.asarray(row[1:], float))
            sums[row[0]] = sums.get(row[0], 0.0) + vals
    avg = {k: v / max(count, 1) for k, v in sums.items()}
    if out_csv:
        with open(out_csv, "w", newline="") as f:
            w = csv.writer(f)
            for k, v in avg.items():
                w.writerow([k] + np.around(v, 3).tolist())
    return avg
