"""2D keypoint and skeleton overlays on images, and camera-rig frustums
(the JAX package's utils/vis.py), in numpy alone.

The JAX package draws with OpenCV; the card's machine has no OpenCV, so
the circles and lines are rasterised here the way OpenCV's are: a filled
circle is the pixels within its integer radius of the centre, a 1-pixel
line is OpenCV's 8-connected line iterator over the segment clipped by
its clipLine, so both give OpenCV's pixels. Thicker lines and circle
outlines are drawn as the pixels within half the thickness of the
segment or circle, close to OpenCV's but not the same.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _put(img, ys, xs, color):
    h, w = img.shape[:2]
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[ok], xs[ok]] = color


def draw_circle(img: np.ndarray, center, radius: int, color,
                thickness: int = -1) -> np.ndarray:
    """cv2.circle in place: filled (thickness < 0) as OpenCV fills, an
    outline of `thickness` pixels otherwise."""
    cx, cy = int(center[0]), int(center[1])
    r = int(radius)
    reach = r + max(thickness, 0)
    dy, dx = np.mgrid[-reach:reach + 1, -reach:reach + 1]
    d2 = dx * dx + dy * dy
    if thickness < 0:
        m = d2 <= r * r
    else:
        half = max(thickness, 1) / 2.0
        d = np.sqrt(d2)
        m = (d >= r - half) & (d <= r + half)
    _put(img, (dy + cy)[m], (dx + cx)[m], color)
    return img


def clip_line(width: int, height: int, p1, p2):
    """OpenCV's clipLine: the segment's ends moved onto the image (integer
    arithmetic, truncation toward zero); (inside, p1, p2)."""
    (x1, y1), (x2, y2) = p1, p2
    right, bottom = width - 1, height - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1, c1 = a, 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2, c2 = a, 0
    return (c1 | c2) == 0, (x1, y1), (x2, y2)


def line_pixels(p1, p2) -> Tuple[np.ndarray, np.ndarray]:
    """(xs, ys) of OpenCV's 8-connected line iterator from p1 to p2 (left
    to right; the minor axis steps where the error term is negative)."""
    (x1, y1), (x2, y2) = p1, p2
    if x2 < x1:
        (x1, y1), (x2, y2) = (x2, y2), (x1, y1)
    dx, dy = x2 - x1, y2 - y1
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    steep = dy > dx
    if steep:
        dx, dy = dy, dx
    # err starts at dx - 2 dy and falls by 2 dy a step; a negative err
    # steps the minor axis and adds 2 dx back
    k = np.arange(dx + 1)
    minor = np.zeros(dx + 1, np.int64)
    err = dx - 2 * dy
    for i in range(dx):
        step = err < 0
        err += -2 * dy + (2 * dx if step else 0)
        minor[i + 1] = minor[i] + step
    if steep:
        return x1 + minor, y1 + sy * k
    return x1 + k, y1 + sy * minor


def draw_line(img: np.ndarray, p1, p2, color, thickness: int = 1):
    """cv2.line in place: OpenCV's pixels at thickness 1; thicker, the
    pixels within thickness / 2 of the segment."""
    h, w = img.shape[:2]
    p1 = (int(p1[0]), int(p1[1]))
    p2 = (int(p2[0]), int(p2[1]))
    if thickness <= 1:
        inside = all(0 <= x < w and 0 <= y < h for x, y in (p1, p2))
        ok, q1, q2 = (True, p1, p2) if inside else clip_line(w, h, p1, p2)
        if ok:
            xs, ys = line_pixels(q1, q2)
            _put(img, ys, xs, color)
        return img
    half = thickness / 2.0
    x0, x1 = int(min(p1[0], p2[0]) - half - 1), int(max(p1[0], p2[0]) + half + 2)
    y0, y1 = int(min(p1[1], p2[1]) - half - 1), int(max(p1[1], p2[1]) + half + 2)
    ys, xs = np.mgrid[y0:y1, x0:x1]
    a = np.asarray(p1, np.float64)
    d = np.asarray(p2, np.float64) - a
    t = ((xs - a[0]) * d[0] + (ys - a[1]) * d[1]) / max(d @ d, 1e-12)
    t = np.clip(t, 0.0, 1.0)
    dist2 = (xs - a[0] - t * d[0]) ** 2 + (ys - a[1] - t * d[1]) ** 2
    m = dist2 <= half * half
    _put(img, ys[m], xs[m], color)
    return img


def plot_points_in_image(points, image, color=(0, 255, 0), radius=2,
                         thickness=-1) -> np.ndarray:
    """A copy of image with points [N, 2+] drawn as circles."""
    image = np.ascontiguousarray(image).copy()
    for point in np.asarray(points):
        draw_circle(image, point[:2].astype(np.int32), radius, color,
                    thickness)
    return image


def project_points(keypoints3d: np.ndarray, P: np.ndarray) -> np.ndarray:
    """Pinhole projection: keypoints3d [N, 3], P [V, 3, 4] -> [V, N, 2]."""
    hom = np.hstack((keypoints3d, np.ones((keypoints3d.shape[0], 1))))
    projected = np.matmul(P, hom.T).transpose(0, 2, 1)
    return (projected / projected[:, :, -1:])[:, :, :-1]


def plot_keypoints_2d(joints: np.ndarray, image: np.ndarray,
                      proj_mat: np.ndarray, kintree: Optional[dict] = None,
                      bone_color: Tuple[int, int, int] = (255, 0, 0),
                      plot_bones: bool = True) -> np.ndarray:
    """The skeleton over an image: joints [J, 3] (world) projected by
    proj_mat [3, 4] as filled circles, and with kintree ({str(bone):
    parent}, joint = bone + 1, joint 0 the wrist) its bones as lines."""
    keypoints_2d = project_points(joints, np.asarray([proj_mat]))[0]
    res = np.ascontiguousarray(image).copy()
    joint_radius = max(1, min(*image.shape[:2]) // 150)
    for kp in keypoints_2d:
        draw_circle(res, (int(kp[0]), int(kp[1])), joint_radius,
                    (0, 0, 255), -1)
    if plot_bones and kintree:
        for bone, parent in kintree.items():
            parent_id, bone_id = int(parent) + 1, int(bone) + 1
            if parent_id <= 0 or bone_id >= len(keypoints_2d):
                continue
            draw_line(res, keypoints_2d[bone_id], keypoints_2d[parent_id],
                      bone_color, max(1, joint_radius // 2))
    return res


def visualize_ik_overlay(images: np.ndarray, joints: np.ndarray,
                         proj_mats: np.ndarray, kintree: Optional[dict] = None,
                         max_views: int = 4) -> np.ndarray:
    """The solved skeleton over the first max_views camera frames
    ([V, H, W, 3] uint8), side by side."""
    return np.concatenate(
        [plot_keypoints_2d(joints, images[v], proj_mats[v], kintree)
         for v in range(min(max_views, len(images)))], axis=1)


def camera_frustum(world_view_transform: np.ndarray, tanfovx: float,
                   tanfovy: float, frustum_length: float = 0.5):
    """One camera's frustum wireframe: 5 world points (the centre and the
    image corners' rays at frustum_length, camera +z forward) and its 8
    edges, from the row-vector world_view_transform [4, 4]."""
    wvt = np.asarray(world_view_transform, np.float64)
    L = float(frustum_length)
    hw, hh = L * float(tanfovx), L * float(tanfovy)
    cam_pts = np.array([
        [0.0, 0.0, 0.0, 1.0],
        [-hw, -hh, L, 1.0],  # top-left image corner
        [hw, -hh, L, 1.0],   # top-right
        [hw, hh, L, 1.0],    # bottom-right
        [-hw, hh, L, 1.0],   # bottom-left
    ])
    world = cam_pts @ np.linalg.inv(wvt)  # p_cam = p_world @ wvt
    world = world[:, :3] / world[:, 3:4]
    edges = np.array([[0, i] for i in range(1, 5)]
                     + [[i, i + 1] for i in range(1, 4)] + [[4, 1]])
    return world.astype(np.float32), edges.astype(np.int32)


def visualize_camera_rig(cameras, path: str, frustum_length: float = 0.5,
                         color=(29 / 255.0, 53 / 255.0, 87 / 255.0),
                         colors: Optional[np.ndarray] = None):
    """Every camera's frustum as one line-set PLY (dump_lineset).
    cameras: a stacked Camera ([N] leading axis) or a list of Cameras;
    colors [N, 3] per camera overrides color. Returns (points, edges,
    edge_colors)."""
    from manus_tpu_torch.utils.camera import index_camera
    from manus_tpu_torch.utils.io import dump_lineset

    if not isinstance(cameras, (list, tuple)):
        n = cameras.world_view_transform.shape[0]
        cameras = [index_camera(cameras, i) for i in range(n)]
    pts_all, edges_all, cols_all = [], [], []
    for i, cam in enumerate(cameras):
        pts, edges = camera_frustum(
            cam.world_view_transform.detach().cpu().numpy(),
            float(cam.tanfovx), float(cam.tanfovy), frustum_length)
        pts_all.append(pts)
        edges_all.append(edges + 5 * i)
        c = np.asarray(colors[i] if colors is not None else color, np.float32)
        cols_all.append(np.tile(c[None], (8, 1)))
    points = np.concatenate(pts_all)
    edges = np.concatenate(edges_all)
    edge_colors = np.concatenate(cols_all)
    dump_lineset(path, points, edges, edge_colors)
    return points, edges, edge_colors
