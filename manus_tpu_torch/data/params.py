"""BRICS calibration parsing, undistortion and area resizing, in numpy.

The calibration contract (optim_params.txt: a row per camera with its
intrinsics, four distortion coefficients and a wxyz quaternion and
translation, sorted by camera name) is the JAX package's
(manus_tpu/data/params.py). The undistortion and the resize are OpenCV's
arithmetic written out, since the card's machine has no OpenCV:

- get_undistort_params is cv2.getOptimalNewCameraMatrix(K, dist, size,
  alpha=0, centerPrincipalPoint=True): a 9x9 grid of border points is
  undistorted by five fixed-point iterations (cv2.undistortPoints'
  default), the inner rectangle of the result bounds the scale about the
  image centre;
- undistort_image is cv2.undistort(img, K, dist, None, new_K) on uint8
  images: the undistort map of OpenCV's stripes, positions rounded to
  1/32 px, then bilinear sampling with 15-bit fixed-point weights and a
  constant zero border. Its bytes equal OpenCV's on every pixel of the
  tests' images; a position within double rounding of a 1/32 px step
  may round to the next one, so tests/test_torch_brics.py allows 1 on
  0.1% of the pixels;
- resize_area is cv2.resize(img, (w, h), interpolation=INTER_AREA) on
  float32 for a downscale: whole-cell means for an integer factor, the
  fractional cell weights otherwise.
"""
from __future__ import annotations

import math

import numpy as np

PARAM_DTYPE = [
    ("cam_id", int),
    ("width", int),
    ("height", int),
    ("fx", float),
    ("fy", float),
    ("cx", float),
    ("cy", float),
    ("k1", float),
    ("k2", float),
    ("p1", float),
    ("p2", float),
    ("cam_name", "<U22"),
    ("qvecw", float),
    ("qvecx", float),
    ("qvecy", float),
    ("qvecz", float),
    ("tvecx", float),
    ("tvecy", float),
    ("tvecz", float),
]


def read_params(params_path: str) -> np.ndarray:
    params = np.loadtxt(params_path, dtype=PARAM_DTYPE)
    return np.sort(np.atleast_1d(params), order="cam_name")


def qvec2rotmat(q) -> np.ndarray:
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z, 2 * z * x + 2 * w * y],
            [2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * w * x],
            [2 * z * x - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x * x - 2 * y * y],
        ]
    )


def get_intr(param):
    K = np.eye(3)
    K[0, 0], K[1, 1] = param["fx"], param["fy"]
    K[0, 2], K[1, 2] = param["cx"], param["cy"]
    dist = np.asarray([param["k1"], param["k2"], param["p1"], param["p2"]])
    return K, dist


def get_extr(param) -> np.ndarray:
    q = [param["qvecw"], param["qvecx"], param["qvecy"], param["qvecz"]]
    t = np.asarray([param["tvecx"], param["tvecy"], param["tvecz"]])
    return np.hstack([qvec2rotmat(q), t[:, None]])  # [3, 4]


# Lower-hemisphere cameras excluded from training (reference
# brics_static.py:33-53).
STATIC_SKIP_CAMERAS = (
    "brics-sbc-003_cam0",
    "brics-sbc-003_cam1",
    "brics-sbc-004_cam1",
    "brics-sbc-008_cam0",
    "brics-sbc-008_cam1",
    "brics-sbc-009_cam0",
    "brics-sbc-013_cam0",
    "brics-sbc-013_cam1",
    "brics-sbc-014_cam0",
    "brics-sbc-018_cam0",
    "brics-sbc-018_cam1",
    "brics-sbc-019_cam0",
)

# cv2.undistortPoints' default criteria: five iterations, no epsilon
UNDISTORT_POINT_ITERS = 5
# cv2.remap's fixed point: positions in 1/32 px, weights of 15 bits
INTER_BITS, REMAP_COEF_BITS = 5, 15
# cv2.undistort computes its map in stripes of about 4096 pixels
UNDISTORT_STRIPE_PIXELS = 1 << 12


def _dist4(dist) -> tuple:
    d = np.zeros(4, np.float64)
    flat = np.asarray(dist, np.float64).reshape(-1)
    if flat.size > 4 and np.any(flat[4:] != 0):
        raise NotImplementedError("distortion beyond k1, k2, p1, p2")
    d[:min(4, flat.size)] = flat[:4]
    return tuple(float(x) for x in d)


def undistort_points(pts, K, dist) -> np.ndarray:
    """cv2.undistortPoints(pts, K, dist, P=K) for pixel points [N, 2]:
    the same five fixed-point iterations in float64."""
    k1, k2, p1, p2 = _dist4(dist)
    K = np.asarray(K, np.float64)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    pts = np.asarray(pts, np.float64)
    x0 = (pts[:, 0] - cx) * (1.0 / fx)
    y0 = (pts[:, 1] - cy) * (1.0 / fy)
    x, y = x0.copy(), y0.copy()
    for _ in range(UNDISTORT_POINT_ITERS):
        r2 = x * x + y * y
        icdist = 1.0 / (1 + (k2 * r2 + k1) * r2)
        bad = icdist < 0  # OpenCV keeps the undistorted-free point there
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x = np.where(bad, x0, (x0 - dx) * icdist)
        y = np.where(bad, y0, (y0 - dy) * icdist)
    return np.stack([fx * x + cx, fy * y + cy], axis=-1)


def get_undistort_params(K, dist, img_size):
    """cv2.getOptimalNewCameraMatrix(K, dist, img_size, alpha=0,
    centerPrincipalPoint=True): (new_K [3, 3] float64, roi (x, y, w, h))."""
    w, h = int(img_size[0]), int(img_size[1])
    K = np.asarray(K, np.float64)
    n = 9
    gx, gy = np.meshgrid(np.arange(n), np.arange(n))
    # the grid is made in float32, as OpenCV makes it
    grid = np.stack([
        (gx.astype(np.float32) * np.float32(w - 1) / np.float32(n - 1)),
        (gy.astype(np.float32) * np.float32(h - 1) / np.float32(n - 1)),
    ], axis=-1).reshape(-1, 2).astype(np.float64)
    und = undistort_points(grid, K, dist).reshape(n, n, 2)
    ix0, ix1 = und[:, 0, 0].max(), und[:, n - 1, 0].min()
    iy0, iy1 = und[0, :, 1].max(), und[n - 1, :, 1].min()
    cx0, cy0 = K[0, 2], K[1, 2]
    cx, cy = (w - 1) * 0.5, (h - 1) * 0.5
    s = max(cx / (cx0 - ix0), cy / (cy0 - iy0), cx / (ix1 - cx0),
            cy / (iy1 - cy0))
    new_K = K.copy()
    new_K[0, 0] *= s
    new_K[1, 1] *= s
    new_K[0, 2], new_K[1, 2] = cx, cy
    rx, ry = (ix0 - cx0) * s + cx, (iy0 - cy0) * s + cy
    rw, rh = (ix1 - ix0) * s, (iy1 - iy0) * s
    x, y = math.ceil(rx), math.ceil(ry)
    x1, y1 = min(x + math.floor(rw), w), min(y + math.floor(rh), h)
    x, y = max(x, 0), max(y, 0)
    roi = (x, y, max(x1 - x, 0), max(y1 - y, 0))
    return new_K, roi


def undistort_map(K, new_K, dist, width: int, height: int) -> np.ndarray:
    """cv2.undistort's map: for each output pixel the source position in
    1/32 px, rounded half to even ([H, W, 2] int64, x then y)."""
    k1, k2, p1, p2 = _dist4(dist)
    K = np.asarray(K, np.float64)
    fx, fy, u0, v0 = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    ar = np.asarray(new_K, np.float64).copy()
    stripe = min(max(1, UNDISTORT_STRIPE_PIXELS // max(width, 1)), height)
    cy_new = ar[1, 2]
    out = np.empty((height, width, 2), np.int64)
    j = np.arange(width, dtype=np.float64)
    for y0 in range(0, height, stripe):
        rows = min(stripe, height - y0)
        ar[1, 2] = cy_new - y0
        ir = np.linalg.inv(ar).reshape(-1)
        i = np.arange(rows, dtype=np.float64)[:, None]
        _x = i * ir[1] + ir[2] + j * ir[0]
        _y = i * ir[4] + ir[5] + j * ir[3]
        _w = i * ir[7] + ir[8] + j * ir[6]
        w = 1.0 / _w
        x, y = _x * w, _y * w
        x2, y2 = x * x, y * y
        r2 = x2 + y2
        _2xy = 2 * x * y
        kr = 1 + (k2 * r2 + k1) * r2
        xd = x * kr + p1 * _2xy + p2 * (r2 + 2 * x2)
        yd = y * kr + p1 * (r2 + 2 * y2) + p2 * _2xy
        u = fx * xd + u0
        v = fy * yd + v0
        scale = float(1 << INTER_BITS)
        out[y0:y0 + rows, :, 0] = np.rint(u * scale)
        out[y0:y0 + rows, :, 1] = np.rint(v * scale)
    return out


def remap_bilinear_u8(img: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """cv2.remap(img, map, INTER_LINEAR, BORDER_CONSTANT 0) on uint8 with
    positions in 1/32 px ([H, W, 2] int): the 2x2 neighbours weighted by
    (32 - f) or f per axis times 32 (15 bits in all), rounded. Where no
    position has a fraction (a map with no distortion to undo), each
    output pixel is its one neighbour, as the weights make it, and the
    identity map copies the image."""
    src = np.asarray(img)
    if src.dtype != np.uint8:
        raise ValueError(
            f"undistort_image takes uint8 images, not {src.dtype}")
    squeeze = src.ndim == 2
    if squeeze:
        src = src[..., None]
    h, w, c = src.shape
    tab = 1 << INTER_BITS
    sx, sy = pos[..., 0] >> INTER_BITS, pos[..., 1] >> INTER_BITS
    fx = (pos[..., 0] & (tab - 1)).astype(np.int32)
    fy = (pos[..., 1] & (tab - 1)).astype(np.int32)
    if (not (fx.any() or fy.any()) and (sx == np.arange(w)).all()
            and (sy == np.arange(h)[:, None]).all()):
        return np.array(img)  # the identity map
    # a zero border of one pixel: a neighbour off the image reads 0, and
    # one further out too (its index is clipped onto the border)
    flat = np.zeros((h + 2, w + 2, c), np.int32)
    flat[1:-1, 1:-1] = src
    flat = flat.reshape(-1, c)
    x0 = np.clip(sx + 1, 0, w + 1)
    y0 = np.clip(sy + 1, 0, h + 1) * (w + 2)
    if not (fx.any() or fy.any()):
        out = flat[y0 + x0].astype(np.uint8)
        return out[..., 0] if squeeze else out
    x1 = np.clip(sx + 2, 0, w + 1)
    y1 = np.clip(sy + 2, 0, h + 1) * (w + 2)
    gx, gy = tab - fx, tab - fy
    acc = (flat[y0 + x0] * (gy * gx * tab)[..., None]
           + flat[y0 + x1] * (gy * fx * tab)[..., None]
           + flat[y1 + x0] * (fy * gx * tab)[..., None]
           + flat[y1 + x1] * (fy * fx * tab)[..., None])
    out = np.clip((acc + (1 << (REMAP_COEF_BITS - 1))) >> REMAP_COEF_BITS,
                  0, 255).astype(np.uint8)
    return out[..., 0] if squeeze else out


def undistort_image(K, new_K, dist, img):
    """cv2.undistort(img, K, dist, None, new_K) for a uint8 [H, W(, C)]
    image."""
    img = np.asarray(img)
    h, w = img.shape[:2]
    return remap_bilinear_u8(img, undistort_map(K, new_K, dist, w, h))


def _area_weights(ssize: int, dsize: int) -> np.ndarray:
    """[dsize, ssize] float32 weights of INTER_AREA along one axis (OpenCV's
    computeResizeAreaTab, or whole cells for an integer factor)."""
    scale = ssize / dsize
    wts = np.zeros((dsize, ssize), np.float64)
    k = int(round(scale))
    if abs(scale - k) < np.finfo(np.float64).eps:
        for d in range(dsize):
            wts[d, d * k:(d + 1) * k] = 1.0 / k
        return wts
    for d in range(dsize):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, ssize - f1)
        s1, s2 = math.ceil(f1), math.floor(f2)
        s2 = min(s2, ssize - 1)
        s1 = min(s1, s2)
        if s1 - f1 > 1e-3:
            wts[d, s1 - 1] = np.float32((s1 - f1) / cell)
        wts[d, s1:s2] = np.float32(1.0 / cell)
        if f2 - s2 > 1e-3:
            wts[d, s2] = np.float32(min(min(f2 - s2, 1.0), cell) / cell)
    return wts


def resize_area(img, size) -> np.ndarray:
    """cv2.resize(img, size=(w, h), interpolation=INTER_AREA) on a float
    [H, W(, C)] image, downscaling (w <= W, h <= H); float32 out."""
    img = np.asarray(img, np.float32)
    w, h = int(size[0]), int(size[1])
    sh, sw = img.shape[:2]
    if w > sw or h > sh:
        raise ValueError(f"resize_area downscales: {sw}x{sh} -> {w}x{h}")
    if (w, h) == (sw, sh):
        return img.copy()
    wy = _area_weights(sh, h)
    wx = _area_weights(sw, w)
    flat = img.reshape(sh, sw, -1).astype(np.float64)
    out = np.einsum("ys,sxc->yxc", wy, np.einsum("xt,stc->sxc", wx, flat))
    return out.reshape((h, w) + img.shape[2:]).astype(np.float32)
