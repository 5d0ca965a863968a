"""The projection kernels' math (manus_tpu_torch/csrc/project.cu), on the CPU.

The kernels cannot run here, so this file writes their forward and their
closed-form backward once more in plain torch, term by term as the .cu
computes them (`kernel_forward`, `kernel_vjp`), and holds them to the
plain chain the kernels replace: `calculate_colors_from_sh` +
`project_gaussians` and autograd's gradients of the pair. The scene holds
every edge the kernels mask: slots behind the near plane, slots past the
1.3 tanfov clamp that still touch the screen, a slot whose 2D covariance
has det == 0, inactive slots, colours with rgb + 0.5 < 0 and, with tf,
singular blends. tests/test_torch_project_cuda.py holds the kernels
themselves to the plain chain on a card.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from manus_tpu_torch.ops.rasterizer.api import calculate_colors_from_sh
from manus_tpu_torch.ops.rasterizer.projection import (
    COV2D_DILATION,
    FRUSTUM_NEAR_Z,
    TILE,
    project_gaussians,
)
from manus_tpu_torch.utils import sh as sh_mod
from manus_tpu_torch.utils.camera import make_camera

SIZE = 64  # image side; the camera's focal length is SIZE, exactly


def half_tan_fov(device) -> torch.Tensor:
    """A float32 field of view whose tan(fov * 0.5) is 0.5 exactly on
    `device`, so that the focal length comes out as SIZE exactly and a
    slot can be given a 2D covariance with det == 0 in any precision."""
    fov = torch.tensor(2.0 * math.atan(0.5), dtype=torch.float32,
                       device=device)
    step = torch.tensor(math.inf, dtype=torch.float32, device=device)
    for _ in range(2):
        for _ in range(64):
            if torch.tan(fov * 0.5).item() == 0.5:
                return fov
            fov = torch.nextafter(fov, step)
        step = -step
        fov = torch.tensor(2.0 * math.atan(0.5), dtype=torch.float32,
                           device=device)
    raise AssertionError("no float32 fov with tan(fov / 2) == 0.5")


def edge_camera(device):
    """A SIZE x SIZE camera at the origin looking down +z (view space is
    world space), its tan(fov / 2) exactly 0.5."""
    fov = half_tan_fov(device)
    cam = make_camera([[SIZE, 0, (SIZE - 1) / 2], [0, SIZE, (SIZE - 1) / 2],
                       [0, 0, 1]], np.eye(4)[:3], SIZE, SIZE, device=device)
    return dataclasses.replace(cam, fovx=fov, fovy=fov.clone())


def edge_scene(n, seed, dtype, device, tf_mode="none", k=16):
    """n random gaussians in front of the camera and rows for each edge.
    Returns a dict of the inputs and `edges`, the rows of each edge."""
    rng = np.random.RandomState(seed)
    z = rng.uniform(1.0, 4.0, n)
    xy = rng.uniform(-0.6, 0.6, (n, 2)) * z[:, None]
    means = np.concatenate([xy, z[:, None]], 1)
    a = rng.normal(size=(n, 3, 3)) * rng.uniform(0.005, 0.08, (n, 1, 1))
    full = a @ a.transpose(0, 2, 1)
    cov = full[:, [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]]
    edges = {}
    # behind the near plane (z <= 0.2), some behind the camera
    rows = np.arange(0, n, 11)
    means[rows, 2] = rng.uniform(-1.0, FRUSTUM_NEAR_Z, len(rows))
    edges["near"] = rows
    # past the 1.3 tanfov clamp (tan 0.5 -> |x / z| > 0.65), large enough
    # to reach into the image
    rows = np.setdiff1d(np.arange(3, n, 13), edges["near"])
    sign = np.where(rng.uniform(size=len(rows)) < 0.5, -1.0, 1.0)
    means[rows, 0] = sign * rng.uniform(0.7, 0.9, len(rows)) * means[rows, 2]
    cov[rows] = np.array([1.0, 0.0, 0.0, 1.0, 0.0, 1.0]) * 0.2
    edges["clamp"] = rows
    # det == 0: on the axis at z = 2, where j = diag(32, 32) exactly, and a
    # covariance that makes cxx = cyy = 0.15 and cxy = -0.15
    s = -0.15 / 1024
    means[5] = [0.0, 0.0, 2.0]
    cov[5] = [s, s, 0.0, s, 0.0, 0.0]
    edges["det0"] = np.array([5])
    active = rng.uniform(size=n) > 0.1
    active[[1, 2]] = False
    active[5] = True
    edges["inactive"] = np.nonzero(~active)[0]
    feat = rng.normal(size=(n, k, 3)) * 0.4
    rows = np.arange(7, n, 9)
    feat[rows, 0, :] = -4.0  # rgb + 0.5 < 0 in every channel
    feat[rows[::2], 0, 1] = 1.0  # and in some only
    edges["dark"] = rows
    out = dict(means=means, cov=cov, active=active, feat=feat)
    if tf_mode != "none":
        rot = np.linalg.qr(rng.normal(size=(n, 3, 3)))[0]
        tf = np.zeros((n, 4, 4))
        tf[:, :3, :3] = rot * rng.uniform(0.8, 1.2, (n, 1, 1))
        tf[:, :3, 3] = rng.normal(size=(n, 3)) * 0.1
        tf[:, 3, 3] = 1.0
        rows = np.arange(4, n, 17)
        tf[rows, :3, :3] = 0.0  # singular blends
        tf[rows[::2], :3, :3] = np.outer([1.0, 2.0, 3.0], [0.5, 1.0, 0.2])
        edges["singular"] = rows
        out["tf"] = tf
        out["cano"] = means + rng.normal(size=(n, 3)) * 0.05
    t = {key: torch.tensor(v, dtype=torch.bool if key == "active" else dtype,
                           device=device) for key, v in out.items()}
    t["edges"] = edges
    return t


# ---------------------------------------------------------------------------
# The kernels' math in torch, term by term as csrc/project.cu has it.


def _camera(cam, dtype):
    """load_camera: the focal lengths (reciprocal(2 tanfov) * size) and
    the clamp limits (1.3 tanfov)."""
    out = {}
    for axis, fov, size in (("x", cam.fovx, cam.width),
                            ("y", cam.fovy, cam.height)):
        tanfov = torch.tan(fov * 0.5)
        out["f" + axis] = torch.reciprocal(tanfov * 2.0) * size
        out["lim_" + axis] = tanfov * 1.3
    out["wv"] = cam.world_view_transform
    out["fp"] = cam.full_proj_transform
    out["r"] = cam.extr[:3, :3]
    out["center"] = cam.camera_center
    return out


def _row_xform(m, j, x, y, z):
    return x * m[0, j] + y * m[1, j] + z * m[2, j] + m[3, j]


def kernel_project(c, width, height, means, cov, active):
    """project(): every intermediate the backward reads, [N] each."""
    x, y, z = means.unbind(-1)
    p = {}
    p["pv"] = [_row_xform(c["wv"], j, x, y, z) for j in range(3)]
    p["ph"] = [_row_xform(c["fp"], j, x, y, z) for j in range(4)]
    p["pw"] = torch.reciprocal(p["ph"][3] + 1e-7)
    ppx, ppy = p["ph"][0] * p["pw"], p["ph"][1] * p["pw"]
    p["in_frustum"] = p["pv"][2] > FRUSTUM_NEAR_Z
    p["ds"] = torch.where(p["in_frustum"], p["pv"][2],
                          torch.ones_like(p["pv"][2]))
    p["qx"] = p["pv"][0] / p["ds"]
    p["qy"] = p["pv"][1] / p["ds"]
    p["txtz"] = torch.clamp(p["qx"], -c["lim_x"], c["lim_x"])
    p["tytz"] = torch.clamp(p["qy"], -c["lim_y"], c["lim_y"])
    p["tx"] = p["txtz"] * p["ds"]
    p["ty"] = p["tytz"] * p["ds"]
    p["inv_tz"] = torch.reciprocal(p["ds"])
    p["inv_tz2"] = p["inv_tz"] * p["inv_tz"]
    j00 = c["fx"] * p["inv_tz"]
    j02 = -c["fx"] * p["tx"] * p["inv_tz2"]
    j11 = c["fy"] * p["inv_tz"]
    j12 = -c["fy"] * p["ty"] * p["inv_tz2"]
    R = c["r"]
    p["a"] = [j00 * R[0, i] + j02 * R[2, i] for i in range(3)]
    p["b"] = [j11 * R[1, i] + j12 * R[2, i] for i in range(3)]
    sxx, sxy, sxz, syy, syz, szz = cov.unbind(-1)
    a, b = p["a"], p["b"]
    p["u"] = [a[0] * sxx + a[1] * sxy + a[2] * sxz,
              a[0] * sxy + a[1] * syy + a[2] * syz,
              a[0] * sxz + a[1] * syz + a[2] * szz]
    p["v"] = [b[0] * sxx + b[1] * sxy + b[2] * sxz,
              b[0] * sxy + b[1] * syy + b[2] * syz,
              b[0] * sxz + b[1] * syz + b[2] * szz]
    u, v = p["u"], p["v"]
    p["cxx"] = u[0] * a[0] + u[1] * a[1] + u[2] * a[2] + COV2D_DILATION
    p["cxy"] = u[0] * b[0] + u[1] * b[1] + u[2] * b[2]
    p["cyy"] = v[0] * b[0] + v[1] * b[1] + v[2] * b[2] + COV2D_DILATION
    p["det"] = p["cxx"] * p["cyy"] - p["cxy"] * p["cxy"]
    det_ok = p["det"] != 0.0
    p["inv_det"] = torch.reciprocal(torch.where(det_ok, p["det"],
                                                torch.ones_like(p["det"])))
    mid = (p["cxx"] + p["cyy"]) * 0.5
    lambda1 = mid + torch.sqrt(torch.clamp(mid * mid - p["det"], min=0.1))
    p["radius_f"] = torch.ceil(torch.sqrt(torch.clamp(lambda1, min=0.0))
                               * 3.0)
    p["m2x"] = ((ppx + 1.0) * width - 1.0) * 0.5
    p["m2y"] = ((ppy + 1.0) * height - 1.0) * 0.5
    gx, gy = (width + TILE - 1) // TILE, (height + TILE - 1) // TILE
    r = p["radius_f"]

    def tile(v, limit):
        return torch.clamp(v.to(torch.int32), 0, limit)

    p["rect"] = torch.stack([
        tile((p["m2x"] - r) / TILE, gx), tile((p["m2y"] - r) / TILE, gy),
        tile((p["m2x"] + r + TILE - 1) / TILE, gx),
        tile((p["m2y"] + r + TILE - 1) / TILE, gy)], -1)
    rect = p["rect"]
    p["visible"] = p["in_frustum"] & det_ok & active & (
        (rect[:, 2] - rect[:, 0]) * (rect[:, 3] - rect[:, 1]) > 0)
    return p


def kernel_view_dir(c, pos, tf):
    """view_dir(): the SH direction's unnormalised vector, and with tf the
    adjugate, 1 / det, the pulled-back centre and where |det| > 1e-12."""
    d = {}
    if tf is None:
        d["v"] = [pos[:, i] - c["center"][i] for i in range(3)]
        return d
    a, b, cc = tf[:, 0, 0], tf[:, 0, 1], tf[:, 0, 2]
    e0, e, f = tf[:, 1, 0], tf[:, 1, 1], tf[:, 1, 2]
    g, h, i = tf[:, 2, 0], tf[:, 2, 1], tf[:, 2, 2]
    rhs = [c["center"][r] - tf[:, r, 3] for r in range(3)]
    adj = [e * i - f * h, cc * h - b * i, b * f - cc * e,
           f * g - e0 * i, a * i - cc * g, cc * e0 - a * f,
           e0 * h - e * g, b * g - a * h, a * e - b * e0]
    det = a * adj[0] + b * adj[3] + cc * adj[6]
    d["ok"] = det.abs() > 1e-12
    d["inv_det"] = torch.reciprocal(torch.where(d["ok"], det,
                                                torch.ones_like(det)))
    d["adj"] = adj
    d["cam"] = [torch.where(
        d["ok"], (adj[3 * r] * rhs[0] + adj[3 * r + 1] * rhs[1]
                  + adj[3 * r + 2] * rhs[2]) * d["inv_det"],
        c["center"][r].to(det.dtype)) for r in range(3)]
    d["v"] = [pos[:, r] - d["cam"][r] for r in range(3)]
    return d


def sh_terms(deg, x, y, z):
    """sh_terms(): (basis, d/dx, d/dy, d/dz) of each term, in its order."""
    zero = torch.zeros_like(x)
    c0, c1, c2, c3, c4 = sh_mod.C0, sh_mod.C1, sh_mod.C2, sh_mod.C3, sh_mod.C4
    out = [(torch.full_like(x, c0), zero, zero, zero)]
    if deg < 1:
        return out
    out += [(-c1 * y, zero, zero - c1, zero), (c1 * z, zero, zero, zero + c1),
            (-c1 * x, zero - c1, zero, zero)]
    if deg < 2:
        return out
    xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
    k = c2
    out += [(k[0] * xy, k[0] * y, k[0] * x, zero),
            (k[1] * yz, zero, k[1] * z, k[1] * y),
            (k[2] * (2.0 * zz - xx - yy), -2 * k[2] * x, -2 * k[2] * y,
             4 * k[2] * z),
            (k[3] * xz, k[3] * z, zero, k[3] * x),
            (k[4] * (xx - yy), 2 * k[4] * x, -2 * k[4] * y, zero)]
    if deg < 3:
        return out
    k = c3
    out += [(k[0] * y * (3.0 * xx - yy), k[0] * 6 * xy,
             k[0] * (3 * xx - 3 * yy), zero),
            (k[1] * xy * z, k[1] * yz, k[1] * xz, k[1] * xy),
            (k[2] * y * (4.0 * zz - xx - yy), k[2] * -2 * xy,
             k[2] * (4 * zz - xx - 3 * yy), k[2] * 8 * yz),
            (k[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy), k[3] * -6 * xz,
             k[3] * -6 * yz, k[3] * (6 * zz - 3 * xx - 3 * yy)),
            (k[4] * x * (4.0 * zz - xx - yy), k[4] * (4 * zz - 3 * xx - yy),
             k[4] * -2 * xy, k[4] * 8 * xz),
            (k[5] * z * (xx - yy), k[5] * 2 * xz, k[5] * -2 * yz,
             k[5] * (xx - yy)),
            (k[6] * x * (xx - 3.0 * yy), k[6] * (3 * xx - 3 * yy),
             k[6] * -6 * xy, zero)]
    if deg < 4:
        return out
    k = c4
    z7m1, z7m3 = 7.0 * zz - 1.0, 7.0 * zz - 3.0
    out += [(k[0] * xy * (xx - yy), k[0] * (3 * xx * y - yy * y),
             k[0] * (xx * x - 3 * x * yy), zero),
            (k[1] * yz * (3.0 * xx - yy), k[1] * 6 * xy * z,
             k[1] * (3 * xx - 3 * yy) * z, k[1] * (3 * xx * y - yy * y)),
            (k[2] * xy * z7m1, k[2] * y * z7m1, k[2] * x * z7m1,
             k[2] * 14 * xy * z),
            (k[3] * yz * z7m3, zero, k[3] * z * z7m3,
             k[3] * y * (21 * zz - 3)),
            (k[4] * (zz * (35.0 * zz - 30.0) + 3.0), zero, zero,
             k[4] * (140 * zz * z - 60 * z)),
            (k[5] * xz * z7m3, k[5] * z * z7m3, zero,
             k[5] * x * (21 * zz - 3)),
            (k[6] * (xx - yy) * z7m1, k[6] * 2 * x * z7m1,
             k[6] * -2 * y * z7m1, k[6] * 14 * z * (xx - yy)),
            (k[7] * xz * (xx - 3.0 * yy), k[7] * z * (3 * xx - 3 * yy),
             k[7] * -6 * xy * z, k[7] * x * (xx - 3 * yy)),
            (k[8] * (xx * (xx - 3.0 * yy) - yy * (3.0 * xx - yy)),
             k[8] * (4 * xx * x - 12 * x * yy),
             k[8] * (4 * yy * y - 12 * xx * y), zero)]
    return out


def kernel_colors(c, pos, feat, tf, deg):
    """The forward's colour part: (colour before the clamp [N, 3], the
    unit direction, the view_dir() record, its norm). The kernel fuses
    the sum over the terms into FMAs; here each product is rounded."""
    d = kernel_view_dir(c, pos, tf)
    v = d["v"]
    nrm = torch.sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])
    x, y, z = v[0] / nrm, v[1] / nrm, v[2] / nrm
    rgb = torch.zeros_like(feat[:, 0, :])
    for k, (bk, _, _, _) in enumerate(sh_terms(deg, x, y, z)):
        rgb = rgb + feat[:, k, :] * bk[:, None]
    return rgb, (x, y, z), d, nrm


def kernel_forward(cam, means, cov, active, cano=None, feat=None, tf=None,
                   deg=-1):
    """project_fwd_kernel: (means2d, conic, depth, radius, rect, visible,
    colors or None)."""
    c = _camera(cam, means.dtype)
    p = kernel_project(c, cam.width, cam.height, means, cov, active)
    vis = p["visible"]
    zero = torch.zeros_like(p["m2x"])
    means2d = torch.stack([torch.where(vis, p["m2x"], zero),
                           torch.where(vis, p["m2y"], zero)], -1)
    conic = torch.stack([
        torch.where(vis, p["cyy"] * p["inv_det"], zero + 1.0),
        torch.where(vis, -p["cxy"] * p["inv_det"], zero),
        torch.where(vis, p["cxx"] * p["inv_det"], zero + 1.0)], -1)
    radius = torch.where(vis, p["radius_f"], zero).to(torch.int32)
    colors = None
    if deg >= 0:
        pos = means if tf is None else cano
        rgb, _, _, _ = kernel_colors(c, pos, feat, tf, deg)
        colors = torch.clamp(rgb + 0.5, min=0.0)
    return means2d, conic, p["pv"][2], radius, p["rect"], vis, colors


def kernel_vjp(cam, means, cov, active, cano, feat, tf, deg, g_means2d,
               g_conic, g_colors):
    """project_bwd_kernel: the gradients of (means, cov, cano, feat, tf)
    from those of means2d, conic and colors, recomputing the forward."""
    c = _camera(cam, means.dtype)
    w, h = cam.width, cam.height
    p = kernel_project(c, w, h, means, cov, active)
    vis = p["visible"]
    dm = [torch.zeros_like(means[:, 0]) for _ in range(3)]
    ds6 = [torch.zeros_like(means[:, 0]) for _ in range(6)]
    gmx, gmy = g_means2d.unbind(-1)
    gc0, gc1, gc2 = g_conic.unbind(-1)
    # means2d = ((p_proj + 1) * size - 1) * 0.5, p_proj = ph * p_w
    dppx, dppy = gmx * 0.5 * w, gmy * 0.5 * h
    dph0, dph1 = dppx * p["pw"], dppy * p["pw"]
    dpw = dppx * p["ph"][0] + dppy * p["ph"][1]
    dph3 = -dpw * p["pw"] * p["pw"]
    # conic = (cyy, -cxy, cxx) / det
    dcxx, dcxy, dcyy = gc2 * p["inv_det"], -gc1 * p["inv_det"], \
        gc0 * p["inv_det"]
    dinv = gc0 * p["cyy"] - gc1 * p["cxy"] + gc2 * p["cxx"]
    ddet = -dinv * p["inv_det"] * p["inv_det"]
    dcxx = dcxx + ddet * p["cyy"]
    dcyy = dcyy + ddet * p["cxx"]
    dcxy = dcxy - 2.0 * ddet * p["cxy"]
    a, b, u, v = p["a"], p["b"], p["u"], p["v"]
    du = [dcxx * a[j] + dcxy * b[j] for j in range(3)]
    dv = [dcyy * b[j] for j in range(3)]
    da = [dcxx * u[j] for j in range(3)]
    db = [dcxy * u[j] + dcyy * v[j] for j in range(3)]
    sxx, sxy, sxz, syy, syz, szz = cov.unbind(-1)
    da[0] = da[0] + du[0] * sxx + du[1] * sxy + du[2] * sxz
    da[1] = da[1] + du[0] * sxy + du[1] * syy + du[2] * syz
    da[2] = da[2] + du[0] * sxz + du[1] * syz + du[2] * szz
    db[0] = db[0] + dv[0] * sxx + dv[1] * sxy + dv[2] * sxz
    db[1] = db[1] + dv[0] * sxy + dv[1] * syy + dv[2] * syz
    db[2] = db[2] + dv[0] * sxz + dv[1] * syz + dv[2] * szz
    ds6 = [du[0] * a[0] + dv[0] * b[0],
           du[0] * a[1] + du[1] * a[0] + dv[0] * b[1] + dv[1] * b[0],
           du[0] * a[2] + du[2] * a[0] + dv[0] * b[2] + dv[2] * b[0],
           du[1] * a[1] + dv[1] * b[1],
           du[1] * a[2] + du[2] * a[1] + dv[1] * b[2] + dv[2] * b[1],
           du[2] * a[2] + dv[2] * b[2]]
    R = c["r"]
    dj00 = da[0] * R[0, 0] + da[1] * R[0, 1] + da[2] * R[0, 2]
    dj02 = da[0] * R[2, 0] + da[1] * R[2, 1] + da[2] * R[2, 2]
    dj11 = db[0] * R[1, 0] + db[1] * R[1, 1] + db[2] * R[1, 2]
    dj12 = db[0] * R[2, 0] + db[1] * R[2, 1] + db[2] * R[2, 2]
    fx, fy = c["fx"], c["fy"]
    dinv_tz = dj00 * fx + dj11 * fy
    dtx = dj02 * -fx * p["inv_tz2"]
    dty = dj12 * -fy * p["inv_tz2"]
    dinv_tz2 = dj02 * (-fx * p["tx"]) + dj12 * (-fy * p["ty"])
    dinv_tz = dinv_tz + 2.0 * dinv_tz2 * p["inv_tz"]
    dds = -dinv_tz * p["inv_tz"] * p["inv_tz"]
    dds = dds + dtx * p["txtz"] + dty * p["tytz"]
    zero = torch.zeros_like(dds)
    dqx = torch.where((p["qx"] >= -c["lim_x"]) & (p["qx"] <= c["lim_x"]),
                      dtx * p["ds"], zero)
    dqy = torch.where((p["qy"] >= -c["lim_y"]) & (p["qy"] <= c["lim_y"]),
                      dty * p["ds"], zero)
    dpv0, dpv1 = dqx / p["ds"], dqy / p["ds"]
    dds = dds - (dqx * p["pv"][0] + dqy * p["pv"][1]) / (p["ds"] * p["ds"])
    dpv2 = torch.where(p["in_frustum"], dds, zero)
    wv, fp = c["wv"], c["fp"]
    for r in range(3):
        dm[r] = torch.where(vis, dpv0 * wv[r, 0] + dpv1 * wv[r, 1]
                            + dpv2 * wv[r, 2] + dph0 * fp[r, 0]
                            + dph1 * fp[r, 1] + dph3 * fp[r, 3], zero)
    ds6 = [torch.where(vis, s, zero) for s in ds6]

    d_cano = d_feat = d_tf = None
    if deg >= 0:
        pos = means if tf is None else cano
        rgb, (x, y, z), d, nrm = kernel_colors(c, pos, feat, tf, deg)
        g = torch.where(rgb + 0.5 >= 0.0, g_colors, torch.zeros_like(rgb))
        d_feat = torch.zeros_like(feat)
        dd = [zero, zero, zero]
        for k, (bk, gx, gy, gz) in enumerate(sh_terms(deg, x, y, z)):
            dbk = (g * feat[:, k, :]).sum(-1)
            dd = [dd[0] + dbk * gx, dd[1] + dbk * gy, dd[2] + dbk * gz]
            d_feat[:, k, :] = g * bk[:, None]
        dvv = [zero, zero, zero]
        if deg >= 1:
            dot = dd[0] * d["v"][0] + dd[1] * d["v"][1] + dd[2] * d["v"][2]
            inv_n = 1.0 / nrm
            k3 = dot * inv_n * inv_n * inv_n
            dvv = [dd[r] * inv_n - d["v"][r] * k3 for r in range(3)]
        if tf is None:
            dm = [dm[r] + dvv[r] for r in range(3)]
        else:
            d_cano = torch.stack(dvv, -1)
            d_tf = torch.zeros_like(tf)
            adj = d["adj"]
            for col in range(3):
                drhs = -(adj[col] * dvv[0] + adj[3 + col] * dvv[1]
                         + adj[6 + col] * dvv[2]) * d["inv_det"]
                drhs = torch.where(d["ok"], drhs, zero)
                for k in range(3):
                    d_tf[:, col, k] = -drhs * d["cam"][k]
                d_tf[:, col, 3] = -drhs
    return torch.stack(dm, -1), torch.stack(ds6, -1), d_cano, d_feat, d_tf


# ---------------------------------------------------------------------------


def plain_outputs(cam, s, deg, tf_mode, precomp=False):
    """The plain chain's means2d, conic and colors, on leaves that require
    grad (tf only with tf_mode "grad")."""
    leaves = {k: s[k].clone().requires_grad_(True)
              for k in ("means", "cov", "feat", "cano") if k in s}
    tf = None
    if tf_mode != "none":
        tf = s["tf"].clone().requires_grad_(tf_mode == "grad")
        leaves["tf"] = tf
    colors = None
    if not precomp:
        colors = calculate_colors_from_sh(
            leaves["means"], leaves["feat"], leaves.get("cano"), cam, deg, tf)
    proj = project_gaussians(leaves["means"], leaves["cov"], cam,
                             active=s["active"])
    return leaves, proj, colors


def cotangents(n, seed, dtype):
    rng = np.random.RandomState(seed + 1000)
    return [torch.tensor(rng.normal(size=(n, w)), dtype=dtype)
            for w in (2, 3, 3)]


def assert_close(got, want, tol, what):
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    assert err <= tol * max(scale, 1e-30), \
        f"{what}: largest gap {err:.3e} over a scale {scale:.3e}"


@pytest.fixture(scope="module")
def cam():
    return edge_camera("cpu")


def test_edge_scene_hits_every_edge(cam):
    """The scene holds each edge the kernels mask, as the plain chain
    sees it."""
    s = edge_scene(300, 0, torch.float32, "cpu", tf_mode="grad")
    p = kernel_project(_camera(cam, torch.float32), SIZE, SIZE, s["means"],
                       s["cov"], s["active"])
    e = s["edges"]
    assert not p["in_frustum"][e["near"]].any()
    q = p["qx"][e["clamp"]].abs()
    clamped = q > _camera(cam, torch.float32)["lim_x"]
    assert clamped.all() and p["visible"][e["clamp"]].any()
    assert p["det"][5].item() == 0.0 and p["in_frustum"][5]
    assert not p["visible"][e["inactive"]].any()
    rgb, _, d, _ = kernel_colors(_camera(cam, torch.float32), s["cano"],
                                 s["feat"], s["tf"], 3)
    assert (rgb[e["dark"]] + 0.5 < 0).any() and (rgb + 0.5 >= 0).any()
    assert not d["ok"][e["singular"]].any() and d["ok"].sum() > 200
    assert p["visible"].sum() > 150


@pytest.mark.parametrize("tf_mode", ["none", "grad"])
@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
def test_kernel_forward_matches_plain_chain(cam, deg, tf_mode):
    """The kernels' forward, one rounded operation at a time, gives the
    plain chain's projected fields bit for bit in float32; the colours
    within float32 rounding (the kernel's sum over the terms is its own)."""
    s = edge_scene(300, deg, torch.float32, "cpu", tf_mode=tf_mode,
                   k=25 if deg == 4 else 16)
    tf = s.get("tf")
    got = kernel_forward(cam, s["means"], s["cov"], s["active"],
                         s.get("cano"), s["feat"], tf, deg)
    want = project_gaussians(s["means"], s["cov"], cam, active=s["active"])
    for g, w_, name in zip(got[:6], want, want._fields):
        assert torch.equal(g, w_), name
    colors = calculate_colors_from_sh(s["means"], s["feat"], s.get("cano"),
                                      cam, deg, tf)
    # a sum of up to 25 float32 products of O(1) terms, rounded in
    # another order: a few units of 2^-24 times the terms' size
    assert_close(got[6], colors, 1e-5, "colors")


@pytest.mark.parametrize("tf_mode", ["none", "fixed", "grad"])
@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
def test_kernel_vjp_matches_autograd(cam, deg, tf_mode):
    """The kernels' closed-form backward against autograd of the plain
    chain, in float64 so that a wrong term shows far above the rounding:
    each input gradient within 1e-10 of the largest entry of autograd's
    (float64 rounding over a few hundred operations is ~1e-13)."""
    dtype = torch.float64
    s = edge_scene(300, 10 + deg, dtype, "cpu", tf_mode=tf_mode,
                   k=25 if deg == 4 else 16)
    leaves, proj, colors = plain_outputs(cam, s, deg, tf_mode)
    gm, gc, gcol = cotangents(300, deg, dtype)
    loss = (proj.means2d * gm).sum() + (proj.conic * gc).sum() \
        + (colors * gcol).sum()
    names = [k for k in ("means", "cov", "cano", "feat", "tf")
             if k in leaves and leaves[k].requires_grad]
    want = dict(zip(names, torch.autograd.grad(
        loss, [leaves[k] for k in names], allow_unused=True)))
    got = dict(zip(("means", "cov", "cano", "feat", "tf"), kernel_vjp(
        cam, s["means"], s["cov"], s["active"], s.get("cano"), s["feat"],
        s.get("tf"), deg, gm, gc, gcol)))
    for name in names:
        w_ = want[name]
        if w_ is None:  # no path (degree 0: the direction is unused)
            w_ = torch.zeros_like(leaves[name])
        assert torch.isfinite(got[name]).all(), name
        assert_close(got[name], w_, 1e-10, name)
    # the masked slots get exactly nothing through the projection
    e = s["edges"]
    masked = ~proj.visible
    if tf_mode != "none":
        assert torch.count_nonzero(got["cov"][masked]) == 0
        assert torch.count_nonzero(got["means"][masked]) == 0
        assert torch.count_nonzero(got["tf"][e["singular"]]) == 0
    assert masked[e["near"]].all() and masked[5]


def test_kernel_vjp_without_colours_matches_autograd(cam):
    """colors_precomp: the kernels skip the colour part; means and cov
    get the projection's gradient alone."""
    dtype = torch.float64
    s = edge_scene(300, 30, dtype, "cpu")
    leaves, proj, _ = plain_outputs(cam, s, -1, "none", precomp=True)
    gm, gc, _ = cotangents(300, 30, dtype)
    loss = (proj.means2d * gm).sum() + (proj.conic * gc).sum()
    want = torch.autograd.grad(loss, [leaves["means"], leaves["cov"]])
    got = kernel_vjp(cam, s["means"], s["cov"], s["active"], None, None,
                     None, -1, gm, gc, None)
    for g, w_, name in zip(got[:2], want, ("means", "cov")):
        assert_close(g, w_, 1e-10, name)
    assert got[2] is None and got[3] is None and got[4] is None


@pytest.mark.parametrize("deg", [1, 3])
def test_kernel_vjp_matches_autograd_in_float32(cam, deg):
    """The same in float32, the kernels' precision: within 1e-4 of the
    largest entry (float32 rounding through the chain and the inverse's
    derivative; a wrong term reads 1e-2 or more)."""
    dtype = torch.float32
    s = edge_scene(300, 40 + deg, dtype, "cpu", tf_mode="grad")
    leaves, proj, colors = plain_outputs(cam, s, deg, "grad")
    gm, gc, gcol = cotangents(300, deg, dtype)
    loss = (proj.means2d * gm).sum() + (proj.conic * gc).sum() \
        + (colors * gcol).sum()
    names = ("means", "cov", "cano", "feat", "tf")
    want = torch.autograd.grad(loss, [leaves[k] for k in names])
    got = kernel_vjp(cam, s["means"], s["cov"], s["active"], s["cano"],
                     s["feat"], s["tf"], deg, gm, gc, gcol)
    for g, w_, name in zip(got, want, names):
        assert_close(g, w_, 1e-4, name)


def _mirror_launchers(monkeypatch):
    """Swap the kernels' launchers for this file's mirror of their math,
    so that project_gaussians_cuda's autograd Function runs on the CPU."""
    from types import SimpleNamespace

    from manus_tpu_torch.ops.rasterizer import projection as proj_mod

    def camera(cam, width, height):
        return SimpleNamespace(
            world_view_transform=cam[0], full_proj_transform=cam[1],
            extr=cam[2], camera_center=cam[3], fovx=cam[4], fovy=cam[5],
            width=width, height=height)

    def fwd(means, cov, cam, width, height, active=None, cano=None,
            feat=None, tf=None, sh_degree=-1):
        if active is None:
            active = torch.ones(means.shape[0], dtype=torch.bool)
        return kernel_forward(camera(cam, width, height), means, cov, active,
                              cano, feat, tf, sh_degree)

    def bwd(means, cov, cam, width, height, active, cano, feat, tf,
            sh_degree, g_means2d, g_conic, g_colors, need=(True,) * 5):
        n = means.shape[0]
        zeros = [torch.zeros(n, w, dtype=means.dtype) for w in (2, 3, 3)]
        g = [z if x is None else x
             for x, z in zip((g_means2d, g_conic, g_colors), zeros)]
        out = kernel_vjp(camera(cam, width, height), means, cov, active,
                         cano, feat, tf, sh_degree, *g)
        return tuple(o if want else None for o, want in zip(out, need))

    monkeypatch.setattr(proj_mod, "project_fwd_cuda", fwd)
    monkeypatch.setattr(proj_mod, "project_bwd_cuda", bwd)
    return proj_mod


@pytest.mark.parametrize("deg,tf_mode", [(3, "none"), (3, "fixed"),
                                         (2, "grad"), (-1, "none")])
def test_project_function_routes_gradients(cam, monkeypatch, deg, tf_mode):
    """project_gaussians_cuda's autograd Function, its launchers swapped
    for the mirror: its outputs are the plain chain's and each input
    receives its own gradient (the inputs' order, the `need` flags, the
    gradients that are None, the outputs without one)."""
    proj_mod = _mirror_launchers(monkeypatch)
    dtype = torch.float64
    s = edge_scene(200, 50 + deg, dtype, "cpu", tf_mode=tf_mode)
    precomp = deg < 0
    leaves, want, want_colors = plain_outputs(cam, s, max(deg, 0), tf_mode,
                                              precomp=precomp)
    got, colors = proj_mod.project_gaussians_cuda(
        leaves["means"], leaves["cov"], cam, active=s["active"],
        cano_means=leaves.get("cano"),
        features=None if precomp else leaves["feat"], sh_degree=deg,
        tf=leaves.get("tf"))
    for g, w_, name in zip(got, want, want._fields):
        assert torch.equal(g, w_), name
    assert not got.depth.requires_grad and not got.visible.requires_grad
    gm, gc, gcol = cotangents(200, deg, dtype)
    loss = (got.means2d * gm).sum() + (got.conic * gc).sum()
    ref = (want.means2d * gm).sum() + (want.conic * gc).sum()
    if precomp:
        assert colors is None
    else:
        assert_close(colors, want_colors, 1e-12, "colors")
        loss = loss + (colors * gcol).sum()
        ref = ref + (want_colors * gcol).sum()
    names = [k for k in ("means", "cov", "cano", "feat", "tf")
             if k in leaves and leaves[k].requires_grad
             and not (precomp and k == "feat")]
    g_got = torch.autograd.grad(loss, [leaves[k] for k in names],
                                allow_unused=True)
    g_want = torch.autograd.grad(ref, [leaves[k] for k in names],
                                 allow_unused=True)
    for name, g, w_ in zip(names, g_got, g_want):
        assert g is not None, name
        assert_close(g, torch.zeros_like(g) if w_ is None else w_, 1e-10,
                     name)
    with torch.no_grad():
        p, _ = proj_mod.project_gaussians_cuda(
            s["means"], s["cov"], cam, active=s["active"],
            cano_means=s.get("cano"),
            features=None if precomp else s["feat"], sh_degree=deg,
            tf=s.get("tf"))
    assert not p.means2d.requires_grad
