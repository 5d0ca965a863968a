"""The benchmark's inputs: a 20-bone hand in poses, a ring of cameras,
the gt images, the initial gaussian cloud and the random-feature VGG16.

All of it is the benchmark's own arithmetic: the program under test only
receives the results. The rig and the poses are the same for every seed
(one fixed capture, so that every seed asks for the same work); the
seed draws the images' colours, the initial cloud, the VGG16 weights
and, in the program, the order of the views. Small numbers come from a
numpy RandomState; large tensors from a torch.Generator on the run's
device, in a few large calls.
"""
from __future__ import annotations

import math

import numpy as np
import torch

# RGB2SH's constant (the degree-0 real spherical harmonic)
SH_C0 = 0.28209479177387814
# VGG16's 13 3x3 convolutions in 5 stages (out channels), a 2x2 max pool
# before every stage but the first
VGG16_STAGES = ((64, 64), (128, 128), (256, 256, 256), (512, 512, 512),
                (512, 512, 512))


def seed32(seed: int, stream: int) -> int:
    """A 32-bit seed for numpy's RandomState from the run's seed (any
    size) and a stream number, so that each input has its own draws."""
    ss = np.random.SeedSequence([seed & (2**64 - 1), stream])
    return int(ss.generate_state(1)[0])


def generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed32(seed, stream))


def hand20_skeleton() -> dict:
    """A 20-bone hand from fixed numbers (metres, the wrist at the origin,
    fingers along +y): bones 0-3 the thumb from the wrist, then four
    fingers of metacarpal, proximal, middle and distal bones, each finger
    a chain from the wrist (a copy of chip_smoke.hand20_skeleton)."""
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
    heads = np.asarray(heads, np.float64)
    tails = np.asarray(tails, np.float64)
    rest = np.tile(np.eye(4), (20, 1, 1))
    rest[:, :3, 3] = heads
    return dict(names=names, parents=np.asarray(parents), heads=heads,
                tails=tails, rest=rest)


def _rot_x(a: float) -> np.ndarray:
    c, s = math.cos(a), math.sin(a)
    m = np.eye(4)
    m[1, 1], m[1, 2], m[2, 1], m[2, 2] = c, -s, s, c
    return m


def hand_poses(skel: dict, num_frames: int) -> dict:
    """Flexion poses: every bone bends about its x axis by an angle drawn
    per frame in [-0.6, 0.1] rad (the thumb's root and the metacarpals
    in [-0.2, 0.05]), by forward kinematics down each chain; the same
    draws for every run. Returns
    float32 arrays: pose [F, 20, 4, 4] (armature->world bone matrices),
    heads and tails [F, 20, 3]."""
    rng = np.random.RandomState(1)
    parents, rest = skel["parents"], skel["rest"]
    j = len(parents)
    roots = parents < 0
    lo = np.where(roots, -0.2, -0.6)
    hi = np.where(roots, 0.05, 0.1)
    ang = rng.uniform(lo, hi, (num_frames, j))
    pose = np.zeros((num_frames, j, 4, 4))
    for f in range(num_frames):
        for i in range(j):  # parents come before their children
            local = rest[i] @ _rot_x(ang[f, i])
            p = parents[i]
            pose[f, i] = local if p < 0 else (
                pose[f, p] @ np.linalg.inv(rest[p]) @ local)
    inv_rest = np.linalg.inv(rest)
    tail_h = np.concatenate([skel["tails"], np.ones((j, 1))], 1)
    tails = np.einsum("fjab,jbc,jc->fja", pose, inv_rest, tail_h)[..., :3]
    return dict(pose=pose.astype(np.float32),
                heads=pose[..., :3, 3].astype(np.float32),
                tails=tails.astype(np.float32))


def ring_cameras(num: int, width: int, height: int, center,
                 dist: float = 0.6, fov_deg: float = 40.0):
    """A BRICS-like rig: `num` cameras on a hemisphere of radius `dist`
    about `center`, looking at it, elevations drawn in 15-75 degrees (the
    same draws for every run).
    Returns K [V, 3, 3] and extr [V, 3, 4] (world->camera, OpenCV) as
    float64 numpy."""
    rng = np.random.RandomState(2)
    f = width / (2 * math.tan(math.radians(fov_deg) / 2))
    K = np.array([[f, 0, (width - 1) / 2], [0, f, (height - 1) / 2],
                  [0, 0, 1.0]])
    center = np.asarray(center, np.float64)
    Ks, extrs = [], []
    for i in range(num):
        theta = 2 * math.pi * i / num + rng.uniform(0, 0.1)
        phi = math.radians(rng.uniform(15, 75))
        pos = center + dist * np.array([math.cos(theta) * math.cos(phi),
                                        math.sin(phi),
                                        math.sin(theta) * math.cos(phi)])
        fwd = (center - pos) / np.linalg.norm(center - pos)
        right = np.cross([0.0, -1.0, 0.0], fwd)
        right /= np.linalg.norm(right)
        R = np.stack([right, np.cross(fwd, right), fwd])
        Ks.append(K.copy())
        extrs.append(np.concatenate([R, (-R @ pos)[:, None]], 1))
    return np.stack(Ks), np.stack(extrs)


def scene_extent(extr: np.ndarray) -> float:
    """1.1 x the largest distance of a camera centre from their mean (the
    reference's scene extent)."""
    centres = -np.einsum("vba,vb->va", extr[:, :3, :3], extr[:, :3, 3])
    return float(np.linalg.norm(centres - centres.mean(0), axis=1).max()
                 * 1.1)


def gt_images(heads, tails, K, extr, width: int, height: int, seed: int,
              device, radius: float = 0.009, views_per_call: int = 4):
    """The gt photographs as uint8 RGBA [F, V, H, W, 4] on the host: each
    posed bone a soft capsule of `radius` metres, projected into every
    camera and shaded by its own colour with a smooth gradient along the
    bone; alpha is the capsules' summed coverage (1 - prod(1 - a)). The
    image is the premultiplied colour over black, the mask its alpha."""
    f_n, v_n = heads.shape[0], K.shape[0]
    gen = generator(seed, 3, device)
    j = heads.shape[1]
    col_a = torch.rand(j, 3, generator=gen, device=device) * 0.8 + 0.2
    col_b = torch.rand(j, 3, generator=gen, device=device) * 0.8 + 0.2
    P = torch.as_tensor(np.einsum("vab,vbc->vac", K, extr), dtype=torch.float32,
                        device=device)  # [V, 3, 4]
    ys, xs = torch.meshgrid(
        torch.arange(height, device=device, dtype=torch.float32),
        torch.arange(width, device=device, dtype=torch.float32),
        indexing="ij")
    pix = torch.stack([xs, ys], -1).reshape(1, -1, 1, 2)  # [1, HW, 1, 2]
    out = torch.empty((f_n, v_n, height, width, 4), dtype=torch.uint8,
                      device=device)
    for f in range(f_n):
        ends = torch.as_tensor(np.stack([heads[f], tails[f]]),
                               dtype=torch.float32, device=device)  # [2, J, 3]
        homo = torch.cat([ends, torch.ones_like(ends[..., :1])], -1)
        for v0 in range(0, v_n, views_per_call):
            p = P[v0:v0 + views_per_call]  # [v, 3, 4]
            uvw = torch.einsum("vab,ejb->veja", p, homo)  # [v, 2, J, 3]
            z = uvw[..., 2].clamp(min=1e-3)
            uv = uvw[..., :2] / z[..., None]
            a, b = uv[:, 0, None], uv[:, 1, None]  # [v, 1, J, 2]
            ab = b - a
            t = (((pix - a) * ab).sum(-1)
                 / (ab * ab).sum(-1).clamp(min=1e-6)).clamp(0, 1)
            d = torch.linalg.norm(pix - (a + t[..., None] * ab), dim=-1)
            r_px = radius * K[v0, 0, 0] / z.mean(1)[:, None, :]  # [v, 1, J]
            cov = torch.exp(-0.5 * (d / r_px) ** 4)  # [v, HW, J]
            colour = (col_a * (1 - t[..., None]) + col_b * t[..., None])
            alpha = 1.0 - torch.prod(1.0 - 0.98 * cov, dim=-1)  # [v, HW]
            rgb = (cov[..., None] * colour).sum(-2) / cov.sum(-1, True).clamp(
                min=1e-6) * alpha[..., None]
            img = torch.cat([rgb, alpha[..., None]], -1).clamp(0, 1)
            out[f, v0:v0 + views_per_call] = (img * 255).round().to(
                torch.uint8).reshape(-1, height, width, 4)
    return out.cpu().numpy()


def init_cloud(skel: dict, per_bone: int, capacity: int, seed: int,
               device) -> dict:
    """The initial cloud in the port's parameter layout, padded to
    `capacity`: per bone `per_bone` points about its middle and
    per_bone // 2 about its head (anisotropic normal draws, as the
    reference's bone init), random colours as degree-0 SH, log-scales
    drawn in log(1.5 mm)..log(4 mm), random unit rotations, opacity 0.1;
    padded slots at log-scale -10, rotation (1, 0, 0, 0), opacity logit
    -9.21. Returns float32 tensors xyz [N, 3], features_dc [N, 1, 3],
    features_rest [N, 15, 3], scaling [N, 3], rotation [N, 4], opacity
    [N, 1] and the bool active [N]."""
    gen = generator(seed, 4, device)
    heads = torch.as_tensor(skel["heads"], dtype=torch.float32, device=device)
    tails = torch.as_tensor(skel["tails"], dtype=torch.float32, device=device)
    j = heads.shape[0]
    length = torch.linalg.norm(tails - heads, dim=1, keepdim=True)
    axis = (tails - heads) / length
    # an orthonormal frame per bone: the bone axis and two normals
    ref = torch.tensor([0.0, 0.0, 1.0], device=device).expand(j, 3)
    n1 = torch.linalg.cross(axis, ref)
    n1 = n1 / torch.linalg.norm(n1, dim=1, keepdim=True)
    n2 = torch.linalg.cross(axis, n1)

    def draw(centre, s_axis, s_norm, count):
        z = torch.randn(count, j, 3, generator=gen, device=device)
        return (centre[None] + z[..., :1] * s_axis[None] * axis[None]
                + z[..., 1:2] * s_norm[None] * n1[None]
                + z[..., 2:] * s_norm[None] * n2[None]).reshape(-1, 3)

    pts = torch.cat([draw((heads + tails) / 2, length / 5, length / 4,
                          per_bone),
                     draw(heads, length / 6, length / 6, per_bone // 2)])
    n0 = pts.shape[0]
    if n0 > capacity:
        raise ValueError(f"{n0} init points exceed capacity {capacity}")
    cols = torch.rand(n0, 3, generator=gen, device=device)
    log_s = torch.empty(n0, 3, device=device).uniform_(
        math.log(1.5e-3), math.log(4e-3), generator=gen)
    quat = torch.randn(n0, 4, generator=gen, device=device)
    quat = quat / torch.linalg.norm(quat, dim=1, keepdim=True)

    def pad(x, fill):
        tail = torch.full((capacity - n0,) + tuple(x.shape[1:]), fill,
                          dtype=x.dtype, device=device)
        return torch.cat([x, tail]).contiguous()

    rot_pad = pad(quat, 0.0)
    rot_pad[n0:, 0] = 1.0
    return dict(
        xyz=pad(pts, 0.0),
        features_dc=pad(((cols - 0.5) / SH_C0)[:, None, :], 0.0),
        features_rest=torch.zeros(capacity, 15, 3, device=device),
        scaling=pad(log_s, -10.0),
        rotation=rot_pad,
        opacity=pad(torch.full((n0, 1), math.log(0.1 / 0.9), device=device),
                    -9.21),
        active=torch.arange(capacity, device=device) < n0)


def vgg16_weights(seed: int, device) -> dict:
    """A random-feature VGG16 for LPIPS in the layout of the port's npz
    (conv{s}_{l}_w [3, 3, Ci, Co], conv{s}_{l}_b [Co], lin{s}_w [C]):
    He-normal convolutions, zero biases, heads uniform in [0, 1/C)."""
    gen = generator(seed, 5, device)
    params, c_in = {}, 3
    for si, stage in enumerate(VGG16_STAGES):
        for li, c_out in enumerate(stage):
            w = torch.randn(3, 3, c_in, c_out, generator=gen, device=device)
            params[f"conv{si}_{li}_w"] = w * math.sqrt(2.0 / (9 * c_in))
            params[f"conv{si}_{li}_b"] = torch.zeros(c_out, device=device)
            c_in = c_out
        params[f"lin{si}_w"] = torch.rand(c_in, generator=gen,
                                          device=device) / c_in
    return params


def object_cloud(centre, radius: float, shell: float, capacity: int,
                 seed: int, device) -> dict:
    """A static object as `capacity` gaussians in a sphere shell of
    `radius` and thickness `shell` about `centre` (uniform directions),
    in init_cloud's layout: random colours, log-scales in
    log(1 mm)..log(3 mm), random rotations, opacity 0.5, all slots
    live."""
    gen = generator(seed, 6, device)
    u = torch.randn(capacity, 3, generator=gen, device=device)
    u = u / torch.linalg.norm(u, dim=1, keepdim=True)
    r = radius + shell * (torch.rand(capacity, 1, generator=gen,
                                     device=device) - 0.5)
    xyz = torch.as_tensor(centre, dtype=torch.float32, device=device) + u * r
    cols = torch.rand(capacity, 3, generator=gen, device=device)
    log_s = torch.empty(capacity, 3, device=device).uniform_(
        math.log(1e-3), math.log(3e-3), generator=gen)
    quat = torch.randn(capacity, 4, generator=gen, device=device)
    return dict(
        xyz=xyz.contiguous(),
        features_dc=((cols - 0.5) / SH_C0)[:, None, :].contiguous(),
        features_rest=torch.zeros(capacity, 15, 3, device=device),
        scaling=log_s,
        rotation=quat / torch.linalg.norm(quat, dim=1, keepdim=True),
        opacity=torch.zeros(capacity, 1, device=device),
        active=torch.ones(capacity, dtype=torch.bool, device=device))
