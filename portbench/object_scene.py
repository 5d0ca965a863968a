"""The object cell's inputs: a closed sphere shell with a fixed texture
of coarse and fine detail, its gt photographs by a plain ray-cast, and
an initial point cloud near its surface that carries the coarse colours
only.

The object, its texture and the rig are the same for every seed (one
fixed capture, as the hand cells have); the seed draws the initial
cloud's points, their noise and their colours' noise, and, in the
program, the order of the views. Like portbench/scene.py, all of it is
the benchmark's own arithmetic: the program under test only receives
the results.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from portbench import scene as sc

# the texture's own streams: one object for every seed
TEXTURE_SEED = 19
COARSE_WAVES, FINE_WAVES = 12, 24


def _waves(dirs, seed: int, count: int, freq: float):
    """sin of `count` fixed plane waves over unit directions [N, 3] of a
    spatial frequency `freq` (per axis, radians over the unit sphere):
    [N, count]."""
    rng = np.random.RandomState(seed)
    f = torch.as_tensor(rng.normal(size=(3, count)) * freq,
                        dtype=torch.float32, device=dirs.device)
    phase = torch.as_tensor(rng.uniform(0, 2 * math.pi, count),
                            dtype=torch.float32, device=dirs.device)
    return torch.sin(dirs @ f + phase), rng


def coarse_texture(dirs: torch.Tensor) -> torch.Tensor:
    """The texture's coarse part [N, 3] in [0.1, 0.9]: a fixed blend of
    COARSE_WAVES waves about 1 cm across at a 5 cm radius."""
    waves, rng = _waves(dirs, TEXTURE_SEED, COARSE_WAVES, 5.0)
    mix = torch.as_tensor(rng.uniform(0, 1, (COARSE_WAVES, 3)),
                          dtype=torch.float32, device=dirs.device)
    return 0.1 + 0.8 * ((0.5 + 0.5 * waves) @ mix) / mix.sum(0)


def texture(dirs: torch.Tensor, detail_freq: float,
            detail_amp: float) -> torch.Tensor:
    """The object's colour [N, 3] in [0, 1] at unit directions [N, 3] from
    its centre: the coarse part plus a fine part of FINE_WAVES waves of
    `detail_freq` (300: about 0.6 mm apart at a 5 cm radius, two pixels
    at 0.6 m) and amplitude up to `detail_amp`."""
    waves, rng = _waves(dirs, TEXTURE_SEED + 1, FINE_WAVES, detail_freq)
    mix = torch.as_tensor(rng.uniform(-1, 1, (FINE_WAVES, 3)),
                          dtype=torch.float32, device=dirs.device)
    fine = detail_amp * torch.tanh(2 * (waves @ mix) / math.sqrt(FINE_WAVES))
    return (coarse_texture(dirs) + fine).clamp(0, 1)


def gt_images(K, extr, centre, radius: float, width: int, height: int,
              device, detail_freq: float, detail_amp: float):
    """The gt photographs as uint8 RGBA [1, V, H, W, 4] on the host: a ray
    through each pixel centre (integer pixel coordinates, as the
    rasterizer's) meets the sphere of `radius` about `centre` or not; a
    hit takes the texture's colour at its direction, unshaded, and alpha
    1, a miss black and alpha 0."""
    v_n = K.shape[0]
    c = torch.as_tensor(np.asarray(centre, np.float64), device=device)
    ys, xs = torch.meshgrid(
        torch.arange(height, device=device, dtype=torch.float64),
        torch.arange(width, device=device, dtype=torch.float64),
        indexing="ij")
    pix = torch.stack([xs, ys, torch.ones_like(xs)], -1).reshape(-1, 3)
    out = np.empty((1, v_n, height, width, 4), np.uint8)
    for v in range(v_n):
        Ki = torch.as_tensor(np.linalg.inv(K[v]), device=device)
        R = torch.as_tensor(extr[v][:, :3], device=device)
        t = torch.as_tensor(extr[v][:, 3], device=device)
        origin = -R.T @ t
        d = pix @ Ki.T @ R  # R^T K^-1 [u, v, 1], a row a pixel
        d = d / torch.linalg.norm(d, dim=1, keepdim=True)
        o = origin - c
        b = d @ o
        disc = b * b - (o @ o - radius * radius)
        hit = disc >= 0
        dist = -b - torch.sqrt(disc.clamp(min=0))
        n = (origin + dist[:, None] * d - c) / radius
        rgb = torch.where(hit[:, None],
                          texture(n.float(), detail_freq, detail_amp), 0.0)
        img = torch.cat([rgb, hit[:, None].float()], 1)
        out[0, v] = (img * 255).round().to(torch.uint8).reshape(
            height, width, 4).cpu().numpy()
    return out


def init_points(n: int, centre, radius: float, noise_m: float,
                colour_noise: float, seed: int, device):
    """`n` initial points near the sphere: directions uniform on it, the
    radius perturbed by a normal draw of `noise_m`, each coloured by the
    texture's coarse part (a mesh's vertex colours lack the fine part)
    plus a normal draw of `colour_noise`, clipped to [0, 1]. Returns numpy
    float32 points [n, 3] and colours [n, 3]."""
    gen = sc.generator(seed, 7, device)
    u = torch.randn(n, 3, generator=gen, device=device)
    u = u / torch.linalg.norm(u, dim=1, keepdim=True)
    r = radius + noise_m * torch.randn(n, 1, generator=gen, device=device)
    pts = torch.as_tensor(np.asarray(centre, np.float32), device=device) \
        + u * r
    cols = coarse_texture(u) + colour_noise * torch.randn(
        n, 3, generator=gen, device=device)
    return pts.cpu().numpy(), cols.clamp(0, 1).cpu().numpy()


def build(cfg: dict, scene: dict, seed: int, device) -> dict:
    """The rig (K [V, 3, 3], extr [V, 3, 4] as float64 numpy, the scene
    extent), the gt images and the initial points and colours from the
    configuration as run and its `scene` numbers."""
    d = cfg["dataset"]
    centre = scene["object_centre"]
    K, extr = sc.ring_cameras(d["num_cameras"], d["width"], d["height"],
                              centre, dist=scene["cam_dist_m"],
                              fov_deg=scene["fov_deg"])
    images = gt_images(K, extr, centre, scene["object_radius_m"],
                       d["width"], d["height"], device,
                       scene["detail_freq"], scene["detail_amp"])
    pts, cols = init_points(d["sample_size"], centre,
                            scene["object_radius_m"], scene["init_noise_m"],
                            scene["init_colour_noise"], seed, device)
    return dict(K=K, extr=extr, extent=sc.scene_extent(extr), images=images,
                points=pts, colors=cols)
