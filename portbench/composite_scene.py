"""The inputs of the contact stage's fine-tune at the object's published
size: hand_720p's hand (its skeleton, poses, rig and initial cloud), an
OBJ_GAUSSIAN object of `object_slots` gaussians on object_scene.py's
textured 5 cm shell, and gt photographs of the two together.

The object stands in for a trained OBJ_GAUSSIAN checkpoint: every slot
live, its points on the shell with 0.5 mm of radial noise (the object
cell's init rule), each coloured by the whole texture, coarse and fine
(a trained object carries the fine detail), its scales from its three
nearest neighbours (any blockwise float32 search will do: the object is
input, not checked), identity rotations and opacity 0.1.

The gt of a (frame, camera) is the capsule hand of portbench/scene.py
and the textured shell seen together, the nearer surface of each pixel
in front: where the shell's ray hit is nearer than the hand's capsules
it shows the shell, opaque; elsewhere the hand's premultiplied colour
over the shell (or black). The hand's depth at a pixel is the
coverage-weighted camera depth of its capsules' axes, less their
radius. As in scene.py, all of it is the benchmark's own arithmetic.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from portbench import object_scene
from portbench import scene as sc
from portbench.drivers.common import build_inputs
from portbench.reference.hand_step import precision


def object_points(n: int, centre, radius: float, noise_m: float,
                  detail_freq: float, detail_amp: float, seed: int, device):
    """`n` points on the shell: uniform directions, the radius perturbed
    by a normal draw of `noise_m`, each coloured by the texture at its
    direction. Returns float32 points [n, 3] and colours [n, 3] on
    `device`."""
    gen = sc.generator(seed, 8, device)
    u = torch.randn(n, 3, generator=gen, device=device)
    u = u / torch.linalg.norm(u, dim=1, keepdim=True)
    r = radius + noise_m * torch.randn(n, 1, generator=gen, device=device)
    pts = torch.as_tensor(np.asarray(centre, np.float32), device=device) \
        + u * r
    return pts, object_scene.texture(u, detail_freq, detail_amp)


@torch.no_grad()
def mean3_sq(pts: torch.Tensor, budget_bytes: int = 2 << 30) -> torch.Tensor:
    """Each point's mean squared distance to its three nearest other
    points, by blocks of rows against all points: |a|^2 + |b|^2 - 2 a.b
    in float32 (TF32 off) about the points' mean, clamped at 0."""
    n = pts.shape[0]
    c = pts - pts.mean(0)
    sq = (c * c).sum(1)
    block = max(1, budget_bytes // (4 * n))
    out = torch.empty(n, dtype=torch.float32, device=pts.device)
    with precision(False):
        for i in range(0, n, block):
            a = c[i:i + block]
            d2 = torch.addmm(sq[None, :], a, c.T, alpha=-2.0)
            d2 += sq[i:i + block, None]
            rows = torch.arange(a.shape[0], device=pts.device)
            d2[rows, rows + i] = float("inf")
            out[i:i + block] = torch.topk(
                d2, min(3, n - 1), dim=1, largest=False).values.clamp(
                    min=0).mean(1)
    return out


def object_cloud(scene: dict, seed: int, device) -> dict:
    """The object's `object_slots` gaussians in the layout of
    scene.init_cloud, all live: the points of object_points, degree-0 SH
    from their colour, log-scales half the log of mean3_sq (clamped at
    1e-7, the published rule), identity rotations, opacity 0.1."""
    n = scene["object_slots"]
    pts, cols = object_points(n, scene["object_centre"],
                              scene["object_radius_m"], scene["init_noise_m"],
                              scene["detail_freq"], scene["detail_amp"],
                              seed, device)
    log_s = 0.5 * torch.log(mean3_sq(pts).clamp(min=1e-7))
    rot = torch.zeros(n, 4, device=device)
    rot[:, 0] = 1.0
    return dict(
        xyz=pts.contiguous(),
        features_dc=((cols - 0.5) / sc.SH_C0)[:, None, :].contiguous(),
        features_rest=torch.zeros(n, 15, 3, device=device),
        scaling=log_s[:, None].expand(n, 3).contiguous(),
        rotation=rot,
        opacity=torch.full((n, 1), math.log(0.1 / 0.9), device=device),
        active=torch.ones(n, dtype=torch.bool, device=device))


def joint_images(heads, tails, K, extr, width: int, height: int, seed: int,
                 device, scene: dict):
    """The gt photographs as uint8 RGBA [F, V, H, W, 4] on the host: the
    capsule hand of scene.gt_images (the same colours from the seed) and
    the textured shell, the nearer in front (module docstring)."""
    f_n, v_n = heads.shape[0], K.shape[0]
    radius = scene["capsule_radius_m"]
    gen = sc.generator(seed, 3, device)
    j = heads.shape[1]
    col_a = torch.rand(j, 3, generator=gen, device=device) * 0.8 + 0.2
    col_b = torch.rand(j, 3, generator=gen, device=device) * 0.8 + 0.2
    centre = torch.as_tensor(np.asarray(scene["object_centre"], np.float64),
                             device=device)
    r_obj = scene["object_radius_m"]
    ys, xs = torch.meshgrid(
        torch.arange(height, device=device, dtype=torch.float32),
        torch.arange(width, device=device, dtype=torch.float32),
        indexing="ij")
    pix = torch.stack([xs, ys], -1).reshape(-1, 1, 2)  # [HW, 1, 2]
    pix_h = torch.cat([pix[:, 0].double(),
                       torch.ones_like(pix[:, 0, :1]).double()], 1)
    out = np.empty((f_n, v_n, height, width, 4), np.uint8)
    for v in range(v_n):
        P = torch.as_tensor(K[v] @ extr[v], dtype=torch.float32,
                            device=device)  # [3, 4]
        # the shell: a ray through each pixel centre, its nearest hit
        R = torch.as_tensor(extr[v][:, :3], device=device)
        t = torch.as_tensor(extr[v][:, 3], device=device)
        origin = -R.T @ t
        d = pix_h @ torch.as_tensor(np.linalg.inv(K[v]), device=device).T @ R
        d = d / torch.linalg.norm(d, dim=1, keepdim=True)
        o = origin - centre
        b = d @ o
        disc = b * b - (o @ o - r_obj * r_obj)
        hit = disc >= 0
        dist = -b - torch.sqrt(disc.clamp(min=0))
        point = origin + dist[:, None] * d
        z_obj = torch.where(hit, (point @ R.T + t)[:, 2], math.inf).float()
        tex = object_scene.texture(((point - centre) / r_obj).float(),
                                   scene["detail_freq"], scene["detail_amp"])
        hit_f = hit[:, None].float()
        for f in range(f_n):
            ends = torch.as_tensor(np.stack([heads[f], tails[f]]),
                                   dtype=torch.float32, device=device)
            homo = torch.cat([ends, torch.ones_like(ends[..., :1])], -1)
            uvw = homo @ P.T  # [2, J, 3]
            z = uvw[..., 2].clamp(min=1e-3)
            uv = uvw[..., :2] / z[..., None]
            a, bb = uv[0], uv[1]  # [J, 2]
            ab = bb - a
            s = (((pix - a) * ab).sum(-1)
                 / (ab * ab).sum(-1).clamp(min=1e-6)).clamp(0, 1)  # [HW, J]
            dd = torch.linalg.norm(pix - (a + s[..., None] * ab), dim=-1)
            r_px = radius * float(K[v, 0, 0]) / z.mean(0)  # [J]
            cov = torch.exp(-0.5 * (dd / r_px) ** 4)
            colour = col_a * (1 - s[..., None]) + col_b * s[..., None]
            alpha = 1.0 - torch.prod(1.0 - 0.98 * cov, dim=-1)
            w_sum = cov.sum(-1).clamp(min=1e-6)
            rgb = (cov[..., None] * colour).sum(-2) / w_sum[:, None] \
                * alpha[:, None]
            z_hand = (cov * (z[0] * (1 - s) + z[1] * s)).sum(-1) / w_sum \
                - radius
            z_hand = torch.where(alpha > 0, z_hand, math.inf)
            front = hit & (z_obj < z_hand)
            rgb = torch.where(front[:, None], tex,
                              rgb + (1 - alpha[:, None]) * hit_f * tex)
            a_out = torch.where(front, 1.0,
                                alpha + (1 - alpha) * hit_f[:, 0])
            img = torch.cat([rgb, a_out[:, None]], 1).clamp(0, 1)
            out[f, v] = (img * 255).round().to(torch.uint8).reshape(
                height, width, 4).cpu().numpy()
    return out


def build(cfg: dict, scene: dict, seed: int, device) -> dict:
    """build_inputs' hand, skeleton, poses and rig from the configuration
    as run, the object's cloud (`obj`) and the joint gt images
    (`images`)."""
    d = cfg["dataset"]
    inputs = build_inputs(cfg, scene, seed, device)
    inputs["obj"] = object_cloud(scene, seed, device)
    inputs["images"] = joint_images(inputs["heads"], inputs["tails"],
                                    inputs["K"], inputs["extr"], d["width"],
                                    d["height"], seed, device, scene)
    return inputs
