"""Baseline contacts: MANO / HARP hand meshes against a trained object
(the reference's scripts/process/mano_contacts.py:30-116).

The posed baseline meshes are subdivided, their vertices' contact with
the object computed by the same 4 mm map as the composite's, and the
rest-pose mesh written per frame coloured by the frame's and the
accumulated contacts. With cameras, the accumulated map is rendered to
the PNGs the evaluation table reads (the reference renders them in
Blender; here each vertex is a small gaussian through render_gaussians,
one composite forward launch a camera on the card).
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from manus_tpu_torch.ops.contacts import contact_map
from manus_tpu_torch.ops.knn import knn_self_distances
from manus_tpu_torch.ops.rasterizer.api import RasterConfig, render_gaussians
from manus_tpu_torch.utils.colormap import apply_colormap
from manus_tpu_torch.utils.device import resolve_device
from manus_tpu_torch.utils.io import dump_image, dump_mesh


def render_contact_images(points, colors, cameras, out_dir: str,
                          names: Optional[Sequence[str]] = None,
                          point_scale: Optional[float] = None,
                          raster_config: Optional[RasterConfig] = None,
                          device=None) -> list:
    """Flat-shaded renders of a contact-coloured point cloud (points and
    colors [N, 3], colours in [0, 1]), one PNG a camera, {out_dir}/
    {name}.png. Each point is an isotropic gaussian of opacity 0.99 whose
    scale is sqrt of the mean squared distance to its 3 nearest
    neighbours (the gaussian init's rule: splats just touch), or
    `point_scale`. Returns the paths written."""
    device = resolve_device(device)
    pts = torch.as_tensor(np.asarray(points, np.float32), device=device)
    cols = torch.as_tensor(np.asarray(colors, np.float32), device=device)
    n = pts.shape[0]
    if point_scale is None:
        s = torch.sqrt(knn_self_distances(pts).clamp(min=1e-12))
    else:
        s = torch.full((n,), point_scale, dtype=torch.float32, device=device)
    z, s2 = torch.zeros_like(s), s * s
    cov = torch.stack([s2, z, z, s2, z, s2], dim=-1)  # isotropic upper-tri
    opac = torch.full((n, 1), 0.99, dtype=torch.float32, device=device)
    feats = torch.zeros((n, 1, 3), dtype=torch.float32, device=device)
    active = torch.ones((n,), dtype=torch.bool, device=device)
    cfg = raster_config or RasterConfig()
    bg = torch.zeros(3, device=device)
    paths = []
    for i, cam in enumerate(cameras):
        with torch.no_grad():
            img = render_gaussians(pts, cov, pts, feats, opac, cam, bg,
                                   colors_precomp=cols, sh_degree=0,
                                   active=active, config=cfg).render
        name = names[i] if names is not None else f"{i:04d}"
        path = os.path.join(out_dir, f"{name}.png")
        dump_image(img.clamp(0.0, 1.0).cpu().numpy(), path)
        paths.append(path)
    return paths


def subdivide_mesh(verts: np.ndarray, faces: np.ndarray):
    """One midpoint subdivision: every face splits into 4 and edge
    midpoints are shared (trimesh's subdivide topology). Vertex order:
    the original vertices, then the unique edges' midpoints sorted by
    (min index, max index), so rest and posed copies of one topology stay
    in correspondence. Returns (verts float32, faces int32)."""
    verts = np.asarray(verts, np.float64)
    faces = np.asarray(faces, np.int64)
    edges = np.sort(np.concatenate(
        [faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]], axis=0),
        axis=1)
    uniq, inv = np.unique(edges, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    mid = 0.5 * (verts[uniq[:, 0]] + verts[uniq[:, 1]])
    n0, f = verts.shape[0], faces.shape[0]
    m01, m12, m20 = n0 + inv[:f], n0 + inv[f:2 * f], n0 + inv[2 * f:]
    a, b, c = faces[:, 0], faces[:, 1], faces[:, 2]
    new_faces = np.concatenate([
        np.stack([a, m01, m20], 1), np.stack([m01, b, m12], 1),
        np.stack([m20, m12, c], 1), np.stack([m01, m12, m20], 1)], axis=0)
    new_verts = np.concatenate([verts, mid], axis=0)
    return new_verts.astype(np.float32), new_faces.astype(np.int32)


def mano_baseline_contacts(rest_verts, faces, posed_verts_seq, object_pts,
                           out_dir: str, cmap_type: str = "gray",
                           subdiv_iters: int = 3,
                           frame_ids: Optional[Sequence[int]] = None,
                           cameras=None,
                           camera_names: Optional[Sequence[str]] = None,
                           raster_config: Optional[RasterConfig] = None,
                           device=None) -> np.ndarray:
    """Per-frame and accumulated baseline contacts (mano_contacts.py:
    92-116); subdiv_iters is 3 for MANO and 2 for HARP in the reference.

    Writes {out_dir}/gt_eval/{frame}.ply (the frame's contact colours on
    the subdivided rest mesh) and {out_dir}/acc_eval/{frame}.ply (the
    running sum's); with `cameras`, renders the final accumulated map on
    the rest mesh to {out_dir}/acc_eval_rendered/*.png, what
    evaluate_composite reads. Returns the accumulated map [V_subdiv]
    float32.
    """
    device = resolve_device(device)
    rest_v, f = np.asarray(rest_verts, np.float32), np.asarray(faces)
    for _ in range(subdiv_iters):
        rest_v, f = subdivide_mesh(rest_v, f)
    obj = torch.as_tensor(np.asarray(object_pts, np.float32), device=device)
    ids = frame_ids if frame_ids is not None else range(len(posed_verts_seq))
    acc = None
    for fid, posed in zip(ids, posed_verts_seq):
        pv, pf = np.asarray(posed, np.float32), np.asarray(faces)
        for _ in range(subdiv_iters):
            pv, pf = subdivide_mesh(pv, pf)
        dist, _, cmap = contact_map(torch.as_tensor(pv, device=device), obj,
                                    cmap_type=cmap_type)
        acc = dist if acc is None else acc + dist
        dump_mesh(os.path.join(out_dir, "gt_eval", f"{fid}.ply"), rest_v, f,
                  colors=cmap.cpu().numpy())
        dump_mesh(os.path.join(out_dir, "acc_eval", f"{fid}.ply"), rest_v, f,
                  colors=apply_colormap(acc.clamp(0, 1),
                                        cmap_type).cpu().numpy())
    if acc is None:
        acc = torch.zeros(rest_v.shape[0], dtype=torch.float32, device=device)
    if cameras is not None:
        render_contact_images(
            rest_v, apply_colormap(acc.clamp(0, 1), cmap_type).cpu().numpy(),
            cameras, os.path.join(out_dir, "acc_eval_rendered"),
            names=camera_names, raster_config=raster_config, device=device)
    return acc.cpu().numpy()
