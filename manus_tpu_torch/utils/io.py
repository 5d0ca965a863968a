"""Run artifacts: PLY point dumps and PNG images.

The PNG writer is the standard library's (zlib and struct): 8-bit RGB,
one filter byte per row, so no image package is needed.
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np


def dump_points(points, path: str, colors=None):
    """Write a point cloud as binary little-endian PLY, with uchar RGB when
    `colors` ([N, 3] or [N, 4], in [0, 1] or [0, 255]) is given."""
    pts = np.asarray(points, np.float32).reshape(-1, 3)
    n = pts.shape[0]
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    if colors is None:
        dtype = np.dtype([("xyz", "<f4", 3)])
    else:
        cols = np.asarray(colors)
        if cols.shape[-1] == 4:
            cols = cols[..., :3]
        if cols.max(initial=0.0) <= 1.0 + 1e-6:
            cols = cols * 255
        cols = np.clip(cols, 0, 255).astype(np.uint8).reshape(-1, 3)
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
        dtype = np.dtype([("xyz", "<f4", 3), ("rgb", "u1", 3)])
    header.append("end_header")
    rec = np.empty(n, dtype)
    rec["xyz"] = pts
    if colors is not None:
        rec["rgb"] = cols
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(rec.tobytes())


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def dump_image(img, path: str):
    """Write img ([H, W, 3] RGB, float in [0, 1] or uint8) as an 8-bit PNG."""
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
    h, w, c = arr.shape
    if c != 3:
        raise ValueError(f"dump_image takes [H, W, 3] RGB, got {arr.shape}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, w * 3)],
                          axis=1)  # filter type 0 (none) on every row
    png = (b"\x89PNG\r\n\x1a\n"
           + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
           + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
           + _png_chunk(b"IEND", b""))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(png)


def concat_images(*imgs, axis: int = 1):
    return np.concatenate([np.asarray(i) for i in imgs], axis=axis)
