"""Run artifacts: PLY point and mesh dumps, PNG images.

The PNG writer and reader are the standard library's (zlib and struct),
so no image package is needed: the writer takes 8-bit greyscale, RGB or
RGBA with filter 0 on every row; the reader takes any 8-bit,
non-interlaced greyscale, grey+alpha, RGB or RGBA file with any of the
five row filters.
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


def dump_mesh(path: str, verts, faces, colors=None):
    """Write a triangle mesh as binary little-endian PLY, with uchar RGB
    per vertex when `colors` is given (as dump_points takes them)."""
    v = np.asarray(verts, np.float32).reshape(-1, 3)
    f = np.asarray(faces, np.int32).reshape(-1, 3)
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {v.shape[0]}",
              "property float x", "property float y", "property float z"]
    if colors is None:
        vdtype = np.dtype([("xyz", "<f4", 3)])
    else:
        cols = np.asarray(colors)
        if cols.shape[-1] == 4:
            cols = cols[..., :3]
        if cols.max(initial=0.0) <= 1.0 + 1e-6:
            cols = cols * 255
        cols = np.clip(cols, 0, 255).astype(np.uint8).reshape(-1, 3)
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
        vdtype = np.dtype([("xyz", "<f4", 3), ("rgb", "u1", 3)])
    header += [f"element face {f.shape[0]}",
               "property list uchar int vertex_indices", "end_header"]
    vrec = np.empty(v.shape[0], vdtype)
    vrec["xyz"] = v
    if colors is not None:
        vrec["rgb"] = cols
    frec = np.empty(f.shape[0], np.dtype([("n", "u1"), ("idx", "<i4", 3)]))
    frec["n"] = 3
    frec["idx"] = f
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as fh:
        fh.write(("\n".join(header) + "\n").encode("ascii"))
        fh.write(vrec.tobytes())
        fh.write(frec.tobytes())


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


# PNG colour types by channel count: greyscale, grey+alpha, RGB, RGBA
_COLOR_TYPES = {1: 0, 2: 4, 3: 2, 4: 6}


def dump_image(img, path: str):
    """Write img as an 8-bit PNG: [H, W] or [H, W, 1] greyscale, [H, W, 3]
    RGB or [H, W, 4] RGBA, float in [0, 1] or uint8."""
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    h, w, c = arr.shape
    if c not in (1, 3, 4):
        raise ValueError(f"dump_image takes [H, W], [H, W, 1], [H, W, 3] "
                         f"or [H, W, 4], got {arr.shape}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, w * c)],
                          axis=1)  # filter type 0 (none) on every row
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPES[c], 0, 0, 0)
    png = (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", ihdr)
           + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
           + _png_chunk(b"IEND", b""))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(png)


def _paeth_row(cur: bytearray, prev: bytes, bpp: int):
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        if pa <= pb and pa <= pc:
            pred = a
        elif pb <= pc:
            pred = b
        else:
            pred = c
        cur[i] = (cur[i] + pred) & 0xFF


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """The [h, stride] bytes of the image from PNG's filtered rows."""
    out = np.zeros((h + 1, stride), np.uint8)  # row 0: the zero row above
    data = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    for r in range(h):
        kind, row, prev = data[r, 0], data[r, 1:], out[r]
        if kind == 0:
            out[r + 1] = row
        elif kind == 1:  # Sub: a running sum per byte of the pixel, mod 256
            lanes = row.reshape(-1, bpp)
            out[r + 1] = np.cumsum(lanes, axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            out[r + 1] = row + prev
        elif kind == 3:  # Average: floor((left + up) / 2), left decoded
            cur = row.astype(np.int32)
            up = prev.astype(np.int32)
            for i in range(stride):
                left = int(cur[i - bpp]) if i >= bpp else 0
                cur[i] = (cur[i] + ((left + int(up[i])) >> 1)) & 0xFF
            out[r + 1] = cur
        elif kind == 4:  # Paeth
            cur = bytearray(row.tobytes())
            _paeth_row(cur, prev.tobytes(), bpp)
            out[r + 1] = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"PNG row {r}: unknown filter type {kind}")
    return out[1:]


def read_png(path: str, mode: str = "rgb") -> np.ndarray:
    """Read an 8-bit, non-interlaced greyscale, grey+alpha, RGB or RGBA
    PNG as uint8. mode "rgb": [H, W, 3] (alpha dropped, grey repeated);
    "rgba": [H, W, 4] (alpha 255 where the file has none); "gray": [H, W],
    colour converted as OpenCV's PNG decoder does for IMREAD_GRAYSCALE,
    (9797 R + 19234 G + 3737 B) >> 15, alpha dropped. Any other file
    (16-bit, palette, interlaced) raises ValueError."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, ihdr = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    if ihdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = ihdr
    channels = {v: k for k, v in _COLOR_TYPES.items()}.get(ctype)
    if depth != 8 or channels is None or interlace != 0:
        raise ValueError(
            f"{path}: bit depth {depth}, colour type {ctype}, interlace "
            f"{interlace}; read_png takes 8-bit, non-interlaced greyscale, "
            "grey+alpha, RGB or RGBA")
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w * channels,
                   channels).reshape(h, w, channels)
    color = px[..., :3] if channels >= 3 else np.repeat(px[..., :1], 3, -1)
    if mode == "rgb":
        return np.ascontiguousarray(color)
    if mode == "rgba":
        alpha = px[..., -1:] if channels in (2, 4) else np.full(
            (h, w, 1), 255, np.uint8)
        return np.concatenate([color, alpha], axis=-1)
    if mode == "gray":
        if channels <= 2:
            return np.ascontiguousarray(px[..., 0])
        c = px[..., :3].astype(np.int64)
        return ((9797 * c[..., 0] + 19234 * c[..., 1] + 3737 * c[..., 2])
                >> 15).astype(np.uint8)
    raise ValueError(f"unknown mode {mode!r}; one of rgb, rgba, gray")


def concat_images(*imgs, axis: int = 1):
    return np.concatenate([np.asarray(i) for i in imgs], axis=axis)
