"""Run artifacts: PLY point, mesh and line-set dumps, PNG images, videos
as animated PNGs, and camera paths.

The PNG writer and reader are the standard library's (zlib and struct),
so no image package is needed: the writer takes 8-bit greyscale, RGB or
RGBA with filter 0 on every row; the reader takes any 8-bit,
non-interlaced greyscale, grey+alpha, RGB or RGBA file with any of the
five row filters. A video is an animated PNG (APNG: acTL, fcTL and fdAT
chunks), written with the same rows: it needs no encoder, has no size
limit, reads back bit for bit (read_video) and plays in web browsers.
"""
from __future__ import annotations

import os
import pickle
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


_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _uint8_image(img) -> np.ndarray:
    """img as [H, W, C] uint8, C in (1, 3, 4); floats in [0, 1] are
    clipped and scaled by 255, truncated."""
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if arr.ndim != 3 or arr.shape[2] not in (1, 3, 4):
        raise ValueError(f"an image is [H, W], [H, W, 1], [H, W, 3] or "
                         f"[H, W, 4], got {arr.shape}")
    return arr


def _ihdr(arr: np.ndarray) -> bytes:
    h, w, c = arr.shape
    return _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                           _COLOR_TYPES[c], 0, 0, 0))


def _png_data(arr: np.ndarray) -> bytes:
    """The zlib stream of arr's rows, filter type 0 (none) on every row."""
    h, w, c = arr.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, w * c)],
                          axis=1)
    return zlib.compress(rows.tobytes(), 6)


def dump_image(img, path: str):
    """Write img as an 8-bit PNG: [H, W] or [H, W, 1] greyscale, [H, W, 3]
    RGB or [H, W, 4] RGBA, float in [0, 1] or uint8."""
    arr = _uint8_image(img)
    png = (_PNG_SIGNATURE + _ihdr(arr) + _png_chunk(b"IDAT", _png_data(arr))
           + _png_chunk(b"IEND", b""))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(png)


def dump_video(frames, path: str, fps: int = 10):
    """Write frames (a list of [H, W, 3] RGB arrays, uint8 or float in
    [0, 1], of one shape) as an animated PNG at path's stem with the
    suffix .apng (novel_path.mp4 -> novel_path.apng), each frame shown
    1/fps s, looping. Returns the path written (None for no frames)."""
    if not frames:
        return None
    arrs = [_uint8_image(fr) for fr in frames]
    if any(a.shape != arrs[0].shape for a in arrs):
        raise ValueError("the frames of a video must share one shape")
    out = os.path.splitext(path)[0] + ".apng"
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    h, w = arrs[0].shape[:2]
    seq = 0
    with open(out, "wb") as f:
        f.write(_PNG_SIGNATURE + _ihdr(arrs[0]))
        f.write(_png_chunk(b"acTL", struct.pack(">II", len(arrs), 0)))
        for i, a in enumerate(arrs):
            # sequence, size, offset, delay 1/fps, dispose none, blend
            # source
            f.write(_png_chunk(b"fcTL", struct.pack(
                ">IIIIIHHBB", seq, w, h, 0, 0, 1, int(fps), 0, 0)))
            seq += 1
            data = _png_data(a)
            if i == 0:
                f.write(_png_chunk(b"IDAT", data))
            else:
                f.write(_png_chunk(b"fdAT", struct.pack(">I", seq) + data))
                seq += 1
        f.write(_png_chunk(b"IEND", b""))
    return out


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


def _chunks(data: bytes, path: str):
    """(kind, body) of each chunk of a PNG file's bytes, up to IEND (the
    CRCs are not checked)."""
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n


def _decode(streams: list, ihdr, path: str) -> np.ndarray:
    w, h, depth, ctype, _, _, interlace = ihdr
    channels = {v: k for k, v in _COLOR_TYPES.items()}.get(ctype)
    if depth != 8 or channels is None or interlace != 0:
        raise ValueError(
            f"{path}: bit depth {depth}, colour type {ctype}, interlace "
            f"{interlace}; read_png takes 8-bit, non-interlaced greyscale, "
            "grey+alpha, RGB or RGBA")
    return _unfilter(zlib.decompress(b"".join(streams)), h, w * channels,
                     channels).reshape(h, w, channels)


def read_video(path: str) -> list:
    """The frames ([H, W, C] uint8) of an animated PNG that dump_video
    wrote (every frame full size at offset 0)."""
    with open(path, "rb") as f:
        data = f.read()
    ihdr, frames, cur = None, [], None
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"fcTL":
            if cur is not None:
                frames.append(cur)
            w, h, x, y = struct.unpack(">IIII", body[4:20])
            if (w, h, x, y) != (ihdr[0], ihdr[1], 0, 0):
                raise ValueError(f"{path}: a frame of {w}x{h} at ({x}, {y})")
            cur = []
        elif kind == b"IDAT" and cur is not None:
            cur.append(body)
        elif kind == b"fdAT":
            cur.append(body[4:])
    if cur is not None:
        frames.append(cur)
    return [_decode(s, ihdr, path) for s in frames]


def read_png(path: str, mode: str = "rgb") -> np.ndarray:
    """Read an 8-bit, non-interlaced greyscale, grey+alpha, RGB or RGBA
    PNG as uint8. mode "rgb": [H, W, 3] (alpha dropped, grey repeated);
    "rgba": [H, W, 4] (alpha 255 where the file has none); "gray": [H, W],
    colour converted as OpenCV's PNG decoder does for IMREAD_GRAYSCALE,
    (9797 R + 19234 G + 3737 B) >> 15, alpha dropped. Any other file
    (16-bit, palette, interlaced) raises ValueError."""
    with open(path, "rb") as f:
        data = f.read()
    idat, ihdr = [], None
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if ihdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    px = _decode(idat, ihdr, path)
    h, w, channels = px.shape
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


def generate_camera_path(out_path: str, num_frames: int = 60,
                         center=(0.0, 0.0, 0.0), dist: float = 2.0,
                         elevation_deg: float = 30.0, fov_deg: float = 50.0,
                         width: int = 1080, height: int = 1080,
                         spiral: float = 0.0) -> str:
    """An orbit (or, with spiral degrees of elevation sweep, a spiral)
    around `center`, written in the Blender camera-path pkl contract
    ({intrs: [(fx, fy, cx, cy)], extrs: [[3, 4]]}), looking at the centre
    as the synthetic rigs do. Returns out_path."""
    center = np.asarray(center, np.float64)
    f = width / (2 * np.tan(np.radians(fov_deg) / 2))
    intr = (f, f, (width - 1) / 2.0, (height - 1) / 2.0)
    intrs, extrs = [], []
    for i in range(num_frames):
        theta = 2 * np.pi * i / num_frames
        phi = np.radians(elevation_deg + spiral * i / max(num_frames - 1, 1))
        pos = center + dist * np.array([np.cos(theta) * np.cos(phi),
                                        np.sin(phi),
                                        np.sin(theta) * np.cos(phi)])
        fwd = center - pos
        fwd /= np.linalg.norm(fwd)
        up = np.array([0.0, -1.0, 0.0])
        right = np.cross(up, fwd)
        right /= np.linalg.norm(right) + 1e-9
        up2 = np.cross(fwd, right)
        R = np.stack([right, up2, fwd], axis=0)
        t = -R @ pos
        intrs.append(intr)
        extrs.append(np.concatenate([R, t[:, None]], axis=1))
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "wb") as fh:
        pickle.dump({"intrs": intrs, "extrs": extrs}, fh)
    return out_path


def load_camera_path(path: str, width: int, height: int, device=None) -> list:
    """The cameras of a Blender camera-path pkl ({intrs, extrs}; an intr
    is (fx, fy, cx, cy) or a 3x3 K, an extr [3, 4] or [4, 4]) on
    `device`. The file is read with pickle: a joblib-compressed file
    (the reference's tooling may write one) raises, naming the fix."""
    from manus_tpu_torch.utils.camera import make_camera

    with open(path, "rb") as f:
        try:
            data = pickle.load(f)
        except (pickle.UnpicklingError, EOFError, ValueError,
                ModuleNotFoundError, AttributeError) as e:
            raise ValueError(
                f"{path} is not a plain pickle ({type(e).__name__}: {e}); "
                "a joblib file? load it with joblib where that is installed "
                "and write it again with pickle.dump") from e
    cams = []
    for K, extr in zip(data["intrs"], data["extrs"]):
        K = np.asarray(K, np.float64)
        if K.ndim == 1:  # Blender's (fx, fy, cx, cy)
            fx, fy, cx, cy = K
            K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
        extr = np.asarray(extr, np.float64)
        if extr.shape[0] == 4:
            extr = extr[:3]
        cams.append(make_camera(K, extr, width, height, device=device))
    return cams


def dump_lineset(path: str, points, edges, colors=None):
    """A line set as binary little-endian PLY, vertex and edge elements:
    points [P, 3], edges [E, 2] vertex indices, colors [E, 3] RGB per
    edge in [0, 1] or [0, 255] (optional)."""
    pts = np.asarray(points, np.float32).reshape(-1, 3)
    edg = np.asarray(edges, np.int32).reshape(-1, 2)
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {len(pts)}",
              "property float x", "property float y", "property float z",
              f"element edge {len(edg)}",
              "property int vertex1", "property int vertex2"]
    if colors is None:
        edtype = np.dtype([("v", "<i4", 2)])
    else:
        cols = np.asarray(colors, np.float32).reshape(-1, 3)
        if cols.max(initial=0.0) <= 1.0 + 1e-6:
            cols = cols * 255
        cols = np.clip(cols, 0, 255).astype(np.uint8)
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
        edtype = np.dtype([("v", "<i4", 2), ("rgb", "u1", 3)])
    header.append("end_header")
    erec = np.empty(len(edg), edtype)
    erec["v"] = edg
    if colors is not None:
        erec["rgb"] = cols
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(pts.astype("<f4").tobytes())
        f.write(erec.tobytes())


def load_lineset(path: str):
    """A dump_lineset PLY -> (points [P, 3], edges [E, 2], edge colours
    [E, 3] uint8 or None)."""
    with open(path, "rb") as f:
        n_v = n_e = 0
        has_color = False
        while True:
            line = f.readline().decode("ascii").strip()
            if line.startswith("element vertex"):
                n_v = int(line.split()[-1])
            elif line.startswith("element edge"):
                n_e = int(line.split()[-1])
            elif line == "property uchar red":
                has_color = True
            elif line == "end_header":
                break
        pts = np.frombuffer(f.read(12 * n_v), "<f4").reshape(n_v, 3)
        edtype = np.dtype([("v", "<i4", 2)] + ([("rgb", "u1", 3)]
                                              if has_color else []))
        erec = np.frombuffer(f.read(edtype.itemsize * n_e), edtype)
    return (pts, erec["v"].astype(np.int32),
            erec["rgb"].copy() if has_color else None)
