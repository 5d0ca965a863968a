"""Write tests/data/hdf5_forms/: HDF5 files in the forms h5py writes, made
by h5py itself, and a manifest of what h5py reads from them, so that the
port's reader (manus_tpu_torch/data/hdf5.py) is held to the real HDF5
library where h5py is absent (on the card's machine).

    python3 scripts/torch_hdf5_fixtures.py [--out tests/data/hdf5_forms]

Needs h5py. With a fixed seed it writes one small file per form in FORMS
(dense groups, the layout-v4 chunk indexes, the lzf, szip, scaleoffset
and nbit filters, compound, complex, enum, bool, array, opaque, variable-length
sequence and committed types, null dataspaces, soft and external links,
user blocks), capture/ (one BRICS dynamic capture: the 20-bone hand
rendered by the port on the CPU at 1280x720, two action files written with
libver="latest" and track_order=True, crops chunked with lzf in one and
with gzip, shuffle and fletcher32 in the other) and manifest.json (for
every file: each group's key order, and every dataset's shape, dtype and
the sha256 of its values, as h5py reads them). `manifest` makes the same
record from h5py's objects or the port's; the tests and chip_smoke.py
compare the two.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "hdf5_forms")
SEED = 0

# capture/: cameras 2.4 m from the hand with a 40 degree field of view, so
# that a crop (the alpha's bbox plus CAPTURE_MARGIN px) stays near 160 px
CAPTURE_W, CAPTURE_H, CAPTURE_VIEWS = 1280, 720, 9
CAPTURE_DIST, CAPTURE_FOV, CAPTURE_MARGIN = 2.4, 40.0, 8
CAPTURE_FRAMES = (("grasp_a", ("0", "5")), ("grasp_b", ("0", "5")))
CAPTURE_GT_PER_BONE = 400


# ---------------------------------------------------------------------------
# the manifest


def dtype_spec(dt: np.dtype):
    """A dtype as JSON, the same under any numpy version."""
    if dt.names is not None:
        return {"fields": [[n, dt.fields[n][1], dtype_spec(dt.fields[n][0])]
                           for n in dt.names], "itemsize": dt.itemsize}
    if dt.subdtype is not None:
        return {"base": dtype_spec(dt.subdtype[0]),
                "shape": list(dt.subdtype[1])}
    meta = dt.metadata or {}
    if "vlen" in meta:
        v = meta["vlen"]
        return {"vlen": v.__name__ if isinstance(v, type) else dtype_spec(
            np.dtype(v))}
    if "enum" in meta:
        return {"enum": np.dtype(dt.str).str,
                "members": [list(kv) for kv in sorted(meta["enum"].items())]}
    return dt.str


def _feed(h, x):
    """The values of x into the hash: bytes with their length, object
    arrays element by element, structured ones field by field."""
    if isinstance(x, bytes):
        h.update(len(x).to_bytes(8, "little") + x)
        return
    x = np.asarray(x)
    if not x.dtype.hasobject:
        h.update(str(x.shape).encode() + np.ascontiguousarray(x).tobytes())
    elif x.dtype.names is not None:
        for name in x.dtype.names:
            _feed(h, x[name])
    else:
        h.update(str(x.shape).encode())
        for e in x.reshape(-1):
            _feed(h, e)


def value_digest(value) -> str:
    h = hashlib.sha256()
    _feed(h, value)
    return h.hexdigest()


def manifest(group, path="/", out=None) -> dict:
    """{path: record} of a group and all under it, read through h5py or
    the port's reader alike: a group's keys in order, a dataset's shape,
    dtype and value digest, a committed datatype's dtype, a dangling
    link as such."""
    out = {} if out is None else out
    keys = list(group.keys())
    out[path] = {"keys": keys}
    for key in keys:
        obj = group.get(key)
        sub = path.rstrip("/") + "/" + key
        if obj is None:
            out[sub] = {"dangling": True}
        elif hasattr(obj, "keys"):
            manifest(obj, sub, out)
        elif hasattr(obj, "shape"):
            rec = {"shape": None if obj.shape is None else list(obj.shape),
                   "dtype": dtype_spec(obj.dtype)}
            if obj.shape is not None:
                rec["sha256"] = value_digest(obj[()])
            out[sub] = rec
        else:
            out[sub] = {"datatype": dtype_spec(obj.dtype)}
    return out


# ---------------------------------------------------------------------------
# one file per form (each writer takes the path and the h5py module)


def _low_level(g, name, tid, shape, data, h5py, dcpl=None, mem=None):
    """A dataset of file type tid, written from `data` in memory type
    `mem` (tid's own where None)."""
    space = h5py.h5s.create_simple(shape)
    ds = h5py.h5d.create(g.id, name.encode(), tid, space, dcpl=dcpl)
    if data is not None:
        ds.write(h5py.h5s.ALL, h5py.h5s.ALL, np.ascontiguousarray(data),
                 mtype=mem)


def dense_links(path, h5py):
    """More than 8 links: a fractal heap indexed by a v2 B-tree, listed
    by name; 300 soft links make the heap's root an indirect block and
    the B-tree two levels deep."""
    with h5py.File(path, "w", libver="latest") as f:
        g = f.create_group("g")
        for i in range(20):
            g[str(i)] = np.arange(i, i + 2)
        f["x"] = np.arange(3)
        big = f.create_group("big")
        for i in range(300):
            big[f"link_{i:05d}"] = h5py.SoftLink("/x")


def dense_links_creation_order(path, h5py):
    """track_order=True: listed in creation order, compact (3 members)
    and dense (12, one deleted and created again: now the last), under
    libver latest and the default libver."""
    for libver, suffix in (("latest", ""), ("earliest", "_default")):
        with h5py.File(path.replace(".h5", f"{suffix}.h5"), "w",
                       libver=libver, track_order=True) as f:
            c = f.create_group("compact", track_order=True)
            for name in ("cam2", "cam0", "cam1"):
                c[name] = np.arange(2)
            d = f.create_group("dense", track_order=True)
            for i in reversed(range(12)):
                d[f"cam{i:03d}"] = np.full(2, i)
            del d["cam005"]
            d["cam005"] = np.zeros(1)


def lzf(path, h5py):
    rng = np.random.RandomState(SEED)
    for libver, suffix in (("earliest", ""), ("latest", "_latest")):
        with h5py.File(path.replace(".h5", f"{suffix}.h5"), "w",
                       libver=libver) as f:
            f.create_dataset("x", data=np.arange(100), chunks=(10,),
                             compression="lzf")
            crop = np.zeros((60, 50, 4), np.uint8)
            crop[10:50, 5:45] = rng.randint(0, 256, (40, 40, 4))
            f.create_dataset("crop", data=crop, chunks=(16, 50, 4),
                             compression="lzf", shuffle=True)
            f.create_dataset("noise", data=rng.randint(0, 256, 500, np.uint8),
                             chunks=(100,), compression="lzf")


def v4_chunk_indexes(path, h5py):
    """Each layout-v4 chunk index: single chunk (filtered and not),
    implicit, fixed array (paged and not, with partial edge chunks),
    extensible array and v2 B-tree (records of types 10 and 11), some
    chunks never written (the fill value)."""
    rng = np.random.RandomState(SEED)
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("fixed", data=np.arange(100), chunks=(10,))
        f.create_dataset("fixed_edges", data=rng.rand(37, 23).astype("f4"),
                         chunks=(8, 5), compression="gzip", shuffle=True)
        part = f.create_dataset("fixed_paged", shape=(3000,), dtype="i2",
                                chunks=(2,), fillvalue=-1)
        part[100:700] = np.arange(600)
        part[2500:2531] = 7
        f.create_dataset("fixed_paged_gzip", data=np.arange(2100) % 251,
                         chunks=(2,), compression="gzip")
        f.create_dataset("single", data=rng.rand(6, 7), chunks=(6, 7))
        f.create_dataset("single_filtered", data=np.arange(64).reshape(8, 8),
                         chunks=(8, 8), compression="gzip", fletcher32=True)
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_chunk((4, 3))
        dcpl.set_alloc_time(h5py.h5d.ALLOC_TIME_EARLY)
        _low_level(f, "implicit", h5py.h5t.STD_I32LE, (10, 7),
                   np.arange(70, dtype="<i4").reshape(10, 7), h5py,
                   dcpl=dcpl)
        ea = f.create_dataset("extensible", shape=(9, 3), maxshape=(None, 3),
                              chunks=(2, 3), dtype="f8")
        ea[...] = rng.rand(9, 3)
        ea.resize((40, 3))
        ea[30:40] = 2.5
        f.create_dataset("extensible_gzip", data=np.arange(300).reshape(
            100, 3), maxshape=(None, 3), chunks=(4, 3), compression="gzip")
        f.create_dataset("extensible_middle", data=rng.randint(
            0, 9, (3, 50, 2)), maxshape=(3, None, 2), chunks=(3, 4, 1))
        bt = f.create_dataset("btree2", shape=(50, 40, 4),
                              maxshape=(None, None, 4), chunks=(3, 2, 4),
                              dtype="u1")
        bt[:45, :37] = rng.randint(0, 256, (45, 37, 4))
        f.create_dataset("btree2_gzip", data=rng.rand(30, 20).astype("f4"),
                         maxshape=(None, None), chunks=(4, 4),
                         compression="gzip", shuffle=True, fletcher32=True)


def extensible_paged(path, h5py):
    """An extensible array past 131,060 chunks, where its data blocks are
    paged: one chunk written there, the rest never."""
    with h5py.File(path, "w", libver="latest") as f:
        ds = f.create_dataset("x", shape=(140000,), maxshape=(None,),
                              chunks=(1,), dtype="u1", fillvalue=3)
        ds[139990] = 9
        ds[5] = 1


def scaleoffset(path, h5py):
    rng = np.random.RandomState(SEED)
    with h5py.File(path, "w") as f:
        f.create_dataset("int", data=rng.randint(-50, 900, (40, 6)),
                         chunks=(10, 6), scaleoffset=0)
        f.create_dataset("uint16_be", data=rng.randint(
            1000, 1100, 97).astype(">u2"), chunks=(20,), scaleoffset=0)
        f.create_dataset("int_fill", data=rng.randint(0, 40, 64).astype(
            "i4"), chunks=(16,), scaleoffset=0, fillvalue=7)
        f.create_dataset("int_bits", data=rng.randint(0, 1 << 20, 50),
                         chunks=(25,), scaleoffset=12)
        f.create_dataset("const", data=np.full(30, 5, "i2"), chunks=(10,),
                         scaleoffset=0)
        f.create_dataset("float", data=rng.rand(33, 4).astype("f4") * 100,
                         chunks=(11, 4), scaleoffset=2)
        f.create_dataset("double", data=rng.normal(0, 10, 70), chunks=(35,),
                         scaleoffset=3)


def nbit(path, h5py):
    """The nbit filter on integers of full and of reduced precision (12
    bits above bit 4, signed and not), floats and a compound."""
    rng = np.random.RandomState(SEED)
    with h5py.File(path, "w") as f:
        for name, tid, data in (
                ("int32", h5py.h5t.STD_I32LE.copy(),
                 rng.randint(-10 ** 6, 10 ** 6, 50).astype("<i4")),
                ("float32", h5py.h5t.IEEE_F32BE.copy(),
                 rng.rand(40).astype("<f4")),
                ("int_12_signed", h5py.h5t.STD_I32LE.copy(),
                 rng.randint(-2048, 2048, 60).astype("<i4") * 16),
                ("uint_12", h5py.h5t.STD_U16BE.copy(),
                 rng.randint(0, 4096, 45).astype("<u2") * 16)):
            if name.endswith("12_signed") or name == "uint_12":
                tid.set_precision(12)
                tid.set_offset(4)
            dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
            dcpl.set_chunk((15,))
            dcpl.set_filter(h5py.h5z.FILTER_NBIT)
            mem = h5py.h5t.py_create(data.dtype)
            _low_level(f, name, tid, data.shape, data, h5py, dcpl=dcpl,
                       mem=mem)
        dt = np.dtype([("a", "<i4"), ("b", "<f8"), ("c", "<u1", (3,)),
                       ("s", "S3")])
        data = np.zeros(20, dt)
        data["a"] = rng.randint(-99, 99, 20)
        data["b"] = rng.rand(20)
        data["c"] = rng.randint(0, 255, (20, 3))
        data["s"] = b"ab"
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_chunk((8,))
        dcpl.set_filter(h5py.h5z.FILTER_NBIT)
        tid = h5py.h5t.py_create(dt)
        _low_level(f, "compound", tid, data.shape, data, h5py, dcpl=dcpl)


def szip(path, h5py):
    """The szip filter (libaec): with and without the nearest-neighbour
    preprocessor, 8-, 16-, 32- and 64-bit pixels of either byte order (a
    32- or 64-bit pixel goes as byte planes), scanlines that are not whole
    blocks, runs of zero blocks, smooth and noisy data."""
    rng = np.random.RandomState(SEED)
    with h5py.File(path, "w") as f:
        for name, data, chunks, opts in (
                ("u1_ramp", np.arange(100, dtype="u1"), (50,), ("nn", 32)),
                ("u1_sparse", (rng.rand(3000) < 0.02).astype("u1") * 7,
                 (3000,), ("nn", 32)),
                ("u1_2d", rng.randint(0, 4, (60, 45)).astype("u1"), (20, 45),
                 ("nn", 32)),
                ("i2_be", np.arange(40, dtype=">i2"), (40,), ("nn", 32)),
                ("u2_smooth", (np.sin(np.arange(2000) / 50) * 1000
                               + 2000).astype("<u2"), (1000,), ("nn", 32)),
                ("i4_ec", rng.randint(0, 1 << 20, 300).astype("<i4"),
                 (300,), ("ec", 16)),
                ("f4_ec", np.linspace(0, 1, 64).astype("<f4"), (64,),
                 ("ec", 16)),
                ("f8_noise", rng.rand(200), (200,), ("nn", 32))):
            f.create_dataset(name, data=data, chunks=chunks,
                             compression="szip", compression_opts=opts)


def types(path, h5py):
    """compound (nested, array and big-endian members), h5py's complex,
    enum and bool, array, opaque, bitfield, reduced-precision integers,
    long double, variable-length sequences and strings (also as compound
    members), fixed strings, a null dataspace; under the default libver
    and the latest."""
    rng = np.random.RandomState(SEED)
    for libver, suffix in (("earliest", ""), ("latest", "_latest")):
        with h5py.File(path.replace(".h5", f"{suffix}.h5"), "w",
                       libver=libver) as f:
            f["compound"] = np.zeros(3, [("a", "f4"), ("b", "i2")])
            nested = np.dtype([("x", ">f8"), ("p", [("u", "u1"),
                                                    ("v", "<i4", (2, 2))]),
                               ("s", "S5"), ("ok", "?")])
            arr = np.zeros(4, nested)
            arr["x"] = rng.rand(4)
            arr["p"]["u"] = [1, 2, 3, 4]
            arr["p"]["v"] = rng.randint(-9, 9, (4, 2, 2))
            arr["s"] = [b"a", b"bb", b"ccc", b"dddd"]
            arr["ok"] = [True, False, True, True]
            f["nested"] = arr
            f["complex64"] = (rng.rand(5) + 1j * rng.rand(5)).astype("c8")
            f["complex128"] = rng.rand(2, 3) + 2j
            f["complex_be"] = (rng.rand(3) - 1j).astype(">c16")
            f.create_dataset("enum", data=np.asarray([0, 2, 1, 2], "i2"),
                             dtype=h5py.enum_dtype({"A": 0, "B": 1, "C": 2},
                                                   "i2"))
            f["bool"] = np.asarray([[True, False], [False, True]])
            arr_t = h5py.h5t.array_create(h5py.h5t.NATIVE_FLOAT, (2, 3))
            _low_level(f, "array", arr_t, (4,),
                       rng.rand(4, 2, 3).astype("f4"), h5py, mem=arr_t)
            f["opaque"] = np.frombuffer(rng.bytes(15), "V5")
            f["datetime"] = np.arange(3).astype("M8[s]").astype(
                h5py.opaque_dtype("M8[s]"))
            _low_level(f, "bitfield", h5py.h5t.STD_B16LE, (4,),
                       np.asarray([1, 2, 65535, 7], "<u2"), h5py,
                       mem=h5py.h5t.NATIVE_UINT16)
            f["longdouble"] = np.linspace(0, 1, 5, dtype=np.longdouble)
            vl = f.create_dataset("vlen", (4,), dtype=h5py.vlen_dtype("i4"))
            for i, v in enumerate(([1, 2], [], [5, 6, 7], [8])):
                vl[i] = v
            vf = f.create_dataset("vlen_2d", (2, 2),
                                  dtype=h5py.vlen_dtype("f8"))
            vf[0, 0], vf[1, 1] = rng.rand(3), rng.rand(1)
            f["strings"] = np.array(["hello", "wörld", ""],
                                    dtype=h5py.string_dtype())
            f["strings_ascii"] = np.array([b"a", b"bc"],
                                          dtype=h5py.string_dtype("ascii"))
            cv = f.create_dataset("compound_vlen", (3,), dtype=[
                ("a", "f4"), ("s", h5py.string_dtype()),
                ("v", h5py.vlen_dtype("i2")), ("b", "u1")])
            cv[0] = (1.5, "one", np.asarray([1, 2], "i2"), 3)
            cv[2] = (-2.0, "three", np.asarray([], "i2"), 9)
            f["empty"] = h5py.Empty("f4")
            f["scalar"] = np.float32(2.5)


def committed_types(path, h5py):
    """Named datatypes, and datasets whose type is shared with them."""
    for libver, suffix in (("earliest", ""), ("latest", "_latest")):
        with h5py.File(path.replace(".h5", f"{suffix}.h5"), "w",
                       libver=libver) as f:
            f["pair"] = np.dtype([("x", "f8"), ("y", "u1")])
            f["int_be"] = np.dtype(">i4")
            ds = f.create_dataset("uses_pair", (3,), dtype=f["pair"])
            ds[1] = (2.5, 7)
            f.create_dataset("uses_int", data=np.arange(4, dtype=">i4"),
                             dtype=f["int_be"])
            f.create_group("g")["t"] = np.dtype("S3")


def links(path, h5py):
    """Soft links (absolute, relative, chained, dangling, to a group) in
    symbol-table and link-message groups, and external links to a file
    beside this one (relative) and to an object in it."""
    target = path.replace(".h5", "_target.h5")
    with h5py.File(target, "w") as t:
        t["data"] = np.arange(5.0)
        t.create_group("grp")["y"] = np.int16(3)
    for libver, suffix in (("earliest", ""), ("latest", "_latest")):
        with h5py.File(path.replace(".h5", f"{suffix}.h5"), "w",
                       libver=libver) as f:
            f["x"] = np.arange(3)
            g = f.create_group("a/b")
            g["z"] = np.ones(2)
            f["soft_abs"] = h5py.SoftLink("/x")
            g["soft_rel"] = h5py.SoftLink("z")
            g["soft_up"] = h5py.SoftLink("/a/b/z")
            f["soft_chain"] = h5py.SoftLink("/soft_abs")
            f["soft_group"] = h5py.SoftLink("/a/b")
            f["dangling"] = h5py.SoftLink("/nowhere")
            f["ext"] = h5py.ExternalLink(os.path.basename(target), "/data")
            f["ext_group"] = h5py.ExternalLink(os.path.basename(target),
                                               "/grp")


def user_block(path, h5py):
    for libver, size, suffix in (("earliest", 512, ""),
                                 ("latest", 1024, "_latest")):
        with h5py.File(path.replace(".h5", f"{suffix}.h5"), "w",
                       libver=libver, userblock_size=size) as f:
            f["x"] = np.arange(6).reshape(2, 3)
            f.create_dataset("chunked", data=np.arange(50.0), chunks=(7,),
                             compression="gzip")
            g = f.create_group("g")
            for i in range(10):
                g[str(i)] = i
        with open(path.replace(".h5", f"{suffix}.h5"), "r+b") as raw:
            raw.write(b"a user block: anything at all")


# form name -> writer; each writes <name>.h5 and maybe siblings
FORMS = {
    "dense_links": dense_links,
    "creation_order": dense_links_creation_order,
    "lzf": lzf,
    "v4_chunk_indexes": v4_chunk_indexes,
    "extensible_paged": extensible_paged,
    "scaleoffset": scaleoffset,
    "nbit": nbit,
    "szip": szip,
    "types": types,
    "committed_types": committed_types,
    "links": links,
    "user_block": user_block,
}


def write_forms(out: str):
    """Every form's files under out."""
    import h5py

    os.makedirs(out, exist_ok=True)
    for name, writer in FORMS.items():
        writer(os.path.join(out, f"{name}.h5"), h5py)


# ---------------------------------------------------------------------------
# capture/


def render_capture(width=CAPTURE_W, height=CAPTURE_H, views=CAPTURE_VIEWS):
    """The hand of chip_smoke.brics_dynamic_capture rendered on the CPU
    through the port's plain composite: {action: tree} in
    tests/test_torch_brics.capture_tree's layout."""
    import torch

    sys.path.insert(0, ROOT)
    from chip_smoke import brics_names, crop_rgba, hand20_skeleton, \
        render_rgba
    from manus_tpu_torch.data.synthetic import (
        hemisphere_cameras,
        sample_gaussians_on_bones,
    )
    from manus_tpu_torch.ops.skinning import (
        bone_deformation_transforms,
        skin_gaussians,
    )
    from manus_tpu_torch.preprocess.novel_pose import \
        generate_flexion_sequence
    from manus_tpu_torch.utils.transforms import \
        covariance_from_scaling_rotation

    torch.manual_seed(SEED)
    nframes = sum(len(f) for _, f in CAPTURE_FRAMES)
    skel = hand20_skeleton()
    seq = generate_flexion_sequence(skel, num_frames=nframes, device="cpu")
    heads, tails, rest = (seq["rest_heads"], seq["rest_tails"],
                          seq["rest_matrixs"])
    pts, cols = sample_gaussians_on_bones(heads, tails, rest,
                                          CAPTURE_GT_PER_BONE, seed=11)
    j, n = heads.shape[0], pts.shape[0]
    bone_of = np.concatenate([
        np.tile(np.arange(j), CAPTURE_GT_PER_BONE),
        np.tile(np.arange(j), CAPTURE_GT_PER_BONE // 2)])
    rng = np.random.RandomState(12)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32))

    cov = covariance_from_scaling_rotation(
        t(rng.uniform(0.002, 0.005, (n, 3))), t(rng.normal(size=(n, 4))))
    skin, colors = t(np.eye(j)[bone_of]), t(cols)
    opacity = t(rng.uniform(0.7, 0.98, n))
    center = (heads.mean(0) + tails.mean(0)) / 2
    cams = hemisphere_cameras(views, width, height, dist=CAPTURE_DIST,
                              fov_deg=CAPTURE_FOV, seed=13, center=center,
                              device="cpu")
    names = brics_names(views)
    # K/ and extr/ in creation order other than the names' (track_order)
    order = names[1::2] + names[0::2]
    out, f = {}, 0
    for action, frames in CAPTURE_FRAMES:
        tree = {"K": {m: cams[names.index(m)].K.double().numpy()
                      for m in order},
                "extr": {m: cams[names.index(m)].extr.double().numpy()[:3]
                         for m in order},
                "frames": {},
                "mano_rest": {
                    "verts": rng.rand(10, 3).astype(np.float32),
                    "faces": rng.randint(0, 10, (6, 3)).astype(np.int32)}}
        for fno in frames:
            sk = skin_gaussians(t(pts), cov, skin, bone_deformation_transforms(
                t(seq["pose_matrixs"][f]), t(rest)))
            images, bbox = {}, {}
            for m in order:
                rgba = render_rgba(sk.posed_xyz, sk.posed_cov, colors,
                                   opacity, cams[names.index(m)], "cpu",
                                   backend="torch")
                bbox[m], images[m] = crop_rgba(rgba, CAPTURE_MARGIN)
            md = {
                "bnames": np.asarray(
                    [b.encode() for b in skel["bnames"]])[:, None],
                "bnames_parent": np.asarray(
                    [b.encode() for b in skel["bnames_parent"]])[:, None],
                "rest_heads": heads, "rest_tails": tails,
                "rest_matrixs": rest,
                "pose_heads": seq["pose_heads"][f],
                "pose_tails": seq["pose_tails"][f],
                "pose_matrixs": seq["pose_matrixs"][f],
                "eulers": np.zeros((j, 3), np.float32),
                "root_translation": np.zeros(3, np.float32),
                "root_rotation": np.zeros(3, np.float32)}
            tree["frames"][fno] = {"images": images, "bbox": bbox,
                                   "metadata": md}
            f += 1
        out[action] = tree
    return out


def write_h5py_tree(group, tree, crop_kw=None):
    """tree ({name: array or dict}) into an h5py group in its order, every
    group tracking creation order; the crops under images/ with
    crop_kw(crop)'s chunking and filters."""
    for name, value in tree.items():
        if isinstance(value, dict):
            write_h5py_tree(group.create_group(name, track_order=True),
                            value, crop_kw)
        elif crop_kw is not None and group.name.endswith("/images"):
            group.create_dataset(name, data=value, **crop_kw(value))
        else:
            group.create_dataset(name, data=value)


# action -> how its crops are stored: in 64x64 chunks with lzf (a fixed
# array index, partial edge chunks) and whole, one chunk, with gzip,
# shuffle and fletcher32 (a filtered single-chunk index)
CAPTURE_CROPS = {
    "grasp_a": lambda c: dict(chunks=(min(64, c.shape[0]),
                                      min(64, c.shape[1]), 4),
                              compression="lzf"),
    "grasp_b": lambda c: dict(chunks=c.shape, compression="gzip",
                              shuffle=True, fletcher32=True),
}


def write_capture(out: str, trees: dict):
    """One action file a tree, as CAPTURE_CROPS says."""
    import h5py

    os.makedirs(out, exist_ok=True)
    for action, tree in trees.items():
        with h5py.File(os.path.join(out, f"{action}.hdf5"), "w",
                       libver="latest", track_order=True) as f:
            write_h5py_tree(f, tree, CAPTURE_CROPS[action])


def write_manifest(out: str) -> dict:
    import h5py

    files = sorted(
        os.path.relpath(os.path.join(d, f), out)
        for d, _, fs in os.walk(out) for f in fs
        if f.endswith((".h5", ".hdf5")))
    result = {}
    for rel in files:
        with h5py.File(os.path.join(out, rel), "r") as f:
            result[rel] = manifest(f)
    with open(os.path.join(out, "manifest.json"), "w") as fh:
        json.dump(result, fh, indent=0, sort_keys=True)
        fh.write("\n")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    write_forms(args.out)
    write_capture(os.path.join(args.out, "capture"), render_capture())
    result = write_manifest(args.out)
    total = sum(os.path.getsize(os.path.join(d, f))
                for d, _, fs in os.walk(args.out) for f in fs)
    print(f"{len(result)} files, {total / 2 ** 20:.3f} MiB under "
          f"{args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
