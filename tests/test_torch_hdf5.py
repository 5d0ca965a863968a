"""The port's HDF5 reader and writer (manus_tpu_torch/data/hdf5.py) against
h5py, on small files written here: every group, key, shape, dtype and
value equal, bit for bit; each unsupported form raises
NotImplementedError naming it."""
import sys
import threading

import numpy as np
import pytest

from manus_tpu_torch.data import hdf5

h5py = pytest.importorskip("h5py")


def _same_tree(want, got, path="/"):
    """Every member of h5py's `want` in the reader's `got`, in h5py's
    order, with equal shapes, dtypes, Python types and bytes."""
    assert list(got.keys()) == list(want.keys()), path
    for name in want.keys():
        w, g = want[name], got[name]
        if isinstance(w, h5py.Group):
            assert isinstance(g, hdf5.Group), path + name
            _same_tree(w, g, path + name + "/")
            continue
        assert isinstance(g, hdf5.Dataset), path + name
        assert g.shape == w.shape, path + name
        wv, gv = w[()], g[()]
        if h5py.check_string_dtype(w.dtype) is not None \
                and w.dtype.kind == "O":
            assert g.dtype.kind == "O"
            assert np.asarray(gv, object).tolist() == \
                np.asarray(wv, object).tolist(), path + name
            continue
        assert g.dtype == w.dtype, path + name
        assert type(gv) is type(wv), path + name
        assert np.asarray(gv).tobytes() == np.asarray(wv).tobytes(), \
            path + name
        if w.shape:
            assert np.asarray(g[:]).tobytes() == np.asarray(w[:]).tobytes()


def _numbers(g, rng):
    g["i64"] = np.arange(10, dtype=np.int64)
    g["u8"] = rng.randint(0, 256, (7, 5, 4), np.uint8)
    g["f32_be"] = rng.rand(3, 4).astype(">f4")
    g["i16_be"] = rng.randint(-300, 300, 9).astype(">i2")
    g["f64"] = rng.rand(5)
    g["f16"] = rng.rand(5).astype(np.float16)
    g["scalar_f"] = 3.5
    g["scalar_i"] = np.int32(-7)


def _strings(g):
    g["fixed"] = np.asarray([b"bone_1", b"b2", b"x"])[:, None]
    g["vlen"] = np.array(["hello", "wörld", ""],
                         dtype=h5py.string_dtype())
    g["vlen_scalar"] = "a scalar string"
    g.create_dataset("unwritten", shape=(4, 3), dtype="f4", fillvalue=7.0)
    g.create_dataset("unwritten_0", shape=(4,), dtype="i4")


def _compact(g, name, data):
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_layout(h5py.h5d.COMPACT)
    space = h5py.h5s.create_simple(data.shape)
    h5py.h5d.create(g.id, name.encode(), h5py.h5t.NATIVE_INT32, space,
                    dcpl=dcpl).write(h5py.h5s.ALL, h5py.h5s.ALL, data)


@pytest.fixture(scope="module")
def default_file(tmp_path_factory):
    """A file of h5py's default libver: symbol-table groups, every
    supported type, chunked data with filters, a 300-member group."""
    path = tmp_path_factory.mktemp("h5") / "default.h5"
    rng = np.random.RandomState(0)
    with h5py.File(path, "w") as f:
        _numbers(f, rng)
        _strings(f.create_group("strings"))
        _compact(f, "compact", np.arange(6, dtype=np.int32))
        f.create_group("a/b/c")["x"] = np.ones((2, 2))
        f.create_group("empty")
        f.create_dataset("gzip_shuffle", data=rng.rand(50, 37).astype("f4"),
                         chunks=(16, 10), compression="gzip", shuffle=True)
        f.create_dataset("fletcher", data=rng.randint(0, 1000, (33, 5)),
                         chunks=(8, 5), fletcher32=True, compression="gzip")
        part = f.create_dataset("partial", shape=(40, 40), dtype="i2",
                                chunks=(16, 16), fillvalue=-3)
        part[0:10, 20:30] = 5
        many = f.create_group("many")
        for i in range(300):
            many[str(i)] = np.asarray([i, i + 1])
    return path


def test_default_libver_file_reads_as_h5py_does(default_file):
    with h5py.File(default_file, "r") as want, hdf5.File(default_file) as got:
        _same_tree(want, got)
        assert got["a/b/c/x"].shape == (2, 2)
        assert "a/b" in got and "a/z" not in got
        assert got.get("nothing") is None
        assert len(got["many"]) == 300


def test_a_300_member_group_has_a_deep_btree(default_file):
    """h5py's symbol nodes hold 8 entries and a B-tree node 32 children, so
    300 members need a second B-tree level, which the reader walks."""
    with hdf5.File(default_file) as f:
        stab = f["many"]._hdr.find(hdf5.MSG_SYMBOL_TABLE)
        btree = int.from_bytes(stab[:8], "little")
        assert f._r.buf[btree + 5] >= 1  # the node's level
        assert sorted(f["many"].keys(), key=int) == [str(i)
                                                     for i in range(300)]
        np.testing.assert_array_equal(f["many"]["299"][:], [299, 300])


def test_deleted_and_recreated_members(default_file, tmp_path):
    path = tmp_path / "edited.h5"
    path.write_bytes(default_file.read_bytes())
    with h5py.File(path, "r+") as f:
        del f["i64"]
        f["i64"] = np.arange(3, dtype=np.int16)
        del f["many"]["17"]
        f["many"]["17"] = np.asarray([1.5])
        del f["a/b/c/x"]
        del f["many"]["250"]
    with h5py.File(path, "r") as want, hdf5.File(path) as got:
        _same_tree(want, got)
        assert "250" not in got["many"]


def test_latest_libver_compact_links(tmp_path):
    """libver="latest": superblock 3, v2 object headers, link messages in
    groups of at most 8 members, layout v4 contiguous and compact, fill
    value message v3."""
    path = tmp_path / "latest.h5"
    rng = np.random.RandomState(1)
    with h5py.File(path, "w", libver="latest") as f:
        _numbers(f.create_group("numbers"), rng)
        _strings(f.create_group("strings"))
        _compact(f, "compact", np.arange(4, dtype=np.int32))
        f.create_group("a/b")["x"] = np.ones((2, 3), np.float32)
    with h5py.File(path, "r") as want, hdf5.File(path) as got:
        assert got._r.buf[8] == 3  # the superblock's version
        _same_tree(want, got)


@pytest.mark.parametrize("form", ["dense_links", "lzf", "v4_chunk_index",
                                  "compound", "soft_link"])
def test_unsupported_forms_raise(form, tmp_path):
    path = tmp_path / f"{form}.h5"
    libver = "latest" if form in ("dense_links", "v4_chunk_index") \
        else "earliest"
    with h5py.File(path, "w", libver=libver) as f:
        if form == "dense_links":  # more than 8 links: a fractal heap
            g = f.create_group("g")
            for i in range(20):
                g[str(i)] = np.arange(2)
        elif form == "lzf":
            f.create_dataset("x", data=np.arange(100), chunks=(10,),
                             compression="lzf")
        elif form == "soft_link":
            f["x"] = np.arange(3)
            f["g/y"] = h5py.SoftLink("/x")
        elif form == "v4_chunk_index":
            f.create_dataset("x", data=np.arange(100), chunks=(10,))
        else:
            f["x"] = np.zeros(3, [("a", "f4"), ("b", "i2")])
    match = {"dense_links": "dense link storage", "lzf": "lzf",
             "v4_chunk_index": "layout-v4 chunk index",
             "compound": "compound types", "soft_link": "soft links"}[form]
    with hdf5.File(path) as f:
        with pytest.raises(NotImplementedError, match=match):
            f["g"].keys() if form in ("dense_links", "soft_link") \
                else f["x"][:]


def test_not_hdf5_raises_oserror(tmp_path):
    for data in (b"this is not hdf5 at all, nor anything", b"",
                 b"\x89HD"):
        path = tmp_path / "junk.hdf5"
        path.write_bytes(data)
        with pytest.raises(OSError, match="not an HDF5 file"):
            hdf5.File(path)


def test_write_tree_reads_back_in_h5py(tmp_path):
    rng = np.random.RandomState(2)
    tree = {
        "K": {f"cam{i:03d}": rng.rand(3, 3) for i in range(60)},
        "frames": {"0": {
            "images": {"cam000": rng.randint(0, 256, (5, 6, 4), np.uint8)},
            "metadata": {
                "bnames": np.asarray([b"a", b"bone_2"])[:, None],
                "scalar": np.float32(2.5),
                "be": np.arange(3).astype(">i4"),
                "f16": rng.rand(4).astype(np.float16)}}},
        "empty": {},
        "zero": np.zeros((0, 3), np.float32),
    }
    path = hdf5.write_tree(tmp_path / "w.hdf5", tree)
    with h5py.File(path, "r") as want, hdf5.File(path) as got:
        _same_tree(want, got)
        np.testing.assert_array_equal(want["K/cam059"][:],
                                      tree["K"]["cam059"])
        assert want["frames/0/metadata/scalar"][()] == np.float32(2.5)
        assert want["frames/0/metadata/bnames"][:].tolist() == \
            [[b"a"], [b"bone_2"]]
        assert want["frames/0/metadata/be"].dtype == np.dtype(">i4")
        for name in ("K/cam003", "frames/0/images/cam000"):
            assert got[name].offset() == want[name].id.get_offset()
        assert got["zero"].offset() is None
    with pytest.raises(NotImplementedError):
        hdf5.write_tree(tmp_path / "x.hdf5", {"o": np.zeros(2, object)})


def test_threads_read_one_file(default_file):
    """The prefetch thread and the main thread read one File: no shared
    seek position, so every read is right under preemption."""
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    errors = []
    try:
        with hdf5.File(default_file) as f, h5py.File(default_file,
                                                      "r") as ref:
            want = {k: ref["many"][k][:] for k in ("3", "150", "299")}
            gz = ref["gzip_shuffle"][:]

            def work():
                try:
                    for _ in range(20):
                        for k, v in want.items():
                            assert np.array_equal(f["many"][k][:], v)
                        assert np.array_equal(f["gzip_shuffle"][:], gz)
                except AssertionError as e:
                    errors.append(e)

            threads = [threading.Thread(target=work) for _ in range(12)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(prev)
    assert not errors
