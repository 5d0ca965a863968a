"""The port's HDF5 reader and writer (manus_tpu_torch/data/hdf5.py) against
h5py, on small files written here and on the committed fixtures of
tests/data/hdf5_forms/ (scripts/torch_hdf5_fixtures.py): every group, key
and its order, shape, dtype (with h5py's dtype metadata) and value equal,
bit for bit; corrupted checksums raise OSError; each form the reader
refuses raises NotImplementedError naming it."""
import json
import os
import sys
import threading

import numpy as np
import pytest

from manus_tpu_torch.data import hdf5, hdf5_filters
from manus_tpu_torch.utils import cuda_build
from scripts import torch_hdf5_fixtures as fixtures

h5py = pytest.importorskip("h5py")

FIXTURES = fixtures.OUT
with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    MANIFEST = json.load(_f)


def _same_values(want, got, where):
    """Equal values: bytes, arrays of numbers bit for bit, object arrays
    (variable-length data) element by element, structured field by
    field."""
    if isinstance(want, bytes):
        assert isinstance(got, bytes) and got == want, where
        return
    assert type(got) is type(want), where
    want, got = np.asarray(want), np.asarray(got)
    assert got.dtype == want.dtype and got.shape == want.shape, where
    if not want.dtype.hasobject:
        assert got.tobytes() == want.tobytes(), where
    elif want.dtype.names is not None:
        for name in want.dtype.names:
            _same_values(want[name], got[name], f"{where}.{name}")
    else:
        for w, g in zip(want.reshape(-1), got.reshape(-1)):
            _same_values(w, g, where)


def _same_tree(want, got, path="/"):
    """Every member of h5py's `want` in the reader's `got`, in h5py's
    order, with equal shapes, dtypes, Python types and bytes."""
    assert list(got.keys()) == list(want.keys()), path
    for name in want.keys():
        w, g = want.get(name), got.get(name)
        if w is None:  # a dangling link: listed, in the group, unreadable
            assert g is None and name in got, path + name
            with pytest.raises(KeyError):
                got[name]
            continue
        if isinstance(w, h5py.Group):
            assert isinstance(g, hdf5.Group), path + name
            _same_tree(w, g, path + name + "/")
            continue
        if isinstance(w, h5py.Datatype):
            assert isinstance(g, hdf5.Datatype), path + name
            assert g.dtype == w.dtype, path + name
            continue
        assert isinstance(g, hdf5.Dataset), path + name
        assert g.shape == w.shape and g.size == w.size, path + name
        assert g.dtype == w.dtype, path + name
        assert (g.dtype.metadata or {}) == (w.dtype.metadata or {}), \
            path + name
        wv, gv = w[()], g[()]
        if isinstance(wv, h5py.Empty):
            assert isinstance(gv, hdf5.Empty) and gv.dtype == wv.dtype
            continue
        _same_values(wv, gv, path + name)
        if w.shape:
            _same_values(w[:], g[:], path + name)


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


@pytest.mark.parametrize("libver", ["earliest", "latest"])
def test_track_order_group_lists_in_creation_order(libver, tmp_path):
    """A compact group that tracks creation order (track_order=True) lists
    its members in that order in h5py, not by name."""
    path = tmp_path / "track.h5"
    with h5py.File(path, "w", libver=libver) as f:
        g = f.create_group("g", track_order=True)
        for name in ("cam2", "cam0", "cam1"):
            g[name] = np.arange(2)
        f.create_group("by_name")["b"] = 1
        f["by_name"]["a"] = 2
    with h5py.File(path, "r") as want, hdf5.File(path) as got:
        assert list(want["g"].keys()) == ["cam2", "cam0", "cam1"]
        _same_tree(want, got)


@pytest.mark.parametrize("form", ["dense_links", "lzf", "v4_chunk_index",
                                  "compound", "soft_link"])
def test_once_refused_forms_read_as_h5py_does(form, tmp_path):
    """The forms the reader refused before it read them (dense groups,
    lzf, layout-v4 chunk indexes, compound types, soft links)."""
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
    with h5py.File(path, "r") as want, hdf5.File(path) as got:
        _same_tree(want, got)


@pytest.mark.parametrize("form", sorted(fixtures.FORMS))
def test_forms_read_as_h5py_does(form, tmp_path):
    """Each form of scripts/torch_hdf5_fixtures.py, written here by h5py
    (every file it writes: some forms write one per libver), read equal
    to h5py."""
    fixtures.FORMS[form](str(tmp_path / f"{form}.h5"), h5py)
    for name in sorted(os.listdir(tmp_path)):
        with h5py.File(tmp_path / name, "r") as want, \
                hdf5.File(tmp_path / name) as got:
            _same_tree(want, got, f"{name}:/")


@pytest.mark.parametrize("name", sorted(MANIFEST))
def test_committed_fixtures_match_the_manifest(name):
    """tests/data/hdf5_forms/ as h5py reads it and as the reader reads it
    equal manifest.json, so a stale fixture fails here, not on the card."""
    path = os.path.join(FIXTURES, name)
    with h5py.File(path, "r") as f:
        assert fixtures.manifest(f) == MANIFEST[name]
    with hdf5.File(path) as f:
        assert fixtures.manifest(f) == MANIFEST[name]


def test_fixtures_stay_small():
    total = sum(os.path.getsize(os.path.join(d, f))
                for d, _, fs in os.walk(FIXTURES) for f in fs)
    assert total <= 2 * 2 ** 20


@pytest.mark.parametrize("form", ["object_reference", "region_reference",
                                  "virtual_dataset"])
def test_unsupported_forms_raise(form, tmp_path):
    """What the reader still refuses raises NotImplementedError naming
    it: references (h5py.Reference has no counterpart without h5py) and
    virtual datasets."""
    path = tmp_path / f"{form}.h5"
    with h5py.File(path, "w", libver="latest") as f:
        f["target"] = np.arange(4)
        if form == "object_reference":
            f.create_dataset("x", data=[f["target"].ref],
                             dtype=h5py.ref_dtype)
        elif form == "region_reference":
            f.create_dataset("x", data=[f["target"].regionref[1:3]],
                             dtype=h5py.regionref_dtype)
        else:
            layout = h5py.VirtualLayout(shape=(4,), dtype="i8")
            layout[:] = h5py.VirtualSource(f["target"])
            f.create_virtual_dataset("x", layout)
    match = "virtual" if form == "virtual_dataset" else "references"
    with hdf5.File(path) as f:
        with pytest.raises(NotImplementedError, match=match):
            f["x"][:]


def _flipped(src, dst, sig: bytes, at: int = 10):
    """A copy of src with one byte flipped `at` bytes into the first
    block with signature sig."""
    data = bytearray(open(src, "rb").read())
    pos = data.index(sig)
    data[pos + at] ^= 0xFF
    open(dst, "wb").write(bytes(data))
    return dst


@pytest.mark.parametrize("fixture,sig", [
    ("dense_links.h5", b"OHDR"), ("dense_links.h5", b"FRHP"),
    ("dense_links.h5", b"FHIB"), ("dense_links.h5", b"BTHD"),
    ("dense_links.h5", b"BTIN"), ("dense_links.h5", b"BTLF"),
    ("v4_chunk_indexes.h5", b"FAHD"), ("v4_chunk_indexes.h5", b"FADB"),
    ("v4_chunk_indexes.h5", b"EAHD"), ("v4_chunk_indexes.h5", b"EAIB"),
    ("extensible_paged.h5", b"EASB"), ("extensible_paged.h5", b"EADB"),
    ("creation_order.h5", b"\x89HDF")])
def test_corrupted_checksum_raises(fixture, sig, tmp_path):
    """One byte changed in a block the format checksums: OSError, as
    h5py's HDF5 raises, when the reader gets to it."""
    path = _flipped(os.path.join(FIXTURES, fixture), tmp_path / fixture,
                    sig)
    with pytest.raises(OSError, match="checksum"):
        with hdf5.File(path) as f:
            fixtures.manifest(f)


def test_corrupted_continuation_block_raises(tmp_path):
    """A v2 object header continued in an OCHK block (attributes added
    after the dataset) is read, and checked."""
    path = tmp_path / "ochk.h5"
    with h5py.File(path, "w", libver="latest") as f:
        f["x"] = np.arange(3)
        for i in range(3):  # compact attributes past the first chunk
            f["x"].attrs[f"a{i}"] = np.arange(2000)
    with h5py.File(path, "r") as want, hdf5.File(path) as got:
        _same_tree(want, got)
    _flipped(path, tmp_path / "bad.h5", b"OCHK")
    with pytest.raises(OSError, match="checksum"):
        with hdf5.File(tmp_path / "bad.h5") as f:
            f["x"][:]


def test_corrupted_fletcher32_chunk_raises(tmp_path):
    path = tmp_path / "f32.h5"
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=np.arange(40, dtype="i4"), chunks=(10,),
                         fletcher32=True)
        at = f["x"].id.get_chunk_info(2).byte_offset
    data = bytearray(path.read_bytes())
    data[at + 3] ^= 0x01
    path.write_bytes(bytes(data))
    with h5py.File(path, "r") as f, pytest.raises(OSError):
        f["x"][:]
    with hdf5.File(path) as f, pytest.raises(OSError, match="fletcher32"):
        f["x"][:]


@pytest.mark.parametrize("data", [b"", b"\x00", b"ab", b"abc",
                                  bytes(range(256)) * 9 + b"\x07"])
def test_fletcher32_matches_what_hdf5_stores(data, tmp_path):
    """The checksum HDF5 appends to a chunk, for odd and even lengths."""
    if not data:
        assert hdf5_filters.fletcher32(b"") == 0
        return
    path = tmp_path / "f.h5"
    arr = np.frombuffer(data, np.uint8)
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=arr, chunks=arr.shape, fletcher32=True)
        _, raw = f["x"].id.read_direct_chunk((0,))
    assert raw[:-4] == data
    assert hdf5_filters.fletcher32(data) == int.from_bytes(raw[-4:],
                                                           "little")


def test_soft_and_external_links(tmp_path, monkeypatch):
    """A dangling soft link is listed and `in` its group but reads as
    KeyError; an external link opens its file relative to the linking
    file's directory, whatever the working directory, and the handle
    closes with the linking file."""
    fixtures.links(str(tmp_path / "links.h5"), h5py)
    monkeypatch.chdir(os.path.dirname(FIXTURES))
    with hdf5.File(tmp_path / "links.h5") as f:
        assert "dangling" in f.keys() and "dangling" in f
        assert f.get("dangling") is None and "nowhere" not in f
        with pytest.raises(KeyError):
            f["dangling"]
        np.testing.assert_array_equal(f["ext"][:], np.arange(5.0))
        assert f["ext_group/y"][()] == np.int16(3)
        np.testing.assert_array_equal(f["a/b/soft_rel"][:], np.ones(2))
        assert "soft_group/z" in f and "dangling/x" not in f
        (ext,) = f._externals.values()
    assert ext._mm is None


def _lzf_chunks(path):
    """(stored bytes, unfiltered bytes) of every lzf-filtered chunk of
    the file's datasets, through h5py."""
    out = []

    def visit(name, obj):
        if isinstance(obj, h5py.Dataset) and obj.compression == "lzf" \
                and not obj.shuffle:
            for i in range(obj.id.get_num_chunks()):
                info = obj.id.get_chunk_info(i)
                mask, raw = obj.id.read_direct_chunk(info.chunk_offset)
                if mask == 0:
                    sl = tuple(slice(o, o + c) for o, c in
                               zip(info.chunk_offset, obj.chunks))
                    block = np.zeros(obj.chunks, obj.dtype)
                    part = obj[sl]
                    block[tuple(slice(0, n) for n in part.shape)] = part
                    out.append((raw, block.tobytes()))

    with h5py.File(path, "r") as f:
        f.visititems(visit)
    return out


def test_lzf_cpp_equals_python(tmp_path):
    """The C++ decoder and the Python one give the bytes h5py reads, on
    random and smooth data and on the committed capture's crops."""
    rng = np.random.RandomState(3)
    path = tmp_path / "lzf.h5"
    with h5py.File(path, "w") as f:
        f.create_dataset("random", data=rng.randint(0, 4, 5000, np.uint8),
                         chunks=(1000,), compression="lzf")
        f.create_dataset("smooth", data=np.repeat(np.arange(300), 40),
                         chunks=(4000,), compression="lzf")
    chunks = _lzf_chunks(path) + _lzf_chunks(os.path.join(
        FIXTURES, "capture", "grasp_a.hdf5"))
    assert len(chunks) > 20
    for raw, want in chunks:
        assert hdf5_filters.lzf_decompress(raw, len(want)) == want
        assert hdf5_filters.lzf_decompress_py(raw, len(want)) == want
    with pytest.raises(OSError, match="lzf"):
        hdf5_filters.lzf_decompress(b"\x20\x00", 100)  # refers back


def test_failed_hdf5_filters_build_raises(monkeypatch, tmp_path):
    """A source that does not compile raises; nothing falls back."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "hdf5_filters.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(cuda_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_build, "_loaded", {})
    with pytest.raises(RuntimeError, match="build failed"):
        hdf5_filters.lzf_decompress(b"\x00a", 1)


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


def test_threads_read_a_latest_capture():
    """As above on the committed capture (libver "latest"): v2 headers
    and their cache, dense groups, fixed-array and single-chunk indexes,
    lzf in C++ and gzip + fletcher32, read by many threads at once."""
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    errors = []
    root = os.path.join(FIXTURES, "capture")
    try:
        with hdf5.File(os.path.join(root, "grasp_a.hdf5")) as fa, \
                hdf5.File(os.path.join(root, "grasp_b.hdf5")) as fb:
            want = {name: fixtures.manifest(f)
                    for name, f in (("a", fa), ("b", fb))}

            def work():
                try:
                    for _ in range(2):
                        assert fixtures.manifest(fa) == want["a"]
                        assert fixtures.manifest(fb) == want["b"]
                except AssertionError as e:
                    errors.append(e)

            threads = [threading.Thread(target=work) for _ in range(12)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(prev)
    assert not errors
    assert want["a"] == MANIFEST["capture/grasp_a.hdf5"]


def test_user_block_offsets_match_h5py():
    """offset() of contiguous data counts the user block, as h5py's
    get_offset does."""
    for name in ("user_block.h5", "user_block_latest.h5"):
        path = os.path.join(FIXTURES, name)
        with h5py.File(path, "r") as want, hdf5.File(path) as got:
            assert want.userblock_size in (512, 1024)
            assert got["x"].offset() == want["x"].id.get_offset()

