"""A read-only HDF5 reader in numpy and zlib, and a small writer.

The BRICS captures are HDF5 files, and the card's machine has no h5py.
`File` reads what h5py writes, through the part of h5py's API that the
loaders and the validator use, and gives what h5py gives:

- groups: keys, items, get, `in`, `[name]` and `["a/b"]` (`["/a"]` from
  the root), iteration, len, in h5py's order (by creation order where the
  group tracks it, else by name);
- datasets: shape, dtype, size, `[()]`, `[:]` (the whole array; any
  other index is applied to it), and offset() of contiguous data;
- committed datatypes as members (`Datatype`, with its dtype).

Supported: superblock versions 0-3, also after a user block; object
headers v1 and v2 with continuation blocks; groups as symbol tables (v1
B-tree, symbol nodes, local heap), as compact link messages, and in dense
storage (a fractal heap indexed by a v2 B-tree); hard, soft and external
links (an external file opens relative to the linking file's directory
and stays open with it); contiguous, compact and chunked data, the chunks
indexed by a v1 B-tree or by a layout-v4 index (single chunk, implicit,
fixed array, extensible array, v2 B-tree); the deflate, shuffle,
fletcher32, lzf, szip, scaleoffset and nbit filters
(data/hdf5_filters.py);
integers (any precision and bit offset), bitfields, floats (IEEE and x87
long double) of either byte order, fixed- and variable-length strings,
opaque, compound (h5py's complex too), enum (h5py's bool too), array and
variable-length sequence types, and datatypes shared with a committed
one; scalar, simple and null dataspaces (a null one reads as `Empty`, as
h5py.Empty); the fill value where data was never written. Every checksum
the format stores (v2 object headers and their continuation blocks, the
v2 superblock, fractal heap, v2 B-tree, fixed and extensible array
blocks, the fletcher32 filter) is verified; a mismatch raises OSError.

Refused, with NotImplementedError naming the form: messages in a
shared-message table (SOHM), object and region references, filters
other than those above, virtual datasets, huge fractal heap objects,
and time types.

The file is read through one read-only mmap, with no shared seek
position, so several threads may read one File (the trainer's prefetch
thread calls the dynamic dataset's get_batch).

`write_tree` writes a nested dict of arrays as superblock 0, symbol-table
groups and contiguous datasets (numbers and fixed-length strings), which
h5py reads; it makes captures on a machine without h5py.
"""
from __future__ import annotations

import mmap
import os
import struct
from typing import Optional

import numpy as np

from manus_tpu_torch.data import hdf5_filters as filters_mod
from manus_tpu_torch.data import hdf5_index as index

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = index.UNDEF

# object header message types
MSG_NIL, MSG_DATASPACE, MSG_LINK_INFO, MSG_DATATYPE = 0x0, 0x1, 0x2, 0x3
MSG_FILL_OLD, MSG_FILL, MSG_LINK, MSG_LAYOUT = 0x4, 0x5, 0x6, 0x8
MSG_FILTERS, MSG_CONTINUATION, MSG_SYMBOL_TABLE = 0xB, 0x10, 0x11

# the most soft links one lookup follows (HDF5's default H5P nlinks)
MAX_SOFT_HOPS = 16


class _Reader:
    """Little-endian fields of the mapped file at absolute offsets; every
    address the file stores is relative to `base` (the superblock's base
    address, past a user block) and comes back absolute, UNDEF as is."""

    def __init__(self, buf, size_o: int = 8, size_l: int = 8, base: int = 0):
        self.buf = buf
        self.size_o, self.size_l, self.base = size_o, size_l, base
        self._undef = (1 << (8 * size_o)) - 1

    def uint(self, pos: int, n: int) -> int:
        return int.from_bytes(self.buf[pos:pos + n], "little")

    def bytes(self, pos: int, n: int) -> bytes:
        return bytes(self.buf[pos:pos + n])

    def addr_in(self, body, pos: int) -> int:
        """The address stored in `body` at pos."""
        v = int.from_bytes(body[pos:pos + self.size_o], "little")
        return UNDEF if v == self._undef else v + self.base

    def addr(self, pos: int) -> int:
        return self.addr_in(self.buf, pos)

    def length(self, pos: int) -> int:
        return self.uint(pos, self.size_l)

    def check(self, pos: int, sig: bytes, what: str):
        if self.buf[pos:pos + 4] != sig:
            raise OSError(f"HDF5: no {what} signature at {pos}")


class Empty:
    """The value of a dataset with a null dataspace (h5py.Empty)."""

    shape = size = None

    def __init__(self, dtype):
        self.dtype = np.dtype(dtype)

    def __eq__(self, other):
        return isinstance(other, Empty) and other.dtype == self.dtype

    def __repr__(self):
        return f"Empty(dtype={self.dtype!r})"


# ---------------------------------------------------------------------------
# dataspaces and datatypes


def _parse_dataspace(d: bytes, size_l: int):
    """(shape, maxshape) of a dataspace message, None in maxshape for an
    unlimited dimension; (None, None) for a null dataspace."""
    version, rank, flags = d[0], d[1], d[2]
    if version == 1:
        pos = 8
    elif version == 2:
        if d[3] == 2:
            return None, None
        pos = 4
    else:
        raise NotImplementedError(f"HDF5 dataspace message version {version}")

    def dims(p):
        return tuple(int.from_bytes(d[p + i * size_l:p + (i + 1) * size_l],
                                    "little") for i in range(rank))

    shape = dims(pos)
    if not flags & 0x01:
        return shape, shape
    return shape, tuple(None if m == (1 << 8 * size_l) - 1 else m
                        for m in dims(pos + rank * size_l))


class _Type:
    """A parsed datatype: the numpy dtype h5py gives for it, its size in
    the file, its size in HDF5's memory layout (which sets a compound's
    offsets in h5py's dtype: a variable-length string takes a pointer's 8
    bytes there, a sequence 16), and `decode`, which turns stored elements
    ([n, size] uint8) into values ([n] and any array dimensions), or None
    where the stored bytes are the values."""

    def __init__(self, dtype: np.dtype, size: int, decode=None,
                 mem_size: Optional[int] = None):
        self.dtype, self.size, self.decode = dtype, size, decode
        self.mem_size = size if mem_size is None else mem_size

    def values(self, raw: np.ndarray, file) -> np.ndarray:
        if self.decode is not None:
            return self.decode(raw, file)
        n = raw.shape[0]
        raw = np.ascontiguousarray(raw)
        sub = self.dtype.subdtype
        if sub is not None:
            return raw.view(sub[0]).reshape((n,) + sub[1])
        return raw.view(self.dtype).reshape(n)


def _name_at(d: bytes, pos: int, padded: bool):
    """A null-terminated name at pos and the position after it (padded to
    a multiple of 8 bytes, terminator included, where `padded`)."""
    end = d.index(b"\0", pos)
    return d[pos:end], (pos + (end - pos) // 8 * 8 + 8 if padded
                        else end + 1)


def _int_decode(dt: np.dtype, offset: int, precision: int, signed: bool):
    """Integers of `precision` bits above bit `offset` of their storage,
    sign-extended where signed, as HDF5 converts them to the full width."""
    udt = np.dtype(f"{dt.byteorder}u{dt.itemsize}")
    bits = 8 * dt.itemsize
    mask = (1 << precision) - 1

    def decode(raw, file):
        u = np.ascontiguousarray(raw).view(udt).reshape(-1).astype(np.uint64)
        v = (u >> np.uint64(offset)) & np.uint64(mask)
        if signed and precision < bits:
            neg = (v >> np.uint64(precision - 1)) & np.uint64(1)
            v = v | (neg * np.uint64(((1 << bits) - 1) ^ mask))
        return v.astype(f"<u{dt.itemsize}").view(
            f"<{dt.kind}{dt.itemsize}").astype(dt)

    return decode


def _vlen_records(raw, file):
    """(length, global heap address, object index) of every stored
    variable-length element."""
    o = file._r.size_o
    for rec in np.ascontiguousarray(raw):
        b = rec.tobytes()
        n = int.from_bytes(b[:4], "little")
        yield n, file._r.addr_in(b, 4), int.from_bytes(b[4 + o:8 + o],
                                                       "little")


def _vlen_string_decode(raw, file):
    out = np.empty(raw.shape[0], object)
    for i, (n, addr, idx) in enumerate(_vlen_records(raw, file)):
        out[i] = file._gheap_object(addr, idx)[:n] if n else b""
    return out


def _vlen_sequence_decode(base: _Type):
    def decode(raw, file):
        out = np.empty(raw.shape[0], object)
        for i, (n, addr, idx) in enumerate(_vlen_records(raw, file)):
            data = b"" if not n else \
                file._gheap_object(addr, idx)[:n * base.size]
            elems = np.frombuffer(data, np.uint8).reshape(n, base.size)
            out[i] = base.values(elems, file)
        return out

    return decode


def _compound(d: bytes, pos: int, version: int, bits: int, size: int, r):
    members = []  # (name, file offset, type)
    for _ in range(bits & 0xFFFF):
        name, pos = _name_at(d, pos, version < 3)
        if version == 1:  # an old-style array member carries its dims
            off, ndims = int.from_bytes(d[pos:pos + 4], "little"), d[pos + 4]
            dims = struct.unpack_from("<4I", d, pos + 16)[:ndims]
            mt, pos = _parse_datatype(d, pos + 32, r)
            if ndims:
                mt = _array_of(mt, dims)
        else:
            w = 4 if version == 2 else (max(size, 1).bit_length() - 1) // 8 + 1
            off = int.from_bytes(d[pos:pos + w], "little")
            mt, pos = _parse_datatype(d, pos + w, r)
        members.append((name.decode("utf-8"), off, mt))
    members.sort(key=lambda m: m[1])
    names = [m[0] for m in members]
    types = [m[2] for m in members]
    # h5py's complex: r and i, floats of one type
    if (names == ["r", "i"] and types[0].dtype == types[1].dtype
            and types[0].dtype.kind == "f"):
        dt = types[0].dtype
        cdt = np.dtype(f"{dt.byteorder}c{2 * dt.itemsize}")
        if [m[1] for m in members] == [0, dt.itemsize] and \
                size == cdt.itemsize:
            return _Type(cdt, size), pos

        def complex_decode(raw, file):
            re = types[0].values(raw[:, members[0][1]:][:, :dt.itemsize],
                                 file)
            im = types[1].values(raw[:, members[1][1]:][:, :dt.itemsize],
                                 file)
            out = np.empty(raw.shape[0], cdt)
            out.real, out.imag = re, im
            return out

        return _Type(cdt, size, complex_decode), pos
    # offsets in HDF5's memory layout (H5T__set_loc): a member that
    # changes size there shifts every one after it
    mem_offs, shift = [], 0
    for _, off, mt in members:
        mem_offs.append(off + shift)
        shift += mt.mem_size - mt.size
    dt = np.dtype({"names": names, "formats": [t.dtype for t in types],
                   "offsets": mem_offs, "itemsize": size + shift})
    if shift == 0 and all(t.decode is None for t in types):
        return _Type(dt, size), pos

    def decode(raw, file):
        out = np.zeros(raw.shape[0], dt)
        for name, off, mt in members:
            out[name] = mt.values(raw[:, off:off + mt.size], file)
        return out

    return _Type(dt, size, decode, size + shift), pos


def _array_of(base: _Type, dims) -> _Type:
    dims = tuple(int(x) for x in dims)
    count = int(np.prod(dims, dtype=np.int64))
    dt = np.dtype((base.dtype, dims))
    decode = None
    if base.decode is not None:
        def decode(raw, file):
            n = raw.shape[0]
            vals = base.values(np.ascontiguousarray(raw).reshape(
                n * count, base.size), file)
            return vals.reshape((n,) + dims + vals.shape[1:])
    return _Type(dt, base.size * count, decode, base.mem_size * count)


def _parse_datatype(d: bytes, pos: int, r):
    """The datatype at d[pos:] and the position after it."""
    cls, version = d[pos] & 0x0F, d[pos] >> 4
    bits = d[pos + 1] | (d[pos + 2] << 8) | (d[pos + 3] << 16)
    size = int.from_bytes(d[pos + 4:pos + 8], "little")
    p = pos + 8
    order = ">" if bits & 1 else "<"
    if cls in (0, 4):  # fixed point, bitfield
        offset, precision = struct.unpack_from("<HH", d, p)
        if size not in (1, 2, 4, 8):
            raise NotImplementedError(f"HDF5 {size}-byte integers")
        signed = cls == 0 and bool(bits & 0x08)
        dt = np.dtype(f"{order}{'i' if signed else 'u'}{size}")
        decode = None if (offset, precision) == (0, 8 * size) else \
            _int_decode(dt, offset, precision, signed)
        return _Type(dt, size, decode), p + 4
    if cls == 1:  # floating point
        if bits & 0x40:
            raise NotImplementedError("HDF5 VAX-order floats")
        if size == 16 and np.dtype(np.longdouble).itemsize == 16 \
                and np.finfo(np.longdouble).nmant == 63 and d[p + 7] == 64:
            return _Type(np.dtype(f"{order}f16"), size), p + 12
        if size not in (2, 4, 8):
            raise NotImplementedError(f"HDF5 {size}-byte floats")
        return _Type(np.dtype(f"{order}f{size}"), size), p + 12
    if cls == 3:  # fixed-length string
        enc = "utf-8" if (bits >> 4) & 0x0F == 1 else "ascii"
        return _Type(np.dtype(f"S{size}", metadata={"h5py_encoding": enc}),
                     size), p
    if cls == 5:  # opaque, h5py's opaque_dtype when its tag says NUMPY:
        tag = d[p:p + (bits & 0xFF)].rstrip(b"\0")
        end = p + (bits & 0xFF)
        if tag.startswith(b"NUMPY:"):
            dt = np.dtype(tag[6:].decode("ascii"),
                          metadata={"h5py_opaque": True})
            if dt.itemsize == size:
                return _Type(dt, size), end
        return _Type(np.dtype(f"V{size}"), size), end
    if cls == 6:
        return _compound(d, p, version, bits, size, r)
    if cls == 8:  # enum over its base integer; FALSE/TRUE is h5py's bool
        base, p = _parse_datatype(d, p, r)
        names = []
        for _ in range(bits & 0xFFFF):
            name, p = _name_at(d, p, version < 3)
            names.append(name)
        n = len(names)
        vals = np.frombuffer(d[p:p + n * base.size], base.dtype, n).tolist()
        p += n * base.size
        members = dict(zip(names, vals))
        if members == {b"FALSE": 0, b"TRUE": 1}:
            if base.size == 1 and base.decode is None:
                return _Type(np.dtype(np.bool_), size), p

            def bool_decode(raw, file):
                return base.values(raw, file) != 0

            return _Type(np.dtype(np.bool_), size, bool_decode), p
        meta = {"enum": {k.decode("utf-8"): v for k, v in members.items()}}
        return _Type(np.dtype(base.dtype, metadata=meta), size,
                     base.decode), p
    if cls == 9:  # variable length: a string or a sequence of its base
        base, p = _parse_datatype(d, p, r)
        vsize = 4 + r.size_o + 4
        if bits & 0x0F == 1:
            kind = str if (bits >> 8) & 0x0F == 1 else bytes
            return _Type(np.dtype("O", metadata={"vlen": kind}), vsize,
                         _vlen_string_decode, 8), p
        return _Type(np.dtype("O", metadata={"vlen": base.dtype}), vsize,
                     _vlen_sequence_decode(base), 16), p
    if cls == 10:  # array
        ndims = d[p]
        p += 1 if version >= 3 else 4
        dims = struct.unpack_from(f"<{ndims}I", d, p)
        p += 4 * ndims * (1 if version >= 3 else 2)
        base, p = _parse_datatype(d, p, r)
        return _array_of(base, dims), p
    names = {2: "time types", 7: "object and region references"}
    raise NotImplementedError(
        f"HDF5 {names.get(cls, f'datatype class {cls}')}")


# ---------------------------------------------------------------------------
# object headers


class _Header:
    """The messages [(type, flags, data)] of one object header, the
    checksums of a v2 header and its continuation blocks verified."""

    def __init__(self, r: _Reader, addr: int):
        self.r = r
        self.messages = []
        if r.buf[addr:addr + 4] == b"OHDR":
            self._read_v2(r, addr)
        elif r.buf[addr] == 1:
            self._read_v1(r, addr)
        else:
            raise OSError(f"HDF5: no object header at {addr}")

    def _v1_block(self, r, pos, end, pending):
        while pos + 8 <= end:
            mtype, size, flags = struct.unpack_from("<HHB", r.buf, pos)
            self._add(r, mtype, flags, r.bytes(pos + 8, size), pending)
            pos += 8 + size

    def _read_v1(self, r, addr):
        pending = []
        self._v1_block(r, addr + 16, addr + 16 + r.uint(addr + 8, 4),
                       pending)
        while pending:
            pos, length = pending.pop(0)
            self._v1_block(r, pos, pos + length, pending)

    def _v2_block(self, r, pos, end, track_order, pending):
        while pos + 4 <= end:
            mtype, size, flags = r.buf[pos], r.uint(pos + 1, 2), r.buf[pos + 3]
            pos += 4 + (2 if track_order else 0)
            if pos + size > end:
                break
            self._add(r, mtype, flags, r.bytes(pos, size), pending)
            pos += size

    def _read_v2(self, r, addr):
        flags = r.buf[addr + 5]
        pos = addr + 6
        if flags & 0x20:
            pos += 16  # access, modification, change and birth times
        if flags & 0x10:
            pos += 4  # attribute phase change values
        nsize = 1 << (flags & 0x03)
        chunk0 = r.uint(pos, nsize)
        pos += nsize
        index.verify(r, addr, pos + chunk0, "object header")
        track = bool(flags & 0x04)
        pending = []
        self._v2_block(r, pos, pos + chunk0, track, pending)
        while pending:
            cpos, length = pending.pop(0)
            r.check(cpos, b"OCHK", "object header continuation")
            index.verify(r, cpos, cpos + length - 4,
                         "object header continuation block")
            # past the signature, before the checksum
            self._v2_block(r, cpos + 4, cpos + length - 4, track, pending)

    def _add(self, r, mtype, flags, body, pending):
        """Keep a message; queue a continuation block (offset, length)."""
        if mtype == MSG_CONTINUATION:
            pending.append((r.addr_in(body, 0), int.from_bytes(
                body[r.size_o:r.size_o + r.size_l], "little")))
        elif mtype != MSG_NIL:
            self.messages.append((mtype, flags, body))

    def find(self, mtype: int) -> Optional[bytes]:
        """The first message of mtype; one stored as shared (a committed
        datatype's) is read from the object header it points at."""
        for t, flags, body in self.messages:
            if t == mtype:
                return self._shared(mtype, body) if flags & 0x02 else body
        return None

    def _shared(self, mtype: int, body: bytes) -> bytes:
        version, kind = body[0], body[1]
        if version == 1:
            addr = self.r.addr_in(body, 8 + self.r.size_l)
        elif version in (2, 3) and (version == 2 or kind != 1):
            addr = self.r.addr_in(body, 2)
        elif version == 3:
            raise NotImplementedError(
                "HDF5 messages in a shared-message table (SOHM)")
        else:
            raise NotImplementedError(f"HDF5 shared message version "
                                      f"{version}")
        target = _Header(self.r, addr).find(mtype)
        if target is None:
            raise OSError(f"HDF5: shared message {mtype} not found at "
                          f"{addr}")
        return target

    def all(self, mtype: int) -> list:
        return [body for t, _, body in self.messages if t == mtype]


# ---------------------------------------------------------------------------
# the file


class File:
    """An HDF5 file opened for reading (h5py.File(path, "r") for the
    subset above). Raises OSError where the file is not HDF5."""

    def __init__(self, path, mode: str = "r"):
        if mode != "r":
            raise ValueError("hdf5.File reads only (mode 'r')")
        self.filename = os.fspath(path)
        self._mm = None
        self._externals: dict = {}  # path -> File of an external link
        with open(self.filename, "rb") as f:
            size = os.fstat(f.fileno()).st_size
            if size < len(SIGNATURE):
                raise OSError(f"{self.filename}: not an HDF5 file "
                              f"({size} bytes)")
            self._mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        self._gheaps: dict = {}
        self._groups: dict = {}  # address -> Group, links read once
        self._headers: dict = {}  # address -> _Header, checked once
        try:
            self._r, root = self._read_superblock(
                self._find_superblock(size))
        except BaseException:
            self.close()
            raise
        self._root = Group(self, root, "/")

    def _find_superblock(self, size: int) -> int:
        pos = 0
        while pos + len(SIGNATURE) <= size:
            if self._mm[pos:pos + len(SIGNATURE)] == SIGNATURE:
                return pos
            pos = 512 if pos == 0 else pos * 2
        raise OSError(f"{self.filename}: not an HDF5 file (no signature)")

    def _read_superblock(self, sb: int):
        mm = self._mm
        version = mm[sb + 8]
        if version in (0, 1):
            size_o, size_l = mm[sb + 13], mm[sb + 14]
            pos = sb + 24 + (4 if version == 1 else 0)
            r = _Reader(mm, size_o, size_l)
            r.base = r.uint(pos, size_o)
            # root group symbol table entry after four addresses
            root = r.addr(pos + 5 * size_o)
        elif version in (2, 3):
            size_o, size_l = mm[sb + 9], mm[sb + 10]
            r = _Reader(mm, size_o, size_l)
            index.verify(r, sb, sb + 12 + 4 * size_o, "superblock")
            r.base = r.uint(sb + 12, size_o)
            root = r.addr(sb + 12 + 3 * size_o)
        else:
            raise NotImplementedError(f"HDF5 superblock version {version}")
        return r, root

    # the h5py.File surface --------------------------------------------------
    def close(self):
        for f in self._externals.values():
            f.close()
        self._externals = {}
        if self._mm is not None:
            self._mm.close()
            self._mm = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()

    def __getitem__(self, name):
        return self._root[name]

    def __contains__(self, name):
        return name in self._root

    def __iter__(self):
        return iter(self._root)

    def __len__(self):
        return len(self._root)

    def keys(self):
        return self._root.keys()

    def items(self):
        return self._root.items()

    def get(self, name, default=None):
        return self._root.get(name, default)

    # internals --------------------------------------------------------------
    def _header(self, addr: int) -> _Header:
        hdr = self._headers.get(addr)
        if hdr is None:
            hdr = self._headers.setdefault(addr, _Header(self._r, addr))
        return hdr

    def _object(self, addr: int, name: str):
        group = self._groups.get(addr)
        if group is not None:
            return group
        hdr = self._header(addr)
        if hdr.find(MSG_LAYOUT) is not None:
            return Dataset(self, hdr, name)
        if hdr.find(MSG_DATATYPE) is not None:
            return Datatype(self, hdr, name)
        return self._groups.setdefault(addr, Group(self, addr, name, hdr))

    def _external(self, target: str) -> "File":
        """The file an external link names: an absolute path as it is,
        else relative to this file's directory, then to the working
        directory (HDF5's default search); opened once."""
        candidates = [target]
        if not os.path.isabs(target):
            candidates.insert(0, os.path.join(
                os.path.dirname(os.path.abspath(self.filename)), target))
        for path in candidates:
            key = os.path.abspath(path)
            if key in self._externals:
                return self._externals[key]
            if os.path.exists(path):
                return self._externals.setdefault(key, File(path))
        raise KeyError(f"external link target {target!r} not found")

    def _gheap_object(self, addr: int, index: int) -> bytes:
        objs = self._gheaps.get(addr)
        if objs is None:
            r = self._r
            r.check(addr, b"GCOL", "global heap")
            end = addr + r.length(addr + 8)
            pos = addr + 8 + r.size_l
            objs = {}
            while pos + 8 + r.size_l <= end:
                idx = r.uint(pos, 2)
                size = r.length(pos + 8)
                if idx == 0:
                    break
                objs[idx] = r.bytes(pos + 8 + r.size_l, size)
                pos += 8 + r.size_l + ((size + 7) & ~7)
            self._gheaps[addr] = objs
        return objs[index]


class _Link:
    """A link of a group: kind "hard" (target: an address), "soft" (a
    path) or "external" ((file name, path)); crt: its creation order."""

    __slots__ = ("kind", "target", "crt")

    def __init__(self, kind: str, target, crt: int = 0):
        self.kind, self.target, self.crt = kind, target, crt


class Group:
    """A group of an HDF5 file: its links by name, ordered as h5py lists
    them (by creation order where the group tracks it, else by name)."""

    def __init__(self, file: File, addr: int, name: str,
                 hdr: Optional[_Header] = None):
        self.file, self.name = file, name
        self._hdr = hdr or file._header(addr)
        self._links: Optional[dict] = None

    def _read_links(self) -> dict:
        r = self.file._r
        links = {}
        stab = self._hdr.find(MSG_SYMBOL_TABLE)
        if stab is not None:
            btree = r.addr_in(stab, 0)
            heap = r.addr_in(stab, r.size_o)
            r.check(heap, b"HEAP", "local heap")
            data = r.addr(heap + 8 + 2 * r.size_l)
            self._walk_group_btree(r, btree, data, links)
        info = self._hdr.find(MSG_LINK_INFO)
        tracked = info is not None and bool(info[1] & 0x01)
        bodies = self._hdr.all(MSG_LINK)
        if info is not None:
            pos = 2 + (8 if tracked else 0)
            fheap = r.addr_in(info, pos)
            if fheap != UNDEF:  # dense: every link message is in the heap
                heap = index.FractalHeap(r, fheap)
                _, records = index.btree2_records(
                    r, r.addr_in(info, pos + r.size_o))
                # name index records: the name's hash, then the heap ID
                bodies = bodies + [heap.get(rec[4:]) for rec in records]
        for body in bodies:
            name, link = self._parse_link(body, r)
            links[name] = link
        # h5py lists a group that tracks creation order in that order,
        # any other by name
        if tracked:
            return dict(sorted(links.items(), key=lambda kv: kv[1].crt))
        return dict(sorted(links.items(),
                           key=lambda kv: kv[0].encode("utf-8")))

    def _walk_group_btree(self, r, addr, heap_data, links):
        r.check(addr, b"TREE", "v1 B-tree")
        if r.buf[addr + 4] != 0:
            raise OSError(f"HDF5: group B-tree node at {addr} is not a "
                          "group node")
        level, used = r.buf[addr + 5], r.uint(addr + 6, 2)
        pos = addr + 8 + 2 * r.size_o + r.size_l  # past key 0
        for _ in range(used):
            child = r.addr(pos)
            pos += r.size_o + r.size_l
            if level > 0:
                self._walk_group_btree(r, child, heap_data, links)
                continue
            r.check(child, b"SNOD", "symbol table node")
            n = r.uint(child + 6, 2)
            entry = child + 8
            for _ in range(n):
                name = self._heap_string(r, heap_data + r.uint(entry,
                                                               r.size_o))
                if r.uint(entry + 2 * r.size_o, 4) == 2:  # a soft link
                    value = r.uint(entry + 2 * r.size_o + 8, 4)
                    links[name] = _Link("soft", self._heap_string(
                        r, heap_data + value))
                else:
                    links[name] = _Link("hard", r.addr(entry + r.size_o))
                entry += 2 * r.size_o + 24

    @staticmethod
    def _heap_string(r, start: int) -> str:
        return r.bytes(start, r.buf.find(b"\0", start) - start).decode(
            "utf-8")

    @staticmethod
    def _parse_link(d: bytes, r):
        flags = d[1]
        pos = 2
        ltype = 0
        if flags & 0x08:
            ltype = d[pos]
            pos += 1
        crt = 0
        if flags & 0x04:
            crt = int.from_bytes(d[pos:pos + 8], "little")
            pos += 8
        if flags & 0x10:
            pos += 1
        nlen_size = 1 << (flags & 0x03)
        nlen = int.from_bytes(d[pos:pos + nlen_size], "little")
        pos += nlen_size
        name = d[pos:pos + nlen].decode("utf-8")
        pos += nlen
        if ltype == 0:
            return name, _Link("hard", r.addr_in(d, pos), crt)
        size = int.from_bytes(d[pos:pos + 2], "little")
        value = d[pos + 2:pos + 2 + size]
        if ltype == 1:
            return name, _Link("soft", value.decode("utf-8"), crt)
        if ltype == 64:  # a flags byte, then the file and the object path
            fname, path = value[1:].split(b"\0")[:2]
            return name, _Link("external", (fname.decode("utf-8"),
                                            path.decode("utf-8")), crt)
        raise NotImplementedError(f"HDF5 user-defined links ({name!r})")

    @property
    def links(self) -> dict:
        if self._links is None:
            self._links = self._read_links()
        return self._links

    def _child(self, name: str, hops: int = 0):
        """The object a link of this group leads to; KeyError where it
        leads nowhere (a dangling soft or external link)."""
        link = self.links[name]
        if link.kind == "hard":
            return self.file._object(link.target,
                                     self.name.rstrip("/") + "/" + name)
        if link.kind == "soft":
            if hops >= MAX_SOFT_HOPS:
                raise KeyError(f"too many soft links from {name!r}")
            return self._walk(link.target, hops + 1)
        fname, path = link.target
        return self.file._external(fname)._root._walk(path, hops)

    def _walk(self, path: str, hops: int = 0):
        obj = self.file._root if path.startswith("/") else self
        for part in path.split("/"):
            if not part or part == ".":
                continue
            if not isinstance(obj, Group) or part not in obj.links:
                raise KeyError(f"{path!r} is not in {self.name!r}")
            obj = obj._child(part, hops)
        return obj

    def __getitem__(self, name: str):
        return self._walk(name)

    def __contains__(self, name) -> bool:
        """Whether the link exists (h5py: a dangling soft link is in its
        group, though reading it raises KeyError)."""
        head, _, last = name.rstrip("/").rpartition("/")
        try:
            parent = self._walk(head or ("/" if name.startswith("/")
                                         else ""))
        except KeyError:
            return False
        return not last or (isinstance(parent, Group)
                            and last in parent.links)

    def get(self, name, default=None):
        try:
            return self[name]
        except KeyError:
            return default

    def keys(self):
        return list(self.links)

    def items(self):
        """(name, object) pairs; None for a dangling link, as h5py."""
        return [(k, self.get(k)) for k in self.links]

    def __iter__(self):
        return iter(list(self.links))

    def __len__(self):
        return len(self.links)

    def __bool__(self):
        return True  # h5py: an open group is true, empty or not

    def __repr__(self):
        return f"<HDF5 group {self.name!r} ({len(self)} members)>"


class Datatype:
    """A committed (named) datatype of a file, as h5py.Datatype: its
    numpy dtype."""

    def __init__(self, file: File, hdr: _Header, name: str):
        self.file, self.name = file, name
        self.dtype = _parse_datatype(hdr.find(MSG_DATATYPE), 0,
                                     file._r)[0].dtype

    def __repr__(self):
        return f"<HDF5 named type {self.name!r}: {self.dtype}>"


class Dataset:
    """A dataset of an HDF5 file; reading it gives a numpy array (Empty
    for a null dataspace)."""

    def __init__(self, file: File, hdr: _Header, name: str):
        r = file._r
        self.file, self.name = file, name
        space = hdr.find(MSG_DATASPACE)
        dtype = hdr.find(MSG_DATATYPE)
        if space is None or dtype is None:
            raise OSError(f"HDF5: {name} has no dataspace or datatype")
        self.shape, self.maxshape = _parse_dataspace(space, r.size_l)
        self._type = _parse_datatype(dtype, 0, r)[0]
        self.dtype = self._type.dtype
        self._layout = hdr.find(MSG_LAYOUT)
        filters = hdr.find(MSG_FILTERS)
        self._filters = filters_mod.parse_filters(filters) if filters \
            else []
        self._fill = self._fill_bytes(hdr)

    @property
    def size(self) -> Optional[int]:
        if self.shape is None:
            return None
        return int(np.prod(self.shape, dtype=np.int64))

    def __repr__(self):
        return (f"<HDF5 dataset {self.name!r}: shape {self.shape}, "
                f"{self.dtype}>")

    def offset(self) -> Optional[int]:
        """The file offset of a contiguous dataset's data (h5py's
        dset.id.get_offset()); None for other layouts or no data."""
        lay = self._layout
        if lay[0] not in (3, 4) or lay[1] != 1:
            return None
        addr = self.file._r.addr_in(lay, 2)
        return None if addr == UNDEF else addr

    def _fill_bytes(self, hdr) -> Optional[bytes]:
        body = hdr.find(MSG_FILL)
        if body is not None:
            version = body[0]
            if version in (1, 2):
                defined = body[3]
                if version == 1 or defined:
                    size = int.from_bytes(body[4:8], "little")
                    return body[8:8 + size] if size else None
                return None
            flags = body[1]
            if flags & 0x20:
                size = int.from_bytes(body[2:6], "little")
                return body[6:6 + size] if size else None
            return None
        body = hdr.find(MSG_FILL_OLD)
        if body is not None:
            size = int.from_bytes(body[:4], "little")
            return body[4:4 + size] if size else None
        return None

    def _decode(self, data, count: int, offset: int = 0) -> np.ndarray:
        """count stored elements of `data` from offset as values, shaped
        [count] and any array dimensions of the type."""
        t = self._type
        if t.decode is None and t.dtype.subdtype is None:
            return np.frombuffer(data, t.dtype, count, offset)
        raw = np.frombuffer(data, np.uint8, count * t.size, offset)
        return t.values(raw.reshape(count, t.size), self.file)

    def _full_shape(self) -> tuple:
        sub = self.dtype.subdtype
        return self.shape + (sub[1] if sub else ())

    def _empty(self) -> np.ndarray:
        """Every element the fill value (zeros where none is defined)."""
        t = self._type
        fill = self._fill if self._fill is not None and \
            len(self._fill) == t.size else bytes(t.size)
        one = self._decode(fill, 1)
        out = np.empty((self.size,) + one.shape[1:], one.dtype)
        out[:] = one
        return out.reshape(self._full_shape())

    def _read(self) -> np.ndarray:
        r = self.file._r
        lay = self._layout
        version, cls = lay[0], lay[1]
        if self.shape is None:
            return Empty(self.dtype)
        if version not in (3, 4):
            raise NotImplementedError(f"HDF5 data layout version {version}")
        count = self.size
        if cls == 0:  # compact: the data is in the message
            return self._decode(lay, count, 4).reshape(
                self._full_shape()).copy()
        if cls == 1:  # contiguous
            addr = r.addr_in(lay, 2)
            if addr == UNDEF or count == 0:
                return self._empty()
            return self._decode(r.buf, count, addr).reshape(
                self._full_shape()).copy()
        if cls == 2:
            if version == 3:
                rank = lay[2]
                chunk = tuple(int.from_bytes(lay[3 + r.size_o + 4 * i:
                                                 7 + r.size_o + 4 * i],
                                             "little")
                              for i in range(rank))[:-1]
                btree = r.addr_in(lay, 3)
                chunks = [] if btree == UNDEF else \
                    self._v1_chunks(r, btree, rank)
                return self._assemble(chunk, chunks)
            return self._read_v4_chunked(r, lay)
        if cls == 3:
            raise NotImplementedError("HDF5 virtual datasets")
        raise NotImplementedError(f"HDF5 data layout class {cls}")

    def _assemble(self, chunk: tuple, chunks) -> np.ndarray:
        """The dataset from its chunks [(element offsets, stored size,
        filter mask, address)], the fill value where none was written."""
        r = self.file._r
        out = self._empty()
        n = int(np.prod(chunk, dtype=np.int64))
        nbytes = n * self._type.size
        for offsets, size, mask, addr in chunks:
            data = r.buf[addr:addr + size]
            if self._filters:
                data = filters_mod.unfilter(bytes(data), self._filters, mask,
                                            nbytes)
            block = self._decode(data, n)
            block = block.reshape(chunk + block.shape[1:])
            dst = tuple(slice(o, min(o + c, s))
                        for o, c, s in zip(offsets, chunk, self.shape))
            src = tuple(slice(0, d.stop - d.start) for d in dst)
            out[dst] = block[src]
        return out

    def _v1_chunks(self, r, addr, rank):
        """(offsets, stored size, filter mask, address) of every chunk
        under a v1 B-tree node."""
        r.check(addr, b"TREE", "v1 B-tree")
        if r.buf[addr + 4] != 1:
            raise OSError(f"HDF5: B-tree node at {addr} is not a chunk node")
        level, used = r.buf[addr + 5], r.uint(addr + 6, 2)
        key_size = 8 + 8 * rank
        pos = addr + 8 + 2 * r.size_o
        for _ in range(used):
            size, mask = r.uint(pos, 4), r.uint(pos + 4, 4)
            offsets = tuple(r.uint(pos + 8 + 8 * i, 8)
                            for i in range(rank - 1))
            child = r.addr(pos + key_size)
            pos += key_size + r.size_o
            if level > 0:
                yield from self._v1_chunks(r, child, rank)
            else:
                yield offsets, size, mask, child

    def _read_v4_chunked(self, r, lay: bytes) -> np.ndarray:
        """A layout-v4 chunked dataset, its chunks found through one of
        the five chunk indexes."""
        flags, ndims, enc = lay[2], lay[3], lay[4]
        dims = [int.from_bytes(lay[5 + i * enc:5 + (i + 1) * enc], "little")
                for i in range(ndims)]
        chunk, esize = tuple(dims[:-1]), dims[-1]
        pos = 5 + ndims * enc
        kind = lay[pos]
        pos += 1
        if flags & 0x01 and self._filters:
            raise NotImplementedError("HDF5 unfiltered partial edge chunks")
        nbytes = int(np.prod(chunk, dtype=np.int64)) * esize
        if kind == 1:  # single chunk: the index address is the chunk's
            size, mask = nbytes, 0
            if flags & 0x02:  # filtered: its stored size and filter mask
                size = int.from_bytes(lay[pos:pos + r.size_l], "little")
                mask = int.from_bytes(lay[pos + r.size_l:pos + r.size_l + 4],
                                      "little")
                pos += r.size_l + 4
            addr = r.addr_in(lay, pos)
            chunks = [] if addr == UNDEF else [((0,) * len(chunk), size,
                                                mask, addr)]
            return self._assemble(chunk, chunks)
        if kind not in (2, 3, 4, 5):
            raise NotImplementedError(f"HDF5 chunk index type {kind}")
        # past the index's parameters: none, page bits, the extensible
        # array's five, the v2 B-tree's node size and split and merge
        addr = r.addr_in(lay, pos + {2: 0, 3: 1, 4: 5, 5: 6}[kind])
        if addr == UNDEF:
            return self._assemble(chunk, [])
        grid = [-(-s // c) for s, c in zip(self.shape, chunk)]
        maxgrid = [None if m is None else -(-m // c)
                   for m, c in zip(self.maxshape, chunk)]
        if kind == 2:  # implicit: every chunk in place, in grid order
            down = _down(maxgrid)
            chunks = [(tuple(s * c for s, c in zip(sc, chunk)), nbytes, 0,
                       addr + int(np.dot(sc, down)) * nbytes)
                      for sc in np.ndindex(*grid)]
            return self._assemble(chunk, chunks)
        def stored(rec, end):
            """(stored size, filter mask) of a chunk record: after its
            address where the chunks are filtered, the size's bytes
            running to the mask's 4 before `end`."""
            if not self._filters:
                return nbytes, 0
            o = r.size_o
            return (int.from_bytes(rec[o:end - 4], "little"),
                    int.from_bytes(rec[end - 4:end], "little"))

        if kind == 5:  # v2 B-tree records: the scaled offsets come last
            _, records = index.btree2_records(r, addr)
            chunks = []
            for rec in records:
                p = len(rec) - 8 * len(chunk)
                scaled = struct.unpack_from(f"<{len(chunk)}Q", rec, p)
                chunks.append((tuple(s * c for s, c in zip(scaled, chunk)),
                               *stored(rec, p), r.addr_in(rec, 0)))
            return self._assemble(chunk, chunks)
        if kind == 3:
            esz, elems = index.fixed_array(r, addr)
            down, unlim = _down(maxgrid), None
        else:
            esz, elems = index.extensible_array(r, addr)
            unlim = [i for i, m in enumerate(maxgrid) if m is None][0]
            # the unlimited dimension is the slowest in the index
            order = [unlim] + [i for i in range(len(chunk)) if i != unlim]
            down = _down([maxgrid[i] for i in order])
        chunks = []
        for i, e in elems:
            caddr = r.addr_in(e, 0)
            if caddr == UNDEF:
                continue
            scaled = _unravel(i, down)
            if unlim is not None:
                scaled = [scaled[order.index(d)] for d in range(len(chunk))]
            if any(s >= g for s, g in zip(scaled, grid)):
                continue  # beyond the current extent
            chunks.append((tuple(s * c for s, c in zip(scaled, chunk)),
                           *stored(e, esz), caddr))
        return self._assemble(chunk, chunks)

    def __getitem__(self, key):
        arr = self._read()
        if isinstance(arr, Empty):
            if (isinstance(key, tuple) and not key) or key is Ellipsis:
                return arr
            raise ValueError("an empty (null dataspace) dataset has no "
                             "elements to index")
        if (isinstance(key, tuple) and not key) or key is Ellipsis:
            return arr[()] if arr.ndim == 0 else arr
        return arr[key]


def _down(extents) -> list:
    """Row-major strides of a chunk grid (the first extent may be None,
    an unlimited dimension, which no stride uses)."""
    out = [1] * len(extents)
    for i in range(len(extents) - 2, -1, -1):
        out[i] = out[i + 1] * extents[i + 1]
    return out


def _unravel(i: int, down) -> list:
    out = []
    for d in down:
        out.append(i // d)
        i %= d
    return out


# ---------------------------------------------------------------------------
# the writer


def _pad8(b: bytes) -> bytes:
    return b + b"\0" * (-len(b) % 8)


def _datatype_message(dt: np.dtype) -> bytes:
    order = 1 if dt.byteorder == ">" else 0
    if dt.kind in "iu":
        bits = order | (0x08 if dt.kind == "i" else 0)
        return (bytes([0x10, bits, 0, 0]) + struct.pack("<I", dt.itemsize)
                + struct.pack("<HH", 0, 8 * dt.itemsize))
    if dt.kind == "f":
        exp_loc, exp_size, mant_size, bias = {
            2: (10, 5, 10, 15), 4: (23, 8, 23, 127),
            8: (52, 11, 52, 1023)}[dt.itemsize]
        nbits = 8 * dt.itemsize
        return (bytes([0x11, order | 0x20, nbits - 1, 0])
                + struct.pack("<I", dt.itemsize)
                + struct.pack("<HHBBBBI", 0, nbits, exp_loc, exp_size, 0,
                              mant_size, bias))
    if dt.kind == "S":
        # null-padded ASCII, as h5py writes numpy's bytes
        return bytes([0x13, 0x01, 0, 0]) + struct.pack("<I", dt.itemsize)
    raise NotImplementedError(f"write_tree: no HDF5 type for {dt}")


def _header_v1(messages) -> bytes:
    body = b""
    for mtype, data in messages:
        data = _pad8(data)
        body += struct.pack("<HHB3x", mtype, len(data), 0) + data
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


class _Writer:
    SIZE = 8  # offsets and lengths

    def __init__(self, f, leaf_k: int):
        self.f, self.leaf_k, self.internal_k = f, leaf_k, 16

    def tell(self) -> int:
        return self.f.tell()

    def put(self, data) -> int:
        pos = self.tell()
        pad = -pos % 8
        if pad:
            self.f.write(b"\0" * pad)
            pos += pad
        self.f.write(data)
        return pos

    def dataset(self, arr: np.ndarray) -> int:
        arr = np.asarray(arr)
        if arr.dtype.kind not in "iufS":
            raise NotImplementedError(f"write_tree: no HDF5 type for "
                                      f"{arr.dtype}")
        if arr.dtype.byteorder == "=":
            arr = arr.astype(arr.dtype.newbyteorder("<"), copy=False)
        flat = np.ascontiguousarray(arr.reshape(-1)).view(np.uint8)
        nbytes = arr.nbytes
        addr = self.put(flat) if nbytes else UNDEF
        space = struct.pack("<BBBB4x", 1, arr.ndim, 0, 0) + b"".join(
            struct.pack("<Q", d) for d in arr.shape)
        fill = bytes([2, 1, 2, 0])  # allocated early, no fill value
        layout = struct.pack("<BBQQ", 3, 1, addr, nbytes)
        dtype = _datatype_message(arr.dtype)
        return self.put(_header_v1([
            (MSG_DATASPACE, space), (MSG_DATATYPE, dtype), (MSG_FILL, fill),
            (MSG_LAYOUT, layout)]))

    def group(self, tree: dict):
        """Write a group's members, its heap, symbol node and B-tree;
        returns (object header address, B-tree address, heap address)."""
        entries = []
        for name in sorted(tree, key=lambda s: s.encode("utf-8")):
            value = tree[name]
            if isinstance(value, dict):
                addr = self.group(value)[0]
            else:
                addr = self.dataset(value)
            entries.append((name, addr))
        heap = bytearray(b"\0" * 8)  # offset 0: the empty name
        offsets = []
        for name, _ in entries:
            offsets.append(len(heap))
            heap += _pad8(name.encode("utf-8") + b"\0")
        heap_data = self.put(bytes(heap))
        heap_addr = self.put(b"HEAP" + bytes([0, 0, 0, 0])
                             + struct.pack("<QQQ", len(heap), 1, heap_data))
        snod = bytearray(b"SNOD" + bytes([1, 0])
                         + struct.pack("<H", len(entries)))
        for (_, addr), off in zip(entries, offsets):
            snod += struct.pack("<QQI4x16x", off, addr, 0)
        snod += b"\0" * (8 + 2 * self.leaf_k * 40 - len(snod))
        snod_addr = self.put(bytes(snod))
        tree_node = bytearray(b"TREE" + bytes([0, 0]) + struct.pack(
            "<HQQ", 1 if entries else 0, UNDEF, UNDEF))
        if entries:  # key 0 is the empty name, key 1 the last name
            tree_node += struct.pack("<QQQ", 0, snod_addr, offsets[-1])
        k2 = 2 * self.internal_k
        tree_node += b"\0" * (24 + k2 * 8 + (k2 + 1) * 8 - len(tree_node))
        btree_addr = self.put(bytes(tree_node))
        hdr = self.put(_header_v1([(MSG_SYMBOL_TABLE, struct.pack(
            "<QQ", btree_addr, heap_addr))]))
        return hdr, btree_addr, heap_addr


def _max_members(tree: dict) -> int:
    return max([len(tree)] + [_max_members(v) for v in tree.values()
                              if isinstance(v, dict)])


def write_tree(path, tree: dict):
    """Write `tree` ({name: array or dict}) as an HDF5 file: superblock 0,
    symbol-table groups (one symbol node each) and contiguous datasets of
    integers, floats or fixed-length strings. Returns the path."""
    leaf_k = max(4, (_max_members(tree) + 1) // 2)
    if 2 * leaf_k * 40 > 0xFFFF * 40:
        raise ValueError("write_tree: a group of more than 131070 members")
    path = os.fspath(path)
    with open(path, "wb") as f:
        f.write(b"\0" * 96)  # the superblock, written last
        w = _Writer(f, leaf_k)
        root, btree, heap = w.group(tree)
        eof = f.tell()
        sb = (SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0])
              + struct.pack("<HHI", leaf_k, w.internal_k, 0)
              + struct.pack("<QQQQ", 0, UNDEF, eof, UNDEF)
              + struct.pack("<QQII", 0, root, 1, 0)
              + struct.pack("<QQ", btree, heap))
        f.seek(0)
        f.write(sb)
    return path
