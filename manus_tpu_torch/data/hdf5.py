"""A read-only HDF5 reader in numpy and zlib, and a small writer.

The BRICS captures are HDF5 files, and the card's machine has no h5py.
`File` reads the part of the format that h5py writes for such captures,
through the part of h5py's API that the loaders and the validator use:

- groups: keys, items, get, `in`, `[name]` and `["a/b"]`, iteration,
  len;
- datasets: shape, dtype, size, `[()]`, `[:]` (the whole array; any
  other index is applied to it), and offset() of contiguous data.

Supported: superblock versions 0-3; object headers v1 and v2 with
continuation blocks; groups as symbol tables (v1 B-tree, symbol nodes,
local heap) and as compact link messages; contiguous, compact and chunked
(v1 B-tree) data layouts; the deflate, shuffle and fletcher32 filters;
integers and floats of either byte order, fixed-length strings and
variable-length strings (global heap); scalar and simple dataspaces; the
fill value where data was never written. Anything else raises
NotImplementedError naming it: dense link storage (fractal heap),
layout-v4 chunk indexes, other filters, compound and other types, shared
messages, soft and external links.

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
import zlib
from typing import Optional

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF

# object header message types
MSG_NIL, MSG_DATASPACE, MSG_LINK_INFO, MSG_DATATYPE = 0x0, 0x1, 0x2, 0x3
MSG_FILL_OLD, MSG_FILL, MSG_LINK, MSG_LAYOUT = 0x4, 0x5, 0x6, 0x8
MSG_FILTERS, MSG_CONTINUATION, MSG_SYMBOL_TABLE = 0xB, 0x10, 0x11

FILTER_DEFLATE, FILTER_SHUFFLE, FILTER_FLETCHER32 = 1, 2, 3

_TYPE_CLASSES = {2: "time types", 4: "bitfield types", 5: "opaque types",
                 6: "compound types", 7: "reference types",
                 8: "enum types", 10: "array types"}


class _Reader:
    """Little-endian fields of the mapped file at absolute offsets."""

    def __init__(self, buf, size_o: int = 8, size_l: int = 8):
        self.buf = buf
        self.size_o, self.size_l = size_o, size_l

    def uint(self, pos: int, n: int) -> int:
        return int.from_bytes(self.buf[pos:pos + n], "little")

    def bytes(self, pos: int, n: int) -> bytes:
        return bytes(self.buf[pos:pos + n])

    def addr(self, pos: int) -> int:
        return self.uint(pos, self.size_o)

    def length(self, pos: int) -> int:
        return self.uint(pos, self.size_l)

    def check(self, pos: int, sig: bytes, what: str):
        if self.buf[pos:pos + 4] != sig:
            raise OSError(f"HDF5: no {what} signature at {pos}")


# ---------------------------------------------------------------------------
# messages


def _parse_dataspace(d: bytes, size_l: int) -> tuple:
    version, rank = d[0], d[1]
    if version == 1:
        pos = 8
    elif version == 2:
        if d[3] == 2:
            raise NotImplementedError("HDF5 null dataspaces")
        pos = 4
    else:
        raise NotImplementedError(f"HDF5 dataspace message version {version}")
    return tuple(int.from_bytes(d[pos + i * size_l:pos + (i + 1) * size_l],
                                "little") for i in range(rank))


class _Type:
    """A parsed datatype: numpy dtype of the element, and for a
    variable-length string the stored element size (vlen)."""

    def __init__(self, dtype: np.dtype, vlen: bool = False, size: int = 0):
        self.dtype, self.vlen, self.size = dtype, vlen, size or dtype.itemsize


def _parse_datatype(d: bytes, size_o: int) -> _Type:
    cls = d[0] & 0x0F
    bits = d[1] | (d[2] << 8) | (d[3] << 16)
    size = int.from_bytes(d[4:8], "little")
    if cls in (0, 1):  # fixed point, floating point
        order = ">" if bits & 1 else "<"
        if cls == 1 and bits & 0x40:
            raise NotImplementedError("HDF5 VAX-order floats")
        if cls == 0:
            kind = "i" if bits & 0x08 else "u"
        else:
            kind = "f"
        if size not in ((1, 2, 4, 8) if cls == 0 else (2, 4, 8)):
            raise NotImplementedError(f"HDF5 {size}-byte numbers")
        return _Type(np.dtype(f"{order}{kind}{size}"))
    if cls == 3:  # fixed-length string
        return _Type(np.dtype(f"S{size}"))
    if cls == 9:  # variable length
        if bits & 0x0F != 1:
            raise NotImplementedError("HDF5 variable-length sequences")
        return _Type(np.dtype(object), vlen=True, size=4 + size_o + 4)
    raise NotImplementedError(
        f"HDF5 {_TYPE_CLASSES.get(cls, f'datatype class {cls}')}")


def _parse_filters(d: bytes) -> list:
    """[(filter id, flags, client data)] of a filter pipeline message."""
    version, n = d[0], d[1]
    pos = 8 if version == 1 else 2
    if version not in (1, 2):
        raise NotImplementedError(f"HDF5 filter pipeline version {version}")
    out = []
    for _ in range(n):
        fid = int.from_bytes(d[pos:pos + 2], "little")
        pos += 2
        name_len = 0
        if version == 1 or fid >= 256:
            name_len = int.from_bytes(d[pos:pos + 2], "little")
            pos += 2
        flags, nvals = struct.unpack_from("<HH", d, pos)
        pos += 4
        if version == 1:
            name_len = (name_len + 7) & ~7
        pos += name_len
        vals = struct.unpack_from(f"<{nvals}I", d, pos)
        pos += 4 * nvals
        if version == 1 and nvals % 2:
            pos += 4
        if fid not in (FILTER_DEFLATE, FILTER_SHUFFLE, FILTER_FLETCHER32):
            names = {4: "szip", 5: "nbit", 6: "scaleoffset", 32000: "lzf",
                     32001: "blosc", 32004: "lz4", 32015: "zstd"}
            raise NotImplementedError(
                f"HDF5 filter {fid} ({names.get(fid, 'unknown')})")
        out.append((fid, flags, vals))
    return out


def _unfilter(data: bytes, filters: list, mask: int) -> bytes:
    for i in range(len(filters) - 1, -1, -1):
        if mask & (1 << i):
            continue
        fid, _, vals = filters[i]
        if fid == FILTER_DEFLATE:
            data = zlib.decompress(data)
        elif fid == FILTER_SHUFFLE:
            size = vals[0] if vals else 1
            n = len(data) // size
            if size > 1 and n:
                body = np.frombuffer(data, np.uint8, n * size)
                data = (body.reshape(size, n).T.tobytes()
                        + data[n * size:])
        else:  # fletcher32: the checksum is the last 4 bytes
            data = data[:-4]
    return data


# ---------------------------------------------------------------------------
# object headers


class _Header:
    """The messages [(type, flags, data)] of one object header."""

    def __init__(self, r: _Reader, addr: int):
        self.messages = []
        if r.buf[addr:addr + 4] == b"OHDR":
            self._read_v2(r, addr)
        elif r.buf[addr] == 1:
            self._read_v1(r, addr)
        else:
            raise OSError(f"HDF5: no object header at {addr}")
        for _, flags, _ in self.messages:
            if flags & 0x02:
                raise NotImplementedError("HDF5 shared object header messages")

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
        track = bool(flags & 0x04)
        pending = []
        self._v2_block(r, pos, pos + chunk0, track, pending)
        while pending:
            cpos, length = pending.pop(0)
            r.check(cpos, b"OCHK", "object header continuation")
            # past the signature, before the checksum
            self._v2_block(r, cpos + 4, cpos + length - 4, track, pending)

    def _add(self, r, mtype, flags, body, pending):
        """Keep a message; queue a continuation block (offset, length)."""
        if mtype == MSG_CONTINUATION:
            pending.append((
                int.from_bytes(body[:r.size_o], "little"),
                int.from_bytes(body[r.size_o:r.size_o + r.size_l], "little")))
        elif mtype != MSG_NIL:
            self.messages.append((mtype, flags, body))

    def find(self, mtype: int) -> Optional[bytes]:
        for t, _, body in self.messages:
            if t == mtype:
                return body
        return None

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
        with open(self.filename, "rb") as f:
            size = os.fstat(f.fileno()).st_size
            if size < len(SIGNATURE):
                raise OSError(f"{self.filename}: not an HDF5 file "
                              f"({size} bytes)")
            self._mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        self._gheaps: dict = {}
        self._groups: dict = {}  # address -> Group, links read once
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
            base = r.addr(pos)
            # root group symbol table entry after four addresses
            entry = pos + 4 * size_o
            root = r.addr(entry + size_o)
        elif version in (2, 3):
            size_o, size_l = mm[sb + 9], mm[sb + 10]
            r = _Reader(mm, size_o, size_l)
            base = r.addr(sb + 12)
            root = r.addr(sb + 12 + 3 * size_o)
        else:
            raise NotImplementedError(f"HDF5 superblock version {version}")
        if sb != 0 or base != 0:
            raise NotImplementedError("HDF5 files with a user block")
        return r, root

    # the h5py.File surface --------------------------------------------------
    def close(self):
        if getattr(self, "_mm", None) is not None:
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
    def _object(self, addr: int, name: str):
        group = self._groups.get(addr)
        if group is not None:
            return group
        hdr = _Header(self._r, addr)
        if hdr.find(MSG_LAYOUT) is not None:
            return Dataset(self, hdr, name)
        return self._groups.setdefault(addr, Group(self, addr, name, hdr))

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


class Group:
    """A group of an HDF5 file: its links by name, sorted as h5py lists
    them."""

    def __init__(self, file: File, addr: int, name: str,
                 hdr: Optional[_Header] = None):
        self.file, self.name = file, name
        self._hdr = hdr or _Header(file._r, addr)
        self._links: Optional[dict] = None

    def _read_links(self) -> dict:
        r = self.file._r
        links = {}
        stab = self._hdr.find(MSG_SYMBOL_TABLE)
        if stab is not None:
            btree = int.from_bytes(stab[:r.size_o], "little")
            heap = int.from_bytes(stab[r.size_o:2 * r.size_o], "little")
            r.check(heap, b"HEAP", "local heap")
            data = r.addr(heap + 8 + 2 * r.size_l)
            self._walk_group_btree(r, btree, data, links)
        info = self._hdr.find(MSG_LINK_INFO)
        if info is not None:
            pos = 2 + (8 if info[1] & 0x01 else 0)
            fheap = int.from_bytes(info[pos:pos + r.size_o], "little")
            if fheap != UNDEF:
                raise NotImplementedError(
                    "HDF5 dense link storage (fractal heap)")
        for body in self._hdr.all(MSG_LINK):
            name, addr = self._parse_link(body, r.size_o)
            links[name] = addr
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
                start = heap_data + r.addr(entry)
                name = r.bytes(start, r.buf.find(b"\0", start) - start)
                if r.uint(entry + 2 * r.size_o, 4) == 2:  # cache type
                    raise NotImplementedError(
                        f"HDF5 soft links ({name.decode('utf-8')!r})")
                links[name.decode("utf-8")] = r.addr(entry + r.size_o)
                entry += 2 * r.size_o + 24

    @staticmethod
    def _parse_link(d: bytes, size_o: int):
        flags = d[1]
        pos = 2
        ltype = 0
        if flags & 0x08:
            ltype = d[pos]
            pos += 1
        if flags & 0x04:
            pos += 8
        if flags & 0x10:
            pos += 1
        nlen_size = 1 << (flags & 0x03)
        nlen = int.from_bytes(d[pos:pos + nlen_size], "little")
        pos += nlen_size
        name = d[pos:pos + nlen].decode("utf-8")
        pos += nlen
        if ltype != 0:
            kind = "soft" if ltype == 1 else "external"
            raise NotImplementedError(f"HDF5 {kind} links ({name!r})")
        return name, int.from_bytes(d[pos:pos + size_o], "little")

    @property
    def links(self) -> dict:
        if self._links is None:
            self._links = self._read_links()
        return self._links

    def _child(self, name: str):
        addr = self.links[name]
        path = (self.name.rstrip("/") + "/" + name)
        return self.file._object(addr, path)

    def __getitem__(self, name: str):
        obj = self
        for part in name.strip("/").split("/"):
            if not part:
                continue
            if not isinstance(obj, Group):
                raise KeyError(name)
            if part not in obj.links:
                raise KeyError(f"{name!r} is not in {self.name!r}")
            obj = obj._child(part)
        return obj

    def __contains__(self, name) -> bool:
        try:
            self[name]
        except KeyError:
            return False
        return True

    def get(self, name, default=None):
        try:
            return self[name]
        except KeyError:
            return default

    def keys(self):
        return list(self.links)

    def items(self):
        return [(k, self._child(k)) for k in self.links]

    def __iter__(self):
        return iter(list(self.links))

    def __len__(self):
        return len(self.links)

    def __bool__(self):
        return True  # h5py: an open group is true, empty or not

    def __repr__(self):
        return f"<HDF5 group {self.name!r} ({len(self)} members)>"


class Dataset:
    """A dataset of an HDF5 file; reading it gives a numpy array."""

    def __init__(self, file: File, hdr: _Header, name: str):
        r = file._r
        self.file, self.name = file, name
        space = hdr.find(MSG_DATASPACE)
        dtype = hdr.find(MSG_DATATYPE)
        if space is None or dtype is None:
            raise OSError(f"HDF5: {name} has no dataspace or datatype")
        self.shape = _parse_dataspace(space, r.size_l)
        self._type = _parse_datatype(dtype, r.size_o)
        self.dtype = self._type.dtype
        self._layout = hdr.find(MSG_LAYOUT)
        filters = hdr.find(MSG_FILTERS)
        self._filters = _parse_filters(filters) if filters else []
        self._fill = self._fill_bytes(hdr)

    @property
    def size(self) -> int:
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
        addr = int.from_bytes(lay[2:2 + self.file._r.size_o], "little")
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

    def _empty(self) -> np.ndarray:
        t = self._type
        if t.vlen:
            out = np.empty(self.shape, object)
            out.fill(b"")
            return out
        if self._fill is not None and len(self._fill) == t.size:
            return np.full(self.shape, np.frombuffer(self._fill, t.dtype)[0],
                           t.dtype)
        return np.zeros(self.shape, t.dtype)

    def _raw_dtype(self) -> np.dtype:
        return np.dtype(f"V{self._type.size}") if self._type.vlen \
            else self._type.dtype

    def _from_raw(self, raw: np.ndarray) -> np.ndarray:
        """Stored elements to values (variable-length strings from the
        global heap)."""
        if not self._type.vlen:
            return raw
        r = self.file._r
        flat = raw.reshape(-1)
        out = np.empty(flat.shape, object)
        for i, rec in enumerate(flat):
            b = bytes(rec)
            n = int.from_bytes(b[:4], "little")
            addr = int.from_bytes(b[4:4 + r.size_o], "little")
            idx = int.from_bytes(b[4 + r.size_o:8 + r.size_o], "little")
            out[i] = b"" if addr in (0, UNDEF) else \
                self.file._gheap_object(addr, idx)[:n]
        return out.reshape(raw.shape)

    def _read(self) -> np.ndarray:
        r = self.file._r
        lay = self._layout
        version, cls = lay[0], lay[1]
        if version not in (3, 4):
            raise NotImplementedError(f"HDF5 data layout version {version}")
        raw_dt = self._raw_dtype()
        count = self.size
        if cls == 0:  # compact: the data is in the message
            size = int.from_bytes(lay[2:4], "little")
            raw = np.frombuffer(lay[4:4 + size], raw_dt, count)
            return self._from_raw(raw.reshape(self.shape).copy())
        if cls == 1:  # contiguous
            addr = int.from_bytes(lay[2:2 + r.size_o], "little")
            if addr == UNDEF or count == 0:
                return self._empty()
            raw = np.frombuffer(r.buf, raw_dt, count, addr)
            return self._from_raw(raw.reshape(self.shape).copy())
        if cls == 2:
            if version == 4:
                raise NotImplementedError(
                    f"HDF5 layout-v4 chunk indexes (index type "
                    f"{self._v4_index_type(lay)})")
            return self._read_chunked(lay)
        raise NotImplementedError(f"HDF5 data layout class {cls}")

    @staticmethod
    def _v4_index_type(lay: bytes) -> int:
        rank, enc = lay[3], lay[4]
        return lay[5 + rank * enc]

    def _read_chunked(self, lay: bytes) -> np.ndarray:
        r = self.file._r
        rank = lay[2]
        btree = int.from_bytes(lay[3:3 + r.size_o], "little")
        pos = 3 + r.size_o
        dims = [int.from_bytes(lay[pos + 4 * i:pos + 4 * i + 4], "little")
                for i in range(rank)]
        chunk = tuple(dims[:-1])
        out = self._empty()
        if btree == UNDEF:
            return out
        raw_dt = self._raw_dtype()
        for offsets, size, mask, addr in self._chunks(r, btree, rank):
            data = _unfilter(r.bytes(addr, size), self._filters, mask)
            block = np.frombuffer(data, raw_dt, int(np.prod(chunk)))
            block = self._from_raw(block.reshape(chunk))
            dst = tuple(slice(o, min(o + c, s))
                        for o, c, s in zip(offsets, chunk, self.shape))
            src = tuple(slice(0, d.stop - d.start) for d in dst)
            out[dst] = block[src]
        return out

    def _chunks(self, r, addr, rank):
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
                yield from self._chunks(r, child, rank)
            else:
                yield offsets, size, mask, child

    def __getitem__(self, key):
        arr = self._read()
        if (isinstance(key, tuple) and not key) or key is Ellipsis:
            return arr[()] if arr.ndim == 0 else arr
        return arr[key]


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
