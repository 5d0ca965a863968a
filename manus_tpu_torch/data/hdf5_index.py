"""The HDF5 format's index structures, for the reader of data/hdf5.py: the
metadata checksum (Jenkins lookup3), the fractal heap that holds a dense
group's link messages, the version 2 B-tree, and the fixed and extensible
arrays that index a layout-v4 dataset's chunks.

Every structure here carries a checksum, and each block's is verified the
first time it is read: a mismatch raises OSError, as the HDF5 library
does. Each function takes the file's reader (`hdf5._Reader`: the mapped
bytes, the sizes of offsets and lengths, and the base address that every
stored address is relative to)."""
from __future__ import annotations

import struct

UNDEF = 0xFFFFFFFFFFFFFFFF
_M32 = 0xFFFFFFFF


def _rot(x: int, k: int) -> int:
    return ((x << k) | (x >> (32 - k))) & _M32


def lookup3(data, initval: int = 0) -> int:
    """Bob Jenkins' lookup3 hashlittle of `data`, the checksum of HDF5's
    metadata (H5_checksum_lookup3)."""
    data = bytes(data)
    n = len(data)
    a = b = c = (0xDEADBEEF + n + initval) & _M32
    if n == 0:
        return c
    # every block of 12 but the last goes through mix; the last, padded
    # with zeros, through final
    tail = n - (n - 1) % 12 - 1
    words = struct.unpack_from(f"<{tail // 4}I", data)
    for i in range(0, len(words), 3):
        a = (a + words[i]) & _M32
        b = (b + words[i + 1]) & _M32
        c = (c + words[i + 2]) & _M32
        a = ((a - c) & _M32) ^ _rot(c, 4)
        c = (c + b) & _M32
        b = ((b - a) & _M32) ^ _rot(a, 6)
        a = (a + c) & _M32
        c = ((c - b) & _M32) ^ _rot(b, 8)
        b = (b + a) & _M32
        a = ((a - c) & _M32) ^ _rot(c, 16)
        c = (c + b) & _M32
        b = ((b - a) & _M32) ^ _rot(a, 19)
        a = (a + c) & _M32
        c = ((c - b) & _M32) ^ _rot(b, 4)
        b = (b + a) & _M32
    x, y, z = struct.unpack("<3I", data[tail:] + b"\0" * (12 - (n - tail)))
    a, b, c = (a + x) & _M32, (b + y) & _M32, (c + z) & _M32
    c = ((c ^ b) - _rot(b, 14)) & _M32
    a = ((a ^ c) - _rot(c, 11)) & _M32
    b = ((b ^ a) - _rot(a, 25)) & _M32
    c = ((c ^ b) - _rot(b, 16)) & _M32
    a = ((a ^ c) - _rot(c, 4)) & _M32
    b = ((b ^ a) - _rot(a, 14)) & _M32
    c = ((c ^ b) - _rot(b, 24)) & _M32
    return c


def verify(r, start: int, end: int, what: str):
    """The checksum stored at `end` against lookup3 of [start, end)."""
    stored = r.uint(end, 4)
    if lookup3(r.buf[start:end]) != stored:
        raise OSError(f"HDF5: bad checksum of the {what} at {start}")


def _enc_size(n: int) -> int:
    """Bytes that encode the count n (H5VM_limit_enc_size)."""
    return (max(n, 1).bit_length() - 1) // 8 + 1


def _log2(n: int) -> int:
    return n.bit_length() - 1


def bitmap_bit(r, pos: int, i: int) -> bool:
    """Bit i of a bitmap at pos, most significant bit first."""
    return bool(r.buf[pos + i // 8] & (0x80 >> (i % 8)))


# ---------------------------------------------------------------------------
# version 2 B-tree


def btree2_records(r, addr: int):
    """Every record of the v2 B-tree whose header is at addr: (tree type,
    [record bytes]) in key order."""
    r.check(addr, b"BTHD", "v2 B-tree header")
    btype = r.buf[addr + 5]
    node_size, rec_size, depth = struct.unpack_from("<IHH", r.buf, addr + 6)
    pos = addr + 16
    root = r.addr(pos)
    root_n = r.uint(pos + r.size_o, 2)
    verify(r, addr, pos + r.size_o + 2 + r.size_l, "v2 B-tree header")
    # the widths of the child pointers' record counts (H5B2__hdr_init)
    prefix = 10  # signature, version, type, checksum
    leaf_max = (node_size - prefix) // rec_size
    nrec_size = _enc_size(leaf_max)
    cum_max, cum_size = [leaf_max], [0]
    for d in range(1, depth + 1):
        ptr = r.size_o + nrec_size + (cum_size[d - 1] if d > 1 else 0)
        n = (node_size - (prefix + ptr)) // (rec_size + ptr)
        cum_max.append((n + 1) * cum_max[d - 1] + n)
        cum_size.append(_enc_size(cum_max[d]))
    out = []
    if root != UNDEF and root_n:
        _btree2_node(r, root, root_n, depth, rec_size, nrec_size, cum_size,
                     out)
    return btype, out


def _btree2_node(r, addr, nrec, depth, rec_size, nrec_size, cum_size, out):
    sig = b"BTLF" if depth == 0 else b"BTIN"
    r.check(addr, sig, "v2 B-tree node")
    recs = addr + 6
    if depth == 0:
        verify(r, addr, recs + nrec * rec_size, "v2 B-tree leaf node")
        out.extend(r.bytes(recs + i * rec_size, rec_size)
                   for i in range(nrec))
        return
    pos = recs + nrec * rec_size
    children = []
    for _ in range(nrec + 1):
        child = r.addr(pos)
        n = r.uint(pos + r.size_o, nrec_size)
        children.append((child, n))
        pos += r.size_o + nrec_size + (cum_size[depth - 1] if depth > 1
                                       else 0)
    verify(r, addr, pos, "v2 B-tree internal node")
    for i, (child, n) in enumerate(children):
        _btree2_node(r, child, n, depth - 1, rec_size, nrec_size, cum_size,
                     out)
        if i < nrec:
            out.append(r.bytes(recs + i * rec_size, rec_size))


# ---------------------------------------------------------------------------
# fractal heap


class FractalHeap:
    """A fractal heap (FRHP): objects by heap ID, managed ones in its
    doubling table of direct and indirect blocks, tiny ones in the ID."""

    def __init__(self, r, addr: int):
        self.r = r
        r.check(addr, b"FRHP", "fractal heap header")
        self.id_len, filter_len, self.flags = struct.unpack_from(
            "<HHB", r.buf, addr + 5)
        max_man = r.uint(addr + 10, 4)
        o, n = r.size_o, r.size_l
        pos = addr + 14 + n + o + n + o + n * 8
        self.width = r.uint(pos, 2)
        self.start = r.length(pos + 2)
        max_direct = r.length(pos + 2 + n)
        max_bits = r.uint(pos + 2 + 2 * n, 2)
        pos += 2 + 2 * n + 4
        self.root = r.addr(pos)
        self.root_rows = r.uint(pos + o, 2)
        pos += o + 2
        if filter_len:
            raise NotImplementedError("HDF5 fractal heaps with I/O filters")
        verify(r, addr, pos, "fractal heap header")
        self.off_size = (max_bits + 7) // 8
        self.len_size = min((_log2(max_direct) + 7) // 8, _enc_size(max_man))
        self.first_row_bits = _log2(self.start) + _log2(self.width)
        self.max_direct_rows = _log2(max_direct) - _log2(self.start) + 2
        self._blocks: dict = {}  # address -> block offset, checked once

    def _row_size(self, row: int) -> int:
        return self.start if row == 0 else self.start << (row - 1)

    def _lookup(self, off: int):
        """(row, column) of a heap offset in a block's doubling table."""
        if off < self.start * self.width:
            return 0, off // self.start
        high = _log2(off)
        row = high - self.first_row_bits + 1
        return row, (off - (1 << high)) // self._row_size(row)

    def _block(self, addr: int, sig: bytes, span: int) -> int:
        """The heap offset a direct or indirect block starts at, its
        checksum verified on first use. span: the direct block's size, or
        the indirect block's rows."""
        off = self._blocks.get(addr)
        if off is not None:
            return off
        r = self.r
        r.check(addr, sig, "fractal heap block")
        off = r.uint(addr + 5 + r.size_o, self.off_size)
        head = 5 + r.size_o + self.off_size
        if sig == b"FHIB":
            verify(r, addr, addr + head + span * self.width * r.size_o,
                   "fractal heap indirect block")
        elif self.flags & 0x02:  # direct blocks are checksummed
            # over the whole block, its checksum field zeroed
            block = bytearray(r.buf[addr:addr + span])
            stored = int.from_bytes(block[head:head + 4], "little")
            block[head:head + 4] = bytes(4)
            if lookup3(block) != stored:
                raise OSError(f"HDF5: bad checksum of the fractal heap "
                              f"direct block at {addr}")
        self._blocks[addr] = off
        return off

    def _managed(self, off: int, length: int) -> bytes:
        r = self.r
        if self.root_rows == 0:  # the root is a direct block
            base = self._block(self.root, b"FHDB", self.start)
            return r.bytes(self.root + off - base, length)
        addr, nrows = self.root, self.root_rows
        while True:
            base = self._block(addr, b"FHIB", nrows)
            row, col = self._lookup(off - base)
            child = r.addr(addr + 5 + r.size_o + self.off_size
                           + (row * self.width + col) * r.size_o)
            if child == UNDEF:
                raise OSError(f"HDF5: fractal heap offset {off} is in no "
                              "block")
            if row < self.max_direct_rows:
                dbase = self._block(child, b"FHDB", self._row_size(row))
                return r.bytes(child + off - dbase, length)
            addr = child
            nrows = _log2(self._row_size(row)) - self.first_row_bits + 1

    def get(self, heap_id: bytes) -> bytes:
        kind = (heap_id[0] >> 4) & 0x03
        if kind == 0:
            off = int.from_bytes(heap_id[1:1 + self.off_size], "little")
            p = 1 + self.off_size
            length = int.from_bytes(heap_id[p:p + self.len_size], "little")
            return self._managed(off, length)
        if kind == 2:  # tiny: the object is in the ID itself
            if self.id_len <= 18:
                n = (heap_id[0] & 0x0F) + 1
                return bytes(heap_id[1:1 + n])
            n = (((heap_id[0] & 0x0F) << 8) | heap_id[1]) + 1
            return bytes(heap_id[2:2 + n])
        raise NotImplementedError("HDF5 huge fractal heap objects")


# ---------------------------------------------------------------------------
# fixed and extensible arrays (layout-v4 chunk indexes 3 and 4)


def _elements(r, pos: int, n: int, size: int) -> list:
    return [r.bytes(pos + i * size, size) for i in range(n)]


def _paged(r, pos: int, nelmts: int, size: int, page_nelmts: int, init,
           what: str, first: int = 0):
    """The initialised pages of a paged data block whose first page is at
    pos: [(element index, element bytes)], each page's checksum checked.
    init(i): whether page i was written."""
    out = []
    npages = -(-nelmts // page_nelmts)
    for p in range(npages):
        n = min(page_nelmts, nelmts - p * page_nelmts)
        if init(p):
            verify(r, pos, pos + n * size, what + " page")
            out.extend((first + p * page_nelmts + i, e)
                       for i, e in enumerate(_elements(r, pos, n, size)))
        pos += page_nelmts * size + 4
    return out


def fixed_array(r, addr: int):
    """The elements of a fixed array (FAHD): (element size,
    [(index, element bytes)]) for every element that is stored."""
    r.check(addr, b"FAHD", "fixed array header")
    size, page_bits = r.buf[addr + 6], r.buf[addr + 7]
    nelmts = r.length(addr + 8)
    dblk = r.addr(addr + 8 + r.size_l)
    verify(r, addr, addr + 8 + r.size_l + r.size_o, "fixed array header")
    if dblk == UNDEF:
        return size, []
    r.check(dblk, b"FADB", "fixed array data block")
    pos = dblk + 6 + r.size_o
    page_nelmts = 1 << page_bits
    if nelmts <= page_nelmts:
        verify(r, dblk, pos + nelmts * size, "fixed array data block")
        return size, list(enumerate(_elements(r, pos, nelmts, size)))
    npages = -(-nelmts // page_nelmts)
    bitmap = pos
    pos += (npages + 7) // 8
    verify(r, dblk, pos, "fixed array data block")
    return size, _paged(r, pos + 4, nelmts, size, page_nelmts,
                        lambda p: bitmap_bit(r, bitmap, p),
                        "fixed array data block")


def extensible_array(r, addr: int):
    """The elements of an extensible array (EAHD), up to its largest index
    set: (element size, [(index, element bytes)])."""
    r.check(addr, b"EAHD", "extensible array header")
    (size, max_bits, iblk_n, dblk_min, sblk_min_ptrs,
     page_bits) = r.buf[addr + 6:addr + 12]
    n = r.size_l
    max_idx = r.length(addr + 12 + 4 * n)
    iblk = r.addr(addr + 12 + 6 * n)
    verify(r, addr, addr + 12 + 6 * n + r.size_o, "extensible array header")
    if iblk == UNDEF:
        return size, []
    # the super blocks' data block counts and sizes (H5EA__hdr_init)
    nsblks = 1 + max_bits - _log2(dblk_min)
    sblk = [(1 << (s // 2), (1 << ((s + 1) // 2)) * dblk_min)
            for s in range(nsblks)]
    i_nsblks = 2 * _log2(sblk_min_ptrs)
    n_dblk_addrs = 2 * (sblk_min_ptrs - 1)
    n_sblk_addrs = nsblks - i_nsblks
    off_size = (max_bits + 7) // 8
    page_nelmts = 1 << page_bits

    r.check(iblk, b"EAIB", "extensible array index block")
    pos = iblk + 6 + r.size_o
    out = list(enumerate(_elements(r, pos, iblk_n, size)))
    pos += iblk_n * size
    dblk_addrs = [r.addr(pos + i * r.size_o) for i in range(n_dblk_addrs)]
    pos += n_dblk_addrs * r.size_o
    sblk_addrs = [r.addr(pos + i * r.size_o) for i in range(n_sblk_addrs)]
    pos += n_sblk_addrs * r.size_o
    verify(r, iblk, pos, "extensible array index block")

    idx = iblk_n
    d_in_iblock = 0
    for s, (ndblks, nelmts) in enumerate(sblk):
        if idx >= max_idx:
            break
        paged = nelmts > page_nelmts
        npages = -(-nelmts // page_nelmts)
        if s < i_nsblks:
            addrs = dblk_addrs[d_in_iblock:d_in_iblock + ndblks]
            d_in_iblock += ndblks
            bitmaps = None
            if paged:
                raise NotImplementedError(
                    "HDF5 paged extensible array data blocks in the index "
                    "block")
        else:
            saddr = sblk_addrs[s - i_nsblks]
            if saddr == UNDEF:
                idx += ndblks * nelmts
                continue
            r.check(saddr, b"EASB", "extensible array super block")
            spos = saddr + 6 + r.size_o + off_size
            bitmaps = spos
            spos += ndblks * ((npages + 7) // 8) if paged else 0
            addrs = [r.addr(spos + i * r.size_o) for i in range(ndblks)]
            verify(r, saddr, spos + ndblks * r.size_o,
                   "extensible array super block")
        for d, daddr in enumerate(addrs):
            if daddr != UNDEF:
                r.check(daddr, b"EADB", "extensible array data block")
                dpos = daddr + 6 + r.size_o + off_size
                if not paged:
                    verify(r, daddr, dpos + nelmts * size,
                           "extensible array data block")
                    out.extend((idx + i, e) for i, e in enumerate(
                        _elements(r, dpos, nelmts, size)))
                else:
                    verify(r, daddr, dpos, "extensible array data block")
                    bit0 = d * npages  # the bits run on over blocks
                    out.extend(_paged(
                        r, dpos + 4, nelmts, size, page_nelmts,
                        lambda p, b0=bit0: bitmap_bit(r, bitmaps, b0 + p),
                        "extensible array data block", idx))
            idx += nelmts
    return size, out
