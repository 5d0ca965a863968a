"""The filter pipeline of the HDF5 reader (data/hdf5.py): the filters a
chunk passes through on its way from the file, undone in reverse order.

deflate (zlib), shuffle, fletcher32 (its checksum verified: a mismatch
raises OSError), lzf (h5py's filter 32000) and szip (CCSDS 121.0, as
libaec decodes it), both decoded in the host C++ of
csrc/hdf5_filters.cpp, built with g++ at first use (a failed build
raises; lzf_decompress_py is the lzf decoder in Python, for the tests),
scaleoffset and nbit (numpy bit unpacking). Any other filter raises
NotImplementedError naming it.
"""
from __future__ import annotations

import ctypes
import struct
import zlib

import numpy as np

from manus_tpu_torch.utils import cuda_build

FILTER_DEFLATE, FILTER_SHUFFLE, FILTER_FLETCHER32 = 1, 2, 3
FILTER_SZIP, FILTER_NBIT, FILTER_SCALEOFFSET, FILTER_LZF = 4, 5, 6, 32000
FILTER_NAMES = {FILTER_DEFLATE: "deflate", FILTER_SHUFFLE: "shuffle",
                FILTER_FLETCHER32: "fletcher32", FILTER_SZIP: "szip",
                FILTER_NBIT: "nbit", FILTER_SCALEOFFSET: "scaleoffset",
                FILTER_LZF: "lzf", 32001: "blosc", 32004: "lz4",
                32015: "zstd"}
READ = (FILTER_DEFLATE, FILTER_SHUFFLE, FILTER_FLETCHER32, FILTER_SZIP,
        FILTER_NBIT, FILTER_SCALEOFFSET, FILTER_LZF)
_BUFFERS = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64]
_SIGNATURES = {"lzf_decompress": (_BUFFERS, ctypes.c_int64),
               "szip_decompress": (_BUFFERS + [ctypes.c_int] * 4,
                                   ctypes.c_int64)}


def parse_filters(d: bytes) -> list:
    """[(filter id, flags, client data)] of a filter pipeline message;
    NotImplementedError naming a filter the reader cannot undo."""
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
        if fid not in READ:
            raise NotImplementedError(
                f"HDF5 filter {fid} ({FILTER_NAMES.get(fid, 'unknown')})")
        out.append((fid, flags, vals))
    return out


def unfilter(data: bytes, filters: list, mask: int, size: int) -> bytes:
    """A stored chunk's bytes through the pipeline in reverse, skipping
    the filters its mask marks as not applied. size: the chunk's bytes
    when unfiltered."""
    for i in range(len(filters) - 1, -1, -1):
        if mask & (1 << i):
            continue
        fid, _, vals = filters[i]
        if fid == FILTER_DEFLATE:
            data = zlib.decompress(data)
        elif fid == FILTER_SHUFFLE:
            data = _unshuffle(data, vals[0] if vals else 1)
        elif fid == FILTER_FLETCHER32:
            data = _checked_fletcher32(data)
        elif fid == FILTER_LZF:
            data = lzf_decompress(data, vals[2] if len(vals) > 2 and vals[2]
                                  else size)
        elif fid == FILTER_SZIP:
            data = szip_decompress(data, vals)
        elif fid == FILTER_SCALEOFFSET:
            data = scaleoffset_decode(data, vals)
        else:
            data = nbit_decode(data, vals)
    return data


def _unshuffle(data: bytes, size: int) -> bytes:
    n = len(data) // size
    if size <= 1 or not n:
        return data
    body = np.frombuffer(data, np.uint8, n * size)
    return body.reshape(size, n).T.tobytes() + data[n * size:]


# ---------------------------------------------------------------------------
# fletcher32


def fletcher32(data) -> int:
    """HDF5's Fletcher-32 (H5_checksum_fletcher32) of `data`: 16-bit words
    read most significant byte first, a trailing odd byte as a word's high
    byte, both sums kept in 1..65535 (0 only when every word is 0)."""
    raw = np.frombuffer(data, np.uint8)
    words = raw[:len(raw) // 2 * 2].view(">u2").astype(np.uint64)
    if len(raw) % 2:
        words = np.append(words, np.uint64(int(raw[-1]) << 8))
    if not words.any():
        return 0
    # sum2 adds every prefix of sum1: word i counts (m - i) times; each
    # product < 65535^2, so the sum stays exact in uint64
    weights = np.arange(len(words), 0, -1, dtype=np.uint64) % 65535
    s1 = int(words.sum() % 65535) or 0xFFFF
    s2 = int((words * weights).sum() % 65535) or 0xFFFF
    return (s2 << 16) | s1


def _checked_fletcher32(data: bytes) -> bytes:
    body = data[:-4]
    stored = int.from_bytes(data[-4:], "little")
    want = fletcher32(body)
    # HDF5 before 1.6.3 wrote it with the bytes of each half swapped
    swapped = ((want & 0x00FF00FF) << 8) | ((want >> 8) & 0x00FF00FF)
    if stored not in (want, swapped):
        raise OSError("HDF5: fletcher32 checksum mismatch in a chunk")
    return body


# ---------------------------------------------------------------------------
# lzf


def lzf_decompress(data: bytes, size: int) -> bytes:
    """An LZF stream decoded by csrc/hdf5_filters.cpp; size: the expected
    output bytes (the filter's third client value, the chunk's size), grown
    by the input's size while the output does not hold the stream, as
    h5py's filter does."""
    lib = cuda_build.load("hdf5_filters", _SIGNATURES)
    src = np.frombuffer(data, np.uint8)
    out_size = size
    while True:
        out = np.empty(max(out_size, 1), np.uint8)
        n = lib.lzf_decompress(src.ctypes.data, len(src), out.ctypes.data,
                               out_size)
        if n >= 0:
            return out[:n].tobytes()
        if n != -1:
            raise OSError("HDF5: invalid data for lzf decompression")
        out_size += len(src)


def szip_decompress(data: bytes, cd) -> bytes:
    """An HDF5 szip chunk (its size in 4 bytes, then the stream) decoded by
    csrc/hdf5_filters.cpp; cd: the filter's client values (options mask,
    pixels per block, bits per pixel, pixels per scanline)."""
    lib = cuda_build.load("hdf5_filters", _SIGNATURES)
    if len(data) < 4:
        raise OSError("HDF5: an szip chunk shorter than its header")
    size = int.from_bytes(data[:4], "little")
    src = np.frombuffer(data, np.uint8)
    out = np.empty(max(size, 1), np.uint8)
    n = lib.szip_decompress(src.ctypes.data, len(src), out.ctypes.data,
                            size, *[int(v) for v in cd[:4]])
    if n < 0:
        raise OSError(f"HDF5: invalid data for szip decompression ({n})")
    return out[:n].tobytes()


def lzf_decompress_py(data: bytes, size: int) -> bytes:
    """The decoder of lzf_decompress in Python (the tests' reference)."""
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        ctrl = data[i]
        i += 1
        if ctrl < 32:
            out += data[i:i + ctrl + 1]
            i += ctrl + 1
            continue
        length = ctrl >> 5
        if length == 7:
            length += data[i]
            i += 1
        ref = len(out) - ((ctrl & 0x1F) << 8) - data[i] - 1
        i += 1
        if ref < 0:
            raise OSError("HDF5: invalid data for lzf decompression")
        for k in range(length + 2):
            out.append(out[ref + k])
    if len(out) > size:
        raise OSError("HDF5: lzf output larger than its chunk")
    return bytes(out)


# ---------------------------------------------------------------------------
# scaleoffset and nbit


def _bits_to_uint(bits: np.ndarray) -> np.ndarray:
    """Rows of bits (most significant first, at most 64) as uint64."""
    n, w = bits.shape
    padded = np.zeros((n, 64), np.uint8)
    padded[:, 64 - w:] = bits
    return np.packbits(padded, axis=1).view(">u8").reshape(n).astype(
        np.uint64)


def _unpacked(data: bytes, n: int, width: int) -> np.ndarray:
    """The first n * width bits of data, most significant first, as rows
    of width."""
    bits = np.unpackbits(np.frombuffer(data, np.uint8))
    if len(bits) < n * width:
        raise OSError("HDF5: a packed chunk is shorter than its elements")
    return bits[:n * width].reshape(n, width)


def scaleoffset_decode(data: bytes, cd) -> bytes:
    """Undo the scaleoffset filter (H5Zscaleoffset.c): each element's
    offset from the chunk's minimum in minbits bits, a float first scaled
    by 10^D and rounded (D-scale, scale type 0). cd: the filter's client
    values (scale type, scale factor D, elements, class 0 integer or 1
    float, size, sign, byte order, fill value defined, fill value)."""
    scale_type, d_val, n, cls, size, sign, order, filavail = cd[:8]
    minbits = int.from_bytes(data[0:4], "little")
    minval = int.from_bytes(data[5:5 + min(8, data[4])], "little")
    body = data[21:]
    kind = "f" if cls == 1 else ("i" if sign else "u")
    native = np.dtype(f"<{kind}{size}")
    stored = np.dtype(f"{'>' if order else '<'}{kind}{size}")
    if minbits == 8 * size:  # the elements as they were, in native order
        return np.frombuffer(body, native, n).astype(stored).tobytes()
    udt = np.dtype(f"<u{size}")
    codes = _bits_to_uint(_unpacked(body, n, minbits)).astype(udt) \
        if minbits else np.zeros(n, udt)
    full = np.asarray((1 << minbits) - 1, udt)
    fill = None
    if filavail:
        fill = np.frombuffer(b"".join(struct.pack("<I", v) for v in cd[8:]),
                             native, 1)[0]
    if cls == 0:
        with np.errstate(over="ignore"):
            vals = (codes + np.asarray(minval & ((1 << 8 * size) - 1),
                                       udt)).view(native)
    elif scale_type == 0:
        fdt = native.type
        low = np.frombuffer(minval.to_bytes(8, "little")[:size], native)[0]
        ints = codes.view(f"<i{size}")
        vals = (ints.astype(native) / fdt(10.0 ** d_val) + low).astype(native)
    else:
        raise NotImplementedError(f"HDF5 scaleoffset scale type "
                                  f"{scale_type}")
    if fill is not None:
        vals = np.where(codes == full, fill, vals).astype(native)
    return vals.astype(stored).tobytes()


_NBIT_ATOMIC, _NBIT_ARRAY, _NBIT_COMPOUND, _NBIT_NOOP = 1, 2, 3, 4


def _nbit_array(cd, i: int, base: int, leaves: list) -> int:
    """The leaves of an array type whose parameters start at cd[i] (its
    size), as H5Z__nbit_decompress_one_array walks them; returns the
    index of the next parameter."""
    total, cls = cd[i], cd[i + 1]
    i += 2
    if cls == _NBIT_ATOMIC:
        size, order, prec, off = cd[i:i + 4]
        leaves.extend((base + k * size, size, order, prec, off)
                      for k in range(total // size))
        return i + 4
    if cls == _NBIT_NOOP:
        leaves.append((base, total, None, 8 * total, 0))
        return i + 1
    sub = _nbit_array if cls == _NBIT_ARRAY else _nbit_compound
    for k in range(total // cd[i]):
        sub(cd, i, base + k * cd[i], leaves)
    return i  # the C code leaves its index at the base's parameters


def _nbit_compound(cd, i: int, base: int, leaves: list) -> int:
    nmembers = cd[i + 1]
    i += 2
    for _ in range(nmembers):
        moff, cls = cd[i], cd[i + 1]
        i += 2
        if cls == _NBIT_ATOMIC:
            size, order, prec, off = cd[i:i + 4]
            leaves.append((base + moff, size, order, prec, off))
            i += 4
        elif cls == _NBIT_ARRAY:
            i = _nbit_array(cd, i, base + moff, leaves)
        elif cls == _NBIT_COMPOUND:
            i = _nbit_compound(cd, i, base + moff, leaves)
        else:
            leaves.append((base + moff, cd[i], None, 8 * cd[i], 0))
            i += 1
    return i


def nbit_decode(data: bytes, cd) -> bytes:
    """Undo the nbit filter (H5Znbit.c): every element's significant bits
    (precision bits above its bit offset, for each atomic part; whole bytes
    for a part of no other class), most significant first, back in their
    place with the other bits zero. cd: the filter's client values."""
    if cd[1]:  # nothing needed packing
        return data
    n, cls = cd[2], cd[3]
    leaves = []
    if cls == _NBIT_ATOMIC:
        leaves.append((0,) + tuple(cd[4:8]))
    elif cls == _NBIT_ARRAY:
        _nbit_array(cd, 4, 0, leaves)
    elif cls == _NBIT_COMPOUND:
        _nbit_compound(cd, 4, 0, leaves)
    else:
        leaves.append((0, cd[4], None, 8 * cd[4], 0))
    size = cd[4]
    width = sum(leaf[3] for leaf in leaves)
    bits = _unpacked(data, n, width)
    out = np.zeros((n, size), np.uint8)
    col = 0
    for off, nbytes, order, prec, boff in leaves:
        part = bits[:, col:col + prec]
        col += prec
        if order is None:  # whole bytes, in order
            out[:, off:off + nbytes] = np.packbits(part, axis=1)
            continue
        vals = (_bits_to_uint(part) << np.uint64(boff)).astype("<u8")
        le = vals.view(np.uint8).reshape(n, 8)[:, :nbytes]
        out[:, off:off + nbytes] = le[:, ::-1] if order else le
    return out.tobytes()
