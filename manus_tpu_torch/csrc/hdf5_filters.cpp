// Host-side decoders of two HDF5 compression filters for the HDF5 reader
// (manus_tpu_torch/data/hdf5_filters.py): LZF (filter 32000, which h5py
// registers as "lzf") and szip (filter 4: CCSDS 121.0 adaptive Rice
// coding, as libaec's SZ_BufftoBuffDecompress decodes it). Plain host
// code with a C interface, loaded with ctypes; each reads only inside its
// input and writes only inside its output, and reports a corrupt or
// truncated stream.
//
// Build (utils/cuda_build.py does it at first use):
//   g++ -O3 -shared -fPIC -pthread -o libhdf5_filters.so hdf5_filters.cpp
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// MSB-first bits of a byte stream.
struct Bits {
  const uint8_t* p;
  int64_t n_bits, pos = 0;
  Bits(const uint8_t* data, int64_t len) : p(data), n_bits(len * 8) {}
  bool get(int n, uint32_t* v) {  // n <= 32
    if (pos + n > n_bits) return false;
    uint64_t out = 0;
    for (int i = 0; i < n; ++i, ++pos)
      out = (out << 1) | ((p[pos >> 3] >> (7 - (pos & 7))) & 1u);
    *v = (uint32_t)out;
    return true;
  }
  bool fs(uint32_t* v) {  // a fundamental sequence code: zeros, then a 1
    uint32_t zeros = 0;
    while (pos < n_bits) {
      if ((p[pos >> 3] >> (7 - (pos & 7))) & 1u) {
        ++pos;
        *v = zeros;
        return true;
      }
      ++pos;
      ++zeros;
    }
    return false;
  }
};

// Decode up to n samples of bps bits (libaec's aec_buffer_decode without
// AEC_DATA_SIGNED, AEC_DATA_3BYTE, AEC_RESTRICTED or AEC_PAD_RSI: the
// flags SZ_BufftoBuffDecompress never sets) into out, unsigned. pp: the
// unit-delay predictor ran before coding (AEC_DATA_PREPROCESS). Returns
// the samples of the whole blocks decoded before n or the stream's end
// (a block cut short, or the zero bits that pad the last byte, ends it).
int64_t aec_decode(Bits& in, int bps, int block, int64_t rsi_blocks,
                   bool pp, int64_t n, std::vector<uint32_t>& out) {
  const int id_len = bps > 16 ? 5 : (bps > 8 ? 4 : 3);
  const uint32_t id_max = (1u << id_len) - 1;
  const int64_t rsi_size = rsi_blocks * block;
  out.assign(n, 0);
  int64_t o = 0;  // samples written
  int64_t done = 0;  // samples of the blocks decoded whole
  for (; o < n; done = o < n ? o : n) {
    const int64_t rsi_start = o - (o % rsi_size);
    const int ref = (pp && o == rsi_start) ? 1 : 0;  // a reference sample
    uint32_t id, v;
    if (!in.get(id_len, &id)) break;
    auto put = [&](uint32_t x) {
      if (o < n) out[o] = x;
      ++o;
    };
    if (id == 0) {  // low entropy: a zero block or the second extension
      uint32_t se;
      if (!in.get(1, &se)) goto end;
      if (ref) {
        if (!in.get(bps, &v)) goto end;
        put(v);
      }
      if (se) {
        for (int i = ref; i < block;) {
          uint32_t m;
          if (!in.fs(&m)) goto end;
          // m indexes the pairs (d0, d1) by gamma = d0 + d1, then d1
          uint32_t gamma = 0;
          while ((gamma + 1) * (gamma + 2) / 2 <= m) ++gamma;
          if (gamma > 12) goto end;
          const uint32_t d1 = m - gamma * (gamma + 1) / 2;
          if ((i & 1) == 0) {
            put(gamma - d1);
            ++i;
          }
          put(d1);
          ++i;
        }
      } else {
        uint32_t fs;
        if (!in.fs(&fs)) goto end;
        int64_t blocks = fs + 1;
        if (blocks == 5) {  // the rest of the segment of 64 or the RSI
          const int64_t b = (o - rsi_start) / block;
          blocks = rsi_blocks - b < 64 - (b % 64) ? rsi_blocks - b
                                                  : 64 - (b % 64);
        } else if (blocks > 5) {
          --blocks;
        }
        for (int64_t i = blocks * block - ref; i > 0 && o < n; --i)
          put(0);
      }
    } else if (id == id_max) {  // uncompressed, the reference included
      for (int i = 0; i < block; ++i) {
        if (!in.get(bps, &v)) goto end;
        put(v);
      }
    } else {  // split samples: k low bits apart from their FS-coded rest
      const int k = (int)id - 1;
      if (ref) {
        if (!in.get(bps, &v)) goto end;
        put(v);
      }
      const int m = block - ref;
      std::vector<uint32_t> high(m);
      for (int i = 0; i < m; ++i)
        if (!in.fs(&high[i])) goto end;
      for (int i = 0; i < m; ++i) {
        uint32_t low = 0;
        if (k && !in.get(k, &low)) goto end;
        put((high[i] << k) | low);
      }
    }
  }
end:
  if (pp) {  // undo the predictor and the mapping of its residuals
    const uint32_t xmax = bps == 32 ? 0xffffffffu : (1u << bps) - 1;
    const uint32_t med = xmax / 2 + 1;
    uint32_t data = 0;
    for (int64_t i = 0; i < done; ++i) {
      if (i % rsi_size == 0) {
        data = out[i];
        continue;
      }
      const uint32_t d = out[i];
      const uint32_t half_d = (d >> 1) + (d & 1);
      const uint32_t mask = (data & med) ? xmax : 0;
      if (half_d <= (mask ^ data))
        data += (d >> 1) ^ (~((d & 1) - 1));
      else
        data = mask ^ d;
      out[i] = data & xmax;
    }
  }
  return done;
}

}  // namespace

extern "C" {

// Decode the LZF stream in[0, in_len) into out[0, out_len). Returns the
// number of bytes written, -1 if the output does not hold them, -2 if the
// stream is truncated or refers before the start of the output.
int64_t lzf_decompress(const uint8_t* in, int64_t in_len, uint8_t* out,
                       int64_t out_len) {
  const uint8_t* ip = in;
  const uint8_t* const in_end = in + in_len;
  uint8_t* op = out;
  uint8_t* const out_end = out + out_len;
  while (ip < in_end) {
    unsigned ctrl = *ip++;
    if (ctrl < (1u << 5)) {  // a run of ctrl + 1 literal bytes
      const int64_t n = ctrl + 1;
      if (out_end - op < n) return -1;
      if (in_end - ip < n) return -2;
      std::memcpy(op, ip, n);
      op += n;
      ip += n;
    } else {  // a back reference of len + 2 bytes
      int64_t len = ctrl >> 5;
      if (len == 7) {
        if (ip >= in_end) return -2;
        len += *ip++;
      }
      if (ip >= in_end) return -2;
      const int64_t back = ((int64_t)(ctrl & 0x1f) << 8) + *ip++ + 1;
      len += 2;
      if (op - out < back) return -2;
      if (out_end - op < len) return -1;
      const uint8_t* ref = op - back;
      if (back >= len) {
        std::memcpy(op, ref, len);
        op += len;
      } else {  // the copy overlaps what it writes: byte by byte
        for (int64_t i = 0; i < len; ++i) *op++ = *ref++;
      }
    }
  }
  return op - out;
}

// Decode an HDF5 szip chunk: in[0, in_len) holds the uncompressed size
// (4 bytes, little-endian), then the stream; the filter's client values
// are the szip options mask, pixels per block, bits per pixel and pixels
// per scanline. Writes out[0, out_len) and returns the bytes decoded,
// -1 if out_len is not the stored size, -2 on a corrupt stream, -3 for
// parameters szip does not have.
int64_t szip_decompress(const uint8_t* in, int64_t in_len, uint8_t* out,
                        int64_t out_len, int options, int ppb, int bpp,
                        int ppsl) {
  const int kMSB = 16, kNN = 32;
  if (in_len < 4) return -2;
  const int64_t size = (int64_t)in[0] | ((int64_t)in[1] << 8) |
                       ((int64_t)in[2] << 16) | ((int64_t)in[3] << 24);
  if (size != out_len) return -1;
  if (ppb <= 0 || ppsl <= 0 || bpp <= 0 || bpp > 64 ||
      (bpp > 32 && bpp != 64))
    return -3;
  // as SZ_BufftoBuffDecompress: 32- and 64-bit pixels go as byte planes;
  // a scanline that is not whole blocks is padded to whole blocks
  const bool planes = bpp == 32 || bpp == 64;
  const int bps = planes ? 8 : bpp;
  const int psize = bps > 16 ? 4 : (bps > 8 ? 2 : 1);
  const int64_t rsi = (ppsl + ppb - 1) / ppb;
  const bool pad = ppsl % ppb != 0;
  int64_t n = out_len / psize;
  int64_t scanlines = 0;
  if (pad || planes) {
    scanlines = (out_len / psize + ppsl - 1) / ppsl;
    n = rsi * ppb * scanlines;
  }
  Bits bits(in + 4, in_len - 4);
  std::vector<uint32_t> samples;
  const int64_t got = aec_decode(bits, bps, ppb, rsi, (options & kNN) != 0,
                                 n, samples);
  samples.resize(got);
  if (pad) {  // drop each scanline's padding
    std::vector<uint32_t> kept;
    for (int64_t s = 0; s * rsi * ppb < got; ++s)
      for (int64_t i = s * rsi * ppb; i < s * rsi * ppb + ppsl && i < got;
           ++i)
        kept.push_back(samples[i]);
    samples.swap(kept);
  }
  if ((int64_t)samples.size() * psize < out_len) return -2;
  const bool msb = (options & kMSB) != 0;
  std::vector<uint8_t> bytes(samples.size() * psize);
  for (size_t i = 0; i < samples.size(); ++i)
    for (int b = 0; b < psize; ++b)
      bytes[i * psize + b] = (uint8_t)(
          samples[i] >> (8 * (msb ? psize - 1 - b : b)));
  if (planes) {  // byte j of word i is at j * words + i
    const int w = bpp / 8;
    const int64_t words = out_len / w;
    for (int64_t i = 0; i < words; ++i)
      for (int j = 0; j < w; ++j) out[i * w + j] = bytes[j * words + i];
  } else {
    std::memcpy(out, bytes.data(), out_len);
  }
  return out_len;
}

}  // extern "C"
