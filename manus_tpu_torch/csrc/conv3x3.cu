// 3x3 SAME stride-1 convolution on the flat padded layout, and the dx of a
// ReLU'd layer, for NVIDIA Hopper (sm_90a). Plain C interface, loaded with
// ctypes (manus_tpu_torch/ops/conv.py).
//
// Replaces the Pallas TPU kernels of manus_tpu/ops/conv_pallas.py:
// conv3x3_layout_kernel<false> replaces _conv_layout_kernel (the
// pallas_call of conv3x3_layout_raw, and of conv3x3_raw on an image's
// layout); conv3x3_layout_kernel<true> replaces _conv_dx_layout_kernel
// (conv3x3_layout_dx_raw).
//
// Layout. x is [rows, ci] bf16, pixel (y, px) of an H x W map at row
// m_blk + y*(W+2) + px; every other row is zero. Output row r reads the
// 9 input rows r + (dy-1)*(W+2) + (dx-1), tap = 3*dy + dx, so a conv is an
// implicit GEMM: out[r, n] = sum over k = tap*ci + c of
// x[r + off(tap), c] * w[k, n], with K = 9*ci, and each tap's A operand a
// contiguous window of rows (no im2col gather). The epilogue adds the
// bias, applies ReLU, and zeroes each row that holds no pixel:
// q = r - m_blk must satisfy 0 <= q < H*(W+2) and q % (W+2) < W. So a
// layer's output is the next layer's input, borders and all.
// The dx kernel is the same GEMM with the dx weights (the forward's,
// flipped in space with ci and co swapped), no bias and no ReLU, and its
// A operand zeroed where the layer's output y is not > 0 (the ReLU mask,
// applied as the tile is loaded).
//
// What bounds it on an H100. A VGG16 layer at 512x512 does 2*H*W*9*ci*co
// operations on bf16 operands, 20 to 420 per byte it must move, against
// the card's ~295 (989 TFLOP/s over 3.35 TB/s): the 512x512 stage's
// layers are bound by memory, the later stages' by the tensor cores.
// Design, a first simple form: one CTA of 8 warps computes a 128-row x
// 64-channel output tile with nvcuda::wmma bf16 16x16x16 fragments and fp32
// accumulators (each warp a 32x32 sub-tile), walking K in chunks of 32.
// The next chunk's A and B tiles are loaded into registers while the
// current chunk's MMAs run, then stored to the other shared-memory
// buffer: one __syncthreads per chunk. A tile's rows overlap their
// neighbours' by up to 2*(W+2)+2 rows (the halo), which L1/L2 serve.
// A CTA whose 128 rows hold no pixel writes zeros and returns. wgmma,
// TMA and a ring of stages are for a later version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int kBM = 128;  // output rows per CTA
constexpr int kBN = 64;   // output channels per CTA
constexpr int kBK = 32;   // K per chunk
constexpr int kThreads = 256;
// Shared-memory row strides (elements). wmma needs 32-byte aligned tile
// pointers, so a row of A or B is a multiple of 16 bf16; the +16 skews the
// banks of consecutive rows.
constexpr int kALd = kBK + 16;  // 48
constexpr int kBLd = kBN + 16;  // 80
constexpr int kCLd = kBN + 4;   // fp32 epilogue staging
constexpr int kASize = kBM * kALd;  // elements per A buffer
constexpr int kBSize = kBK * kBLd;
constexpr int kPipeBytes = 2 * (kASize + kBSize) * 2;
constexpr int kEpiBytes = kBM * kCLd * 4;
constexpr int kSmemBytes = kPipeBytes > kEpiBytes ? kPipeBytes : kEpiBytes;
// A chunk is kBM x kBK = 512 16-byte segments (2 per thread); B is
// kBK x kBN = 256 segments (1 per thread).
constexpr int kASegs = kBM * kBK / 8 / kThreads;

struct Params {
  const bf16* x;     // [rows, ci]
  const bf16* mask;  // [rows, ci] or null: A is zeroed where mask <= 0
  const bf16* w;     // [9*ci, co]
  const float* bias; // [co] or null
  bf16* y;           // [rows, co]
  int rows, ci, co, w2, m_blk, n_valid, relu;
};

__device__ __forceinline__ bool pixel_row(const Params& p, int r) {
  const int q = r - p.m_blk;
  return q >= 0 && q < p.n_valid && q % p.w2 < p.w2 - 2;
}

__device__ __forceinline__ uint4 relu_mask(uint4 v, uint4 m) {
  const bf16* mv = reinterpret_cast<const bf16*>(&m);
  uint16_t* vv = reinterpret_cast<uint16_t*>(&v);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    if (!(__bfloat162float(mv[e]) > 0.0f)) vv[e] = 0;
  }
  return v;
}

template <bool kMask>
__global__ void __launch_bounds__(kThreads) conv3x3_layout_kernel(Params p) {
  __shared__ __align__(128) unsigned char smem[kSmemBytes];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + 2 * kASize;
  float* Cs = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int ksize = 9 * p.ci;
  const int nk = (ksize + kBK - 1) / kBK;

  // A CTA whose rows hold no pixel writes zeros.
  if (r0 + kBM <= p.m_blk || r0 >= p.m_blk + p.n_valid) {
    for (int s = tid; s < kBM * kBN / 8; s += kThreads) {
      const int r = r0 + s / (kBN / 8);
      const int n = n0 + (s % (kBN / 8)) * 8;
      if (r < p.rows && n < p.co) {
        *reinterpret_cast<uint4*>(p.y + (int64_t)r * p.co + n) =
            make_uint4(0, 0, 0, 0);
      }
    }
    return;
  }

  uint4 ra[kASegs], rb;

  auto load_chunk = [&](int kc) {
#pragma unroll
    for (int i = 0; i < kASegs; ++i) {
      const int s = tid + i * kThreads;
      const int m = s / (kBK / 8);
      const int k = kc * kBK + (s % (kBK / 8)) * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (k < ksize) {
        const int tap = k / p.ci;
        const int c = k - tap * p.ci;
        const int src = r0 + m + (tap / 3 - 1) * p.w2 + (tap % 3 - 1);
        if (src >= 0 && src < p.rows) {
          const int64_t at = (int64_t)src * p.ci + c;
          v = *reinterpret_cast<const uint4*>(p.x + at);
          if (kMask) {
            v = relu_mask(v, *reinterpret_cast<const uint4*>(p.mask + at));
          }
        }
      }
      ra[i] = v;
    }
    {
      const int kk = tid / (kBN / 8);
      const int k = kc * kBK + kk;
      const int n = n0 + (tid % (kBN / 8)) * 8;
      rb = make_uint4(0, 0, 0, 0);
      if (k < ksize && n < p.co) {
        rb = *reinterpret_cast<const uint4*>(p.w + (int64_t)k * p.co + n);
      }
    }
  };
  auto store_chunk = [&](int buf) {
    bf16* a = As + buf * kASize;
#pragma unroll
    for (int i = 0; i < kASegs; ++i) {
      const int s = tid + i * kThreads;
      *reinterpret_cast<uint4*>(a + (s / (kBK / 8)) * kALd +
                                (s % (kBK / 8)) * 8) = ra[i];
    }
    bf16* b = Bs + buf * kBSize;
    *reinterpret_cast<uint4*>(b + (tid / (kBN / 8)) * kBLd +
                              (tid % (kBN / 8)) * 8) = rb;
  };

  const int warp = tid / 32;
  const int wm = (warp % 4) * 32;  // the warp's 32 x 32 sub-tile
  const int wn = (warp / 4) * 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  load_chunk(0);
  store_chunk(0);
  __syncthreads();
  for (int kc = 0; kc < nk; ++kc) {
    const int buf = kc & 1;
    if (kc + 1 < nk) load_chunk(kc + 1);
    const bf16* a = As + buf * kASize;
    const bf16* b = Bs + buf * kBSize;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], a + (wm + 16 * i) * kALd + kk, kALd);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], b + kk * kBLd + wn + 16 * j, kBLd);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    if (kc + 1 < nk) store_chunk(buf ^ 1);
    __syncthreads();
  }

  // Epilogue: stage the fp32 tile in shared memory (the pipeline buffers
  // are free after the last __syncthreads), then bias, ReLU, the pixel
  // mask and the bf16 store, 8 channels (16 bytes) per thread and step.
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm + 16 * i) * kCLd + wn + 16 * j,
                              acc[i][j], kCLd, wmma::mem_row_major);
  __syncthreads();
  for (int s = tid; s < kBM * kBN / 8; s += kThreads) {
    const int m = s / (kBN / 8);
    const int nn = (s % (kBN / 8)) * 8;
    const int r = r0 + m;
    const int n = n0 + nn;
    if (r >= p.rows || n >= p.co) continue;
    const bool keep = pixel_row(p, r);
    uint4 out;
    bf16* ov = reinterpret_cast<bf16*>(&out);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float v = Cs[m * kCLd + nn + e];
      if (p.bias != nullptr) v = p.bias[n + e] + v;
      if (p.relu) v = fmaxf(v, 0.0f);
      ov[e] = __float2bfloat16(keep ? v : 0.0f);
    }
    *reinterpret_cast<uint4*>(p.y + (int64_t)r * p.co + n) = out;
  }
}

}  // namespace

extern "C" {

// y = conv(x) on the layout; with mask non-null, the dx form (A zeroed
// where mask <= 0). ci and co must be multiples of 8, every pointer 16-byte
// aligned. w is the image width W; m_blk and n_valid = H*(W+2) as in
// StageLayout.
int conv3x3_layout(const void* x, const void* mask, const void* w,
                   const float* bias, void* y, int rows, int ci, int co,
                   int width, int m_blk, int n_valid, int relu,
                   void* stream) {
  if (ci % 8 != 0 || co % 8 != 0 || rows <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  Params p;
  p.x = static_cast<const bf16*>(x);
  p.mask = static_cast<const bf16*>(mask);
  p.w = static_cast<const bf16*>(w);
  p.bias = bias;
  p.y = static_cast<bf16*>(y);
  p.rows = rows;
  p.ci = ci;
  p.co = co;
  p.w2 = width + 2;
  p.m_blk = m_blk;
  p.n_valid = n_valid;
  p.relu = relu;
  const dim3 grid((rows + kBM - 1) / kBM, (co + kBN - 1) / kBN);
  if (mask != nullptr) {
    conv3x3_layout_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(p);
  } else {
    conv3x3_layout_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(p);
  }
  return (int)cudaGetLastError();
}

const char* conv3x3_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
