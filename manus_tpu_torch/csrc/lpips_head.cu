// The LPIPS head of one stage, forward and closed-form backward, for NVIDIA
// Hopper (sm_90a). Plain C interface, loaded with ctypes
// (manus_tpu_torch/ops/conv.py).
//
// Replaces the Pallas TPU kernels of manus_tpu/ops/conv_pallas.py:
// lpips_head_fwd_kernel replaces _head_fwd_kernel (_head_fwd_call),
// lpips_head_bwd_kernel replaces _head_bwd_kernel (_head_bwd_call).
//
// Math, per row of the [rows, C] bf16 feature pair (a, b), in fp32:
//   ra = |a|, rb = |b| (over the C channels), na = a / (ra + 1e-10), ...
//   forward:  sum over rows and channels of (na - nb)^2 * lin[c]
//   backward: g = 2 lin ct (na - nb),
//             da = g / (ra + eps) - a (a.g) / (safe(ra) (ra + eps)^2),
//             db = -(the same in b), safe(r) = r > 0 ? r : 1,
//   where ct is the cotangent of the forward's scalar. da and db are
//   bf16, the features' type. Rows that hold no pixel are zero in a and b
//   and add nothing.
//
// What bounds it on an H100. A row is read once (2 * C * 2 bytes) for
// about 10 fp32 operations per channel, so both kernels are bound by
// memory: 3.35 TB/s. Design: one warp per row, a lane holding channels
// lane, lane + 32, ... in registers (C <= 512, so at most 16 each), so a
// row's norms, dot products and outputs come from one read; warp shuffles
// reduce over channels. The forward writes one partial sum per CTA of
// kRowsPerCta rows, summed in a fixed order: lanes by a butterfly, rows in
// order within a warp, warps in order within the CTA; the caller sums the
// partials. No float atomics, so two runs give the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 8;
constexpr int kRowsPerCta = kWarps * kRowsPerWarp;
constexpr int kMaxPerLane = 16;  // C <= 512
constexpr float kEps = 1e-10f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Load row r's channels of lane into av/bv (zero past C); returns the
// squared norms via sa/sb, reduced over the warp.
__device__ __forceinline__ void load_row(
    const bf16* __restrict__ a, const bf16* __restrict__ b, int64_t r, int c,
    int lane, float* av, float* bv, float* ra, float* rb) {
  float sa = 0.0f, sb = 0.0f;
#pragma unroll
  for (int j = 0; j < kMaxPerLane; ++j) {
    const int ch = lane + 32 * j;
    av[j] = 0.0f;
    bv[j] = 0.0f;
    if (ch < c) {
      av[j] = __bfloat162float(a[r * c + ch]);
      bv[j] = __bfloat162float(b[r * c + ch]);
    }
    sa += av[j] * av[j];
    sb += bv[j] * bv[j];
  }
  *ra = sqrtf(warp_sum(sa));
  *rb = sqrtf(warp_sum(sb));
}

__global__ void __launch_bounds__(kThreads) lpips_head_fwd_kernel(
    const bf16* __restrict__ a, const bf16* __restrict__ b,
    const float* __restrict__ lin, int rows, int c,
    float* __restrict__ partials) {
  __shared__ float warp_part[kWarps];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float part = 0.0f;
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int64_t r = (int64_t)blockIdx.x * kRowsPerCta + warp * kRowsPerWarp + i;
    if (r >= rows) break;
    float av[kMaxPerLane], bv[kMaxPerLane], ra, rb;
    load_row(a, b, r, c, lane, av, bv, &ra, &rb);
    float d = 0.0f;
#pragma unroll
    for (int j = 0; j < kMaxPerLane; ++j) {
      const int ch = lane + 32 * j;
      if (ch < c) {
        const float diff = av[j] / (ra + kEps) - bv[j] / (rb + kEps);
        d += diff * diff * lin[ch];
      }
    }
    part += warp_sum(d);
  }
  if (lane == 0) warp_part[warp] = part;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += warp_part[w];
    partials[blockIdx.x] = s;
  }
}

__global__ void __launch_bounds__(kThreads) lpips_head_bwd_kernel(
    const bf16* __restrict__ a, const bf16* __restrict__ b,
    const float* __restrict__ lin, const float* __restrict__ ct, int rows,
    int c, bf16* __restrict__ da, bf16* __restrict__ db) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const float cot = *ct;
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int64_t r = (int64_t)blockIdx.x * kRowsPerCta + warp * kRowsPerWarp + i;
    if (r >= rows) break;
    float av[kMaxPerLane], bv[kMaxPerLane], ra, rb;
    load_row(a, b, r, c, lane, av, bv, &ra, &rb);
    float g[kMaxPerLane];
    float dot_a = 0.0f, dot_b = 0.0f;
#pragma unroll
    for (int j = 0; j < kMaxPerLane; ++j) {
      const int ch = lane + 32 * j;
      g[j] = 0.0f;
      if (ch < c) {
        const float lin_scaled = lin[ch] * cot;
        g[j] = 2.0f * lin_scaled * (av[j] / (ra + kEps) - bv[j] / (rb + kEps));
      }
      dot_a += av[j] * g[j];
      dot_b += bv[j] * g[j];
    }
    dot_a = warp_sum(dot_a);
    dot_b = warp_sum(dot_b);
    const float ea = ra + kEps, eb = rb + kEps;
    const float ka = dot_a / ((ra > 0.0f ? ra : 1.0f) * (ea * ea));
    const float kb = dot_b / ((rb > 0.0f ? rb : 1.0f) * (eb * eb));
#pragma unroll
    for (int j = 0; j < kMaxPerLane; ++j) {
      const int ch = lane + 32 * j;
      if (ch < c) {
        da[r * c + ch] = __float2bfloat16(g[j] / ea - av[j] * ka);
        db[r * c + ch] = __float2bfloat16(-(g[j] / eb - bv[j] * kb));
      }
    }
  }
}

int num_ctas(int rows) { return (rows + kRowsPerCta - 1) / kRowsPerCta; }

}  // namespace

extern "C" {

// The number of partial sums lpips_head_fwd writes for `rows` rows.
int lpips_head_partials(int rows) { return num_ctas(rows); }

int lpips_head_fwd(const void* a, const void* b, const float* lin, int rows,
                   int c, float* partials, void* stream) {
  if (c <= 0 || c > 32 * kMaxPerLane || rows <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  lpips_head_fwd_kernel<<<num_ctas(rows), kThreads, 0,
                          (cudaStream_t)stream>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b), lin, rows, c,
      partials);
  return (int)cudaGetLastError();
}

int lpips_head_bwd(const void* a, const void* b, const float* lin,
                   const float* ct, int rows, int c, void* da, void* db,
                   void* stream) {
  if (c <= 0 || c > 32 * kMaxPerLane || rows <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  lpips_head_bwd_kernel<<<num_ctas(rows), kThreads, 0,
                          (cudaStream_t)stream>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b), lin, ct, rows,
      c, static_cast<bf16*>(da), static_cast<bf16*>(db));
  return (int)cudaGetLastError();
}

const char* lpips_head_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
