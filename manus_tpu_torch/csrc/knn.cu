// The nearest reference point of every query point, for NVIDIA Hopper
// (sm_90a): the contact search of the composite stage and the voxel
// grid's distances. Plain C interface, loaded with ctypes
// (manus_tpu_torch/ops/knn.py, nearest_neighbor_cuda).
//
// Replaces no Pallas kernel: the JAX package's nearest_neighbor
// (manus_tpu/ops/knn.py) is plain JAX, a blockwise |x|^2 + |y|^2 - 2 x.y
// with an argmin. It was added because that search, as separate torch
// operations over [1024, M] float32 slabs in device memory, took ~95% of
// a composite frame's device time on an H100.
//
// Math, in float32 throughout (no TF32, no tensor cores), for query x and
// references y_j:
//   w_j = |y_j|^2, or +inf where y_j is not valid, and a = -2 x;
//   d2 = |x|^2 + min_j (w_j + a.y_j), the inner term three FMAs a pair:
//        fma(a.z, y.z, fma(a.y, y.y, fma(a.x, y.x, w)));
//   dist = sqrt(max(d2, 0)), idx the lowest j that reaches the minimum.
// |x|^2 is constant over a row and is added after the minimum, so the
// argmin is the same. The error on d2 stays under 8 u (|x| + |y|)^2, the
// bound the expansion has on every path of the port. An invalid
// reference is never chosen (w = +inf), at no cost in the loop. With no
// valid reference, dist = inf and idx = 0.
//
// What bounds it on an H100: instructions. A pair is 3 FFMA and one
// FMNMX, and nothing else at the loop's steady state; no operand comes
// from device memory (the whole reference cloud, 16 bytes a point,
// stays in the 50 MB L2). Each of an SM's 4 schedulers starts one warp
// instruction a clock: 132 x 128 lanes x 1.98 GHz = 3.35e13 lane
// instructions a second, so the 3 FFMA alone bound a 131,072 x 131,072
// search at 1.54 ms, the 4 instructions of a pair at 2.05 ms.
//
// The design:
//   * a CTA of kThreads threads holds kQueries queries a thread in
//     registers (a, and the running minimum of each), and stages
//     kTile references at a time in shared memory as packed float4
//     (x, y, z, w): one load a thread, w computed there. Every lane then
//     reads the same reference, a broadcast 16-byte load that feeds
//     kQueries pairs;
//   * the argmin costs nothing a pair. The loop keeps only the minimum
//     over each run of kChunk references (one FMNMX a pair), and after
//     each run, a query whose run minimum beats its best (strict <)
//     records the run's start: 3 instructions a query every kChunk
//     references. After the last run, each query scans its recorded
//     run again from device memory (L2), computing the same pair values
//     bit for bit (the same FMAs on the same operands), and takes the
//     lowest index whose value equals the minimum. So ties go to the
//     lowest index: the earliest run that reaches the minimum, and in it
//     the earliest reference;
//   * the references are split into `slices` contiguous slices, a CTA
//     per (query block, slice), so that at 131,072 queries (64 query
//     blocks) the grid still fills the card; the plan (ops/knn.py
//     knn_plan) takes the number from N, M and the SM count. With one
//     slice the CTA writes dist and idx itself. With more, each writes
//     its slice's (minimum, index) to a workspace and a second kernel
//     merges them in slice order, the lower slice winning on equal
//     values, so the result has the same bits for every number of
//     slices.
// Ragged N and M: a query block's tail reads the last query again and
// writes nothing; a tile's tail holds (0, 0, 0, +inf) and a run past the
// slice's end is not computed.
//
// Measured on an H100 (700 W; 1,980 MHz throughout the load): ptxas
// gives the search kernel 96 registers and no spill; its run loop, fully
// unrolled, is 4.26 instructions a pair (1,090 for 256 pairs in the
// SASS); a 131,072 x 131,072 search with 90% of the references valid
// takes 2.85-2.98 ms at 4 slices (1.9x the FFMA bound; one slice 5.6-5.7
// ms). No faster: 3 CTAs an SM (80 registers, spills), 4 queries a
// thread at 4 CTAs an SM, 16 at one, runs of 64, the run loop unrolled
// by 8, and the next tile's loads in flight over the current tile's
// pairs.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kQueries = 8;   // queries a thread
constexpr int kTile = 256;    // references staged a step, one a thread
constexpr int kChunk = 32;    // references a run minimum covers
constexpr int kCtasPerSm = 2;  // __launch_bounds__: 128 registers a thread
constexpr int kBlockQueries = kThreads * kQueries;
constexpr int kMergeThreads = 256;

static_assert(kTile == kThreads, "one staged reference a thread");
static_assert(kTile % kChunk == 0, "runs tile the staged references");

// Reference j as read: (x, y, z, 1 if valid else 0).
__device__ __forceinline__ float4 read_ref(const float* __restrict__ ref,
                                           const uint8_t* __restrict__ valid,
                                           int j) {
  return make_float4(ref[3 * j], ref[3 * j + 1], ref[3 * j + 2],
                     valid == nullptr || valid[j] != 0 ? 1.0f : 0.0f);
}

// The packed reference: (x, y, z, |y|^2), w = +inf where not valid.
// Explicit roundings, so every inlined copy gives the same bits.
__device__ __forceinline__ float4 pack_ref(float4 r) {
  const float w = __fmaf_rn(r.z, r.z, __fmaf_rn(r.y, r.y, __fmul_rn(r.x, r.x)));
  return make_float4(r.x, r.y, r.z, r.w != 0.0f ? w : CUDART_INF_F);
}

// w + a.y for a = -2 x: the pair's value, 3 FMAs.
__device__ __forceinline__ float pair_value(float ax, float ay, float az,
                                            float4 r) {
  return __fmaf_rn(az, r.z, __fmaf_rn(ay, r.y, __fmaf_rn(ax, r.x, r.w)));
}

// dist from the minimum over the references and the query itself.
__device__ __forceinline__ float finish(const float* __restrict__ q, int i,
                                        float best) {
  const float x = q[3 * i], y = q[3 * i + 1], z = q[3 * i + 2];
  const float sx = __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                             __fmul_rn(z, z));
  return __fsqrt_rn(fmaxf(__fadd_rn(sx, best), 0.0f));
}

// Grid (query blocks, slices). Slice s covers references
// [s * slice_len, min((s + 1) * slice_len, m)). With one slice, writes
// dist and idx; with more, the slice's minimum and index at
// part_d / part_i [s * n + i].
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
knn_search_kernel(const float* __restrict__ q, int n,
                  const float* __restrict__ ref,
                  const uint8_t* __restrict__ valid, int m, int slice_len,
                  float* __restrict__ part_d, int* __restrict__ part_i,
                  float* __restrict__ dist, int* __restrict__ idx) {
  __shared__ float4 tile[kTile];
  const int t = threadIdx.x;
  const int q0 = blockIdx.x * kBlockQueries;
  const int lo = blockIdx.y * slice_len;
  const int hi = min(lo + slice_len, m);

  float ax[kQueries], ay[kQueries], az[kQueries], best[kQueries];
  int run[kQueries];
#pragma unroll
  for (int k = 0; k < kQueries; ++k) {
    const int i = min(q0 + k * kThreads + t, n - 1);
    ax[k] = __fmul_rn(-2.0f, q[3 * i]);
    ay[k] = __fmul_rn(-2.0f, q[3 * i + 1]);
    az[k] = __fmul_rn(-2.0f, q[3 * i + 2]);
    best[k] = CUDART_INF_F;
    run[k] = -1;
  }

  // A tile's tail: an invalid reference, never chosen (w = +inf).
  const float4 pad = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int t0 = lo; t0 < hi; t0 += kTile) {
    const int j = t0 + t;
    tile[t] = pack_ref(j < hi ? read_ref(ref, valid, j) : pad);
    __syncthreads();
    const int runs = (min(kTile, hi - t0) + kChunk - 1) / kChunk;
    for (int c = 0; c < runs; ++c) {
      float cm[kQueries];
#pragma unroll
      for (int k = 0; k < kQueries; ++k) cm[k] = CUDART_INF_F;
      const float4* rp = tile + c * kChunk;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float4 r = rp[jj];
#pragma unroll
        for (int k = 0; k < kQueries; ++k)
          cm[k] = fminf(cm[k], pair_value(ax[k], ay[k], az[k], r));
      }
      const int start = t0 + c * kChunk;
#pragma unroll
      for (int k = 0; k < kQueries; ++k) {
        if (cm[k] < best[k]) {
          best[k] = cm[k];
          run[k] = start;
        }
      }
    }
    __syncthreads();
  }

  // The recorded run again: the lowest index whose value is the minimum.
#pragma unroll
  for (int k = 0; k < kQueries; ++k) {
    const int i = q0 + k * kThreads + t;
    if (i < n) {
      int found = 0;
      if (run[k] >= 0) {
        found = run[k];
#pragma unroll 8
        for (int jj = kChunk - 1; jj >= 0; --jj) {
          const int j = run[k] + jj;
          if (j < hi && pair_value(ax[k], ay[k], az[k], pack_ref(read_ref(
                                       ref, valid, j))) == best[k])
            found = j;
        }
      }
      if (part_d != nullptr) {
        part_d[(size_t)blockIdx.y * n + i] = best[k];
        part_i[(size_t)blockIdx.y * n + i] = found;
      } else {
        dist[i] = finish(q, i, best[k]);
        idx[i] = found;
      }
    }
  }
}

// The slices' results in slice order: a strictly smaller value wins, so
// on equal values the lower slice, and with it the lower index.
__global__ void __launch_bounds__(kMergeThreads)
knn_merge_kernel(const float* __restrict__ q, int n, int slices,
                 const float* __restrict__ part_d,
                 const int* __restrict__ part_i, float* __restrict__ dist,
                 int* __restrict__ idx) {
  const int i = blockIdx.x * kMergeThreads + threadIdx.x;
  if (i >= n) return;
  float best = part_d[i];
  int found = part_i[i];
  for (int s = 1; s < slices; ++s) {
    const float v = part_d[(size_t)s * n + i];
    if (v < best) {
      best = v;
      found = part_i[(size_t)s * n + i];
    }
  }
  dist[i] = finish(q, i, best);
  idx[i] = found;
}

}  // namespace

extern "C" {

// The kernel's fixed shape, for the host's plan: threads a CTA, queries a
// thread, references staged a step, references a run, CTAs an SM.
void knn_config(int* out) {
  out[0] = kThreads;
  out[1] = kQueries;
  out[2] = kTile;
  out[3] = kChunk;
  out[4] = kCtasPerSm;
}

// CTAs of the search kernel an SM holds, as the runtime computes it.
int knn_occupancy(int* ctas) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas, knn_search_kernel, kThreads, 0);
}

// dist [n] float32 and idx [n] int32 of queries q [n, 3] against ref
// [m, 3] (float32, contiguous), valid [m] bytes or null, over `slices`
// slices of slice_len references; with more than one slice, part_d and
// part_i hold slices * n values each. n, m >= 1.
int knn_nearest(const float* q, int n, const float* ref,
                const uint8_t* valid, int m, int slices, int slice_len,
                float* part_d, int* part_i, float* dist, int* idx,
                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((n + kBlockQueries - 1) / kBlockQueries, slices);
  const bool merge = slices > 1;
  knn_search_kernel<<<grid, kThreads, 0, s>>>(
      q, n, ref, valid, m, slice_len, merge ? part_d : nullptr,
      merge ? part_i : nullptr, dist, idx);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !merge) return (int)err;
  knn_merge_kernel<<<(n + kMergeThreads - 1) / kMergeThreads,
                     kMergeThreads, 0, s>>>(q, n, slices, part_d, part_i,
                                            dist, idx);
  return (int)cudaGetLastError();
}

const char* knn_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
