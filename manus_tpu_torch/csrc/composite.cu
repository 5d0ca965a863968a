// Tile compositing of depth-ordered gaussian pairs, forward and backward,
// for NVIDIA Hopper (sm_90a). Plain C interface, loaded with ctypes.
//
// Replaces the Pallas TPU kernels of manus_tpu/ops/rasterizer/
// pallas_backend.py: composite_fwd_kernel replaces _make_fwd_kernel,
// composite_bwd_kernel replaces _make_bwd_kernel (the custom VJP of
// _make_composite).
//
// Layout. payload is field-major [16, P] float32: rows mean x, mean y,
// conic a, b, c, opacity, r, g, b, then padding (payload.py). Tile t owns
// the pair columns [offsets[t], offsets[t] + counts[t]), depth-ordered.
// One CTA composites one 16x16 tile, one thread per pixel; the pixel
// centre of thread i in tile t is (tx*16 + i%16, ty*16 + i/16) with
// tx = t % ntx, ty = t / ntx (integer coordinates).
//
// Numerics (the JAX kernel's, pair by pair):
//   power = -0.5 (a dx^2 + c dy^2) - b dx dy,  skipped where power > 0
//   alpha = min(opacity exp(power), 0.99),      skipped where < 1/255
//   log T accumulates log1p(-alpha); a pair is included while
//   log T after it >= log(1e-4), and the walk of a pixel ends at the first
//   pair that is not; T_final is the min T over the included pairs.
// The 0.99 clamp is straight-through in the backward: d opacity and
// d power use exp(power) as if unclamped.
//
// What bounds it on an H100. The forward reads 36 bytes per pair of the
// walked batches once per tile (from shared memory 256 times) and writes
// 24 bytes per pixel; it does about 32 float operations per pixel-pair,
// three of them transcendental, so a tile with more than a few dozen
// walked pairs is bound by the SMs' float and SFU rate, not by memory.
// One CTA walks its tile's pairs in order, so a scene whose pairs crowd
// into a few tiles is bound by the deepest tile's serial walk on one SM.
// Design: the batch of pairs is staged once into shared memory by the
// whole CTA (coalesced, one field row at a time) and each thread walks it
// in order from shared memory; a per-pixel done flag and a block vote
// (__syncthreads_count) end the walk as soon as every pixel is saturated,
// so the farthest pairs of an opaque tile are never read.
// The backward redoes the forward's alpha (the same inline function, so
// the same gates), about 61 operations per pixel-pair in all, and
// reduces nine gradient values per pair over the 256 pixels: warp
// shuffles, then a deterministic sum over the 8 warps in shared memory.
// Each pair lies in exactly one tile segment, so each d_payload column
// is written by exactly one CTA, once: no global atomics. It walks from
// each pixel's last included pair back to the front and rebuilds T from
// the forward's final log T by subtracting log1p(-alpha) (the log-domain
// form of the analytic T / (1 - alpha) rebuild, as the JAX kernel does).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;
constexpr int kPixels = kTile * kTile;  // threads per CTA
constexpr int kLive = 9;                // live payload fields
constexpr int kFwdBatch = 256;          // pairs staged per forward batch
constexpr int kBwdBatch = 128;          // pairs staged per backward batch
constexpr int kWarps = kPixels / 32;
constexpr float kAlphaEps = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
// log(1e-4) in float32, the JAX kernel's LOG_T_EPS
constexpr float kLogTEps = -9.210340371976182f;

// Alpha of one pair at one pixel; false where a gate drops the pair.
__device__ __forceinline__ bool pair_alpha(
    float dx, float dy, float ca, float cb, float cc, float op,
    float* alpha, float* g) {
  const float power = -0.5f * (ca * dx * dx + cc * dy * dy) - cb * dx * dy;
  if (!(power <= 0.0f)) return false;
  *g = expf(power);
  *alpha = fminf(op * *g, kAlphaMax);
  return *alpha >= kAlphaEps;
}

__global__ void __launch_bounds__(kPixels) composite_fwd_kernel(
    const float* __restrict__ payload, int64_t P,
    const int* __restrict__ offsets, const int* __restrict__ counts, int ntx,
    float* __restrict__ rgb,     // [T, 3, 256]
    float* __restrict__ t_final, // [T, 256]
    float* __restrict__ log_t,   // [T, 256] log T after the last included pair
    int* __restrict__ n_walk) {  // [T, 256] index + 1 of the last included pair
  __shared__ float s[kLive][kFwdBatch];
  const int t = blockIdx.x;
  const int i = threadIdx.x;
  const float px = (float)((t % ntx) * kTile + i % kTile);
  const float py = (float)((t / ntx) * kTile + i / kTile);
  const int64_t start = offsets[t];
  const int count = counts[t];

  float lt = 0.0f, tmin = 1.0f, cr = 0.0f, cg = 0.0f, cb_ = 0.0f;
  int last = 0;
  bool done = false;
  for (int b0 = 0; b0 < count; b0 += kFwdBatch) {
    // every thread has finished the previous batch: safe to overwrite
    if (__syncthreads_count(!done) == 0) break;
    const int n = min(kFwdBatch, count - b0);
    if (i < n) {
#pragma unroll
      for (int f = 0; f < kLive; ++f) s[f][i] = payload[f * P + start + b0 + i];
    }
    __syncthreads();
    for (int j = 0; j < n && !done; ++j) {
      float alpha, g;
      if (!pair_alpha(px - s[0][j], py - s[1][j], s[2][j], s[3][j], s[4][j],
                      s[5][j], &alpha, &g))
        continue;
      const float log1m = log1pf(-alpha);
      const float lt_after = lt + log1m;
      if (!(lt_after >= kLogTEps)) {
        done = true;
        break;
      }
      const float t_bef = expf(lt);
      const float w = alpha * t_bef;
      cr += w * s[6][j];
      cg += w * s[7][j];
      cb_ += w * s[8][j];
      tmin = fminf(tmin, t_bef * (1.0f - alpha));
      lt = lt_after;
      last = b0 + j + 1;
    }
  }
  const int64_t o = (int64_t)t * kPixels + i;
  rgb[(int64_t)t * 3 * kPixels + i] = cr;
  rgb[(int64_t)t * 3 * kPixels + kPixels + i] = cg;
  rgb[(int64_t)t * 3 * kPixels + 2 * kPixels + i] = cb_;
  t_final[o] = tmin;
  log_t[o] = lt;
  n_walk[o] = last;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

__global__ void __launch_bounds__(kPixels) composite_bwd_kernel(
    const float* __restrict__ payload, int64_t P,
    const int* __restrict__ offsets, const int ntx,
    const float* __restrict__ d_rgb,    // [T, 3, 256]
    const float* __restrict__ d_tfin,   // [T, 256]
    const float* __restrict__ t_final,  // [T, 256]
    const float* __restrict__ log_t,    // [T, 256]
    const int* __restrict__ n_walk,     // [T, 256]
    float* __restrict__ d_payload) {    // [16, P], zero on entry
  __shared__ float s[kLive][kBwdBatch];
  __shared__ float red[kWarps][kLive][kBwdBatch];
  __shared__ int walk_max;
  const int t = blockIdx.x;
  const int i = threadIdx.x;
  const int lane = i & 31, warp = i >> 5;
  const float px = (float)((t % ntx) * kTile + i % kTile);
  const float py = (float)((t / ntx) * kTile + i / kTile);
  const int64_t start = offsets[t];
  const int64_t o = (int64_t)t * kPixels + i;
  const int my_walk = n_walk[o];

  if (i == 0) walk_max = 0;
  __syncthreads();
  atomicMax(&walk_max, my_walk);
  __syncthreads();
  const int walk = walk_max;
  if (walk == 0) return;  // uniform: nothing of this tile was composited

  const float dr = d_rgb[(int64_t)t * 3 * kPixels + i];
  const float dg = d_rgb[(int64_t)t * 3 * kPixels + kPixels + i];
  const float db = d_rgb[(int64_t)t * 3 * kPixels + 2 * kPixels + i];
  const float tfin_term = t_final[o] * d_tfin[o];
  float lt = log_t[o];
  float suffix = 0.0f;  // sum of w * (dL/dC . c) over the included pairs behind

  for (int b_end = walk; b_end > 0; b_end -= kBwdBatch) {
    const int b0 = max(0, b_end - kBwdBatch);
    const int n = b_end - b0;
    if (i < n) {
#pragma unroll
      for (int f = 0; f < kLive; ++f) s[f][i] = payload[f * P + start + b0 + i];
    }
    __syncthreads();
    for (int j = n - 1; j >= 0; --j) {
      float c[kLive];
#pragma unroll
      for (int f = 0; f < kLive; ++f) c[f] = 0.0f;
      float alpha, g;
      const float dx = px - s[0][j], dy = py - s[1][j];
      const float ca = s[2][j], cb = s[3][j], cc = s[4][j], op = s[5][j];
      const bool act = (b0 + j < my_walk) &&
                       pair_alpha(dx, dy, ca, cb, cc, op, &alpha, &g);
      if (act) {
        const float log1m = log1pf(-alpha);
        const float lt_bef = lt - log1m;
        const float t_bef = expf(lt_bef);
        const float w = alpha * t_bef;
        const float cd = dr * s[6][j] + dg * s[7][j] + db * s[8][j];
        const float d_alpha = t_bef * cd - (suffix + tfin_term) / (1.0f - alpha);
        suffix += w * cd;
        lt = lt_bef;
        const float d_power = d_alpha * op * g;
        const float dpx = d_power * dx, dpy = d_power * dy;
        c[0] = ca * dpx + cb * dpy;      // d mean x
        c[1] = cc * dpy + cb * dpx;      // d mean y
        c[2] = -0.5f * dpx * dx;         // d conic a
        c[3] = -dpx * dy;                // d conic b
        c[4] = -0.5f * dpy * dy;         // d conic c
        c[5] = d_alpha * g;              // d opacity
        c[6] = w * dr;
        c[7] = w * dg;
        c[8] = w * db;
      }
      if (__any_sync(0xffffffffu, act)) {
#pragma unroll
        for (int f = 0; f < kLive; ++f) c[f] = warp_sum(c[f]);
      }
      if (lane == 0) {
#pragma unroll
        for (int f = 0; f < kLive; ++f) red[warp][f][j] = c[f];
      }
    }
    __syncthreads();
    for (int k = i; k < kLive * n; k += kPixels) {
      const int f = k / n, j = k - f * n;
      float v = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v += red[w][f][j];
      d_payload[f * P + start + b0 + j] = v;
    }
    // the next batch overwrites s and red
    __syncthreads();
  }
}

}  // namespace

extern "C" {

int composite_fwd(const float* payload, int64_t P, const int* offsets,
                  const int* counts, int num_tiles, int ntx, float* rgb,
                  float* t_final, float* log_t, int* n_walk, void* stream) {
  if (num_tiles > 0) {
    composite_fwd_kernel<<<num_tiles, kPixels, 0, (cudaStream_t)stream>>>(
        payload, P, offsets, counts, ntx, rgb, t_final, log_t, n_walk);
  }
  return (int)cudaGetLastError();
}

int composite_bwd(const float* payload, int64_t P, const int* offsets,
                  int num_tiles, int ntx, const float* d_rgb,
                  const float* d_tfin, const float* t_final,
                  const float* log_t, const int* n_walk, float* d_payload,
                  void* stream) {
  if (num_tiles > 0) {
    composite_bwd_kernel<<<num_tiles, kPixels, 0, (cudaStream_t)stream>>>(
        payload, P, offsets, ntx, d_rgb, d_tfin, t_final, log_t, n_walk,
        d_payload);
  }
  return (int)cudaGetLastError();
}

const char* composite_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
