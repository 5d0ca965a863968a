// The training step's SSIM term, forward and backward, for NVIDIA Hopper
// (sm_90a): the mean SSIM of two [H, W, 3] float32 images over an 11-tap
// Gaussian window with zero padding, and its gradient with respect to the
// first. Plain C interface, loaded with ctypes (manus_tpu_torch/utils/
// losses.py, ssim_fwd_cuda and ssim_bwd_cuda).
//
// Replaces no Pallas kernel: the JAX package's ssim (manus_tpu/utils/
// losses.py) blurs by multiplying with dense banded [W, W] and [H, H]
// matrices, a form that suits the TPU's matrix unit. On this card the
// same form cost a training step ten pageable host-to-device copies of the
// matrices (43 MB at 1280x720, each a host sync) and sixteen fp32 GEMMs
// (~88 GFLOP) for 0.6 GFLOP of taps. It was added for that.
//
// Math, in float32 throughout (no TF32, no tensor cores), for pred x and
// gt y, per pixel channel, with G the 11 taps the wrapper passes in (the
// float32 numbers the banded matrices hold) and zero padding (a border
// pixel sees fewer taps, with no renormalisation):
//   mu1 = G*x, mu2 = G*y, s11 = G*(x x) - mu1^2, s22 = G*(y y) - mu2^2,
//   s12 = G*(x y) - mu1 mu2;
//   A1 = 2 mu1 mu2 + C1, A2 = 2 s12 + C2, B1 = mu1^2 + mu2^2 + C1,
//   B2 = s11 + s22 + C2, s = A1 A2 / (B1 B2), C1 = 0.01^2, C2 = 0.03^2;
//   the value is the mean of s over the N = H W 3 pixel channels.
// Where the caller wants the gradient, the forward also writes the three
// partial maps of s that the backward blurs:
//   p2 = ds/ds11 = -s / B2,  p3 = ds/ds12 = 2 A1 / (B1 B2),
//   p1 = ds/dmu1 - 2 mu1 p2 - mu2 p3 (the sigma terms folded in), with
//        ds/dmu1 = 2 mu2 A2 / (B1 B2) - 2 mu1 s / B1.
// Backward, for the incoming gradient g of the mean:
//   dx = g / N [G*p1 + 2 x G*p2 + y G*p3].
// The window is symmetric, so the adjoint of the zero-padded blur is the
// same zero-padded blur. utils/losses.py ssim_partials and ssim_grad are
// this math in plain torch over the banded blur.
//
// What bounds it on an H100: bytes. The forward reads x and y and writes
// the three maps, 20 bytes a pixel channel (55 MB at 1280x720x3, 17 us at
// 3.35 TB/s); the backward reads the maps, x and y and writes dx, 24
// bytes (66 MB, 20 us). The taps are ~120 operations a pixel channel
// forward and ~70 backward, 0.5 GFLOP at that size: 8 us at the fp32 rate.
//
// The design:
//   * a row of the image is W * 3 floats; channel c of pixel j is element
//     3 j + c, and its taps are the elements 3 (j + k - 5) + c. So a tile
//     is kTileE elements of kTileH rows wherever its edges cut a pixel,
//     and an element past either end of a row is padding;
//   * a CTA stages its tile with a halo (kHaloE elements, kHalf rows) of
//     each input map in shared memory, zeros outside the image, with
//     16-byte loads where the row length and the pointers allow; runs the
//     horizontal pass from there into shared memory, and the vertical one
//     into registers. A staged element is read by up to 11 taps, and from
//     device memory once a CTA (the halo's re-reads come from L2);
//   * the mean: each CTA writes its partial sum (each thread's terms in
//     order, a butterfly over the warp, the warps in order) and takes a
//     ticket from an integer counter; the CTA that takes the last ticket
//     sums the partials in a fixed order and writes the mean. atomicInc
//     wraps the counter to 0 on the last ticket, so every launch and every
//     replay of a CUDA graph finds it at 0. No float atomics: two launches
//     give the same bits. The counter is this library's, one a device, so
//     the forward launches must run on one stream, as the port makes them;
//   * the backward blurs the maps the forward kept (33 MB at 1280x720)
//     rather than recomputing the statistics from x and y over a second
//     halo: one staged pass each way, and either way a launch is tens of
//     microseconds against a step of tens of milliseconds.
// Shared memory stays under the 48 KB a CTA gets without opting in, so
// five CTAs fit an SM.
//
// Measured on an H100 (700 W) at 1280x720x3: ptxas gives the forward 47
// registers and the backward 44, no spill; the forward takes 0.068 ms
// HBM-cold (4.1x its bytes bound; 0.058 without the maps), the backward
// 0.057 ms (2.9x), against 9 ms for the banded chain's forward and
// backward on the same card. What holds them there is instruction issue,
// not bytes: each tap of each output is a shared-memory load of its own
// (~75k a forward CTA) with its index arithmetic. A thread that walked a
// column over the tile's rows, keeping the window in registers, would
// load each staged value once.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTaps = 11;
constexpr int kHalf = kTaps / 2;
constexpr int kC = 3;          // channels: the elements between two taps
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileE = 64;     // elements a tile row
constexpr int kTileH = 12;     // rows a tile
constexpr int kHaloE = 16;     // >= kHalf * kC, a whole number of float4
constexpr int kStageE = kTileE + 2 * kHaloE;
constexpr int kStageH = kTileH + 2 * kHalf;
constexpr int kQuads = kStageE / 4;
// as torch rounds the Python floats 0.01 ** 2 and 0.03 ** 2
constexpr float kC1 = (float)(0.01 * 0.01);
constexpr float kC2 = (float)(0.03 * 0.03);

static_assert(kHaloE >= kHalf * kC && kHaloE % 4 == 0 && kTileE % 4 == 0,
              "the halo covers the taps in whole float4");
static_assert(kTileE % 32 == 0, "a warp's outputs lie on one tile row");

struct Taps {
  float g[kTaps];
};

// The forward's ticket counter (see the design above).
__device__ unsigned int ssim_ticket = 0;

// Rows [r0 - kHalf, r0 + kTileH + kHalf) and elements [e0 - kHaloE,
// e0 + kTileE + kHaloE) of the [h, n] map src into dst [kStageH][kStageE],
// zeros outside the map. vec: n and src allow 16-byte loads (then a
// float4 lies wholly inside a row or wholly outside it).
__device__ __forceinline__ void stage_map(const float* __restrict__ src,
                                          float* dst, int h, int n, int r0,
                                          int e0, bool vec) {
  for (int i = threadIdx.x; i < kStageH * kQuads; i += kThreads) {
    const int rr = i / kQuads, q = i - rr * kQuads;
    const int r = r0 - kHalf + rr, e = e0 - kHaloE + 4 * q;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r >= 0 && r < h) {
      const float* row = src + (size_t)r * n;
      if (vec) {
        if (e >= 0 && e < n)
          v = __ldg(reinterpret_cast<const float4*>(row + e));
      } else {
        if (e >= 0 && e < n) v.x = __ldg(row + e);
        if (e + 1 >= 0 && e + 1 < n) v.y = __ldg(row + e + 1);
        if (e + 2 >= 0 && e + 2 < n) v.z = __ldg(row + e + 2);
        if (e + 3 >= 0 && e + 3 < n) v.w = __ldg(row + e + 3);
      }
    }
    reinterpret_cast<float4*>(dst + rr * kStageE)[q] = v;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The CTA's sum of `acc` over its threads, in a fixed order, on thread 0.
__device__ __forceinline__ float block_sum(float acc, float* warp_part) {
  const int warp = threadIdx.x / 32;
  acc = warp_sum(acc);
  if (threadIdx.x % 32 == 0) warp_part[warp] = acc;
  __syncthreads();
  float s = 0.0f;
  if (threadIdx.x == 0)
    for (int i = 0; i < kWarps; ++i) s += warp_part[i];
  return s;
}

// Grid (ceil(n / kTileE), ceil(h / kTileH)) over x, y [h, n] (n = W * 3).
// part: null, or the maps p1, p2, p3 [3][h][n]; block_sums: a float a CTA;
// out: the mean SSIM.
__global__ void __launch_bounds__(kThreads) ssim_fwd_kernel(
    const float* __restrict__ x, const float* __restrict__ y, int h, int n,
    Taps taps, bool vec, float* __restrict__ part,
    float* __restrict__ block_sums, float* __restrict__ out) {
  __shared__ __align__(16) float in[2][kStageH][kStageE];
  __shared__ float hs[5][kStageH][kTileE];
  __shared__ float warp_part[kWarps];
  __shared__ bool last;
  const int e0 = blockIdx.x * kTileE, r0 = blockIdx.y * kTileH;
  stage_map(x, &in[0][0][0], h, n, r0, e0, vec);
  stage_map(y, &in[1][0][0], h, n, r0, e0, vec);
  __syncthreads();

  // horizontal: x, y, x x, y y and x y over the taps of each staged row
  for (int i = threadIdx.x; i < kStageH * kTileE; i += kThreads) {
    const int rr = i / kTileE, c = i - rr * kTileE;
    const float* xr = &in[0][rr][c + kHaloE - kHalf * kC];
    const float* yr = &in[1][rr][c + kHaloE - kHalf * kC];
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f, a4 = 0.0f;
#pragma unroll
    for (int k = 0; k < kTaps; ++k) {
      const float g = taps.g[k], xv = xr[k * kC], yv = yr[k * kC];
      a0 = __fmaf_rn(g, xv, a0);
      a1 = __fmaf_rn(g, yv, a1);
      a2 = __fmaf_rn(g, __fmul_rn(xv, xv), a2);
      a3 = __fmaf_rn(g, __fmul_rn(yv, yv), a3);
      a4 = __fmaf_rn(g, __fmul_rn(xv, yv), a4);
    }
    hs[0][rr][c] = a0;
    hs[1][rr][c] = a1;
    hs[2][rr][c] = a2;
    hs[3][rr][c] = a3;
    hs[4][rr][c] = a4;
  }
  __syncthreads();

  // vertical, then s and its partials
  const size_t hn = (size_t)h * n;
  float acc = 0.0f;
  for (int i = threadIdx.x; i < kTileH * kTileE; i += kThreads) {
    const int rr = i / kTileE, c = i - rr * kTileE;
    const int r = r0 + rr, e = e0 + c;
    if (r >= h || e >= n) continue;
    float mu1 = 0.0f, mu2 = 0.0f, e11 = 0.0f, e22 = 0.0f, e12 = 0.0f;
#pragma unroll
    for (int k = 0; k < kTaps; ++k) {
      const float g = taps.g[k];
      mu1 = __fmaf_rn(g, hs[0][rr + k][c], mu1);
      mu2 = __fmaf_rn(g, hs[1][rr + k][c], mu2);
      e11 = __fmaf_rn(g, hs[2][rr + k][c], e11);
      e22 = __fmaf_rn(g, hs[3][rr + k][c], e22);
      e12 = __fmaf_rn(g, hs[4][rr + k][c], e12);
    }
    const float mu1_sq = mu1 * mu1, mu2_sq = mu2 * mu2, mu12 = mu1 * mu2;
    const float s11 = e11 - mu1_sq, s22 = e22 - mu2_sq, s12 = e12 - mu12;
    const float a1 = 2.0f * mu12 + kC1, a2 = 2.0f * s12 + kC2;
    const float b1 = mu1_sq + mu2_sq + kC1, b2 = s11 + s22 + kC2;
    const float den = b1 * b2;
    const float s = (a1 * a2) / den;
    acc += s;
    if (part != nullptr) {
      const float p2 = -s / b2;
      const float p3 = 2.0f * a1 / den;
      const float d_mu1 = 2.0f * mu2 * a2 / den - 2.0f * mu1 * s / b1;
      const float p1 = d_mu1 - 2.0f * mu1 * p2 - mu2 * p3;
      const size_t o = (size_t)r * n + e;
      part[o] = p1;
      part[hn + o] = p2;
      part[2 * hn + o] = p3;
    }
  }

  const int nblocks = gridDim.x * gridDim.y;
  const float s = block_sum(acc, warp_part);
  if (threadIdx.x == 0) {
    block_sums[blockIdx.y * gridDim.x + blockIdx.x] = s;
    __threadfence();  // the partial is visible before the ticket is taken
    last = atomicInc(&ssim_ticket, nblocks - 1) == (unsigned)(nblocks - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  float t = 0.0f;
  for (int i = threadIdx.x; i < nblocks; i += kThreads)
    t += __ldcg(block_sums + i);
  t = block_sum(t, warp_part);
  if (threadIdx.x == 0) *out = __fdiv_rn(t, (float)hn);
}

// Same grid. dx [h, n] = g / N [G*p1 + 2 x G*p2 + y G*p3] from the maps
// part [3][h][n], x and y [h, n] and the incoming gradient *grad.
__global__ void __launch_bounds__(kThreads) ssim_bwd_kernel(
    const float* __restrict__ part, const float* __restrict__ x,
    const float* __restrict__ y, int h, int n, Taps taps, bool vec,
    const float* __restrict__ grad, float* __restrict__ dx) {
  __shared__ __align__(16) float in[3][kStageH][kStageE];
  __shared__ float hs[3][kStageH][kTileE];
  const int e0 = blockIdx.x * kTileE, r0 = blockIdx.y * kTileH;
  const size_t hn = (size_t)h * n;
#pragma unroll
  for (int m = 0; m < 3; ++m)
    stage_map(part + m * hn, &in[m][0][0], h, n, r0, e0, vec);
  __syncthreads();

  for (int i = threadIdx.x; i < kStageH * kTileE; i += kThreads) {
    const int rr = i / kTileE, c = i - rr * kTileE;
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      const float* pr = &in[m][rr][c + kHaloE - kHalf * kC];
      float a = 0.0f;
#pragma unroll
      for (int k = 0; k < kTaps; ++k) a = __fmaf_rn(taps.g[k], pr[k * kC], a);
      hs[m][rr][c] = a;
    }
  }
  __syncthreads();

  const float scale = __fdiv_rn(__ldg(grad), (float)hn);
  for (int i = threadIdx.x; i < kTileH * kTileE; i += kThreads) {
    const int rr = i / kTileE, c = i - rr * kTileE;
    const int r = r0 + rr, e = e0 + c;
    if (r >= h || e >= n) continue;
    float b0 = 0.0f, b1 = 0.0f, b2 = 0.0f;
#pragma unroll
    for (int k = 0; k < kTaps; ++k) {
      const float g = taps.g[k];
      b0 = __fmaf_rn(g, hs[0][rr + k][c], b0);
      b1 = __fmaf_rn(g, hs[1][rr + k][c], b1);
      b2 = __fmaf_rn(g, hs[2][rr + k][c], b2);
    }
    const size_t o = (size_t)r * n + e;
    dx[o] = scale * (b0 + 2.0f * __ldg(x + o) * b1 + __ldg(y + o) * b2);
  }
}

bool aligned(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

dim3 grid(int h, int w) {
  return dim3((3 * w + kTileE - 1) / kTileE, (h + kTileH - 1) / kTileH);
}

Taps read_taps(const float* taps) {
  Taps t;
  for (int k = 0; k < kTaps; ++k) t.g[k] = taps[k];
  return t;
}

}  // namespace

extern "C" {

// CTAs of a launch on an [h, w, 3] image: the floats of block_sums.
int ssim_blocks(int h, int w) {
  const dim3 g = grid(h, w);
  return (int)(g.x * g.y);
}

// Mean SSIM of x against y ([h, w, 3] float32, contiguous) into *out, with
// the maps p1, p2, p3 into part [3, h, w, 3] unless it is null. taps: 11
// floats on the host; block_sums: ssim_blocks(h, w) floats on the card.
int ssim_forward(const float* x, const float* y, int h, int w,
                 const float* taps, float* part, float* block_sums,
                 float* out, void* stream) {
  if (h < 1 || w < 1) return (int)cudaErrorInvalidValue;
  const int n = 3 * w;
  const bool vec = n % 4 == 0 && aligned(x) && aligned(y);
  ssim_fwd_kernel<<<grid(h, w), kThreads, 0, (cudaStream_t)stream>>>(
      x, y, h, n, read_taps(taps), vec, part, block_sums, out);
  return (int)cudaGetLastError();
}

// dx [h, w, 3] of the mean SSIM for the incoming gradient *grad (one float
// on the card), from the forward's maps part [3, h, w, 3] and x, y.
int ssim_backward(const float* part, const float* x, const float* y, int h,
                  int w, const float* taps, const float* grad, float* dx,
                  void* stream) {
  if (h < 1 || w < 1) return (int)cudaErrorInvalidValue;
  const int n = 3 * w;
  const bool vec = n % 4 == 0 && aligned(part);
  ssim_bwd_kernel<<<grid(h, w), kThreads, 0, (cudaStream_t)stream>>>(
      part, x, y, h, n, read_taps(taps), vec, grad, dx);
  return (int)cudaGetLastError();
}

const char* ssim_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
