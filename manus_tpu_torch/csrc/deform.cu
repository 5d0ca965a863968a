// The gaussians' deformation stage, forward and backward, for NVIDIA
// Hopper (sm_90a): the covariance from scale and rotation, linear blend
// skinning (the blended bone transform, the posed mean and A Sigma A^T)
// and the voxel grid's skin weights. Plain C interface, loaded with
// ctypes (manus_tpu_torch/ops/deform.py: covariance_fwd_cuda,
// skin_fwd_cuda, skin_sample_fwd_cuda and their backwards).
//
// Replaces no Pallas kernel: the JAX package's
// covariance_from_scaling_rotation (manus_tpu/utils/transforms.py),
// skin_gaussians (manus_tpu/ops/skinning.py) and
// skinning_weights_from_voxel_grid (manus_tpu/ops/grid_sample.py) are
// plain XLA, which fuses them on the TPU. It was added because the
// port's plain version, one torch operation per scalar term, made ~440
// launches forward and ~420 in autograd's backward (~670 with the
// gradient through the grid sample) a hand step, on a step the host's
// launches bound.
//
// Math: the plain chain's, a gaussian a thread (a warp in the grid
// sample). The forward rounds
// every operation as the chain does, one torch operation at a time
// (__fmul_rn and friends: nvcc's FMA contraction would otherwise merge a
// product into the next sum). Where the chain reduces (the quaternion's
// norm and squared norm, the grid's eight corners, the weights' sum) the
// kernels add in the order ATen's reductions take on the card for such
// short rows (warp_row_sum, sum4, sum8 below: read from the card's sums).
// The blend (the chain's skin_weights @ transforms, a cuBLAS GEMM) is one
// fused multiply-add a bone, in bone order. The backward is the closed-form vector-Jacobian
// product of that forward, recomputed from the inputs (nothing but the
// inputs is saved), in float32 with nvcc's default contraction. No TF32,
// no bf16.
//
// What bounds it on an H100: bytes. Covariance: 28 bytes read and 24
// written a gaussian forward, 52 read and 28 written backward. Skinning
// with B bones: 36 + 4B read and 100 written forward, ~100 + 4B read and
// 36 + 4B written backward. The grid sample: 12 read, 8 corners of 4C
// bytes gathered and 4C written forward. At 3.35 TB/s and 131,072 rows
// of 21 bones that is ~9 us for covariance and skinning forward and ~30
// us for the sample; the object's 1,048,576 covariances ~16 us forward
// and ~25 us backward. The arithmetic (~100-400 operations a gaussian)
// stays far under the FP32 rate. The sample's gather is the one access
// that cannot stream: a corner's 4C bytes lie at any 4-byte alignment, so
// its 84 bytes span 3-4 sectors of 32, and positions spread over a grid
// larger than L2 fetch those sectors from HBM at random; it reads ~2.6x
// its byte bound on an H100 (77-90 us at 131,072 rows).
//
// The design:
//   * a CTA of kThreads threads, a gaussian a thread in covariance and
//     skinning;
//   * the rows wider than 8 floats (skin weights and their gradient, the
//     blended transforms and theirs) are staged a
//     CTA at a time through shared memory: the CTA reads or writes its
//     rows as one contiguous span, consecutive threads on consecutive
//     words (16-byte accesses where the span is aligned), into rows
//     padded to an odd stride so that a warp's threads, each on its own
//     row, hit distinct banks;
//   * the narrow rows (3, 4 or 6 floats) are read and written a word at a
//     time: a warp's accesses cover one contiguous span, which L1 and L2
//     merge into whole sectors;
//   * the B bone transforms (B * 64 bytes) sit in shared memory, read by
//     every thread of a warp at one address (a broadcast);
//   * the grid sample takes a gaussian a warp, a channel a lane
//     (kSampleRows gaussians a warp in turn): each of the 8 corners is
//     one load of the warp over the corner's 4C contiguous bytes, so the
//     scattered gather still moves whole sectors; the weights' row is
//     written the same way, and the sum over the channels is a tree of
//     warp shuffles. A gaussian a thread instead makes each warp load hit
//     32 x 8 scattered lines once a channel, which thrashes L1 and ran at
//     a tenth of the bound.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
// The most bones (skinning) or grid channels (sample) a row: the CTA's
// staged rows and the bone transforms fit in shared memory, and a warp's
// lanes hold a sampled row in two channels each (DEFORM_MAX_CHANNELS in
// ops/deform.py).
constexpr int kMaxChannels = 64;
// The grid sample's gaussians a warp, one after another.
constexpr int kSampleRows = 8;

// Every forward operation rounded on its own, as one torch op is.
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
// 2.0 / t in Python is t.reciprocal() * 2.0: one correctly rounded
// reciprocal.
__device__ __forceinline__ float rcp(float a) { return __frcp_rn(a); }

__host__ __device__ __forceinline__ int staged_ld(int len) { return len | 1; }

// The CTA's rows [row0, row0 + rows) of len floats into shared memory at
// the odd stride ld; the caller syncs.
__device__ void stage_rows(const float* __restrict__ src, float* s, int row0,
                           int rows, int len, int ld) {
  const float* g = src + (size_t)row0 * len;
  const int count = rows * len;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(g) & 15) == 0) {
    const float4* g4 = reinterpret_cast<const float4*>(g);
    for (int q = threadIdx.x; q < count / 4; q += kThreads) {
      const float4 v = g4[q];
      const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = 4 * q + u;
        const int r = j / len;
        s[r * ld + (j - r * len)] = e[u];
      }
    }
    done = count / 4 * 4;
  }
  for (int j = done + threadIdx.x; j < count; j += kThreads) {
    const int r = j / len;
    s[r * ld + (j - r * len)] = g[j];
  }
}

// The rows back from shared memory to dst; the caller synced.
__device__ void unstage_rows(float* __restrict__ dst, const float* s,
                             int row0, int rows, int len, int ld) {
  float* g = dst + (size_t)row0 * len;
  const int count = rows * len;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(g) & 15) == 0) {
    float4* g4 = reinterpret_cast<float4*>(g);
    for (int q = threadIdx.x; q < count / 4; q += kThreads) {
      float e[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = 4 * q + u;
        const int r = j / len;
        e[u] = s[r * ld + (j - r * len)];
      }
      g4[q] = make_float4(e[0], e[1], e[2], e[3]);
    }
    done = count / 4 * 4;
  }
  for (int j = done + threadIdx.x; j < count; j += kThreads) {
    const int r = j / len;
    g[j] = s[r * ld + (j - r * len)];
  }
}

// The same over four values, (v0 + v2) + (v1 + v3); and the sum over the
// grid's eight corners, a reduction over the outer axis of [8, N, C] that
// one thread makes in four interleaved accumulators, added in turn:
// (((v0 + v4) + (v1 + v5)) + (v2 + v6)) + (v3 + v7).
__device__ __forceinline__ float sum4(float a, float b, float c, float d) {
  return add(add(a, c), add(b, d));
}
__device__ __forceinline__ float sum8(const float* v) {
  return add(add(add(add(v[0], v[4]), add(v[1], v[5])), add(v[2], v[6])),
             add(v[3], v[7]));
}

// ---------------------------------------------------------------------------
// Covariance: Sigma = R diag(s^2) R^T, upper triangle (xx, xy, xz, yy, yz,
// zz), with R from the normalised quaternion (w, x, y, z) by the 2/|q|^2
// rule and s the scale times the modifier.

struct Rot {
  float q[4];   // the quaternion as given
  float nrm;    // its norm
  float qn[4];  // q / nrm
  float ts;     // 2 / |qn|^2
  float r[9];   // row-major
};

__device__ __forceinline__ void rotation(const float* q, Rot& o) {
#pragma unroll
  for (int k = 0; k < 4; ++k) o.q[k] = q[k];
  o.nrm = __fsqrt_rn(sum4(mul(q[0], q[0]), mul(q[1], q[1]), mul(q[2], q[2]),
                          mul(q[3], q[3])));
#pragma unroll
  for (int k = 0; k < 4; ++k) o.qn[k] = dvd(o.q[k], o.nrm);
  const float r = o.qn[0], i = o.qn[1], j = o.qn[2], k = o.qn[3];
  o.ts = mul(rcp(sum4(mul(r, r), mul(i, i), mul(j, j), mul(k, k))), 2.0f);
  const float ts = o.ts;
  o.r[0] = sub(1.0f, mul(ts, add(mul(j, j), mul(k, k))));
  o.r[1] = mul(ts, sub(mul(i, j), mul(k, r)));
  o.r[2] = mul(ts, add(mul(i, k), mul(j, r)));
  o.r[3] = mul(ts, add(mul(i, j), mul(k, r)));
  o.r[4] = sub(1.0f, mul(ts, add(mul(i, i), mul(k, k))));
  o.r[5] = mul(ts, sub(mul(j, k), mul(i, r)));
  o.r[6] = mul(ts, sub(mul(i, k), mul(j, r)));
  o.r[7] = mul(ts, add(mul(j, k), mul(i, r)));
  o.r[8] = sub(1.0f, mul(ts, add(mul(i, i), mul(j, j))));
}

// The six (a, b) of the upper triangle, in the rows' order: (0, 0),
// (0, 1), (0, 2), (1, 1), (1, 2), (2, 2). Called with unrolled p, so they
// fold to constants.
__device__ __forceinline__ int pair_a(int p) {
  return p < 3 ? 0 : (p < 5 ? 1 : 2);
}
__device__ __forceinline__ int pair_b(int p) {
  return p < 3 ? p : (p == 3 ? 1 : 2);
}

struct CovArgs {
  int n;
  const float* scaling;  // [n, 3] at strides (s_row, s_col) in floats
  long long s_row, s_col;
  const float* rotation;  // [n, 4]
  float modifier;
  float* cov;             // forward: [n, 6]
  const float* g_cov;     // backward: [n, 6]
  float* g_scaling;       // [n, 3] or null
  float* g_rotation;      // [n, 4] or null
};

__device__ __forceinline__ void load_scale(const CovArgs& a, int i,
                                           float* x) {
  // (scaling_modifier * scaling), one torch op
#pragma unroll
  for (int k = 0; k < 3; ++k)
    x[k] = mul(a.scaling[i * a.s_row + k * a.s_col], a.modifier);
}

__global__ void __launch_bounds__(kThreads)
covariance_fwd_kernel(const CovArgs a) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.n) return;
  float x[3], s2[3];
  load_scale(a, i, x);
#pragma unroll
  for (int k = 0; k < 3; ++k) s2[k] = mul(x[k], x[k]);  // ** 2
  Rot o;
  rotation(a.rotation + 4 * (size_t)i, o);
  const float* R = o.r;
#pragma unroll
  for (int p = 0; p < 6; ++p) {
    const int u = pair_a(p), v = pair_b(p);
    // s0 * R[u, 0] * R[v, 0] + s1 * R[u, 1] * R[v, 1] + s2 * ...
    a.cov[6 * (size_t)i + p] =
        add(add(mul(mul(s2[0], R[3 * u]), R[3 * v]),
                mul(mul(s2[1], R[3 * u + 1]), R[3 * v + 1])),
            mul(mul(s2[2], R[3 * u + 2]), R[3 * v + 2]));
  }
}

__global__ void __launch_bounds__(kThreads)
covariance_bwd_kernel(const CovArgs a) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.n) return;
  float x[3], s2[3], g[6];
  load_scale(a, i, x);
#pragma unroll
  for (int k = 0; k < 3; ++k) s2[k] = x[k] * x[k];
#pragma unroll
  for (int p = 0; p < 6; ++p) g[p] = a.g_cov[6 * (size_t)i + p];
  Rot o;
  rotation(a.rotation + 4 * (size_t)i, o);
  const float* R = o.r;
  if (a.g_scaling != nullptr) {
    // d/d s2_k: sum over the pairs of g_uv R_uk R_vk; then (m s)^2
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float gs2 = 0.0f;
#pragma unroll
      for (int p = 0; p < 6; ++p)
        gs2 += g[p] * R[3 * pair_a(p) + k] * R[3 * pair_b(p) + k];
      a.g_scaling[3 * (size_t)i + k] = gs2 * (2.0f * x[k]) * a.modifier;
    }
  }
  if (a.g_rotation == nullptr) return;
  // dL/dR = (G + G^T) R diag(s2), G the upper triangle of g
  const float G[9] = {2.0f * g[0], g[1], g[2], g[1], 2.0f * g[3], g[4],
                      g[2], g[4], 2.0f * g[5]};
  float gR[9];
#pragma unroll
  for (int u = 0; u < 3; ++u)
#pragma unroll
    for (int k = 0; k < 3; ++k)
      gR[3 * u + k] = s2[k] * (G[3 * u] * R[k] + G[3 * u + 1] * R[3 + k] +
                               G[3 * u + 2] * R[6 + k]);
  // quaternion_to_matrix at qn, with ts = 2 / |qn|^2 differentiated too
  const float r = o.qn[0], qi = o.qn[1], qj = o.qn[2], qk = o.qn[3];
  const float ts = o.ts;
  const float gts = -gR[0] * (qj * qj + qk * qk) +
                    gR[1] * (qi * qj - qk * r) + gR[2] * (qi * qk + qj * r) +
                    gR[3] * (qi * qj + qk * r) -
                    gR[4] * (qi * qi + qk * qk) +
                    gR[5] * (qj * qk - qi * r) + gR[6] * (qi * qk - qj * r) +
                    gR[7] * (qj * qk + qi * r) - gR[8] * (qi * qi + qj * qj);
  float gq[4];
  gq[0] = ts * (-qk * gR[1] + qj * gR[2] + qk * gR[3] - qi * gR[5] -
                qj * gR[6] + qi * gR[7]);
  gq[1] = ts * (qj * gR[1] + qk * gR[2] + qj * gR[3] - 2.0f * qi * gR[4] -
                r * gR[5] + qk * gR[6] + r * gR[7] - 2.0f * qi * gR[8]);
  gq[2] = ts * (-2.0f * qj * gR[0] + qi * gR[1] + r * gR[2] + qi * gR[3] +
                qk * gR[5] - r * gR[6] + qk * gR[7] - 2.0f * qj * gR[8]);
  gq[3] = ts * (-2.0f * qk * gR[0] - r * gR[1] + qi * gR[2] + r * gR[3] -
                2.0f * qk * gR[4] + qj * gR[5] + qi * gR[6] + qj * gR[7]);
  const float dts = -ts * ts * gts;  // d ts / d qn_x = -ts^2 qn_x
#pragma unroll
  for (int k = 0; k < 4; ++k) gq[k] += dts * o.qn[k];
  // qn = q / |q|: the quotient's two terms, then the norm's
  float dot = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) dot += gq[k] * o.q[k];
  const float g_nrm = -dot / (o.nrm * o.nrm);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    a.g_rotation[4 * (size_t)i + k] =
        gq[k] / o.nrm + o.q[k] * (g_nrm / o.nrm);
}

// ---------------------------------------------------------------------------
// Skinning: tf = sum_b w_b T_b (the rows of [n, 4, 4]), posed xyz = A x +
// t and posed covariance A Sigma A^T, A and t tf's upper 3 x 4 block.

struct SkinArgs {
  int n, b;
  const float* xyz;  // [n, 3]
  const float* cov;  // [n, 6]
  const float* w;    // [n, b]
  const float* T;    // [b, 16]
  // forward outputs
  float* pxyz;  // [n, 3]
  float* pcov;  // [n, 6]
  float* tf;    // [n, 16]
  // backward: incoming gradients (null: zero) and outputs (null: skip)
  const float* g_pxyz;
  const float* g_pcov;
  const float* g_tf;
  float* d_xyz;
  float* d_cov;
  float* d_w;
};

// Shared memory of a skinning CTA: the transforms, the weights' rows and
// the transforms' rows (forward: out; backward: their gradient in).
__host__ __device__ __forceinline__ size_t skin_smem_floats(int b) {
  return (size_t)b * 16 + (size_t)kThreads * (staged_ld(b) + staged_ld(16));
}

// skin_weights @ transforms for one row: a fused multiply-add a bone.
__device__ __forceinline__ void blend(const float* w, const float* T, int b,
                                      float* tf) {
#pragma unroll
  for (int e = 0; e < 16; ++e) tf[e] = 0.0f;
  for (int k = 0; k < b; ++k) {
    const float wk = w[k];
#pragma unroll
    for (int e = 0; e < 16; ++e) tf[e] = __fmaf_rn(wk, T[16 * k + e], tf[e]);
  }
}

__global__ void __launch_bounds__(kThreads) skin_fwd_kernel(const SkinArgs a) {
  extern __shared__ float smem[];
  const int ldw = staged_ld(a.b), ldt = staged_ld(16);
  float* sT = smem;
  float* sw = sT + 16 * a.b;
  float* st = sw + kThreads * ldw;
  const int row0 = blockIdx.x * kThreads;
  const int nrows = min(kThreads, a.n - row0);
  for (int j = threadIdx.x; j < 16 * a.b; j += kThreads) sT[j] = a.T[j];
  stage_rows(a.w, sw, row0, nrows, a.b, ldw);
  __syncthreads();
  const int i = row0 + threadIdx.x;
  if (i < a.n) {
    float tf[16];
    blend(sw + threadIdx.x * ldw, sT, a.b, tf);
    const float x = a.xyz[3 * (size_t)i], y = a.xyz[3 * (size_t)i + 1],
                z = a.xyz[3 * (size_t)i + 2];
#pragma unroll
    for (int r = 0; r < 3; ++r)
      a.pxyz[3 * (size_t)i + r] =
          add(add(add(mul(tf[4 * r], x), mul(tf[4 * r + 1], y)),
                  mul(tf[4 * r + 2], z)),
              tf[4 * r + 3]);
    float s[6];
#pragma unroll
    for (int p = 0; p < 6; ++p) s[p] = a.cov[6 * (size_t)i + p];
    // m_r = (row r of A) . Sigma, as skinning.py's row_sigma
    float m[3][3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const float p0 = tf[4 * r], p1 = tf[4 * r + 1], p2 = tf[4 * r + 2];
      m[r][0] = add(add(mul(p0, s[0]), mul(p1, s[1])), mul(p2, s[2]));
      m[r][1] = add(add(mul(p0, s[1]), mul(p1, s[3])), mul(p2, s[4]));
      m[r][2] = add(add(mul(p0, s[2]), mul(p1, s[4])), mul(p2, s[5]));
    }
#pragma unroll
    for (int p = 0; p < 6; ++p) {
      const int u = pair_a(p), v = pair_b(p);
      a.pcov[6 * (size_t)i + p] =
          add(add(mul(m[u][0], tf[4 * v]), mul(m[u][1], tf[4 * v + 1])),
              mul(m[u][2], tf[4 * v + 2]));
    }
    float* out = st + threadIdx.x * ldt;
#pragma unroll
    for (int e = 0; e < 16; ++e) out[e] = tf[e];
  }
  __syncthreads();
  unstage_rows(a.tf, st, row0, nrows, 16, ldt);
}

__global__ void __launch_bounds__(kThreads) skin_bwd_kernel(const SkinArgs a) {
  extern __shared__ float smem[];
  const int ldw = staged_ld(a.b), ldt = staged_ld(16);
  float* sT = smem;
  float* sw = sT + 16 * a.b;
  float* sg = sw + kThreads * ldw;
  const int row0 = blockIdx.x * kThreads;
  const int nrows = min(kThreads, a.n - row0);
  for (int j = threadIdx.x; j < 16 * a.b; j += kThreads) sT[j] = a.T[j];
  stage_rows(a.w, sw, row0, nrows, a.b, ldw);
  if (a.g_tf != nullptr) stage_rows(a.g_tf, sg, row0, nrows, 16, ldt);
  __syncthreads();
  const int i = row0 + threadIdx.x;
  if (i < a.n) {
    float* wrow = sw + threadIdx.x * ldw;
    float tf[16], gt[16];
    blend(wrow, sT, a.b, tf);
#pragma unroll
    for (int e = 0; e < 16; ++e)
      gt[e] = a.g_tf != nullptr ? sg[threadIdx.x * ldt + e] : 0.0f;
    const float x[3] = {a.xyz[3 * (size_t)i], a.xyz[3 * (size_t)i + 1],
                        a.xyz[3 * (size_t)i + 2]};
    float dx[3] = {0.0f, 0.0f, 0.0f};
    if (a.g_pxyz != nullptr) {
      float gp[3];
#pragma unroll
      for (int r = 0; r < 3; ++r) gp[r] = a.g_pxyz[3 * (size_t)i + r];
#pragma unroll
      for (int r = 0; r < 3; ++r) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          dx[k] += tf[4 * r + k] * gp[r];
          gt[4 * r + k] += gp[r] * x[k];
        }
        gt[4 * r + 3] += gp[r];
      }
    }
    float ds[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (a.g_pcov != nullptr) {
      float g[6], s[6];
#pragma unroll
      for (int p = 0; p < 6; ++p) {
        g[p] = a.g_pcov[6 * (size_t)i + p];
        s[p] = a.cov[6 * (size_t)i + p];
      }
      // Gh = (M + M^T) / 2 of the upper-triangle gradient M; S symmetric
      const float Gh[9] = {g[0], 0.5f * g[1], 0.5f * g[2],
                           0.5f * g[1], g[3], 0.5f * g[4],
                           0.5f * g[2], 0.5f * g[4], g[5]};
      const float S[9] = {s[0], s[1], s[2], s[1], s[3], s[4],
                          s[2], s[4], s[5]};
      float A[9], AS[9], GA[9];
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int k = 0; k < 3; ++k) A[3 * r + k] = tf[4 * r + k];
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          AS[3 * r + k] = A[3 * r] * S[k] + A[3 * r + 1] * S[3 + k] +
                          A[3 * r + 2] * S[6 + k];
          GA[3 * r + k] = Gh[3 * r] * A[k] + Gh[3 * r + 1] * A[3 + k] +
                          Gh[3 * r + 2] * A[6 + k];
        }
      // dL/dA = 2 Gh A S
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int k = 0; k < 3; ++k)
          gt[4 * r + k] += 2.0f * (Gh[3 * r] * AS[k] +
                                   Gh[3 * r + 1] * AS[3 + k] +
                                   Gh[3 * r + 2] * AS[6 + k]);
      // H = A^T Gh A; Sigma's six entries take H's diagonal and twice its
      // off-diagonal
#pragma unroll
      for (int p = 0; p < 6; ++p) {
        const int u = pair_a(p), v = pair_b(p);
        const float h = A[u] * GA[v] + A[3 + u] * GA[3 + v] +
                        A[6 + u] * GA[6 + v];
        ds[p] = u == v ? h : 2.0f * h;
      }
    }
    if (a.d_xyz != nullptr) {
#pragma unroll
      for (int k = 0; k < 3; ++k) a.d_xyz[3 * (size_t)i + k] = dx[k];
    }
    if (a.d_cov != nullptr) {
#pragma unroll
      for (int p = 0; p < 6; ++p) a.d_cov[6 * (size_t)i + p] = ds[p];
    }
    if (a.d_w != nullptr) {
      // d w_k = tf's gradient . T_k, over the row the weights came from
      for (int k = 0; k < a.b; ++k) {
        float acc = 0.0f;
#pragma unroll
        for (int e = 0; e < 16; ++e) acc += gt[e] * sT[16 * k + e];
        wrow[k] = acc;
      }
    }
  }
  if (a.d_w == nullptr) return;  // uniform over the CTA
  __syncthreads();
  unstage_rows(a.d_w, sw, row0, nrows, a.b, ldw);
}

// ---------------------------------------------------------------------------
// The voxel grid's skin weights: the [d, h, w, c] grid sampled trilinearly
// (align_corners, zeros outside) at the normalised position, normalised to
// sum to one, or the last (background) channel where the sample is all
// zeros.

struct SampleArgs {
  int n, d, h, w, c;
  const float* xyz;     // [n, 3]
  const float* center;  // [3]
  const float* scale;   // [3]
  const float* grid;    // [d, h, w, c]
  float* out;           // forward: [n, c]
  const float* g_out;   // backward: [n, c]
  float* d_xyz;         // [n, 3]
};

// The eight corners of a position, dz-major then dy then dx, as
// grid_sample_trilinear loops: each one's weight (0 outside the grid), its
// clamped voxel and whether it lies inside; t the fractional parts.
struct Corners {
  float wgt[8];
  int voxel[8];
  bool inside[8];
  float t[3];
};

__device__ __forceinline__ void corners(const SampleArgs& a, int i,
                                        Corners& c) {
  const float size[3] = {(float)(a.w - 1), (float)(a.h - 1),
                         (float)(a.d - 1)};
  const int dims[3] = {a.w, a.h, a.d};
  float lo[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float xn = dvd(sub(a.xyz[3 * (size_t)i + k], a.center[k]),
                         a.scale[k]);
    // (x + 1.0) * 0.5 * (size - 1)
    const float f = mul(mul(add(xn, 1.0f), 0.5f), size[k]);
    lo[k] = floorf(f);
    c.t[k] = sub(f, lo[k]);
  }
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int off[3] = {q & 1, (q >> 1) & 1, q >> 2};
    int idx[3];
    bool in = true;
    float wk[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float v = lo[k] + (float)off[k];
      in = in && v >= 0.0f && v < (float)dims[k];
      // the index clamped into the grid (a NaN position reads voxel 0)
      idx[k] = (int)fminf(fmaxf(v, 0.0f), (float)(dims[k] - 1));
      wk[k] = off[k] ? c.t[k] : sub(1.0f, c.t[k]);
    }
    c.inside[q] = in;
    c.voxel[q] = (idx[2] * a.h + idx[1]) * a.w + idx[0];
    c.wgt[q] = in ? mul(mul(wk[0], wk[1]), wk[2]) : 0.0f;
  }
}

// The grid sample's warp: a gaussian at a time, a channel a lane (two where
// c > 32), so that each corner's c channels are one coalesced load of the
// warp and the gather moves whole sectors, leaning on no cache.
__device__ __forceinline__ int sample_warp() {
  return (blockIdx.x * kThreads + threadIdx.x) / 32;
}

// torch's sum of a contiguous row of len <= 64 floats on the card, over
// the warp's channels (lane x holds v[x] in lo and v[x + 32] in hi, 0 past
// len): lane x of w = min(2^k <= len, 32) lanes takes v[x] + v[x + w], then
// the lanes add in a tree, halves first (ATen's warp shuffles down by w / 2,
// w / 4, ..., 1). Every lane gets the sum.
__device__ __forceinline__ float warp_row_sum(float lo, float hi, int len) {
  const int lane = threadIdx.x & 31;
  int w = 1;
  while (2 * w <= len && 2 * w <= 32) w *= 2;
  const float up = w == 32 ? hi : __shfl_down_sync(0xffffffffu, lo, w);
  float acc = lane + w < len ? add(lo, up) : lo;
  for (int off = w / 2; off >= 1; off /= 2)
    acc = add(acc, __shfl_down_sync(0xffffffffu, acc, off));
  return __shfl_sync(0xffffffffu, acc, 0);
}

// A plain sum over the warp, for the backward's dot products.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off >= 1; off /= 2)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
skin_sample_fwd_kernel(const SampleArgs a) {
  const int lane = threadIdx.x & 31;
  const int row0 = sample_warp() * kSampleRows;
  const int row1 = min(row0 + kSampleRows, a.n);
  for (int i = row0; i < row1; ++i) {  // uniform over the warp
    Corners cr;
    corners(a, i, cr);
    float raw[2] = {0.0f, 0.0f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ch = lane + 32 * h;
      if (ch >= a.c) continue;
      float e[8];
#pragma unroll
      for (int q = 0; q < 8; ++q)
        e[q] = mul(cr.wgt[q], a.grid[(size_t)cr.voxel[q] * a.c + ch]);
      raw[h] = sum8(e);
    }
    const float denom = warp_row_sum(raw[0], raw[1], a.c);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ch = lane + 32 * h;
      if (ch < a.c)
        a.out[(size_t)i * a.c + ch] =
            denom == 0.0f ? (ch == a.c - 1 ? 1.0f : 0.0f)
                          : dvd(raw[h], denom);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
skin_sample_bwd_kernel(const SampleArgs a) {
  const int lane = threadIdx.x & 31;
  const int row0 = sample_warp() * kSampleRows;
  const int row1 = min(row0 + kSampleRows, a.n);
  const float size[3] = {(float)(a.w - 1), (float)(a.h - 1),
                         (float)(a.d - 1)};
  for (int i = row0; i < row1; ++i) {  // uniform over the warp
    Corners cr;
    corners(a, i, cr);
    float v[2][8], g[2] = {0.0f, 0.0f}, raw[2] = {0.0f, 0.0f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ch = lane + 32 * h;
      float e[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        v[h][q] = ch < a.c ? a.grid[(size_t)cr.voxel[q] * a.c + ch] : 0.0f;
        e[q] = mul(cr.wgt[q], v[h][q]);
      }
      if (ch < a.c) {
        g[h] = a.g_out[(size_t)i * a.c + ch];
        raw[h] = sum8(e);
      }
    }
    const float denom = warp_row_sum(raw[0], raw[1], a.c);
    float dt[3] = {0.0f, 0.0f, 0.0f};
    if (denom != 0.0f) {  // uniform over the warp
      // out = raw / denom: d raw_ch = g_ch / denom + d denom, d denom =
      // -(g . raw) / denom^2; a corner's weight takes sum_ch d raw_ch v_ch
      const float dot = warp_sum(g[0] * raw[0] + g[1] * raw[1]);
      const float g_den = -dot / (denom * denom);
      float coef[2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        coef[h] = lane + 32 * h < a.c ? g[h] / denom + g_den : 0.0f;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        if (!cr.inside[q]) continue;
        const float gw = coef[0] * v[0][q] + coef[1] * v[1][q];
        const int off[3] = {q & 1, (q >> 1) & 1, q >> 2};
        float wk[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) wk[k] = off[k] ? cr.t[k] : 1.0f - cr.t[k];
        // wgt = (wx * wy) * wz
        const float gxy = gw * wk[2];
        const float gk[3] = {gxy * wk[1], gxy * wk[0], gw * (wk[0] * wk[1])};
#pragma unroll
        for (int k = 0; k < 3; ++k) dt[k] += off[k] ? gk[k] : -gk[k];
      }
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) dt[k] = warp_sum(dt[k]);
    if (lane < 3) {
      const int k = lane;  // a register select, not a stack array
      const float dk = k == 0 ? dt[0] : (k == 1 ? dt[1] : dt[2]);
      const float sk = k == 0 ? size[0] : (k == 1 ? size[1] : size[2]);
      a.d_xyz[3 * (size_t)i + k] = dk * sk * 0.5f / a.scale[k];
    }
  }
}

int finish() { return (int)cudaGetLastError(); }

dim3 rows_grid(int n) { return dim3((n + kThreads - 1) / kThreads); }

int launch_covariance(bool backward, const CovArgs& a, void* stream) {
  if (a.n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (backward)
    covariance_bwd_kernel<<<rows_grid(a.n), kThreads, 0, s>>>(a);
  else
    covariance_fwd_kernel<<<rows_grid(a.n), kThreads, 0, s>>>(a);
  return finish();
}

int launch_skin(bool backward, const SkinArgs& a, void* stream) {
  if (a.n <= 0) return 0;
  if (a.b < 1 || a.b > kMaxChannels) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * skin_smem_floats(a.b);
  cudaStream_t s = (cudaStream_t)stream;
  if (backward)
    skin_bwd_kernel<<<rows_grid(a.n), kThreads, smem, s>>>(a);
  else
    skin_fwd_kernel<<<rows_grid(a.n), kThreads, smem, s>>>(a);
  return finish();
}

int launch_sample(bool backward, const SampleArgs& a, void* stream) {
  if (a.n <= 0) return 0;
  if (a.c < 1 || a.c > kMaxChannels || a.d < 1 || a.h < 1 || a.w < 1)
    return (int)cudaErrorInvalidValue;
  const int rows = kThreads / 32 * kSampleRows;  // a CTA's
  const dim3 grid((a.n + rows - 1) / rows);
  cudaStream_t s = (cudaStream_t)stream;
  if (backward)
    skin_sample_bwd_kernel<<<grid, kThreads, 0, s>>>(a);
  else
    skin_sample_fwd_kernel<<<grid, kThreads, 0, s>>>(a);
  return finish();
}

}  // namespace

extern "C" {

// Sigma [n, 6] of scaling [n, 3] (at strides s_row, s_col floats: an
// isotropic model's expanded column has s_col 0) and rotation [n, 4]
// (wxyz, unnormalised), the scale times `modifier`. Returns a
// cudaError_t.
int covariance_forward(int n, const float* scaling, long long s_row,
                       long long s_col, const float* rotation, float modifier,
                       float* cov, void* stream) {
  CovArgs a = {};
  a.n = n;
  a.scaling = scaling;
  a.s_row = s_row;
  a.s_col = s_col;
  a.rotation = rotation;
  a.modifier = modifier;
  a.cov = cov;
  return launch_covariance(false, a, stream);
}

// The backward from the same inputs and Sigma's gradient g_cov [n, 6]:
// g_scaling [n, 3] (contiguous whatever the input's strides) and
// g_rotation [n, 4], each skipped where null.
int covariance_backward(int n, const float* scaling, long long s_row,
                        long long s_col, const float* rotation,
                        float modifier, const float* g_cov, float* g_scaling,
                        float* g_rotation, void* stream) {
  CovArgs a = {};
  a.n = n;
  a.scaling = scaling;
  a.s_row = s_row;
  a.s_col = s_col;
  a.rotation = rotation;
  a.modifier = modifier;
  a.g_cov = g_cov;
  a.g_scaling = g_scaling;
  a.g_rotation = g_rotation;
  return launch_covariance(true, a, stream);
}

// Skinning of n gaussians (xyz [n, 3], cov [n, 6], weights w [n, b], b <=
// 64) by b transforms T [b, 4, 4]: posed xyz [n, 3], posed cov [n, 6]
// and the blended transforms tf [n, 4, 4]. Contiguous float32.
int skin_forward(int n, int b, const float* xyz, const float* cov,
                 const float* w, const float* T, float* pxyz, float* pcov,
                 float* tf, void* stream) {
  SkinArgs a = {};
  a.n = n;
  a.b = b;
  a.xyz = xyz;
  a.cov = cov;
  a.w = w;
  a.T = T;
  a.pxyz = pxyz;
  a.pcov = pcov;
  a.tf = tf;
  return launch_skin(false, a, stream);
}

// The backward from the same inputs and the gradients of posed xyz, posed
// cov and tf (each null for zero): d_xyz [n, 3], d_cov [n, 6], d_w [n,
// b], each skipped where null.
int skin_backward(int n, int b, const float* xyz, const float* cov,
                  const float* w, const float* T, const float* g_pxyz,
                  const float* g_pcov, const float* g_tf, float* d_xyz,
                  float* d_cov, float* d_w, void* stream) {
  SkinArgs a = {};
  a.n = n;
  a.b = b;
  a.xyz = xyz;
  a.cov = cov;
  a.w = w;
  a.T = T;
  a.g_pxyz = g_pxyz;
  a.g_pcov = g_pcov;
  a.g_tf = g_tf;
  a.d_xyz = d_xyz;
  a.d_cov = d_cov;
  a.d_w = d_w;
  return launch_skin(true, a, stream);
}

// The skin weights [n, c] (c <= 64) of n positions xyz [n, 3] from the
// grid [d, h, w, c] about center [3] and scale [3]. Contiguous float32.
int skin_sample_forward(int n, int d, int h, int w, int c, const float* xyz,
                        const float* center, const float* scale,
                        const float* grid, float* out, void* stream) {
  SampleArgs a = {};
  a.n = n;
  a.d = d;
  a.h = h;
  a.w = w;
  a.c = c;
  a.xyz = xyz;
  a.center = center;
  a.scale = scale;
  a.grid = grid;
  a.out = out;
  return launch_sample(false, a, stream);
}

// The positions' gradient d_xyz [n, 3] from the weights' g_out [n, c].
int skin_sample_backward(int n, int d, int h, int w, int c, const float* xyz,
                         const float* center, const float* scale,
                         const float* grid, const float* g_out, float* d_xyz,
                         void* stream) {
  SampleArgs a = {};
  a.n = n;
  a.d = d;
  a.h = h;
  a.w = w;
  a.c = c;
  a.xyz = xyz;
  a.center = center;
  a.scale = scale;
  a.grid = grid;
  a.g_out = g_out;
  a.d_xyz = d_xyz;
  return launch_sample(true, a, stream);
}

const char* deform_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
