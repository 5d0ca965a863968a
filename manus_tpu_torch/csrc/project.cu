// The raster's projection stage, forward and backward, for NVIDIA Hopper
// (sm_90a): a gaussian's view-dependent SH colour and its EWA projection
// to the screen, with the tile rectangle binning reads. Plain C
// interface, loaded with ctypes (manus_tpu_torch/ops/rasterizer/
// projection.py, project_fwd_cuda and project_bwd_cuda).
//
// Replaces no Pallas kernel: the JAX package's calculate_colors_from_sh
// (manus_tpu/ops/rasterizer/api.py) and project_gaussians
// (manus_tpu/ops/rasterizer/projection.py) are plain XLA. It was added
// because the port's plain version of the pair, one torch operation per
// scalar term, made ~260-320 launches a view in the forward and ~360 in
// autograd's backward, on a step the host's launches bound.
//
// Math: the plain chain's (calculate_colors_from_sh + project_gaussians),
// one thread a gaussian. The forward rounds every operation as the chain
// does, one torch operation at a time (__fmul_rn and friends: nvcc's FMA
// contraction would otherwise merge a product into the next sum), so the
// projected fields, the tile rectangle and `visible` come out with the
// chain's bits on the card; the colours differ from the chain's in the
// last bits only, where the chain's norm and einsum reduce in their own
// order. The backward is the closed-form vector-Jacobian product of that
// forward, recomputed from the inputs (nothing but the inputs is saved),
// in float32 with nvcc's default contraction. It follows autograd's
// masks: no gradient through a culled or parked slot's means2d and conic,
// through the 1.3 tanfov clamp outside its range, through the near cull
// or through clamp(rgb + 0.5, min=0) below 0. depth, radius, tile_rect and
// visible carry no gradient.
//
// What bounds it on an H100: bytes. The forward reads ~75 floats a
// gaussian (the SH rows, 48 floats, most of them) and writes ~14; the
// backward reads ~80 and writes ~60: at 3.35 TB/s, ~0.11 ms forward and
// ~0.18 ms backward at 1,048,576 rows. The arithmetic (~600 operations a
// gaussian forward, ~1,200 backward) stays far under the FP32 rate.
//
// The design:
//   * a CTA of kThreads threads, a gaussian a thread; the camera (its
//     three matrices, centre and fields of view, ~60 floats read from
//     device memory, so the host reads nothing back) is put in shared
//     memory once a CTA, with the focal lengths and clamp limits;
//   * the SH rows ([N, K, 3], 192 contiguous bytes a gaussian at K = 16)
//     are staged a CTA at a time through shared memory: the CTA reads its
//     rows as one contiguous span, consecutive threads on consecutive
//     words (16-byte loads where the span is aligned), into rows padded
//     to an odd stride so that a warp's threads, each on its own row, hit
//     distinct banks. The backward writes d features back the same way,
//     in place of the rows it read;
//   * the other fields (12-24 bytes a gaussian) are read and written a
//     word at a time: a warp's accesses cover one contiguous span, which
//     L1 and L2 merge into whole sectors.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 16;       // pixels a tile side (projection.py TILE)
constexpr int kMaxCoeffs = 25;  // SH degree 4

// The plain chain's constants, as torch rounds a Python float to float32.
#define F32(x) ((float)(x))

// Every forward operation rounded on its own, as one torch op is.
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
// 1.0 / t in Python is t.reciprocal() * 1.0: one correctly rounded
// reciprocal.
__device__ __forceinline__ float rcp(float a) { return __frcp_rn(a); }
// torch.clamp: a NaN stays NaN.
__device__ __forceinline__ float clamp2(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float clamp_lo(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
// .to(torch.int32): truncation, saturating, NaN to 0 (cvt.rzi.s32.f32).
__device__ __forceinline__ int to_int(float v) { return __float2int_rz(v); }
__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

constexpr double kC0 = 0.28209479177387814;
constexpr double kC1 = 0.4886025119029199;

struct Args {
  int n, k, deg;  // rows; SH coefficients a row; degree, -1: no colours
  int width, height;
  const float* means;  // [n, 3] posed
  const float* cov;    // [n, 6] posed, upper triangle
  const float* cano;   // [n, 3] canonical means, with tf
  const float* feat;   // [n, k, 3] SH, dc first
  const float* tf;     // [n, 4, 4] blended transforms, or null
  const uint8_t* active;  // [n] or null
  const float* wv;     // [4, 4] world_view_transform
  const float* fp;     // [4, 4] full_proj_transform
  const float* extr;   // [4, 4]
  const float* center;  // [3]
  const float* fovx;   // []
  const float* fovy;   // []
  // forward outputs
  float* means2d;  // [n, 2]
  float* conic;    // [n, 3]
  float* depth;    // [n]
  int* radius;     // [n]
  int* rect;       // [n, 4]
  uint8_t* visible;  // [n]
  float* colors;   // [n, 3]
  // backward: incoming gradients (null: zero) and outputs (null: skip)
  const float* g_means2d;  // [n, 2]
  const float* g_conic;    // [n, 3]
  const float* g_colors;   // [n, 3]
  float* d_means;  // [n, 3]
  float* d_cov;    // [n, 6]
  float* d_cano;   // [n, 3]
  float* d_feat;   // [n, k, 3]
  float* d_tf;     // [n, 4, 4]
};

struct Cam {
  float wv[16], fp[16], r[9], center[3];
  float fx, fy, lim_x, lim_y;
};

// The camera into shared memory, with project_gaussians' focal lengths
// (w / (2 tanfov), i.e. reciprocal(2 tanfov) * w) and clamp limits
// (1.3 tanfov). The caller syncs.
__device__ void load_camera(const Args& a, Cam& c) {
  const int t = threadIdx.x;
  if (t < 16) {
    c.wv[t] = a.wv[t];
    c.fp[t] = a.fp[t];
  } else if (t < 25) {
    const int j = t - 16;
    c.r[j] = a.extr[(j / 3) * 4 + j % 3];
  } else if (t < 28) {
    c.center[t - 25] = a.center[t - 25];
  } else if (t == 28 || t == 29) {
    const float tanfov = tanf(mul(t == 28 ? *a.fovx : *a.fovy, 0.5f));
    const float size = (float)(t == 28 ? a.width : a.height);
    const float focal = mul(rcp(mul(tanfov, 2.0f)), size);
    const float lim = mul(tanfov, F32(1.3));
    if (t == 28) {
      c.fx = focal;
      c.lim_x = lim;
    } else {
      c.fy = focal;
      c.lim_y = lim;
    }
  }
}

// The CTA's SH rows [row0, row0 + rows) into shared memory at an odd
// stride `ld`; the caller syncs.
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
__device__ void unstage_rows(float* __restrict__ dst, const float* s, int row0,
                             int rows, int len, int ld) {
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

// project_gaussians for one gaussian, every intermediate the backward
// reads kept.
struct Proj {
  float pv[3], ph[4], pw, ds, qx, qy, txtz, tytz, tx, ty, inv_tz, inv_tz2;
  float a[3], b[3], u[3], v[3], cxx, cxy, cyy, inv_det;
  float m2x, m2y;
  int rect[4];
  bool in_frustum, visible;
  float radius_f;
};

__device__ __forceinline__ float row_xform(const float* m, int j, float x,
                                           float y, float z) {
  // x * M[0, j] + y * M[1, j] + z * M[2, j] + M[3, j]
  return add(add(add(mul(x, m[j]), mul(y, m[4 + j])), mul(z, m[8 + j])),
             m[12 + j]);
}

__device__ __forceinline__ void project(const Cam& c, int width, int height,
                                        float x, float y, float z,
                                        const float* s, bool active,
                                        Proj& p) {
#pragma unroll
  for (int j = 0; j < 3; ++j) p.pv[j] = row_xform(c.wv, j, x, y, z);
#pragma unroll
  for (int j = 0; j < 4; ++j) p.ph[j] = row_xform(c.fp, j, x, y, z);
  p.pw = rcp(add(p.ph[3], F32(1e-7)));
  const float ppx = mul(p.ph[0], p.pw), ppy = mul(p.ph[1], p.pw);
  p.in_frustum = p.pv[2] > F32(0.2);
  p.ds = p.in_frustum ? p.pv[2] : 1.0f;
  p.qx = dvd(p.pv[0], p.ds);
  p.qy = dvd(p.pv[1], p.ds);
  p.txtz = clamp2(p.qx, -c.lim_x, c.lim_x);
  p.tytz = clamp2(p.qy, -c.lim_y, c.lim_y);
  p.tx = mul(p.txtz, p.ds);
  p.ty = mul(p.tytz, p.ds);
  p.inv_tz = rcp(p.ds);
  p.inv_tz2 = mul(p.inv_tz, p.inv_tz);
  const float j00 = mul(c.fx, p.inv_tz);
  const float j02 = mul(mul(-c.fx, p.tx), p.inv_tz2);
  const float j11 = mul(c.fy, p.inv_tz);
  const float j12 = mul(mul(-c.fy, p.ty), p.inv_tz2);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    p.a[i] = add(mul(j00, c.r[i]), mul(j02, c.r[6 + i]));
    p.b[i] = add(mul(j11, c.r[3 + i]), mul(j12, c.r[6 + i]));
  }
  const float sxx = s[0], sxy = s[1], sxz = s[2], syy = s[3], syz = s[4],
              szz = s[5];
  p.u[0] = add(add(mul(p.a[0], sxx), mul(p.a[1], sxy)), mul(p.a[2], sxz));
  p.u[1] = add(add(mul(p.a[0], sxy), mul(p.a[1], syy)), mul(p.a[2], syz));
  p.u[2] = add(add(mul(p.a[0], sxz), mul(p.a[1], syz)), mul(p.a[2], szz));
  p.v[0] = add(add(mul(p.b[0], sxx), mul(p.b[1], sxy)), mul(p.b[2], sxz));
  p.v[1] = add(add(mul(p.b[0], sxy), mul(p.b[1], syy)), mul(p.b[2], syz));
  p.v[2] = add(add(mul(p.b[0], sxz), mul(p.b[1], syz)), mul(p.b[2], szz));
  p.cxx = add(add(add(mul(p.u[0], p.a[0]), mul(p.u[1], p.a[1])),
                  mul(p.u[2], p.a[2])), F32(0.3));
  p.cxy = add(add(mul(p.u[0], p.b[0]), mul(p.u[1], p.b[1])),
              mul(p.u[2], p.b[2]));
  p.cyy = add(add(add(mul(p.v[0], p.b[0]), mul(p.v[1], p.b[1])),
                  mul(p.v[2], p.b[2])), F32(0.3));
  const float det = sub(mul(p.cxx, p.cyy), mul(p.cxy, p.cxy));
  const bool det_ok = det != 0.0f;
  p.inv_det = rcp(det_ok ? det : 1.0f);
  const float mid = mul(add(p.cxx, p.cyy), 0.5f);
  const float lambda1 =
      add(mid, __fsqrt_rn(clamp_lo(sub(mul(mid, mid), det), F32(0.1))));
  p.radius_f = ceilf(mul(__fsqrt_rn(clamp_lo(lambda1, 0.0f)), 3.0f));
  p.m2x = mul(sub(mul(add(ppx, 1.0f), (float)width), 1.0f), 0.5f);
  p.m2y = mul(sub(mul(add(ppy, 1.0f), (float)height), 1.0f), 0.5f);
  const int gx = (width + kTile - 1) / kTile, gy = (height + kTile - 1) / kTile;
  const float r = p.radius_f, t = (float)kTile;
  // (m2d - r) / TILE and (m2d + r + TILE - 1) / TILE, as Python groups them
  p.rect[0] = clampi(to_int(dvd(sub(p.m2x, r), t)), 0, gx);
  p.rect[1] = clampi(to_int(dvd(sub(p.m2y, r), t)), 0, gy);
  p.rect[2] = clampi(to_int(dvd(sub(add(add(p.m2x, r), t), 1.0f), t)), 0, gx);
  p.rect[3] = clampi(to_int(dvd(sub(add(add(p.m2y, r), t), 1.0f), t)), 0, gy);
  p.visible = p.in_frustum && det_ok && active &&
              (p.rect[2] - p.rect[0]) * (p.rect[3] - p.rect[1]) > 0;
}

// The SH view direction's vector v (unnormalised) for one gaussian: from
// the camera centre, or for an articulated model from the centre pulled
// back through inv(tf) by the adjugate (the untransformed centre where
// |det| <= 1e-12). adj and inv_det are kept for tf's gradient.
struct ViewDir {
  float v[3], cam[3], adj[9], inv_det;
  bool ok;
};

__device__ __forceinline__ void view_dir(const Cam& c, const float* pos,
                                         const float* tf, ViewDir& d) {
  if (tf == nullptr) {
#pragma unroll
    for (int i = 0; i < 3; ++i) d.v[i] = sub(pos[i], c.center[i]);
    d.ok = false;
    return;
  }
  const float a = tf[0], b = tf[1], cc = tf[2], e0 = tf[4], e = tf[5],
              f = tf[6], g = tf[8], h = tf[9], i = tf[10];
  const float rhs[3] = {sub(c.center[0], tf[3]), sub(c.center[1], tf[7]),
                        sub(c.center[2], tf[11])};
  // R = [[a, b, cc], [e0, e, f], [g, h, i]]; adj[row * 3 + col] is the
  // plain chain's co{row}{col}
  d.adj[0] = sub(mul(e, i), mul(f, h));
  d.adj[1] = sub(mul(cc, h), mul(b, i));
  d.adj[2] = sub(mul(b, f), mul(cc, e));
  d.adj[3] = sub(mul(f, g), mul(e0, i));
  d.adj[4] = sub(mul(a, i), mul(cc, g));
  d.adj[5] = sub(mul(cc, e0), mul(a, f));
  d.adj[6] = sub(mul(e0, h), mul(e, g));
  d.adj[7] = sub(mul(b, g), mul(a, h));
  d.adj[8] = sub(mul(a, e), mul(b, e0));
  const float det =
      add(add(mul(a, d.adj[0]), mul(b, d.adj[3])), mul(cc, d.adj[6]));
  d.ok = fabsf(det) > F32(1e-12);
  d.inv_det = rcp(d.ok ? det : 1.0f);
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float x = mul(add(add(mul(d.adj[3 * r], rhs[0]),
                                mul(d.adj[3 * r + 1], rhs[1])),
                            mul(d.adj[3 * r + 2], rhs[2])),
                        d.inv_det);
    d.cam[r] = d.ok ? x : c.center[r];
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) d.v[r] = sub(pos[r], d.cam[r]);
}

// The SH basis term by term, as utils/sh.py sh_basis computes it (each
// operation rounded as there), with each term's gradient in the
// direction: term(k, basis, d/dx, d/dy, d/dz). The gradients are not
// computed where `grads` is false.
template <bool grads, class Term>
__device__ __forceinline__ void sh_terms(int deg, float x, float y, float z,
                                         Term&& term) {
  term(0, F32(kC0), 0.0f, 0.0f, 0.0f);
  if (deg < 1) return;
  const float c1 = F32(kC1);
  term(1, mul(F32(-kC1), y), 0.0f, grads ? -c1 : 0.0f, 0.0f);
  term(2, mul(c1, z), 0.0f, 0.0f, grads ? c1 : 0.0f);
  term(3, mul(F32(-kC1), x), grads ? -c1 : 0.0f, 0.0f, 0.0f);
  if (deg < 2) return;
  const float xx = mul(x, x), yy = mul(y, y), zz = mul(z, z);
  const float xy = mul(x, y), yz = mul(y, z), xz = mul(x, z);
  {
    const float k0 = F32(1.0925484305920792);
    const float k1 = F32(-1.0925484305920792);
    const float k2 = F32(0.31539156525252005);
    const float k3 = F32(-1.0925484305920792);
    const float k4 = F32(0.5462742152960396);
    term(4, mul(k0, xy), grads ? k0 * y : 0.f, grads ? k0 * x : 0.f, 0.f);
    term(5, mul(k1, yz), 0.f, grads ? k1 * z : 0.f, grads ? k1 * y : 0.f);
    term(6, mul(k2, sub(sub(mul(2.0f, zz), xx), yy)),
         grads ? -2.f * k2 * x : 0.f, grads ? -2.f * k2 * y : 0.f,
         grads ? 4.f * k2 * z : 0.f);
    term(7, mul(k3, xz), grads ? k3 * z : 0.f, 0.f, grads ? k3 * x : 0.f);
    term(8, mul(k4, sub(xx, yy)), grads ? 2.f * k4 * x : 0.f,
         grads ? -2.f * k4 * y : 0.f, 0.f);
  }
  if (deg < 3) return;
  {
    const float k0 = F32(-0.5900435899266435);
    const float k1 = F32(2.890611442640554);
    const float k2 = F32(-0.4570457994644658);
    const float k3 = F32(0.3731763325901154);
    const float k4 = F32(-0.4570457994644658);
    const float k5 = F32(1.445305721320277);
    const float k6 = F32(-0.5900435899266435);
    term(9, mul(mul(k0, y), sub(mul(3.0f, xx), yy)),
         grads ? k0 * 6.f * xy : 0.f, grads ? k0 * (3.f * xx - 3.f * yy) : 0.f,
         0.f);
    term(10, mul(mul(k1, xy), z), grads ? k1 * yz : 0.f,
         grads ? k1 * xz : 0.f, grads ? k1 * xy : 0.f);
    term(11, mul(mul(k2, y), sub(sub(mul(4.0f, zz), xx), yy)),
         grads ? k2 * -2.f * xy : 0.f,
         grads ? k2 * (4.f * zz - xx - 3.f * yy) : 0.f,
         grads ? k2 * 8.f * yz : 0.f);
    term(12, mul(mul(k3, z), sub(sub(mul(2.0f, zz), mul(3.0f, xx)),
                                 mul(3.0f, yy))),
         grads ? k3 * -6.f * xz : 0.f, grads ? k3 * -6.f * yz : 0.f,
         grads ? k3 * (6.f * zz - 3.f * xx - 3.f * yy) : 0.f);
    term(13, mul(mul(k4, x), sub(sub(mul(4.0f, zz), xx), yy)),
         grads ? k4 * (4.f * zz - 3.f * xx - yy) : 0.f,
         grads ? k4 * -2.f * xy : 0.f, grads ? k4 * 8.f * xz : 0.f);
    term(14, mul(mul(k5, z), sub(xx, yy)), grads ? k5 * 2.f * xz : 0.f,
         grads ? k5 * -2.f * yz : 0.f, grads ? k5 * (xx - yy) : 0.f);
    term(15, mul(mul(k6, x), sub(xx, mul(3.0f, yy))),
         grads ? k6 * (3.f * xx - 3.f * yy) : 0.f,
         grads ? k6 * -6.f * xy : 0.f, 0.f);
  }
  if (deg < 4) return;
  {
    const float k0 = F32(2.5033429417967046);
    const float k1 = F32(-1.7701307697799304);
    const float k2 = F32(0.9461746957575601);
    const float k3 = F32(-0.6690465435572892);
    const float k4 = F32(0.10578554691520431);
    const float k5 = F32(-0.6690465435572892);
    const float k6 = F32(0.47308734787878004);
    const float k7 = F32(-1.7701307697799304);
    const float k8 = F32(0.6258357354491761);
    const float z7m1 = sub(mul(7.0f, zz), 1.0f);
    const float z7m3 = sub(mul(7.0f, zz), 3.0f);
    term(16, mul(mul(k0, xy), sub(xx, yy)),
         grads ? k0 * (3.f * xx * y - yy * y) : 0.f,
         grads ? k0 * (xx * x - 3.f * x * yy) : 0.f, 0.f);
    term(17, mul(mul(k1, yz), sub(mul(3.0f, xx), yy)),
         grads ? k1 * 6.f * xy * z : 0.f,
         grads ? k1 * (3.f * xx - 3.f * yy) * z : 0.f,
         grads ? k1 * (3.f * xx * y - yy * y) : 0.f);
    term(18, mul(mul(k2, xy), z7m1), grads ? k2 * y * z7m1 : 0.f,
         grads ? k2 * x * z7m1 : 0.f, grads ? k2 * 14.f * xy * z : 0.f);
    term(19, mul(mul(k3, yz), z7m3), 0.f, grads ? k3 * z * z7m3 : 0.f,
         grads ? k3 * y * (21.f * zz - 3.f) : 0.f);
    term(20, mul(k4, add(mul(zz, sub(mul(35.0f, zz), 30.0f)), 3.0f)), 0.f,
         0.f, grads ? k4 * (140.f * zz * z - 60.f * z) : 0.f);
    term(21, mul(mul(k5, xz), z7m3), grads ? k5 * z * z7m3 : 0.f, 0.f,
         grads ? k5 * x * (21.f * zz - 3.f) : 0.f);
    term(22, mul(mul(k6, sub(xx, yy)), z7m1), grads ? k6 * 2.f * x * z7m1 : 0.f,
         grads ? k6 * -2.f * y * z7m1 : 0.f,
         grads ? k6 * 14.f * z * (xx - yy) : 0.f);
    term(23, mul(mul(k7, xz), sub(xx, mul(3.0f, yy))),
         grads ? k7 * z * (3.f * xx - 3.f * yy) : 0.f,
         grads ? k7 * -6.f * xy * z : 0.f,
         grads ? k7 * x * (xx - 3.f * yy) : 0.f);
    term(24, mul(k8, sub(mul(xx, sub(xx, mul(3.0f, yy))),
                         mul(yy, sub(mul(3.0f, xx), yy)))),
         grads ? k8 * (4.f * xx * x - 12.f * x * yy) : 0.f,
         grads ? k8 * (4.f * yy * y - 12.f * xx * y) : 0.f, 0.f);
  }
}

// The direction's norm; torch's norm reduces in an order of its own, so
// the colours may differ from the plain chain's in their last bits.
__device__ __forceinline__ float norm3(const float* v) {
  return __fsqrt_rn(fmaf(v[2], v[2], fmaf(v[1], v[1], v[0] * v[0])));
}

// Shared memory the CTA stages its SH rows in: rows of len floats at an
// odd stride.
__host__ __device__ __forceinline__ int staged_ld(int len) { return len | 1; }

__global__ void __launch_bounds__(kThreads)
project_fwd_kernel(const Args a) {
  extern __shared__ float rows[];
  __shared__ Cam cam;
  const int row0 = blockIdx.x * kThreads;
  const int nrows = min(kThreads, a.n - row0);
  const bool colors = a.deg >= 0;
  const int len = a.k * 3, ld = staged_ld(len);
  load_camera(a, cam);
  if (colors) stage_rows(a.feat, rows, row0, nrows, len, ld);
  __syncthreads();
  const int i = row0 + threadIdx.x;
  if (i >= a.n) return;

  const float* m = a.means + 3 * (size_t)i;
  const float pos[3] = {m[0], m[1], m[2]};
  float s[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) s[j] = a.cov[6 * (size_t)i + j];
  const bool act = a.active == nullptr || a.active[i] != 0;
  Proj p;
  project(cam, a.width, a.height, pos[0], pos[1], pos[2], s, act, p);
  a.depth[i] = p.pv[2];
  a.radius[i] = p.visible ? to_int(p.radius_f) : 0;
  reinterpret_cast<int4*>(a.rect)[i] =
      make_int4(p.rect[0], p.rect[1], p.rect[2], p.rect[3]);
  a.visible[i] = p.visible ? 1 : 0;
  a.means2d[2 * (size_t)i] = p.visible ? p.m2x : 0.0f;
  a.means2d[2 * (size_t)i + 1] = p.visible ? p.m2y : 0.0f;
  a.conic[3 * (size_t)i] = p.visible ? mul(p.cyy, p.inv_det) : 1.0f;
  a.conic[3 * (size_t)i + 1] = p.visible ? mul(-p.cxy, p.inv_det) : 0.0f;
  a.conic[3 * (size_t)i + 2] = p.visible ? mul(p.cxx, p.inv_det) : 1.0f;
  if (!colors) return;

  ViewDir d;
  if (a.tf != nullptr) {
    const float* cm = a.cano + 3 * (size_t)i;
    const float cpos[3] = {cm[0], cm[1], cm[2]};
    view_dir(cam, cpos, a.tf + 16 * (size_t)i, d);
  } else {
    view_dir(cam, pos, nullptr, d);
  }
  const float nrm = norm3(d.v);
  const float x = dvd(d.v[0], nrm), y = dvd(d.v[1], nrm),
              z = dvd(d.v[2], nrm);
  const float* f = rows + threadIdx.x * ld;
  float rgb[3] = {0.0f, 0.0f, 0.0f};
  sh_terms<false>(a.deg, x, y, z,
                  [&](int k, float bk, float, float, float) {
#pragma unroll
                    for (int c = 0; c < 3; ++c)
                      rgb[c] = fmaf(f[3 * k + c], bk, rgb[c]);
                  });
#pragma unroll
  for (int c = 0; c < 3; ++c)
    a.colors[3 * (size_t)i + c] = clamp_lo(add(rgb[c], 0.5f), 0.0f);
}

__global__ void __launch_bounds__(kThreads)
project_bwd_kernel(const Args a) {
  extern __shared__ float rows[];
  __shared__ Cam cam;
  const int row0 = blockIdx.x * kThreads;
  const int nrows = min(kThreads, a.n - row0);
  // the colour part runs where the colours have a gradient
  const bool colors = a.deg >= 0 && a.g_colors != nullptr;
  const int len = a.k * 3, ld = staged_ld(len);
  load_camera(a, cam);
  if (colors) stage_rows(a.feat, rows, row0, nrows, len, ld);
  __syncthreads();
  const int i = row0 + threadIdx.x;
  if (i < a.n) {
    const float* m = a.means + 3 * (size_t)i;
    const float pos[3] = {m[0], m[1], m[2]};
    float s[6];
#pragma unroll
    for (int j = 0; j < 6; ++j) s[j] = a.cov[6 * (size_t)i + j];
    float dm[3] = {0.0f, 0.0f, 0.0f}, ds6[6] = {0.0f, 0.0f, 0.0f, 0.0f,
                                                0.0f, 0.0f};
    float dcano[3] = {0.0f, 0.0f, 0.0f}, dtf[12];
#pragma unroll
    for (int j = 0; j < 12; ++j) dtf[j] = 0.0f;

    // projection: means2d and conic, where the slot is visible
    const bool act = a.active == nullptr || a.active[i] != 0;
    Proj p;
    project(cam, a.width, a.height, pos[0], pos[1], pos[2], s, act, p);
    if (p.visible && (a.g_means2d != nullptr || a.g_conic != nullptr)) {
      float gmx = 0.0f, gmy = 0.0f, gc0 = 0.0f, gc1 = 0.0f, gc2 = 0.0f;
      if (a.g_means2d != nullptr) {
        gmx = a.g_means2d[2 * (size_t)i];
        gmy = a.g_means2d[2 * (size_t)i + 1];
      }
      if (a.g_conic != nullptr) {
        gc0 = a.g_conic[3 * (size_t)i];
        gc1 = a.g_conic[3 * (size_t)i + 1];
        gc2 = a.g_conic[3 * (size_t)i + 2];
      }
      // means2d = ((p_proj + 1) * size - 1) * 0.5, p_proj = ph * p_w,
      // p_w = 1 / (ph3 + 1e-7)
      const float dppx = gmx * 0.5f * (float)a.width;
      const float dppy = gmy * 0.5f * (float)a.height;
      const float dph0 = dppx * p.pw, dph1 = dppy * p.pw;
      const float dpw = dppx * p.ph[0] + dppy * p.ph[1];
      const float dph3 = -dpw * p.pw * p.pw;
      // conic = (cyy, -cxy, cxx) / det, det = cxx cyy - cxy^2
      float dcxx = gc2 * p.inv_det, dcxy = -gc1 * p.inv_det,
            dcyy = gc0 * p.inv_det;
      const float dinv = gc0 * p.cyy - gc1 * p.cxy + gc2 * p.cxx;
      const float ddet = -dinv * p.inv_det * p.inv_det;
      dcxx += ddet * p.cyy;
      dcyy += ddet * p.cxx;
      dcxy -= 2.0f * ddet * p.cxy;
      // cxx = u.a + 0.3, cxy = u.b, cyy = v.b + 0.3; u = S a, v = S b
      float du[3], dv[3], da[3], db[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        du[j] = dcxx * p.a[j] + dcxy * p.b[j];
        dv[j] = dcyy * p.b[j];
        da[j] = dcxx * p.u[j];
        db[j] = dcxy * p.u[j] + dcyy * p.v[j];
      }
      const float sxx = s[0], sxy = s[1], sxz = s[2], syy = s[3],
                  syz = s[4], szz = s[5];
      da[0] += du[0] * sxx + du[1] * sxy + du[2] * sxz;
      da[1] += du[0] * sxy + du[1] * syy + du[2] * syz;
      da[2] += du[0] * sxz + du[1] * syz + du[2] * szz;
      db[0] += dv[0] * sxx + dv[1] * sxy + dv[2] * sxz;
      db[1] += dv[0] * sxy + dv[1] * syy + dv[2] * syz;
      db[2] += dv[0] * sxz + dv[1] * syz + dv[2] * szz;
      ds6[0] = du[0] * p.a[0] + dv[0] * p.b[0];
      ds6[1] = du[0] * p.a[1] + du[1] * p.a[0] + dv[0] * p.b[1] +
               dv[1] * p.b[0];
      ds6[2] = du[0] * p.a[2] + du[2] * p.a[0] + dv[0] * p.b[2] +
               dv[2] * p.b[0];
      ds6[3] = du[1] * p.a[1] + dv[1] * p.b[1];
      ds6[4] = du[1] * p.a[2] + du[2] * p.a[1] + dv[1] * p.b[2] +
               dv[2] * p.b[1];
      ds6[5] = du[2] * p.a[2] + dv[2] * p.b[2];
      // a = j00 R[0] + j02 R[2], b = j11 R[1] + j12 R[2]
      const float* R = cam.r;
      const float dj00 = da[0] * R[0] + da[1] * R[1] + da[2] * R[2];
      const float dj02 = da[0] * R[6] + da[1] * R[7] + da[2] * R[8];
      const float dj11 = db[0] * R[3] + db[1] * R[4] + db[2] * R[5];
      const float dj12 = db[0] * R[6] + db[1] * R[7] + db[2] * R[8];
      // j00 = fx / tz, j02 = -fx tx / tz^2 (and y)
      float dinv_tz = dj00 * cam.fx + dj11 * cam.fy;
      const float dtx = dj02 * -cam.fx * p.inv_tz2;
      const float dty = dj12 * -cam.fy * p.inv_tz2;
      const float dinv_tz2 = dj02 * (-cam.fx * p.tx) + dj12 * (-cam.fy * p.ty);
      dinv_tz += 2.0f * dinv_tz2 * p.inv_tz;
      float dds = -dinv_tz * p.inv_tz * p.inv_tz;
      // tx = clamp(pv_x / ds, +-lim) * ds (and y)
      dds += dtx * p.txtz + dty * p.tytz;
      const float dqx =
          (p.qx >= -cam.lim_x && p.qx <= cam.lim_x) ? dtx * p.ds : 0.0f;
      const float dqy =
          (p.qy >= -cam.lim_y && p.qy <= cam.lim_y) ? dty * p.ds : 0.0f;
      const float dpv0 = dqx / p.ds, dpv1 = dqy / p.ds;
      dds -= (dqx * p.pv[0] + dqy * p.pv[1]) / (p.ds * p.ds);
      const float dpv2 = p.in_frustum ? dds : 0.0f;
      // pv = row-vector transforms of the mean
#pragma unroll
      for (int r = 0; r < 3; ++r)
        dm[r] += dpv0 * cam.wv[4 * r] + dpv1 * cam.wv[4 * r + 1] +
                 dpv2 * cam.wv[4 * r + 2] + dph0 * cam.fp[4 * r] +
                 dph1 * cam.fp[4 * r + 1] + dph3 * cam.fp[4 * r + 3];
    }

    if (colors) {
      ViewDir d;
      const float* cpos = pos;
      float cano_pos[3];
      if (a.tf != nullptr) {
        const float* cm = a.cano + 3 * (size_t)i;
        cano_pos[0] = cm[0];
        cano_pos[1] = cm[1];
        cano_pos[2] = cm[2];
        cpos = cano_pos;
        view_dir(cam, cpos, a.tf + 16 * (size_t)i, d);
      } else {
        view_dir(cam, pos, nullptr, d);
      }
      const float nrm = norm3(d.v);
      const float x = dvd(d.v[0], nrm), y = dvd(d.v[1], nrm),
                  z = dvd(d.v[2], nrm);
      float* f = rows + threadIdx.x * ld;
      // the clamp's mask needs the colour itself
      float rgb[3] = {0.0f, 0.0f, 0.0f};
      sh_terms<false>(a.deg, x, y, z,
                      [&](int k, float bk, float, float, float) {
#pragma unroll
                        for (int c = 0; c < 3; ++c)
                          rgb[c] = fmaf(f[3 * k + c], bk, rgb[c]);
                      });
      float g[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float gc = a.g_colors[3 * (size_t)i + c];
        g[c] = add(rgb[c], 0.5f) >= 0.0f ? gc : 0.0f;
      }
      // d features (in place of the rows read) and d direction
      float dd[3] = {0.0f, 0.0f, 0.0f};
      sh_terms<true>(a.deg, x, y, z,
                     [&](int k, float bk, float gx, float gy, float gz) {
                       const float dbk = g[0] * f[3 * k] + g[1] * f[3 * k + 1]
                                         + g[2] * f[3 * k + 2];
                       dd[0] += dbk * gx;
                       dd[1] += dbk * gy;
                       dd[2] += dbk * gz;
#pragma unroll
                       for (int c = 0; c < 3; ++c) f[3 * k + c] = g[c] * bk;
                     });
      const int kk = (a.deg + 1) * (a.deg + 1);
      for (int j = 3 * kk; j < len; ++j) f[j] = 0.0f;
      if (a.deg >= 1) {
        // dir = v / |v|: dv = dd / n - v (dd . v) / n^3
        const float dot = dd[0] * d.v[0] + dd[1] * d.v[1] + dd[2] * d.v[2];
        const float inv_n = 1.0f / nrm;
        const float k3 = dot * inv_n * inv_n * inv_n;
        float dvv[3];
#pragma unroll
        for (int r = 0; r < 3; ++r) dvv[r] = dd[r] * inv_n - d.v[r] * k3;
        if (a.tf != nullptr) {
#pragma unroll
          for (int r = 0; r < 3; ++r) dcano[r] = dvv[r];
          if (d.ok && a.d_tf != nullptr) {
            // v = cano - x, x = inv(R) (centre - t) = adj rhs / det:
            // dx = -dv; d rhs = inv(R)^T dx, dR = -d rhs x^T, dt = -d rhs
#pragma unroll
            for (int col = 0; col < 3; ++col) {
              const float drhs =
                  -(d.adj[col] * dvv[0] + d.adj[3 + col] * dvv[1] +
                    d.adj[6 + col] * dvv[2]) * d.inv_det;
#pragma unroll
              for (int k = 0; k < 3; ++k) dtf[4 * col + k] = -drhs * d.cam[k];
              dtf[4 * col + 3] = -drhs;
            }
          }
        } else {
#pragma unroll
          for (int r = 0; r < 3; ++r) dm[r] += dvv[r];
        }
      }
    }

    if (a.d_means != nullptr) {
#pragma unroll
      for (int r = 0; r < 3; ++r) a.d_means[3 * (size_t)i + r] = dm[r];
    }
    if (a.d_cov != nullptr) {
#pragma unroll
      for (int j = 0; j < 6; ++j) a.d_cov[6 * (size_t)i + j] = ds6[j];
    }
    if (a.d_cano != nullptr) {
#pragma unroll
      for (int r = 0; r < 3; ++r) a.d_cano[3 * (size_t)i + r] = dcano[r];
    }
    if (a.d_tf != nullptr) {
      float4* o = reinterpret_cast<float4*>(a.d_tf + 16 * (size_t)i);
      o[0] = make_float4(dtf[0], dtf[1], dtf[2], dtf[3]);
      o[1] = make_float4(dtf[4], dtf[5], dtf[6], dtf[7]);
      o[2] = make_float4(dtf[8], dtf[9], dtf[10], dtf[11]);
      o[3] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
  if (a.d_feat == nullptr) return;  // uniform over the CTA
  __syncthreads();
  if (colors) {
    unstage_rows(a.d_feat, rows, row0, nrows, len, ld);
  } else {
    // no colour gradient: d features are zero
    float* g = a.d_feat + (size_t)row0 * len;
    for (int j = threadIdx.x; j < nrows * len; j += kThreads) g[j] = 0.0f;
  }
}

size_t staged_bytes(const Args& a, bool colors) {
  return colors ? sizeof(float) * kThreads * staged_ld(3 * a.k) : 0;
}

int launch(bool backward, const Args& a, void* stream) {
  if (a.n <= 0) return 0;
  if (a.deg > 4 || a.k > kMaxCoeffs) return (int)cudaErrorInvalidValue;
  const bool colors =
      a.deg >= 0 && (!backward || a.g_colors != nullptr);
  const dim3 grid((a.n + kThreads - 1) / kThreads);
  const size_t smem = staged_bytes(a, colors);
  cudaStream_t s = (cudaStream_t)stream;
  if (backward)
    project_bwd_kernel<<<grid, kThreads, smem, s>>>(a);
  else
    project_fwd_kernel<<<grid, kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

Args make_args(int n, int k, int deg, int width, int height,
               const float* means, const float* cov, const float* cano,
               const float* feat, const float* tf, const uint8_t* active,
               const float* wv, const float* fp, const float* extr,
               const float* center, const float* fovx, const float* fovy) {
  Args a = {};
  a.n = n;
  a.k = k;
  a.deg = deg;
  a.width = width;
  a.height = height;
  a.means = means;
  a.cov = cov;
  a.cano = cano;
  a.feat = feat;
  a.tf = tf;
  a.active = active;
  a.wv = wv;
  a.fp = fp;
  a.extr = extr;
  a.center = center;
  a.fovx = fovx;
  a.fovy = fovy;
  return a;
}

}  // namespace

extern "C" {

// The forward: n gaussians (float32, contiguous; cano and tf null unless
// articulated, feat null and deg -1 without colours, active null for
// all live) under one camera (device pointers) -> means2d [n, 2], conic
// [n, 3], depth [n], radius [n] int32, rect [n, 4] int32, visible [n]
// bytes and, with colours, colors [n, 3]. Returns a cudaError_t.
int project_forward(int n, int k, int deg, int width, int height,
                    const float* means, const float* cov, const float* cano,
                    const float* feat, const float* tf,
                    const uint8_t* active, const float* wv, const float* fp,
                    const float* extr, const float* center,
                    const float* fovx, const float* fovy, float* means2d,
                    float* conic, float* depth, int* radius, int* rect,
                    uint8_t* visible, float* colors, void* stream) {
  Args a = make_args(n, k, deg, width, height, means, cov, cano, feat, tf,
                     active, wv, fp, extr, center, fovx, fovy);
  a.means2d = means2d;
  a.conic = conic;
  a.depth = depth;
  a.radius = radius;
  a.rect = rect;
  a.visible = visible;
  a.colors = colors;
  return launch(false, a, stream);
}

// The backward from the same inputs and the gradients of means2d, conic
// and colors (each null for zero): d_means [n, 3], d_cov [n, 6], d_cano
// [n, 3], d_feat [n, k, 3], d_tf [n, 4, 4], each written whole, or
// skipped where null. Returns a cudaError_t.
int project_backward(int n, int k, int deg, int width, int height,
                     const float* means, const float* cov, const float* cano,
                     const float* feat, const float* tf,
                     const uint8_t* active, const float* wv, const float* fp,
                     const float* extr, const float* center,
                     const float* fovx, const float* fovy,
                     const float* g_means2d, const float* g_conic,
                     const float* g_colors, float* d_means, float* d_cov,
                     float* d_cano, float* d_feat, float* d_tf,
                     void* stream) {
  Args a = make_args(n, k, deg, width, height, means, cov, cano, feat, tf,
                     active, wv, fp, extr, center, fovx, fovy);
  a.g_means2d = g_means2d;
  a.g_conic = g_conic;
  a.g_colors = g_colors;
  a.d_means = d_means;
  a.d_cov = d_cov;
  a.d_cano = d_cano;
  a.d_feat = d_feat;
  a.d_tf = d_tf;
  return launch(true, a, stream);
}

const char* project_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
