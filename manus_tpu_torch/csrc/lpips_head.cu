// The LPIPS head of one stage, forward and closed-form backward, for NVIDIA
// Hopper (sm_90a). Plain C interface, loaded with ctypes
// (manus_tpu_torch/ops/conv.py).
//
// Replaces the Pallas TPU kernels of manus_tpu/ops/conv_pallas.py:
// lpips_head_fwd_kernel replaces _head_fwd_kernel (_head_fwd_call),
// lpips_head_bwd_kernel replaces _head_bwd_kernel (_head_bwd_call).
//
// Math, per row of the [rows, C] feature pair (a, b), bf16 or fp32, in fp32:
//   ra = |a|, rb = |b| over the C channels, ea = ra + 1e-10, ia = 1 / ea,
//   forward:  sum over rows and channels of (a ia - b ib)^2 lin[c]
//   backward: g = 2 (lin ct) (a ia - b ib),
//             da = g ia - a (a.g) / (safe(ra) ea^2),
//             db = -(g ib - b (b.g) / (safe(rb) eb^2)), safe(r) = r > 0 ? r : 1,
//   where ct is the cotangent of the forward's scalar, read on the card.
//   da and db are in the features' type. The fp32 form (the xla_dx LPIPS
//   engine's features) is the same code with 8 channels in two 16-byte
//   vectors instead of one, at 2 CTAs an SM (128 registers a thread)
//   instead of 4; the numbers below are the bf16 form's.
//
// Pixel rows only. On a stage's layout the pixels lie in the row span
// [lo, hi) = [m_blk, m_blk + n_valid); every row outside it is zero in a
// and b (the conv kernels zero-fill it) and adds nothing. The forward
// reads only the span. The backward reads only the span and writes zeros
// to the rows outside it without reading them. Without a layout the span
// is every row.
//
// What bounds it on an H100: memory. A row pair is read once, 4 C bytes,
// for 10 fp32 operations a channel (forward) or 17 (backward, da only;
// 22 with db; g is computed twice rather than held for the stores), under
// the card's 20 operations a byte. The bound is the pixels' bytes over
// 3.35 TB/s: 4 px C (forward), 6 px C (backward, da only) or 8 px C (da
// and db). What the design does to reach it:
//   * a row is split over a group of LANES lanes, LANES = C / 8 rounded up
//     to a power of 2 (8 at C = 64, 32 at C >= 256; at C = 512 a lane
//     takes two vectors): each lane loads 16 bytes, 8 bf16 channels, of a
//     and of b per vector, neighbouring lanes on neighbouring addresses.
//     The row's norms and dot products are butterflies of __shfl_xor_sync
//     inside the group, after which every lane of the group holds the same
//     bits;
//   * a group starts the loads of kUnroll rows before the first reduction
//     (2, or 1 at C = 512): 64 bytes a thread, 64 KB an SM at 4 CTAs of
//     256 threads, which __launch_bounds__ holds to 64 registers (each
//     pass after the first unpacks the raw vectors again). More
//     rows in flight, or fewer CTAs with more registers, measured no
//     faster on an H100, and a cap that makes ptxas spill much slower
//     (scripts/torch_head_tune.py): past a fixed 3-5 us a launch, the
//     large stages stream at 2.5-3.0 TB/s;
//   * lin (2 lin ct in the backward) is held in registers, loaded once;
//   * a grid-stride loop over steps of kRows rows, on a grid fixed by the
//     span and the SM count (one wave, at most), so the order of every sum
//     is fixed;
//   * the backward skips db (its dot product and its stores) when the
//     caller passes none, as for the detached gt features of the train
//     step; da's instructions are the same either way, and so are its bits.
//
// The forward's scalar comes from the same launch. Each CTA writes its
// partial (each thread's terms in row order, then a butterfly over the
// warp, then the warps in order) and takes a ticket from an integer
// counter. The CTA that takes the last ticket sums the partials in a fixed
// order (thread t those of CTAs t, t + 256, ... in order, a butterfly over
// the warp, the warps in order) and writes the scalar. atomicInc wraps the
// counter to 0 on the last ticket, so every launch, and every replay of a
// CUDA graph, finds it at 0. The counter and the partials are one
// workspace per device: the launches that share it must run on one
// stream, as the port makes them. No float atomics: two launches give the
// same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// CTAs an SM holds of each bf16 kernel (the registers a thread may take
// follow from it), and so the most CTAs of its grid: one wave. The fp32
// kernels hold kF32CtasPerSm.
constexpr int kFwdCtasPerSm = 4;
constexpr int kBwdCtasPerSm = 4;
constexpr int kF32CtasPerSm = 2;
// Rows a lane group loads at once at C <= 256 (half as many at C = 512).
constexpr int kRowsInFlight = 2;
constexpr int kMaxC = 512;
constexpr float kEps = 1e-10f;

// One instance: LANES lanes a row, VPL 16-byte vectors a lane.
template <int LANES, int VPL>
struct Tile {
  static constexpr int kLanes = LANES;
  static constexpr int kVpl = VPL;
  static constexpr int kGroups = kThreads / LANES;  // rows a CTA holds at once
  static constexpr int kUnroll = kRowsInFlight / VPL;  // rows a group loads at once
  static constexpr int kRows = kGroups * kUnroll;   // rows a CTA takes a step
};

// 8 bf16 channels (one 16-byte vector) to floats, exactly.
__device__ __forceinline__ void unpack8(const uint4& q, float* f) {
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    f[2 * k] = __uint_as_float(w[k] << 16);
    f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

// 8 floats to bf16, round to nearest even, as one 16-byte vector.
__device__ __forceinline__ uint4 pack8(const float* f) {
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
    w[k] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// q itself, but opaque to the compiler: each pass over a step's rows
// after the first unpacks the raw vectors again instead of keeping the
// first pass's floats, 4 registers a vector instead of 16. Without it
// the backward spills at 64 registers.
__device__ __forceinline__ uint4 reread(uint4 q) {
  asm volatile("" : "+r"(q.x), "+r"(q.y), "+r"(q.z), "+r"(q.w));
  return q;
}

// The features' type: how 8 channels are held, loaded, unpacked to floats
// and packed back, and how many CTAs an SM holds.
struct Bf16 {
  using Vec = uint4;  // 8 bf16 channels
  static constexpr int kFwdCtas = kFwdCtasPerSm, kBwdCtas = kBwdCtasPerSm;
  __device__ __forceinline__ static Vec zero() { return make_uint4(0u, 0u, 0u, 0u); }
  __device__ __forceinline__ static Vec load(const Vec* p) { return __ldg(p); }
  __device__ __forceinline__ static void unpack(const Vec& q, float* f) { unpack8(q, f); }
  __device__ __forceinline__ static Vec pack(const float* f) { return pack8(f); }
  __device__ __forceinline__ static Vec opaque(const Vec& q) { return reread(q); }
};

struct F32 {
  struct Vec {
    uint4 lo, hi;  // 8 fp32 channels
  };
  static constexpr int kFwdCtas = kF32CtasPerSm, kBwdCtas = kF32CtasPerSm;
  __device__ __forceinline__ static Vec zero() {
    return {make_uint4(0u, 0u, 0u, 0u), make_uint4(0u, 0u, 0u, 0u)};
  }
  __device__ __forceinline__ static Vec load(const Vec* p) {
    const uint4* u = reinterpret_cast<const uint4*>(p);
    return {__ldg(u), __ldg(u + 1)};
  }
  __device__ __forceinline__ static void unpack(const Vec& q, float* f) {
    const uint32_t w[8] = {q.lo.x, q.lo.y, q.lo.z, q.lo.w, q.hi.x, q.hi.y, q.hi.z, q.hi.w};
#pragma unroll
    for (int k = 0; k < 8; ++k) f[k] = __uint_as_float(w[k]);
  }
  __device__ __forceinline__ static Vec pack(const float* f) {
    return {make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                       __float_as_uint(f[3])),
            make_uint4(__float_as_uint(f[4]), __float_as_uint(f[5]), __float_as_uint(f[6]),
                       __float_as_uint(f[7]))};
  }
  __device__ __forceinline__ static Vec opaque(const Vec& q) { return {reread(q.lo), reread(q.hi)}; }
};

// Sum over a group of LANES lanes (a power of 2 up to 32) of a full warp.
template <int LANES>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = LANES / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The unit difference a ia - b ib, with explicit roundings (as every
// product and FMA of the gradient) so that no form of a kernel contracts
// them differently.
__device__ __forceinline__ float unit_diff(float a, float ia, float b, float ib) {
  return __fmaf_rn(-b, ib, __fmul_rn(a, ia));
}

// This lane's place: its row group, its lane in the group, and which of
// its vectors hold channels (all of them unless C / 8 is no power of 2).
template <class T, class E>
struct Lane {
  int group, lig;
  bool on[T::kVpl];

  __device__ __forceinline__ Lane(int nvec) {
    group = threadIdx.x / T::kLanes;
    lig = threadIdx.x % T::kLanes;
#pragma unroll
    for (int j = 0; j < T::kVpl; ++j) on[j] = vec(j) < nvec;
  }
  __device__ __forceinline__ int vec(int j) const { return lig + T::kLanes * j; }

  // This lane's 8 weights of vector j, times `scale` (0 where it holds none).
  __device__ __forceinline__ void weights(const float* __restrict__ lin,
                                          float scale, float (&w)[T::kVpl][8]) const {
#pragma unroll
    for (int j = 0; j < T::kVpl; ++j) {
#pragma unroll
      for (int k = 0; k < 8; ++k) w[j][k] = on[j] ? lin[8 * vec(j) + k] * scale : 0.0f;
    }
  }

  // The vectors of rows base + u kGroups + group, u < kUnroll, of x and y:
  // every load started before any is used; zeros past hi.
  __device__ __forceinline__ void load(const typename E::Vec* __restrict__ x,
                                       const typename E::Vec* __restrict__ y,
                                       int64_t base, int hi, int nvec,
                                       typename E::Vec (&qx)[T::kUnroll][T::kVpl],
                                       typename E::Vec (&qy)[T::kUnroll][T::kVpl]) const {
#pragma unroll
    for (int u = 0; u < T::kUnroll; ++u) {
      const int64_t r = base + u * T::kGroups + group;
#pragma unroll
      for (int j = 0; j < T::kVpl; ++j) {
        qx[u][j] = qy[u][j] = E::zero();
        if (r < hi && on[j]) {
          const int64_t e = r * nvec + vec(j);
          qx[u][j] = E::load(x + e);
          qy[u][j] = E::load(y + e);
        }
      }
    }
  }
};

// Squared norms of the kUnroll rows of qa and qb, summed over the group.
template <class T, class E>
__device__ __forceinline__ void row_norms(const typename E::Vec (&qa)[T::kUnroll][T::kVpl],
                                          const typename E::Vec (&qb)[T::kUnroll][T::kVpl],
                                          float (&ra)[T::kUnroll],
                                          float (&rb)[T::kUnroll]) {
#pragma unroll
  for (int u = 0; u < T::kUnroll; ++u) {
    float sa = 0.0f, sb = 0.0f;
#pragma unroll
    for (int j = 0; j < T::kVpl; ++j) {
      float fa[8], fb[8];
      E::unpack(qa[u][j], fa);
      E::unpack(qb[u][j], fb);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        sa = __fmaf_rn(fa[k], fa[k], sa);
        sb = __fmaf_rn(fb[k], fb[k], sb);
      }
    }
    ra[u] = sa;
    rb[u] = sb;
  }
#pragma unroll
  for (int u = 0; u < T::kUnroll; ++u) {
    ra[u] = sqrtf(group_sum<T::kLanes>(ra[u]));
    rb[u] = sqrtf(group_sum<T::kLanes>(rb[u]));
  }
}

int grid_size(int rows_per_step, int span, int ctas_per_sm, int sm_count) {
  const int steps = (span + rows_per_step - 1) / rows_per_step;
  return steps < ctas_per_sm * sm_count ? steps : ctas_per_sm * sm_count;
}

template <class T, class E>
__global__ void __launch_bounds__(kThreads, E::kFwdCtas) lpips_head_fwd_kernel(
    const typename E::Vec* __restrict__ a, const typename E::Vec* __restrict__ b,
    const float* __restrict__ lin, int lo, int hi, int nvec,
    unsigned int* __restrict__ ticket, float* __restrict__ partials,
    float* __restrict__ out) {
  using Vec = typename E::Vec;
  constexpr int U = T::kUnroll, V = T::kVpl;
  const Lane<T, E> lane(nvec);
  float w[V][8];
  lane.weights(lin, 1.0f, w);
  float acc = 0.0f;
  for (int64_t base = lo + (int64_t)blockIdx.x * T::kRows; base < hi;
       base += (int64_t)gridDim.x * T::kRows) {
    Vec qa[U][V], qb[U][V];
    lane.load(a, b, base, hi, nvec, qa, qb);
    float ra[U], rb[U];
    row_norms<T, E>(qa, qb, ra, rb);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float ia = 1.0f / (ra[u] + kEps), ib = 1.0f / (rb[u] + kEps);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        float fa[8], fb[8];
        E::unpack(E::opaque(qa[u][j]), fa);
        E::unpack(E::opaque(qb[u][j]), fb);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float d = unit_diff(fa[k], ia, fb[k], ib);
          acc = __fmaf_rn(__fmul_rn(d, d), w[j][k], acc);
        }
      }
    }
  }

  __shared__ float warp_part[kWarps];
  __shared__ bool last;
  const int warp = threadIdx.x / 32;
  acc = group_sum<32>(acc);
  if (threadIdx.x % 32 == 0) warp_part[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.0f;
    for (int i = 0; i < kWarps; ++i) s += warp_part[i];
    partials[blockIdx.x] = s;
    __threadfence();  // the partial is visible before the ticket is taken
    last = atomicInc(ticket, gridDim.x - 1) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  float s = 0.0f;
  for (int i = threadIdx.x; i < (int)gridDim.x; i += kThreads) s += __ldcg(partials + i);
  s = group_sum<32>(s);
  if (threadIdx.x % 32 == 0) warp_part[warp] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.0f;
    for (int i = 0; i < kWarps; ++i) t += warp_part[i];
    *out = t;
  }
}

template <class T, class E>
__global__ void __launch_bounds__(kThreads, E::kBwdCtas) lpips_head_bwd_kernel(
    const typename E::Vec* __restrict__ a, const typename E::Vec* __restrict__ b,
    const float* __restrict__ lin, const float* __restrict__ ct, int rows,
    int lo, int hi, int nvec, typename E::Vec* __restrict__ da,
    typename E::Vec* __restrict__ db) {
  using Vec = typename E::Vec;
  constexpr int U = T::kUnroll, V = T::kVpl;
  const bool with_db = db != nullptr;
  // the rows outside the span: zeros, not read
  const int64_t lead = (int64_t)lo * nvec;
  const int64_t outside = lead + (int64_t)(rows - hi) * nvec;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < outside;
       i += (int64_t)gridDim.x * kThreads) {
    const int64_t e = i < lead ? i : i - lead + (int64_t)hi * nvec;
    da[e] = E::zero();
    if (with_db) db[e] = E::zero();
  }

  const Lane<T, E> lane(nvec);
  float w2[V][8];  // 2 (lin ct), as the plain version rounds it
  lane.weights(lin, *ct, w2);
#pragma unroll
  for (int j = 0; j < V; ++j) {
#pragma unroll
    for (int k = 0; k < 8; ++k) w2[j][k] *= 2.0f;
  }
  for (int64_t base = lo + (int64_t)blockIdx.x * T::kRows; base < hi;
       base += (int64_t)gridDim.x * T::kRows) {
    Vec qa[U][V], qb[U][V];
    lane.load(a, b, base, hi, nvec, qa, qb);
    float ra[U], rb[U], ia[U], ib[U], dot_a[U], dot_b[U];
    row_norms<T, E>(qa, qb, ra, rb);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ia[u] = 1.0f / (ra[u] + kEps);
      ib[u] = 1.0f / (rb[u] + kEps);
      dot_a[u] = dot_b[u] = 0.0f;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        float fa[8], fb[8];
        E::unpack(E::opaque(qa[u][j]), fa);
        E::unpack(E::opaque(qb[u][j]), fb);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float g = __fmul_rn(w2[j][k], unit_diff(fa[k], ia[u], fb[k], ib[u]));
          dot_a[u] = __fmaf_rn(fa[k], g, dot_a[u]);
          if (with_db) dot_b[u] = __fmaf_rn(fb[k], g, dot_b[u]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) dot_a[u] = group_sum<T::kLanes>(dot_a[u]);
    if (with_db) {
#pragma unroll
      for (int u = 0; u < U; ++u) dot_b[u] = group_sum<T::kLanes>(dot_b[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t r = base + u * T::kGroups + lane.group;
      const float ea = ra[u] + kEps, eb = rb[u] + kEps;
      const float ka = dot_a[u] / ((ra[u] > 0.0f ? ra[u] : 1.0f) * (ea * ea));
      const float kb = dot_b[u] / ((rb[u] > 0.0f ? rb[u] : 1.0f) * (eb * eb));
#pragma unroll
      for (int j = 0; j < V; ++j) {
        if (r >= hi || !lane.on[j]) continue;
        const int64_t e = r * nvec + lane.vec(j);
        float fa[8], fb[8], g[8], out[8];
        E::unpack(E::opaque(qa[u][j]), fa);
        E::unpack(E::opaque(qb[u][j]), fb);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          g[k] = __fmul_rn(w2[j][k], unit_diff(fa[k], ia[u], fb[k], ib[u]));
          out[k] = __fmaf_rn(-fa[k], ka, __fmul_rn(g[k], ia[u]));
        }
        da[e] = E::pack(out);
        if (with_db) {
#pragma unroll
          for (int k = 0; k < 8; ++k) out[k] = __fmaf_rn(fb[k], kb, -__fmul_rn(g[k], ib[u]));
          db[e] = E::pack(out);
        }
      }
    }
  }
}

// Calls f(Tile<LANES, VPL>()) for the instance that fits nvec vectors a
// row: every C that is a multiple of 8 up to kMaxC.
template <class F>
int with_tile(int nvec, F f) {
  if (nvec <= 1) return f(Tile<1, 1>());
  if (nvec <= 2) return f(Tile<2, 1>());
  if (nvec <= 4) return f(Tile<4, 1>());
  if (nvec <= 8) return f(Tile<8, 1>());
  if (nvec <= 16) return f(Tile<16, 1>());
  if (nvec <= 32) return f(Tile<32, 1>());
  return f(Tile<32, 2>());
}

bool valid(int rows, int c, int lo, int hi, int sm_count) {
  return c > 0 && c % 8 == 0 && c <= kMaxC && 0 <= lo && lo < hi &&
         hi <= rows && sm_count > 0;
}

template <class E>
int head_fwd(const void* a, const void* b, const float* lin, int rows, int c, int lo,
             int hi, int sm_count, void* workspace, float* out, void* stream) {
  if (!valid(rows, c, lo, hi, sm_count)) return (int)cudaErrorInvalidValue;
  const int nvec = c / 8;
  return with_tile(nvec, [&](auto tile) {
    using T = decltype(tile);
    using Vec = typename E::Vec;
    unsigned int* ticket = static_cast<unsigned int*>(workspace);
    const int grid = grid_size(T::kRows, hi - lo, E::kFwdCtas, sm_count);
    lpips_head_fwd_kernel<T, E><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        static_cast<const Vec*>(a), static_cast<const Vec*>(b), lin, lo, hi, nvec,
        ticket, reinterpret_cast<float*>(ticket + 1), out);
    return (int)cudaGetLastError();
  });
}

template <class E>
int head_bwd(const void* a, const void* b, const float* lin, const float* ct, int rows,
             int c, int lo, int hi, int sm_count, void* da, void* db, void* stream) {
  if (!valid(rows, c, lo, hi, sm_count)) return (int)cudaErrorInvalidValue;
  const int nvec = c / 8;
  return with_tile(nvec, [&](auto tile) {
    using T = decltype(tile);
    using Vec = typename E::Vec;
    const int grid = grid_size(T::kRows, hi - lo, E::kBwdCtas, sm_count);
    lpips_head_bwd_kernel<T, E><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        static_cast<const Vec*>(a), static_cast<const Vec*>(b), lin, ct, rows, lo, hi,
        nvec, static_cast<Vec*>(da), static_cast<Vec*>(db));
    return (int)cudaGetLastError();
  });
}

}  // namespace

extern "C" {

// The forward's workspace for `sm_count` SMs, in 4-byte words: the ticket
// counter (0 when allocated) and a partial per CTA (of either form).
int lpips_head_workspace_words(int sm_count) {
  return 1 + (kFwdCtasPerSm > kF32CtasPerSm ? kFwdCtasPerSm : kF32CtasPerSm) * sm_count;
}

// Forward over rows [lo, hi) of a, b ([rows, c] bf16, 16-byte aligned):
// the fp32 scalar into *out.
int lpips_head_fwd(const void* a, const void* b, const float* lin, int rows,
                   int c, int lo, int hi, int sm_count, void* workspace,
                   float* out, void* stream) {
  return head_fwd<Bf16>(a, b, lin, rows, c, lo, hi, sm_count, workspace, out, stream);
}

// The same on fp32 features.
int lpips_head_fwd_f32(const void* a, const void* b, const float* lin, int rows,
                       int c, int lo, int hi, int sm_count, void* workspace,
                       float* out, void* stream) {
  return head_fwd<F32>(a, b, lin, rows, c, lo, hi, sm_count, workspace, out, stream);
}

// Backward: da (and db unless it is null), [rows, c] bf16, from rows
// [lo, hi) of a, b and the fp32 cotangent *ct; zeros outside [lo, hi).
int lpips_head_bwd(const void* a, const void* b, const float* lin,
                   const float* ct, int rows, int c, int lo, int hi,
                   int sm_count, void* da, void* db, void* stream) {
  return head_bwd<Bf16>(a, b, lin, ct, rows, c, lo, hi, sm_count, da, db, stream);
}

// The same on fp32 features and gradients.
int lpips_head_bwd_f32(const void* a, const void* b, const float* lin,
                       const float* ct, int rows, int c, int lo, int hi,
                       int sm_count, void* da, void* db, void* stream) {
  return head_bwd<F32>(a, b, lin, ct, rows, c, lo, hi, sm_count, da, db, stream);
}

const char* lpips_head_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
