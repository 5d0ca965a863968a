// Tile compositing of depth-ordered gaussian pairs, forward and backward,
// for NVIDIA Hopper (sm_90a). Plain C interface, loaded with ctypes.
//
// Replaces the Pallas TPU kernels of manus_tpu/ops/rasterizer/
// pallas_backend.py: composite_fwd replaces _make_fwd_kernel,
// composite_bwd replaces _make_bwd_kernel (the custom VJP of
// _make_composite).
//
// Layout. payload is field-major [16, P] float32: rows mean x, mean y,
// conic a, b, c, opacity, r, g, b, then padding (payload.py). Tile t owns
// the pair columns [offsets[t], offsets[t] + counts[t]), depth-ordered.
// The T slots need not cover the grid: slot t composites the tile of
// global id g = tile_ids[t] (tile_ids null: g = t, the full grid), as the
// JAX kernels' scalar-prefetched tile ids do; the outputs keep the slot
// order. A tile is 16x16 pixels; pixel i of slot t has its centre at
// (tx*16 + i%16, ty*16 + i/16), tx = g % ntx, ty = g / ntx.
//
// Numerics (the JAX kernel's, pair by pair):
//   power = -0.5 (a dx^2 + c dy^2) - b dx dy,  skipped where power > 0
//   alpha = min(opacity exp(power), 0.99),      skipped where < 1/255
//   log T accumulates log1p(-alpha); a pair is included while
//   log T after it >= log(1e-4), and the walk of a pixel ends at the first
//   pair that is not; T_final is T after the last included pair.
// The 0.99 clamp is straight-through in the backward: d opacity and
// d power use exp(power) as if unclamped.
//
// What bounds it on an H100. 36 bytes a pair are read and 24 a pixel
// written against about 32 (forward) and 61 (backward) float operations
// per pixel and pair, three of them transcendental: operations, not
// bytes. A pixel's walk is a serial chain, and scenes crowd their pairs
// into few tiles (the bench scene: 115 of 1,024 tiles, the deepest at the
// 4,096-pair cap), so one CTA per tile leaves most SMs idle for as long
// as the deepest tile's walk lasts. The design spreads that walk.
//
// Work items. A tile's segment is cut into chunks of kChunk pairs; one
// item is one (tile, chunk), one CTA of 256 threads, one thread a pixel.
// plan_kernel numbers the items from the counts alone (a block scan), so
// the grid is the static bound ceil(P / kChunk) + T and the host never
// looks at the counts (a tile without pairs has no item; its outputs are
// written on the side). Every walk is made the same way:
//   * the item's pairs are staged once into shared memory, and with each
//     pair a mask of the warps (8x4 pixel blocks) its footprint can
//     reach: the gate alpha >= 1/255 needs power >= -log(255 opacity),
//     an ellipse whose bounding box is known from the conic. A pair
//     outside a warp's block fails the gate at all 32 pixels, so leaving
//     it out changes no bit;
//   * each warp collects its pairs with a ballot and walks only those,
//     in depth order (in both bench payloads a warp is left with 24% of
//     its item's pairs), a few at a time: what a pair brings to a pixel
//     (the gates, alpha, 1 - alpha, its log) depends on no other pair
//     and is computed for the whole group before the walk's short serial
//     chain, so a warp alone on its scheduler still hides the latency of
//     the exponentials. T is carried as a product beside log T.
//
// Forward, three kernels in one call.
//   chunk_pass: chunk 0 walks from log T = 0 under the stop rule, which
//     is the true walk; a pixel that stops there, or whose tile has one
//     chunk, is finished. Every later chunk is walked from log T = 0
//     without the stop rule and gives, per pixel, L = the log of its
//     product of (1 - alpha), K = the colour it would add, and its last
//     gated pair.
//   rewalk: item (t, c >= 1) scans the tile's chunks before it: log T
//     only falls, so chunk k is included whole while pre_k + L_k >=
//     log(1e-4), adding exp(pre_k) K_k. The first chunk that fails is
//     the only one walked again, pair by pair from its true pre under
//     the stop rule, by the CTA of that very item; a CTA none of whose
//     pixels stop in its chunk stages nothing. If rounding lets such a
//     walk reach the chunk's end, the thread goes on through the later
//     chunks from global memory (rare; stop_margin > 0 forces it, for
//     tests). Each pixel's outputs are written once, by the item in
//     which it stops, else by the tile's last item. Every item scans
//     from chunk 0, so a tile costs the square of its chunks in 4-byte
//     loads: 32 chunks at the 4,096-pair cap.
//   Saved for the backward, per item and pixel: log T at the chunk's
//     start and the colour the chunk added.
//
// Backward, one kernel, one item per (tile, chunk). A pixel takes part
// in the chunks up to the one that holds its last included pair. There
// it starts from the forward's final log T with nothing behind; in an
// earlier chunk from the next chunk's saved log T and, behind, the saved
// colours of the later chunks summed farthest first (never the total
// less a prefix, which cancels where d_alpha divides by 1 - alpha). It
// walks back to front in batches of 64 pairs, two pairs at a time, and
// rebuilds T before each pair as T / (1 - alpha), starting from exp of
// that log T. Nine gradient values per pair are summed over the pixels:
// within a warp by a butterfly that halves the values a lane holds at
// each step (14 shuffles, not 45), only where a lane of the warp is
// active; then over the warps that wrote, in warp order, in shared
// memory. Each pair lies in one item, so each d_payload column is
// written by one CTA, once: no atomics, equal bits at every launch.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;
constexpr int kPixels = kTile * kTile;  // threads per CTA
constexpr int kLive = 9;                // live payload fields
constexpr int kChunk = 128;             // pairs per item
constexpr int kBwdBatch = 64;           // pairs per backward batch
constexpr int kGroup = 4;               // pairs a forward walk takes at once
constexpr int kRedStride = kBwdBatch + 1;  // the 8 field rows hit 8 banks
constexpr int kWarps = kPixels / 32;
constexpr int kPlanThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kAlphaEps = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
// log(1e-4) in float32, the JAX kernel's LOG_T_EPS
constexpr float kLogTEps = -9.210340371976182f;

// Alpha of one pair at one pixel; false where a gate drops the pair.
// Without a branch, so that the terms of several pairs can be in flight
// at once; where it returns false, alpha and g mean nothing.
__device__ __forceinline__ bool pair_alpha(
    float dx, float dy, float ca, float cb, float cc, float op,
    float* alpha, float* g) {
  const float power = -0.5f * (ca * dx * dx + cc * dy * dy) - cb * dx * dy;
  *g = expf(power);
  *alpha = fminf(op * *g, kAlphaMax);
  return power <= 0.0f && *alpha >= kAlphaEps;
}

// Thread i of a CTA owns the pixel at (x, y) of its tile: warp w is the
// 8x4 block at columns 8 (w % 2), rows 4 (w / 2).
__device__ __forceinline__ void pixel_of_thread(int i, int* x, int* y) {
  const int w = i >> 5, l = i & 31;
  *x = ((w & 1) << 3) | (l & 7);
  *y = ((w >> 1) << 2) | (l >> 3);
}

// The pixel origin of slot `slot`: its global tile id's column and row.
__device__ __forceinline__ void tile_origin(const int* __restrict__ tile_ids,
                                            int slot, int ntx, float* x0,
                                            float* y0) {
  const int g = tile_ids ? tile_ids[slot] : slot;
  *x0 = (float)((g % ntx) * kTile);
  *y0 = (float)((g / ntx) * kTile);
}

// The warps whose pixel block a pair's footprint can reach, one bit a
// warp. The pair passes the gates at a pixel only if opacity >= 1/255
// and power >= -log(255 opacity) =: -h, that is a dx^2 + 2 b dx dy +
// c dy^2 <= 2h, which holds |dx| <= sqrt(2h c / det), |dy| <= sqrt(2h a /
// det). The box is taken 1% and half a pixel wider than that, and h 0.025
// larger, far beyond float rounding of power and exp; a conic that is
// not positive definite is culled nowhere.
__device__ __forceinline__ unsigned warp_mask(
    float mx, float my, float ca, float cb, float cc, float op,
    float x0, float y0) {
  if (!(op >= kAlphaEps)) return 0u;  // alpha <= opacity where power <= 0
  const float det = ca * cc - cb * cb;
  if (!(det > 0.0f && ca > 0.0f && cc > 0.0f)) return 0xffu;
  const float h2 = 2.0f * logf(op * 255.0f) + 0.05f;
  const float rx = sqrtf(h2 * cc / det) * 1.01f + 0.5f;
  const float ry = sqrtf(h2 * ca / det) * 1.01f + 0.5f;
  if (!(rx < 1e6f && ry < 1e6f)) return 0xffu;
  const float xa = mx - rx - x0, xb = mx + rx - x0;
  const float ya = my - ry - y0, yb = my + ry - y0;
  const unsigned cols = (xb >= 0.0f && xa <= 7.0f ? 1u : 0u) |
                        (xb >= 8.0f && xa <= 15.0f ? 2u : 0u);
  unsigned mask = 0u;
#pragma unroll
  for (int by = 0; by < 4; ++by) {
    if (yb >= 4.0f * by && ya <= 4.0f * by + 3.0f) mask |= cols << (2 * by);
  }
  return mask;
}

// kN staged pairs: a warp reads one pair's nine fields, all lanes the same
// address, as two 16-byte loads and one of 4 bytes.
template <int kN>
struct Staged {
  float4 a[kN];  // mean x, mean y, conic a, conic b
  float4 b[kN];  // conic c, opacity, r, g
  float c[kN];   // b
  unsigned char mask[kN];
};

// Stage n pairs from column col0 on, and their warp masks.
template <int kN>
__device__ __forceinline__ void stage_pairs(
    Staged<kN>& s, const float* __restrict__ payload, int64_t P, int64_t col0,
    int n, float x0, float y0) {
  for (int j = threadIdx.x; j < n; j += kPixels) {
    float f[kLive];
#pragma unroll
    for (int k = 0; k < kLive; ++k) f[k] = payload[k * P + col0 + j];
    s.a[j] = make_float4(f[0], f[1], f[2], f[3]);
    s.b[j] = make_float4(f[4], f[5], f[6], f[7]);
    s.c[j] = f[8];
    s.mask[j] = (unsigned char)warp_mask(f[0], f[1], f[2], f[3], f[4], f[5],
                                         x0, y0);
  }
}

// One pixel's walk: log T as the sum of log(1 - alpha) (the stop rule's
// and the outputs'), T as the product of (1 - alpha) (the weights'; the
// two differ by rounding only), the colour added, index + 1 of the last
// included pair, and whether the stop rule has ended it.
struct Walk {
  float lt, t, r, g, b;
  int last;
  bool done;
};

// What one pair brings to one pixel, whatever came before it: whether it
// passes the gates, alpha, 1 - alpha and (for the stop rule) its log.
// log(1 - alpha) is the hardware's log2 (absolute error about 2e-7 here):
// over the few hundred pairs a pixel includes that moves log T by far
// less than 1e-4, and only the place where a walk stops depends on it.
struct Term {
  float alpha, u, log_u;
  bool ok;
};

template <bool kStop>
__device__ __forceinline__ Term pair_term(float px, float py, float4 a,
                                          float4 b) {
  Term t;
  float g;
  t.ok = pair_alpha(px - a.x, py - a.y, a.z, a.w, b.x, b.y, &t.alpha, &g);
  t.u = 1.0f - t.alpha;
  t.log_u = kStop ? __logf(t.u) : 0.0f;
  return t;
}

// The serial part of a walk. With kStop the true walk. Without, a chunk on
// its own from T = 1 with no stop rule: only the product is carried, and
// its log taken at the end.
template <bool kStop>
__device__ __forceinline__ void walk_step(
    Walk& s, const Term& t, float cr, float cg, float cb, int idx1) {
  if (!t.ok) return;
  if (kStop) {
    const float lt_after = s.lt + t.log_u;
    if (!(lt_after >= kLogTEps)) {
      s.done = true;
      return;
    }
    s.lt = lt_after;
  }
  const float w = t.alpha * s.t;
  s.r += w * cr;
  s.g += w * cg;
  s.b += w * cb;
  s.t *= t.u;
  s.last = idx1;
}

// Walk the staged pairs that reach this warp's block, in order. idx0 is
// the place in the tile's segment of staged pair 0. The pairs are taken
// kGroup at a time: their terms first, all independent, then the walk's
// short serial chain, so that a warp alone on its scheduler still hides
// the latency of the exponentials.
template <bool kStop>
__device__ __forceinline__ void walk_staged(
    Walk& s, const Staged<kChunk>& sp, int n, int idx0, float px, float py) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int b = 0; b < n; b += 32) {
    if (kStop && __all_sync(kFull, s.done)) break;
    const int j = b + lane;
    unsigned m = __ballot_sync(kFull, j < n && ((sp.mask[j] >> warp) & 1));
    while (m) {
      int k[kGroup];
      Term term[kGroup];
      float4 col[kGroup];
      float blue[kGroup];
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        k[i] = m ? b + __ffs(m) - 1 : -1;
        m &= m - 1;
      }
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        const int kk = max(k[i], 0);
        col[i] = sp.b[kk];
        blue[i] = sp.c[kk];
        term[i] = pair_term<kStop>(px, py, sp.a[kk], col[i]);
      }
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        if (k[i] >= 0 && (!kStop || !s.done))
          walk_step<kStop>(s, term[i], col[i].z, col[i].w, blue[i],
                           idx0 + k[i] + 1);
      }
    }
  }
}

struct Item {
  int tile, first, chunk, n_chunks, count, lo, n;
  int64_t start;
};

// The (tile, chunk) of item blockIdx.x; false beyond the last item.
__device__ __forceinline__ bool find_item(
    const int* __restrict__ item_start, const int* __restrict__ item_tile,
    const int* __restrict__ offsets, const int* __restrict__ counts,
    int num_tiles, int max_items, Item* it) {
  const int item = blockIdx.x;
  if (item >= min(item_start[num_tiles], max_items)) return false;
  it->tile = item_tile[item];
  it->first = item_start[it->tile];
  it->chunk = item - it->first;
  it->n_chunks = item_start[it->tile + 1] - it->first;
  it->count = counts[it->tile];
  it->lo = it->chunk * kChunk;
  it->n = min(kChunk, it->count - it->lo);
  it->start = offsets[it->tile];
  return true;
}

// item_start[t] = the number of chunks of the tiles before t (so
// item_start[T] = the number of items), item_tile[i] = the tile of item i.
__global__ void __launch_bounds__(kPlanThreads) plan_kernel(
    const int* __restrict__ counts, int num_tiles, int max_items,
    int* __restrict__ item_start, int* __restrict__ item_tile) {
  __shared__ int warp_total[kPlanThreads / 32];
  __shared__ int base_s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) base_s = 0;
  __syncthreads();
  for (int t0 = 0; t0 < num_tiles; t0 += kPlanThreads) {
    const int t = t0 + tid;
    const int n = t < num_tiles ? (max(counts[t], 0) + kChunk - 1) / kChunk : 0;
    int incl = n;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += up;
    }
    if (lane == 31) warp_total[warp] = incl;
    __syncthreads();
    const int base = base_s;
    int before = 0;
    for (int w = 0; w < warp; ++w) before += warp_total[w];
    const int excl = base + before + incl - n;
    if (t < num_tiles) {
      item_start[t] = excl;
      for (int k = 0; k < n && excl + k < max_items; ++k) item_tile[excl + k] = t;
    }
    __syncthreads();
    if (tid == kPlanThreads - 1) base_s = excl + n;
    __syncthreads();
  }
  if (tid == 0) item_start[num_tiles] = base_s;
}

struct FwdOut {
  float* rgb;      // [T, 3, 256]
  float* t_final;  // [T, 256]
  float* log_t;    // [T, 256] log T after the last included pair
  int* n_walk;     // [T, 256] index + 1 of the last included pair
};

__device__ __forceinline__ void write_pixel(
    const FwdOut& out, int tile, int pix, float r, float g, float b, float lt,
    int last) {
  const int64_t o = (int64_t)tile * kPixels + pix;
  out.rgb[(int64_t)tile * 3 * kPixels + pix] = r;
  out.rgb[(int64_t)tile * 3 * kPixels + kPixels + pix] = g;
  out.rgb[(int64_t)tile * 3 * kPixels + 2 * kPixels + pix] = b;
  out.t_final[o] = expf(lt);
  out.log_t[o] = lt;
  out.n_walk[o] = last;
}

// A walk that reached its chunk's end without stopping goes on, pair by
// pair from global memory, through the chunks from `chunk` on, and saves
// their state. s holds log T and, in r, g, b, the colour so far.
__device__ __noinline__ void walk_on(
    Walk& s, const Item& it, int chunk, const float* __restrict__ payload,
    int64_t P, float px, float py, float* __restrict__ saved, int pix) {
  for (int c = chunk; c < it.n_chunks && !s.done; ++c) {
    Walk w = {s.lt, s.t, 0.0f, 0.0f, 0.0f, s.last, false};
    const int hi = min((c + 1) * kChunk, it.count);
    for (int j = c * kChunk; j < hi && !w.done; ++j) {
      const float* p = payload + it.start + j;
      const Term t = pair_term<true>(
          px, py, make_float4(p[0], p[P], p[2 * P], p[3 * P]),
          make_float4(p[4 * P], p[5 * P], 0.0f, 0.0f));
      walk_step<true>(w, t, p[6 * P], p[7 * P], p[8 * P], j + 1);
    }
    float* sv = saved + (int64_t)(it.first + c) * 4 * kPixels + pix;
    sv[0] = s.lt;
    sv[kPixels] = w.r;
    sv[2 * kPixels] = w.g;
    sv[3 * kPixels] = w.b;
    s.r += w.r;
    s.g += w.g;
    s.b += w.b;
    s.lt = w.lt;
    s.t = w.t;
    s.last = w.last;
    s.done = w.done;
  }
}

__global__ void __launch_bounds__(kPixels) chunk_pass_kernel(
    const float* __restrict__ payload, int64_t P,
    const int* __restrict__ offsets, const int* __restrict__ counts,
    const int* __restrict__ tile_ids, int num_tiles, int ntx,
    const int* __restrict__ item_start,
    const int* __restrict__ item_tile, int max_items,
    float* __restrict__ lk,     // [max_items, 5, 256]: L, K rgb, last gated
    float* __restrict__ saved,  // [max_items, 4, 256]
    FwdOut out, float stop_margin) {
  __shared__ Staged<kChunk> s;
  // a tile without pairs has no item: the grid is at least T wide, and
  // CTA b writes tile b's empty outputs
  if (blockIdx.x < num_tiles && counts[blockIdx.x] <= 0)
    write_pixel(out, blockIdx.x, threadIdx.x, 0.0f, 0.0f, 0.0f, 0.0f, 0);
  Item it;
  if (!find_item(item_start, item_tile, offsets, counts, num_tiles, max_items,
                 &it))
    return;
  int x, y;
  pixel_of_thread(threadIdx.x, &x, &y);
  const int pix = y * kTile + x;
  float x0, y0;
  tile_origin(tile_ids, it.tile, ntx, &x0, &y0);
  const float px = x0 + (float)x, py = y0 + (float)y;
  stage_pairs(s, payload, P, it.start + it.lo, it.n, x0, y0);
  __syncthreads();

  Walk w = {0.0f, 1.0f, 0.0f, 0.0f, 0.0f, 0, false};
  float chunk_l;
  if (it.chunk == 0) {
    walk_staged<true>(w, s, it.n, 0, px, py);
    bool own = w.done || it.n_chunks == 1;
    if (!own && w.lt < kLogTEps + stop_margin) {
      walk_on(w, it, 1, payload, P, px, py, saved, pix);
      own = true;
    }
    if (own) write_pixel(out, it.tile, pix, w.r, w.g, w.b, w.lt, w.last);
    // the later items see a pixel that is finished as one that stopped
    chunk_l = own ? -CUDART_INF_F : w.lt;
  } else {
    walk_staged<false>(w, s, it.n, it.lo, px, py);
    chunk_l = logf(w.t);  // -inf for a chunk that leaves no T in a float
  }
  float* rec = lk + (int64_t)blockIdx.x * 5 * kPixels + pix;
  rec[0] = chunk_l;
  rec[kPixels] = w.r;
  rec[2 * kPixels] = w.g;
  rec[3 * kPixels] = w.b;
  rec[4 * kPixels] = __int_as_float(w.last);
}

__global__ void __launch_bounds__(kPixels) rewalk_kernel(
    const float* __restrict__ payload, int64_t P,
    const int* __restrict__ offsets, const int* __restrict__ counts,
    const int* __restrict__ tile_ids, int num_tiles, int ntx,
    const int* __restrict__ item_start,
    const int* __restrict__ item_tile, int max_items,
    const float* __restrict__ lk, float* __restrict__ saved, FwdOut out,
    float stop_margin) {
  __shared__ Staged<kChunk> s;
  Item it;
  if (!find_item(item_start, item_tile, offsets, counts, num_tiles, max_items,
                 &it))
    return;
  if (it.chunk == 0) return;
  int x, y;
  pixel_of_thread(threadIdx.x, &x, &y);
  const int pix = y * kTile + x;
  float x0, y0;
  tile_origin(tile_ids, it.tile, ntx, &x0, &y0);
  const float px = x0 + (float)x, py = y0 + (float)y;
  const float limit = kLogTEps + stop_margin;

  // the chunks before this one: included whole while log T stays above
  const float* first_rec = lk + (int64_t)it.first * 5 * kPixels + pix;
  float pre = 0.0f;
  bool alive = true;
  for (int k = 0; k < it.chunk && alive; ++k) {
    const float chunk_l = first_rec[(int64_t)k * 5 * kPixels];
    alive = pre + chunk_l >= limit;  // else the item of chunk k finishes it
    if (alive) pre += chunk_l;
  }
  const float* rec = lk + (int64_t)blockIdx.x * 5 * kPixels + pix;
  float* sv = saved + (int64_t)blockIdx.x * 4 * kPixels + pix;
  const bool again = alive && !(pre + rec[0] >= limit);
  const bool last_item = it.chunk == it.n_chunks - 1;
  // only the item that finishes a pixel needs what came before it
  float r = 0.0f, g = 0.0f, b = 0.0f;
  int last = 0;
  if (again || (alive && last_item)) {
    float at = 0.0f;
    for (int k = 0; k < it.chunk; ++k) {
      const float* rk = first_rec + (int64_t)k * 5 * kPixels;
      const float e = expf(at);
      r += e * rk[kPixels];
      g += e * rk[2 * kPixels];
      b += e * rk[3 * kPixels];
      at += rk[0];
      last = max(last, __float_as_int(rk[4 * kPixels]));
    }
  }
  const float t_pre = expf(pre);
  if (alive && !again) {
    const float ar = t_pre * rec[kPixels], ag = t_pre * rec[2 * kPixels],
                ab = t_pre * rec[3 * kPixels];
    sv[0] = pre;
    sv[kPixels] = ar;
    sv[2 * kPixels] = ag;
    sv[3 * kPixels] = ab;
    if (last_item) {
      write_pixel(out, it.tile, pix, r + ar, g + ag, b + ab, pre + rec[0],
                  max(last, __float_as_int(rec[4 * kPixels])));
    }
  }
  if (!__syncthreads_or(again)) return;

  stage_pairs(s, payload, P, it.start + it.lo, it.n, x0, y0);
  __syncthreads();
  Walk w = {pre, t_pre, 0.0f, 0.0f, 0.0f, last, !again};
  walk_staged<true>(w, s, it.n, it.lo, px, py);
  if (!again) return;
  sv[0] = pre;
  sv[kPixels] = w.r;
  sv[2 * kPixels] = w.g;
  sv[3 * kPixels] = w.b;
  w.r += r;
  w.g += g;
  w.b += b;
  if (!w.done && it.chunk + 1 < it.n_chunks)
    walk_on(w, it, it.chunk + 1, payload, P, px, py, saved, pix);
  write_pixel(out, it.tile, pix, w.r, w.g, w.b, w.lt, w.last);
}

// Sums over the warp of v[0..7]: lane l ends with the sum of v[l / 4].
__device__ __forceinline__ float warp_sum8(const float (&v)[8], int lane) {
  float a[4], b[2];
  bool hi = lane & 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float keep = hi ? v[4 + i] : v[i], send = hi ? v[i] : v[4 + i];
    a[i] = keep + __shfl_xor_sync(kFull, send, 16);
  }
  hi = lane & 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float keep = hi ? a[2 + i] : a[i], send = hi ? a[i] : a[2 + i];
    b[i] = keep + __shfl_xor_sync(kFull, send, 8);
  }
  hi = lane & 4;
  float r = (hi ? b[1] : b[0]) + __shfl_xor_sync(kFull, hi ? b[0] : b[1], 4);
  r += __shfl_xor_sync(kFull, r, 2);
  r += __shfl_xor_sync(kFull, r, 1);
  return r;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(kFull, v, m);
  return v;
}

__global__ void __launch_bounds__(kPixels) composite_bwd_kernel(
    const float* __restrict__ payload, int64_t P,
    const int* __restrict__ offsets, const int* __restrict__ counts,
    const int* __restrict__ tile_ids, int num_tiles, int ntx,
    const int* __restrict__ item_start,
    const int* __restrict__ item_tile, int max_items,
    const float* __restrict__ saved,    // [max_items, 4, 256]
    const float* __restrict__ d_rgb,    // [T, 3, 256]
    const float* __restrict__ d_tfin,   // [T, 256]
    const float* __restrict__ t_final,  // [T, 256]
    const float* __restrict__ log_t,    // [T, 256]
    const int* __restrict__ n_walk,     // [T, 256]
    float* __restrict__ d_payload) {    // [16, P], zero on entry
  __shared__ Staged<kBwdBatch> s;
  __shared__ float red[kWarps][kLive][kRedStride];
  __shared__ unsigned wrote_s[kWarps][kBwdBatch / 32];
  __shared__ int walk_s[kWarps];
  Item it;
  if (!find_item(item_start, item_tile, offsets, counts, num_tiles, max_items,
                 &it))
    return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x, y;
  pixel_of_thread(threadIdx.x, &x, &y);
  const int pix = y * kTile + x;
  float x0, y0;
  tile_origin(tile_ids, it.tile, ntx, &x0, &y0);
  const float px = x0 + (float)x, py = y0 + (float)y;
  const int64_t o = (int64_t)it.tile * kPixels + pix;

  // the pairs of this chunk up to the pixel's last included pair
  const int nw = n_walk[o];
  const int mine = min(nw - it.lo, it.n);
  const int warp_walk = __reduce_max_sync(kFull, mine);
  if (lane == 0) walk_s[warp] = warp_walk;
  __syncthreads();
  int walk = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) walk = max(walk, walk_s[w]);
  if (walk <= 0) return;  // uniform: no pixel's walk reached this chunk

  float dr = 0.0f, dg = 0.0f, db = 0.0f, tfin_term = 0.0f, lt = 0.0f;  // log T behind
  float suffix = 0.0f;  // sum of w * (dL/dC . c) over the included pairs behind
  if (mine > 0) {
    dr = d_rgb[(int64_t)it.tile * 3 * kPixels + pix];
    dg = d_rgb[(int64_t)it.tile * 3 * kPixels + kPixels + pix];
    db = d_rgb[(int64_t)it.tile * 3 * kPixels + 2 * kPixels + pix];
    tfin_term = t_final[o] * d_tfin[o];
    const int last_chunk = (nw - 1) / kChunk;
    if (last_chunk == it.chunk) {
      lt = log_t[o];
    } else {
      const float* sv = saved + (int64_t)(it.first + last_chunk) * 4 * kPixels + pix;
      float br = 0.0f, bg = 0.0f, bb = 0.0f;
      for (int k = last_chunk; k > it.chunk; --k, sv -= 4 * kPixels) {
        br += sv[kPixels];
        bg += sv[2 * kPixels];
        bb += sv[3 * kPixels];
      }
      lt = sv[4 * kPixels];  // log T at the next chunk's start
      suffix = dr * br + dg * bg + db * bb;
    }
  }
  float t = expf(lt);  // T after the pair at hand; divided back pair by pair

  for (int b_end = walk; b_end > 0; b_end -= kBwdBatch) {
    const int b0 = max(0, b_end - kBwdBatch);
    const int n = b_end - b0;
    stage_pairs(s, payload, P, it.start + it.lo + b0, n, x0, y0);
    // also: every thread is done with the previous batch's red and wrote_s
    __syncthreads();
    unsigned wrote[kBwdBatch / 32];
#pragma unroll
    for (int word = kBwdBatch / 32 - 1; word >= 0; --word) {
      wrote[word] = 0u;
      const int jl = word * 32 + lane;
      unsigned m = __ballot_sync(
          kFull, jl < n && b0 + jl < warp_walk && ((s.mask[jl] >> warp) & 1));
      while (m) {
        // two pairs at a time: their reductions' shuffles interleave
        int bit[2], j[2];
        bool act[2], any[2];
        float alpha[2], g[2], dx[2], dy[2], blue[2];
        float4 fa[2], fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          bit[i] = m ? 31 - __clz(m) : -1;
          if (m) m &= ~(1u << bit[i]);
          j[i] = word * 32 + max(bit[i], 0);
          fa[i] = s.a[j[i]];
          fb[i] = s.b[j[i]];
          blue[i] = s.c[j[i]];
          dx[i] = px - fa[i].x;
          dy[i] = py - fa[i].y;
          act[i] = pair_alpha(dx[i], dy[i], fa[i].z, fa[i].w, fb[i].x, fb[i].y,
                              &alpha[i], &g[i]) &&
                   bit[i] >= 0 && b0 + j[i] < mine;
          any[i] = __any_sync(kFull, act[i]);
        }
        if (!(any[0] || any[1])) continue;
        float c[2][8], c8[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int f = 0; f < 8; ++f) c[i][f] = 0.0f;
          c8[i] = 0.0f;
          if (act[i]) {
            const float ca = fa[i].z, cb = fa[i].w, cc = fb[i].x, op = fb[i].y;
            const float inv_u = __frcp_rn(1.0f - alpha[i]);
            const float t_bef = t * inv_u;
            const float w = alpha[i] * t_bef;
            const float cd = dr * fb[i].z + dg * fb[i].w + db * blue[i];
            const float d_alpha = t_bef * cd - (suffix + tfin_term) * inv_u;
            suffix += w * cd;
            t = t_bef;
            const float d_power = d_alpha * op * g[i];
            const float dpx = d_power * dx[i], dpy = d_power * dy[i];
            c[i][0] = ca * dpx + cb * dpy;      // d mean x
            c[i][1] = cc * dpy + cb * dpx;      // d mean y
            c[i][2] = -0.5f * dpx * dx[i];      // d conic a
            c[i][3] = -dpx * dy[i];             // d conic b
            c[i][4] = -0.5f * dpy * dy[i];      // d conic c
            c[i][5] = d_alpha * g[i];           // d opacity
            c[i][6] = w * dr;
            c[i][7] = w * dg;
            c8[i] = w * db;
          }
        }
        float v[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          v[i] = warp_sum8(c[i], lane);
          c8[i] = warp_sum(c8[i]);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (!any[i]) continue;
          if ((lane & 3) == 0) red[warp][lane >> 2][j[i]] = v[i];
          if (lane == 1) red[warp][8][j[i]] = c8[i];
          wrote[word] |= 1u << bit[i];
        }
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int word = 0; word < kBwdBatch / 32; ++word)
        wrote_s[warp][word] = wrote[word];
    }
    __syncthreads();
    for (int k = threadIdx.x; k < kLive * n; k += kPixels) {
      const int f = k / n, j = k - f * n;
      float v = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        if ((wrote_s[w][j >> 5] >> (j & 31)) & 1u) v += red[w][f][j];
      }
      d_payload[f * P + it.start + it.lo + b0 + j] = v;
    }
  }
}

}  // namespace

extern "C" {

// Pairs per (tile, chunk) item: the wrapper sizes the item tables and the
// per-item scratch by it.
int composite_chunk() { return kChunk; }

// CTAs an SM holds of the chunk pass, the second walk and the backward.
int composite_occupancy(int* ctas) {
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas[0], chunk_pass_kernel,
                                                kPixels, 0);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas[1], rewalk_kernel,
                                                kPixels, 0);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas[2], composite_bwd_kernel,
                                                kPixels, 0);
  return (int)cudaGetLastError();
}

// tile_ids: [num_tiles] global tile ids of the slots, or null for the
// full grid (slot t is tile t).
int composite_fwd(const float* payload, int64_t P, const int* offsets,
                  const int* counts, const int* tile_ids, int num_tiles,
                  int ntx, float* rgb, float* t_final, float* log_t,
                  int* n_walk, int* item_start, int* item_tile, int max_items,
                  float* lk, float* saved, float stop_margin, void* stream) {
  if (num_tiles > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    const FwdOut out = {rgb, t_final, log_t, n_walk};
    plan_kernel<<<1, kPlanThreads, 0, st>>>(counts, num_tiles, max_items,
                                            item_start, item_tile);
    chunk_pass_kernel<<<max_items, kPixels, 0, st>>>(
        payload, P, offsets, counts, tile_ids, num_tiles, ntx, item_start,
        item_tile, max_items, lk, saved, out, stop_margin);
    rewalk_kernel<<<max_items, kPixels, 0, st>>>(
        payload, P, offsets, counts, tile_ids, num_tiles, ntx, item_start,
        item_tile, max_items, lk, saved, out, stop_margin);
  }
  return (int)cudaGetLastError();
}

int composite_bwd(const float* payload, int64_t P, const int* offsets,
                  const int* counts, const int* tile_ids, int num_tiles,
                  int ntx, const int* item_start, const int* item_tile,
                  int max_items, const float* saved, const float* d_rgb, const float* d_tfin,
                  const float* t_final, const float* log_t, const int* n_walk,
                  float* d_payload, void* stream) {
  if (num_tiles > 0) {
    composite_bwd_kernel<<<max_items, kPixels, 0, (cudaStream_t)stream>>>(
        payload, P, offsets, counts, tile_ids, num_tiles, ntx, item_start,
        item_tile, max_items, saved, d_rgb, d_tfin, t_final, log_t, n_walk,
        d_payload);
  }
  return (int)cudaGetLastError();
}

const char* composite_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
