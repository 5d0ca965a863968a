// 3x3 SAME stride-1 convolution on the flat padded layout, and the dx of a
// ReLU'd layer, for NVIDIA Hopper (sm_90a). Plain C interface, loaded with
// ctypes (manus_tpu_torch/ops/conv.py).
//
// Replaces the Pallas TPU kernels of manus_tpu/ops/conv_pallas.py:
// conv3x3_layout_kernel<.., false> replaces _conv_layout_kernel (the
// pallas_call of conv3x3_layout_raw, and of conv3x3_raw on an image's
// layout); conv3x3_layout_kernel<.., true> replaces _conv_dx_layout_kernel
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
// A operand zeroed where the layer's output y is not > 0 (the ReLU mask).
//
// What bounds it on an H100. A VGG16 layer at 512x512 does 2*H*W*9*ci*co
// operations on bf16 operands, 20 to 420 per byte it must move, against
// the card's ~295 (989 TFLOP/s over 3.35 TB/s): the 512x512 stage's
// layers are bound by memory, the later stages' by the tensor cores. On
// the way to either bound stands the traffic from L2 into shared memory:
// an implicit GEMM loads A once per tap, nine times in all, and the dx
// loads y beside it.
//
// Design.
//  * The product is wgmma.mma_async m64nNk16 (bf16 in, fp32 sum in
//    registers), A and B both read from shared memory through matrix
//    descriptors. A CTA computes a 128-row x BN-channel tile with two
//    consumer warpgroups, 64 rows each; BN is 16, 64, 128 or 256 (at 256
//    the producer is a whole warpgroup that hands its registers to the
//    consumers with setmaxnreg, for their 128 accumulators a thread).
//  * Two rings of stages filled by TMA, from one lane of a producer
//    warp. A K-chunk is KC = 64 channels (16 where ci is no multiple of
//    64: the 16-channel path of conv0_0) of the three taps of one dy.
//    Their A operands are the same rows shifted by one, so an A stage is
//    one 2D box of the [rows, ci] array, 136 rows from
//    r0 + (dy-1)*(W+2) - 1 on, loaded once per chunk: A crosses into
//    shared memory three times, not nine. Rows below 0 or past the end
//    arrive as zeros, so there is no bounds test and no per-element index
//    arithmetic. A B stage is one tap's [KC, BN] weights, BN/64 boxes of
//    the [9*ci, co] array. Boxes are 128 bytes wide with the 128-byte
//    swizzle (32 bytes and the 32-byte swizzle for 16 channels), the
//    form wgmma reads without bank conflicts: A K-major, B MN-major (the
//    weights are [K, N] row-major, so tnspB = 1). Tap dx reads the A stage
//    from row 64*wg + dx on: the descriptor's start address moves by whole
//    rows, and the swizzle, a function of the address, follows. Full and
//    empty mbarriers hand the stages over; a consumer frees a tap's B
//    stage (and after a chunk's last tap its A stage) after
//    wgmma.wait_group 1, while the next tap's MMAs run.
//  * The dx mask, choice (b), masking in shared memory: the A stage also
//    holds the same box of y; the consumers zero the cotangent rows in
//    place where y <= 0 (both tiles have the same swizzle, so element by
//    element), then fence.proxy.async.shared::cta (scoped: the unscoped
//    fence also waits on the epilogue's global stores and cost more than
//    the mask pass) and a barrier, then the wgmmas that read them. Once per loaded row, so a third as often as once per
//    tap; a chunk's three taps are started together and the next chunk is
//    masked while they run.
//  * A plan per layer from the host (conv_plan in ops/conv.py): KC, BN
//    and the split of K. Working tiles start at m_blk, where the pixel
//    rows start, so no tile is spent on border rows; the other row blocks
//    are zero-filled by extra CTAs of the same grid.
//  * Persistent CTAs: as many working CTAs as the card holds at once (one
//    an SM, two for BN <= 64), each walking every work_ctas-th row tile of
//    its channel tile. The rings run on across tiles, so a tile's
//    epilogue overlaps the next tile's loads, and the 2,056 tiles of the
//    512x512 stage do not each pay a CTA's start.
//  * Split-K for the small stages: CTA z of a tile sums chunks
//    [z*n, (z+1)*n) and writes its fp32 partial tile to a workspace;
//    conv3x3_splitk_reduce adds the slices in index order, then bias,
//    ReLU, the pixel mask and the one rounding to bf16. No atomics: two
//    runs give the same bits.
//  * The epilogue keeps the pixel test per row, stages the bf16 tile in
//    shared memory 64 channels at a time and stores 16 bytes a thread.
//
// Measured on an NVIDIA H100 80GB HBM3 (700 W), VGG16 layers at 512x512
// (scripts/torch_conv_tune.py): 425 to 663 TFLOP/s on the 64- to
// 512-channel forward layers of the first four stages, 296 to 625 on
// their dx. The dx sweep stays about a third over the forward's: its A
// stages are twice the size (half the ring), the mask pass adds to the
// shared-memory traffic of MMAs that already read both operands from
// there, and y crosses L2 beside g.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;             // output rows per CTA
constexpr int kARows = 136;          // rows of an A stage: kBM + 2, to 8
constexpr int kConsumerThreads = 256;  // two warpgroups, 64 rows each
constexpr int kSmemLimit = 232448;   // bytes a block can use on sm_90
constexpr int kBarrierBytes = 256;

struct Params {
  const float* bias;  // [co] or null
  bf16* y;            // [rows, co]
  float* ws;          // [split, m_tiles*128, co] fp32, split > 1 only
  int rows, co, w2, m_blk, n_valid, relu;
  int m_tiles;           // working row tiles, from m_blk on
  int work_ctas;         // CTAs along x that walk them
  int lead_blocks;       // zero-filled blocks of rows [0, m_blk)
  int chunks_per_dy;     // ci / KC
  int chunks_per_split;  // 3 * ci / KC / split
  int split;
};

// ---------------------------------------------------------------------------
// PTX: mbarriers, TMA, wgmma.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

template <int kId, int kCount>
__device__ __forceinline__ void named_barrier() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(kId), "n"(kCount) : "memory");
}

// The barrier of one consumer warpgroup (ids 2 and 3).
__device__ __forceinline__ void warpgroup_barrier(int wg) {
  if (wg == 0) {
    named_barrier<2, 128>();
  } else {
    named_barrier<3, 128>();
  }
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (all in 16-byte units), swizzle mode in bits 62-63 (1 = 128
// bytes, 3 = 32 bytes).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t mode) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (mode << 62);
}

// D[64, N] += A[64, 16] * B[16, N]: A K-major, B MN-major (tnspB = 1).
template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], uint64_t da,
                                           uint64_t db);

template <>
__device__ __forceinline__ void wgmma_bf16<16>(float (&d)[8], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float (&d)[32], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<128>(float (&d)[64], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<256>(float (&d)[128], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// ---------------------------------------------------------------------------
// One instance per (KC, BN, mask): its ring and its occupancy.

constexpr int imin(int a, int b) { return a < b ? a : b; }

template <int KC, int BN, bool kMask>
struct Cfg {
  static_assert(KC == 16 || KC == 64, "a K-chunk is 16 or 64 channels");
  static_assert(BN == 16 || BN % 64 == 0, "BN is 16 or a multiple of 64");
  // A 256-channel tile keeps 128 accumulators a thread, more than an even
  // share of the registers leaves room for: its producer is a whole
  // warpgroup that hands its registers to the consumers (setmaxnreg).
  static constexpr bool kMoveRegs = BN == 256;
  static constexpr int kThreads = kConsumerThreads + (kMoveRegs ? 128 : 32);
  // One A stage: the kARows-row window of x (and of y, for the dx) that
  // the three taps of one dy share.
  static constexpr int kATile = kARows * KC * 2;
  static constexpr int kABytes = kATile * (kMask ? 2 : 1);
  // One B stage: one tap's [KC, BN] weights, in boxes of 64 channels.
  static constexpr int kBBox = imin(BN, 64);
  static constexpr int kBBoxBytes = KC * kBBox * 2;
  static constexpr int kBBytes = KC * BN * 2;
  // bf16 staging of the output tile, kEpiCols channels at a time, in its
  // own region because the rings are already being filled for the CTA's
  // next tile (+16 bytes skews the banks of rows).
  static constexpr int kEpiCols = imin(BN, 64);
  static constexpr int kEpiPitch = kEpiCols * 2 + 16;
  static constexpr int kEpiBytes = kBM * kEpiPitch;
  // Two CTAs an SM where two A and four B stages (three for the dx,
  // whose A stages are twice the size) fit in half its shared memory and
  // the accumulators leave room in half its registers (BN <= 64), else
  // one CTA. Three A stages if they fit beside four B stages, and as
  // many B stages as fit, at most six.
  static constexpr int kHalf = 111 * 1024 - kEpiBytes;
  static constexpr int kMinBlocks =
      BN <= 64 && 2 * kABytes + (kMask ? 3 : 4) * kBBytes <= kHalf ? 2 : 1;
  static constexpr int kBudget =
      kMinBlocks == 2 ? kHalf : 224 * 1024 - kEpiBytes;
  static constexpr int kAStages = 3 * kABytes + 4 * kBBytes <= kBudget ? 3 : 2;
  static constexpr int kBStages =
      imin(6, (kBudget - kAStages * kABytes) / kBBytes);
  // The B ring first (its 128-byte-swizzled boxes need 1024-byte
  // alignment), then the A ring, then the staging.
  static constexpr int kARing = kBStages * kBBytes;
  static constexpr int kRingBytes = kARing + kAStages * kABytes;
  static constexpr int kDataBytes = kRingBytes + kEpiBytes;
  static constexpr int kSmemBytes = 1024 + kDataBytes + kBarrierBytes;
  static_assert(kBStages >= (kMask ? 3 : 2), "ring");
  static_assert(2 * (kAStages + kBStages) * 8 <= kBarrierBytes, "barriers");
  static_assert(kSmemBytes <= kSmemLimit, "shared memory");
  // Matrix descriptors. A is K-major: rows KC*2 bytes apart, 8-row groups
  // SBO apart, 32 bytes per k16 step. B is MN-major: 64-channel boxes LBO
  // apart, 8-k groups SBO apart, 16 k-rows per step.
  static constexpr uint64_t kAMode = KC == 64 ? 1 : 3;
  static constexpr uint32_t kASbo = 8 * KC * 2;
  static constexpr uint64_t kBMode = kBBox == 64 ? 1 : 3;
  static constexpr uint32_t kBSbo = 8 * kBBox * 2;
  static constexpr uint32_t kBStep = 16 * kBBox * 2;
};

__device__ __forceinline__ bool pixel_row(const Params& p, int r) {
  const int q = r - p.m_blk;
  return q >= 0 && q < p.n_valid && q % p.w2 < p.w2 - 2;
}

// Two bf16 of v, each kept where its partner in m is > 0.
__device__ __forceinline__ uint32_t relu_mask(uint32_t v, uint32_t m) {
  return v & __hgt2_mask(*reinterpret_cast<const __nv_bfloat162*>(&m),
                         __float2bfloat162_rn(0.0f));
}

template <int KC, int BN, bool kMask>
__global__ void __launch_bounds__(Cfg<KC, BN, kMask>::kThreads,
                                  Cfg<KC, BN, kMask>::kMinBlocks)
    conv3x3_layout_kernel(const __grid_constant__ CUtensorMap map_a,
                          const __grid_constant__ CUtensorMap map_m,
                          const __grid_constant__ CUtensorMap map_b,
                          const Params p) {
  using C = Cfg<KC, BN, kMask>;
  extern __shared__ unsigned char smem_raw[];
  const int tid = threadIdx.x;
  const int n0 = blockIdx.y * BN;

  // The row blocks that hold no pixel are zero-filled by the CTAs past the
  // working ones: first those of rows [0, m_blk), then those past the
  // last working tile.
  if (blockIdx.x >= p.work_ctas) {
    if (blockIdx.z != 0) return;
    const int j = blockIdx.x - p.work_ctas;
    int lo, hi;
    if (j < p.lead_blocks) {
      lo = j * kBM;
      hi = min(lo + kBM, p.m_blk);
    } else {
      lo = p.m_blk + (p.m_tiles + j - p.lead_blocks) * kBM;
      hi = min(lo + kBM, p.rows);
    }
    for (int s = tid; s < (hi - lo) * (BN / 8); s += C::kThreads) {
      const int r = lo + s / (BN / 8);
      const int n = n0 + (s % (BN / 8)) * 8;
      *reinterpret_cast<uint4*>(p.y + (int64_t)r * p.co + n) =
          make_uint4(0, 0, 0, 0);
    }
    return;
  }

  // Shared memory: the rings (1024-byte aligned, as the 128-byte swizzle
  // needs), then the full and empty barriers of the B and the A stages.
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  unsigned char* ring_ptr = smem_raw + (ring - raw);
  const uint32_t b_full = ring + C::kDataBytes;
  const uint32_t b_empty = b_full + 8 * C::kBStages;
  const uint32_t a_full = b_empty + 8 * C::kBStages;
  const uint32_t a_empty = a_full + 8 * C::kAStages;

  if (tid == 0) {
    for (int s = 0; s < C::kBStages; ++s) {
      mbar_init(b_full + 8 * s, 1);
      mbar_init(b_empty + 8 * s, kConsumerThreads / 32);
    }
    for (int s = 0; s < C::kAStages; ++s) {
      mbar_init(a_full + 8 * s, 1);
      mbar_init(a_empty + 8 * s, kConsumerThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  // A working CTA walks the row tiles blockIdx.x, blockIdx.x + work_ctas,
  // ... of its channel tile and its K slice; the rings run on from tile
  // to tile, so a tile's epilogue overlaps the loads of the next. A chunk
  // is KC channels of the three taps of one dy: chunk c has
  // dy = c / chunks_per_dy and channels (c % chunks_per_dy) * KC on.
  const int n_chunks = p.chunks_per_split;
  const int c0 = blockIdx.z * n_chunks;
  const int warp = tid / 32;
  const int lane = tid % 32;

  if (warp >= kConsumerThreads / 32) {
    // Producer: one lane keeps both rings full. i and t count the CTA's
    // chunks and taps across its tiles.
    if (C::kMoveRegs) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == kConsumerThreads / 32 && lane == 0) {
      int i = 0, t = 0;
      for (int m = blockIdx.x; m < p.m_tiles; m += p.work_ctas) {
        const int r0 = p.m_blk + m * kBM;
        int dy = c0 / p.chunks_per_dy;
        int cc = c0 - dy * p.chunks_per_dy;
        for (int c = 0; c < n_chunks; ++c, ++i) {
          const int sa = i % C::kAStages;
          mbar_wait(a_empty + 8 * sa, ((i / C::kAStages) & 1) ^ 1);
          const uint32_t full = a_full + 8 * sa;
          const uint32_t a = ring + C::kARing + sa * C::kABytes;
          mbar_expect_tx(full, C::kABytes);
          const int row = r0 + (dy - 1) * p.w2 - 1;
          tma_load_2d(a, &map_a, full, cc * KC, row);
          if (kMask) tma_load_2d(a + C::kATile, &map_m, full, cc * KC, row);
          for (int dx = 0; dx < 3; ++dx, ++t) {
            const int sb = t % C::kBStages;
            mbar_wait(b_empty + 8 * sb, ((t / C::kBStages) & 1) ^ 1);
            const uint32_t bfull = b_full + 8 * sb;
            const uint32_t b = ring + sb * C::kBBytes;
            mbar_expect_tx(bfull, C::kBBytes);
            const int k = ((3 * dy + dx) * p.chunks_per_dy + cc) * KC;
#pragma unroll
            for (int jb = 0; jb < BN / C::kBBox; ++jb) {
              tma_load_2d(b + jb * C::kBBoxBytes, &map_b, bfull,
                          n0 + jb * C::kBBox, k);
            }
          }
          if (++cc == p.chunks_per_dy) {
            cc = 0;
            ++dy;
          }
        }
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns rows [64*wg, 64*wg + 64) of the tile. Tap
  // dx of a chunk reads rows [64*wg + dx, 64*wg + dx + 64) of the A
  // stage: the descriptor's start moves by whole rows, and the swizzle,
  // a function of the shared-memory address, follows.
  if (C::kMoveRegs) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = warp / 4;
  float acc[BN / 2];

  // The ReLU mask of the dx, once per loaded row: both warpgroups zero the
  // cotangent rows of chunk i's A stage in place where y <= 0 (the two
  // tiles have the same swizzle, so element by element); then the
  // generic-proxy writes are fenced for the async-proxy reads by wgmma.
  auto mask_stage = [&](int i) {
    const int sa = i % C::kAStages;
    mbar_wait(a_full + 8 * sa, (i / C::kAStages) & 1);
    uint4* a = reinterpret_cast<uint4*>(ring_ptr + C::kARing +
                                        sa * C::kABytes);
    const uint4* m = reinterpret_cast<const uint4*>(
        ring_ptr + C::kARing + sa * C::kABytes + C::kATile);
#pragma unroll
    for (int e = tid; e < (kBM + 2) * KC * 2 / 16; e += kConsumerThreads) {
      uint4 v = a[e];
      const uint4 y = m[e];
      v.x = relu_mask(v.x, y.x);
      v.y = relu_mask(v.y, y.y);
      v.z = relu_mask(v.z, y.z);
      v.w = relu_mask(v.w, y.w);
      a[e] = v;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    named_barrier<1, kConsumerThreads>();
  };
  // The MMAs of tap dx of chunk i, B from stage t % kBStages.
  auto start_tap = [&](int i, int dx, int t) {
    const int sb = t % C::kBStages;
    mbar_wait(b_full + 8 * sb, (t / C::kBStages) & 1);
    const uint64_t da = smem_desc(
        ring + C::kARing + (i % C::kAStages) * C::kABytes +
            (64 * wg + dx) * KC * 2,
        16, C::kASbo, C::kAMode);
    const uint64_t db = smem_desc(ring + sb * C::kBBytes, C::kBBoxBytes,
                                  C::kBSbo, C::kBMode);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < KC / 16; ++k) {
      wgmma_bf16<BN>(acc, da + k * (32 >> 4), db + k * (C::kBStep >> 4));
    }
    wgmma_commit();
  };

  // Thread's accumulators: rows row and row + 8 of the tile, channels
  // 8*j + 2*(lane % 4) + {0, 1} for j < BN / 8.
  const int row = wg * 64 + (warp % 4) * 16 + lane / 4;
  const int col = 2 * (lane % 4);
  unsigned char* staging = ring_ptr + C::kRingBytes;

  int i = 0, t = 0;
  if (kMask) mask_stage(0);
  for (int m = blockIdx.x; m < p.m_tiles; m += p.work_ctas) {
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) acc[e] = 0.0f;
    if (kMask) {
      // A chunk's three taps are started together, and the next chunk (of
      // this tile or the next) is masked while they run; then the chunk's
      // stages are handed back.
      for (int c = 0; c < n_chunks; ++c, ++i) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx, ++t) start_tap(i, dx, t);
        if (c + 1 < n_chunks || m + p.work_ctas < p.m_tiles) {
          mask_stage(i + 1);
        }
        wgmma_wait<0>();
        if (lane == 0) {
#pragma unroll
          for (int d = 1; d <= 3; ++d) {
            mbar_arrive(b_empty + 8 * ((t - d) % C::kBStages));
          }
          mbar_arrive(a_empty + 8 * (i % C::kAStages));
        }
      }
    } else {
      for (int c = 0; c < n_chunks; ++c, ++i) {
        mbar_wait(a_full + 8 * (i % C::kAStages), (i / C::kAStages) & 1);
#pragma unroll
        for (int dx = 0; dx < 3; ++dx, ++t) {
          start_tap(i, dx, t);
          if (c > 0 || dx > 0) {
            // The tap before is done: hand its B stage back, and with a
            // chunk's last tap its A stage.
            wgmma_wait<1>();
            if (lane == 0) {
              mbar_arrive(b_empty + 8 * ((t - 1) % C::kBStages));
              if (dx == 0) {
                mbar_arrive(a_empty + 8 * ((i - 1) % C::kAStages));
              }
            }
          }
        }
      }
      wgmma_wait<0>();
      if (lane == 0) {
        mbar_arrive(b_empty + 8 * ((t - 1) % C::kBStages));
        mbar_arrive(a_empty + 8 * ((i - 1) % C::kAStages));
      }
    }
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) {
      asm volatile("" : "+f"(acc[e])::"memory");
    }

    const int r0 = p.m_blk + m * kBM;
    if (p.split > 1) {
      float* ws = p.ws + ((int64_t)blockIdx.z * p.m_tiles * kBM + m * kBM +
                          row) * p.co + n0 + col;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        *reinterpret_cast<float2*>(ws + 8 * j) =
            make_float2(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<float2*>(ws + (int64_t)8 * p.co + 8 * j) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
      }
      continue;
    }

    // Bias, ReLU, the pixel mask (per row) and the rounding to bf16, then
    // through the staging area to 16-byte stores, kEpiCols channels at a
    // time.
    const bool keep0 = pixel_row(p, r0 + row);
    const bool keep1 = pixel_row(p, r0 + row + 8);
    unsigned char* st = staging + row * C::kEpiPitch + col * 2;
#pragma unroll
    for (int q = 0; q < BN / C::kEpiCols; ++q) {
      warpgroup_barrier(wg);  // the reads of the pass before are done
#pragma unroll
      for (int jj = 0; jj < C::kEpiCols / 8; ++jj) {
        const int j = q * (C::kEpiCols / 8) + jj;
        float2 b = make_float2(0.0f, 0.0f);
        if (p.bias != nullptr) {
          b = *reinterpret_cast<const float2*>(p.bias + n0 + 8 * j + col);
        }
        float v0 = b.x + acc[4 * j], v1 = b.y + acc[4 * j + 1];
        float v2 = b.x + acc[4 * j + 2], v3 = b.y + acc[4 * j + 3];
        if (p.relu) {
          v0 = fmaxf(v0, 0.0f);
          v1 = fmaxf(v1, 0.0f);
          v2 = fmaxf(v2, 0.0f);
          v3 = fmaxf(v3, 0.0f);
        }
        *reinterpret_cast<__nv_bfloat162*>(st + 16 * jj) =
            __floats2bfloat162_rn(keep0 ? v0 : 0.0f, keep0 ? v1 : 0.0f);
        *reinterpret_cast<__nv_bfloat162*>(st + 8 * C::kEpiPitch + 16 * jj) =
            __floats2bfloat162_rn(keep1 ? v2 : 0.0f, keep1 ? v3 : 0.0f);
      }
      warpgroup_barrier(wg);
      for (int e = tid % 128; e < 64 * (C::kEpiCols / 8); e += 128) {
        const int mr = wg * 64 + e / (C::kEpiCols / 8);
        const int seg = e % (C::kEpiCols / 8);
        const int r = r0 + mr;
        if (r < p.rows) {
          *reinterpret_cast<uint4*>(p.y + (int64_t)r * p.co + n0 +
                                    q * C::kEpiCols + seg * 8) =
              *reinterpret_cast<const uint4*>(staging + mr * C::kEpiPitch +
                                              seg * 16);
        }
      }
    }
  }
}

// The fixed-order sum of the split-K slices, then the conv's epilogue.
// One thread per working row and 4 channels.
__global__ void __launch_bounds__(256)
    conv3x3_splitk_reduce(const Params p) {
  const int quads = p.co / 4;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t work_rows = (int64_t)p.m_tiles * kBM;
  if (idx >= work_rows * quads) return;
  const int row = (int)(idx / quads);
  const int n = (int)(idx % quads) * 4;
  const int r = p.m_blk + row;
  if (r >= p.rows) return;
  const float* src = p.ws + (int64_t)row * p.co + n;
  float4 v = *reinterpret_cast<const float4*>(src);
  for (int z = 1; z < p.split; ++z) {
    const float4 t =
        *reinterpret_cast<const float4*>(src + z * work_rows * p.co);
    v.x += t.x;
    v.y += t.y;
    v.z += t.z;
    v.w += t.w;
  }
  if (p.bias != nullptr) {
    const float4 b = *reinterpret_cast<const float4*>(p.bias + n);
    v.x = b.x + v.x;
    v.y = b.y + v.y;
    v.z = b.z + v.z;
    v.w = b.w + v.w;
  }
  if (p.relu) {
    v.x = fmaxf(v.x, 0.0f);
    v.y = fmaxf(v.y, 0.0f);
    v.z = fmaxf(v.z, 0.0f);
    v.w = fmaxf(v.w, 0.0f);
  }
  if (!pixel_row(p, r)) v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  __nv_bfloat162 out[2] = {__floats2bfloat162_rn(v.x, v.y),
                           __floats2bfloat162_rn(v.z, v.w)};
  *reinterpret_cast<uint2*>(p.y + (int64_t)r * p.co + n) =
      *reinterpret_cast<const uint2*>(out);
}

// ---------------------------------------------------------------------------
// Host side: tensor maps and the launch.

constexpr int kErrNoEncoder = -1;
constexpr int kErrTensorMap = -2;

using EncodeTiledFn = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the libcuda the process has loaded (the
// build links no stub of it).
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    return lib == nullptr ? nullptr
                          : reinterpret_cast<EncodeTiledFn>(
                                dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// A map of a row-major [n_rows, n_cols] bf16 array with a box of
// box_rows x box_cols; the swizzle is the box's width in bytes (128 or 32).
bool make_map(CUtensorMap* map, const void* base, int n_rows, int n_cols,
              int box_rows, int box_cols) {
  const cuuint64_t dims[2] = {(cuuint64_t)n_cols, (cuuint64_t)n_rows};
  const cuuint64_t strides[1] = {(cuuint64_t)n_cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUtensorMapSwizzle swz = box_cols * 2 == 128
                                     ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Launches one instance. The working CTAs are as many as the card holds
// at once (or as there are tiles); each walks its share of the row tiles.
// The zero-filling CTAs follow them along x.
template <int KC, int BN, bool kMask>
int launch(const CUtensorMap& ma, const CUtensorMap& mm, const CUtensorMap& mb,
           Params p, int zero_blocks, int n_tiles, cudaStream_t stream) {
  using C = Cfg<KC, BN, kMask>;
  static int resident = 0;  // CTAs of this instance the card holds at once
  if (resident == 0) {
    cudaError_t e = cudaFuncSetAttribute(
        conv3x3_layout_kernel<KC, BN, kMask>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
    int device = 0, sms = 0, per_sm = 0;
    if (e == cudaSuccess) e = cudaGetDevice(&device);
    if (e == cudaSuccess) {
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    }
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, conv3x3_layout_kernel<KC, BN, kMask>, C::kThreads,
          C::kSmemBytes);
    }
    if (e != cudaSuccess) return (int)e;
    if (sms * per_sm <= 0) return (int)cudaErrorLaunchOutOfResources;
    resident = sms * per_sm;
  }
  const int share = resident / (n_tiles * p.split);
  p.work_ctas = share < 1 ? 1 : (share < p.m_tiles ? share : p.m_tiles);
  const dim3 grid(p.work_ctas + zero_blocks, n_tiles, p.split);
  conv3x3_layout_kernel<KC, BN, kMask>
      <<<grid, C::kThreads, C::kSmemBytes, stream>>>(ma, mm, mb, p);
  return (int)cudaGetLastError();
}

template <int KC, int BN>
int launch_form(bool mask, const CUtensorMap& ma, const CUtensorMap& mm,
                const CUtensorMap& mb, const Params& p, int zero_blocks,
                int n_tiles, cudaStream_t stream) {
  return mask ? launch<KC, BN, true>(ma, mm, mb, p, zero_blocks, n_tiles,
                                     stream)
              : launch<KC, BN, false>(ma, ma, mb, p, zero_blocks, n_tiles,
                                      stream);
}

}  // namespace

extern "C" {

// y = conv(x) on the layout; with mask non-null, the dx form (A zeroed
// where mask <= 0). The plan (conv_plan in ops/conv.py): kc channels per
// K-chunk (64, or 16 where ci is no multiple of 64), bn output channels
// per tile (16, 64, 128 or 256, dividing co; at most 64 with kc = 16),
// and split, which divides the
// 3*ci/kc chunks; split > 1 needs ws, [split, ceil(n_valid/128)*128, co]
// fp32. Every pointer is 16-byte aligned. width is the image width W;
// m_blk and n_valid = H*(W+2) as in StageLayout.
int conv3x3_layout(const void* x, const void* mask, const void* w,
                   const float* bias, void* y, float* ws, int rows, int ci,
                   int co, int width, int m_blk, int n_valid, int relu, int kc,
                   int bn, int split, void* stream) {
  if (rows <= 0 || n_valid <= 0 || m_blk < 0 || (kc != 16 && kc != 64) ||
      ci <= 0 || ci % kc != 0 ||
      (bn != 16 && bn != 64 && bn != 128 && bn != 256) ||
      (kc == 16 && bn > 64) || co <= 0 ||
      co % bn != 0 || split < 1 || (3 * ci / kc) % split != 0 ||
      (split > 1 && ws == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (encode_tiled() == nullptr) return kErrNoEncoder;
  CUtensorMap ma, mm, mb;
  if (!make_map(&ma, x, rows, ci, kARows, kc) ||
      (mask != nullptr && !make_map(&mm, mask, rows, ci, kARows, kc)) ||
      !make_map(&mb, w, 9 * ci, co, kc, bn < 64 ? bn : 64)) {
    return kErrTensorMap;
  }
  Params p;
  p.bias = bias;
  p.y = static_cast<bf16*>(y);
  p.ws = ws;
  p.rows = rows;
  p.co = co;
  p.w2 = width + 2;
  p.m_blk = m_blk;
  p.n_valid = n_valid;
  p.relu = relu;
  p.m_tiles = (n_valid + kBM - 1) / kBM;
  p.work_ctas = p.m_tiles;
  p.lead_blocks = (m_blk + kBM - 1) / kBM;
  p.chunks_per_dy = ci / kc;
  p.chunks_per_split = 3 * ci / kc / split;
  p.split = split;
  const int tail = rows - (m_blk + p.m_tiles * kBM);
  const int tail_blocks = tail > 0 ? (tail + kBM - 1) / kBM : 0;
  const int zero_blocks = p.lead_blocks + tail_blocks;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool dx = mask != nullptr;
  int rc = (int)cudaErrorInvalidValue;
#define CONV_FORM(KC_, BN_) \
  if (kc == KC_ && bn == BN_) \
    rc = launch_form<KC_, BN_>(dx, ma, mm, mb, p, zero_blocks, co / bn, st)
  CONV_FORM(64, 256);
  CONV_FORM(64, 128);
  CONV_FORM(64, 64);
  CONV_FORM(64, 16);
  CONV_FORM(16, 64);
  CONV_FORM(16, 16);
#undef CONV_FORM
  if (rc != 0 || split == 1) return rc;
  const int64_t quads = (int64_t)p.m_tiles * kBM * (co / 4);
  conv3x3_splitk_reduce<<<(unsigned)((quads + 255) / 256), 256, 0, st>>>(p);
  return (int)cudaGetLastError();
}

const char* conv3x3_error_string(int code) {
  if (code == kErrNoEncoder) {
    return "cuTensorMapEncodeTiled not found in libcuda.so.1";
  }
  if (code == kErrTensorMap) return "cuTensorMapEncodeTiled failed";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
