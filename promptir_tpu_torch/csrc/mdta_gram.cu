// The wide route's Gram stage in bf16 on Hopper: stats[b, h, :d*d] =
// q_h^T k_h summed over all pixels, q and k pixel-major (B, P, C) bf16, head
// h's d columns from h * d, fp32 sums. One launch, deterministic.
//
// Replaces the Gram that promptir_tpu/ops/pallas/mdta.py:317 mdta_stats
// accumulates in its body over its sequential grid (:102-116), on the wide
// route, where mdta_stats' pass writes q and k out (mdta_stats.cu); the
// float32 route keeps mdta_stats.cu:gram_kernel and its slot sum.
//
// Bound on the H100: q and k read once (2 B P C bytes each) and d^2 fp32
// written a head; 2 d^2 P operations a head. At every served shape the bytes
// bound it (promptxrestormerir's 15 launches a B4 256x256 forward: 201 MB,
// 60 us at 3.35 TB/s, against 25 GFLOP, 26 us at 989 TFLOP/s).
//
// Design, against the five costs of the mma.sync kernel it replaces:
//  - q and k read about once: a cluster of `slices` blocks owns an output
//    tile of up to 192 rows (three warpgroups of 64) by tn <= 192 columns
//    (ops/cuda/mdta.py:gram_plan: the whole head up to d = 192, 2 x 2 tiles
//    at 320 and 384, 4 x 4 at 704), not 64 x 64;
//  - ragged widths cost no padding in channels: q and k are read through 4-D
//    tensor maps (d, heads, P, B), so a box's channels past d are zeros
//    filled by the TMA unit (not read) and a tile of 80, 160 or 176 columns
//    runs wgmma N = 80, 160, 176; rows come in 64s (wgmma's M), and no
//    box is loaded for a warpgroup whose rows all lie past d (it multiplies
//    stale boxes, its sums never stored: a wgmma behind a branch, or in
//    flight across one, is serialized by ptxas, warning C7518);
//  - long pixel spans: a block's slice is P / slices pixels, at least four
//    64-pixel chunks, fed through a 4-stage ring (48 KB a stage); slices
//    (1 to 16 a cluster) are as many as keep one cluster an item within
//    what the card holds at once; persistent clusters walk the (image,
//    head, tile) items past that;
//  - wgmma from shared memory: thread 0 starts TMA loads of (64 pixels x 64
//    channels) boxes, 128-byte swizzled, into an mbarrier ring, three
//    chunks ahead; each warpgroup runs one wgmma.m64nNk16 a 16-pixel step
//    with both operands MN-major (the 16-bit transpose bits: a pixel-major
//    chunk has q^T's M and k's N contiguous), its fp32 sums in registers
//    over the slice, three chunks landing while one is multiplied;
//  - no second launch: after a cluster barrier each block stores the rows
//    of its partial tile that block q owns into slot `rank` of block q's
//    shared memory (distributed shared memory), and after a second barrier
//    block q sums its rows over slots 0, 1, ..., slices - 1 in that order
//    and writes them. Fixed order, no atomics: two launches give the same
//    bits. A one-block cluster writes its registers straight out.
// Measured on the card (PERF.md, section 6): a block multiplies a 48 KB chunk
// of a 192 x 192 tile in ~0.9 us (its wgmma at about 70% of the SM's
// rate), the cluster's reduction takes ~5 us, and cuBLAS's batched product
// still beats the kernel at the one-head widths of 192-704 channels.
// The block launches 384 threads (three warpgroups), where common.cuh's
// kThreads = 256 is the rule elsewhere; the host encodes the tensor maps
// through cudaGetDriverEntryPoint (no -lcuda) and caches them by address.
#include <cuda.h>

#include <mutex>

#include "common.cuh"

namespace {
using namespace pk;

constexpr int kGWG = 3;                        // consumer warpgroups
constexpr int kGRows = 64 * kGWG;              // output rows of a tile
constexpr int kGMaxCols = 192;                 // output columns of a tile, at most
constexpr int kGThreads = 128 * kGWG;          // thread 0 also keeps the ring full
constexpr int kGChunk = 64;                    // pixels a ring stage
constexpr int kGStages = 4;                    // stages of the ring
constexpr int kGMaxSlices = 16;                // blocks of a cluster (16: non-portable)
constexpr int kGBox = kGChunk * 128;           // bytes of a 64-channel box
constexpr int kGStage = 2 * kGWG * kGBox;      // q boxes, then k boxes: 48 KB
constexpr int kGRing = kGStages * kGStage;
// the ring, 1024 bytes of slack to align it (128-byte swizzle), and a full
// and an empty barrier a stage (ops/cuda/mdta.py:GRAM_SMEM)
constexpr int kGSmem = kGRing + 1024 + 2 * kGStages * 8;
// the ranks' partial tiles, rows of kGMaxCols + 8 floats, reuse the ring
static_assert((kGRows + kGMaxSlices - 1) * (kGMaxCols + 8) * 4 <= kGRing, "ring");

struct GramTcArgs {
  float* stats;  // (B, heads, ld): the Gram fills [:d*d] of each row
  int d, heads, P, tiles_m, tiles_n, items, slices, span, ld;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// One (64 channels, 1 head, 64 pixels, 1 image) box of a 4-D tensor map into
// shared memory, its bytes counted on `bar`.
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                        int c, int h, int p, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(h), "r"(p), "r"(b)
      : "memory");
}

// wgmma's shared-memory descriptor of a 128-byte-swizzled MN-major operand
// at addr: the leading byte offset is the stride between its 64-wide MN
// atoms (the 64-channel boxes, kGBox), the stride byte offset between its
// 8-pixel k groups (1024 bytes), both in 16-byte units.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(kGBox >> 4) << 16 |
         (uint64_t)(1024 >> 4) << 32 | (uint64_t)1 << 62;
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

// D (64 x N fp32, N / 2 registers a thread) += A^T B over 16 pixels, A and B
// MN-major bf16 in shared memory (both transpose bits set).
template <int N>
__device__ __forceinline__ void wgmma_tt(float* d, uint64_t a, uint64_t b);

template <>
__device__ __forceinline__ void wgmma_tt<16>(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tt<32>(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tt<48>(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23}, "
      "%24, %25, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tt<64>(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tt<80>(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "%40, %41, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tt<96>(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "%48, %49, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tt<112>(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %58, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
      "%47, %48, %49, %50, %51, %52, %53, %54, %55}, "
      "%56, %57, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tt<128>(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
      "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, "
      "%64, %65, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tt<144>(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %74, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
      "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71}, "
      "%72, %73, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tt<160>(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
      "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, "
      "%77, %78, %79}, "
      "%80, %81, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tt<176>(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %90, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n176k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
      "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, "
      "%77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87}, "
      "%88, %89, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tt<192>(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
      "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, "
      "%77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, "
      "%92, %93, %94, %95}, "
      "%96, %97, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Store (x, y) at shared address addr of the cluster's block `rank`.
__device__ __forceinline__ void store_rank(uint32_t addr, uint32_t rank, float x, float y) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(addr), "r"(rank));
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(remote), "f"(x), "f"(y)
               : "memory");
}

// One block: rank r of its cluster takes pixels [r span, (r + 1) span) of
// each item (image-head, row tile, column tile) that its cluster walks
// (items c, c + clusters, ...; ops/cuda/mdta.py:gram_items lists the same).
// Warpgroup w owns rows i0 + 64 w .. + 63 of the tile; thread 0 also starts
// the copies, kGStages - 1 chunks ahead of the chunk being multiplied.
template <int TN>
__global__ void __launch_bounds__(kGThreads, 1)
    gram_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap, GramTcArgs a) {
  constexpr int NB = (TN + 63) / 64;  // k boxes a chunk
  extern __shared__ uint8_t gsm[];
  const uint32_t base = smem_u32(gsm);
  uint8_t* ring = gsm + ((base + 1023) / 1024 * 1024 - base);
  const uint32_t ring_s = smem_u32(ring);
  const uint32_t full = ring_s + kGRing, empty = full + kGStages * 8;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, wg = warp >> 2;
  const int rank = static_cast<int>(cluster_rank());
  const int cluster = blockIdx.x / a.slices, clusters = gridDim.x / a.slices;
  if (tid == 0) {
    for (int s = 0; s < kGStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kGThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&qmap)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&kmap)) : "memory");
  }
  __syncthreads();
  const int p0 = rank * a.span, p1 = min(a.P, p0 + a.span);
  const int chunks = (p1 - p0 + kGChunk - 1) / kGChunk;
  const int per = a.tiles_m * a.tiles_n, rld = TN + 8;  // rld: a slot row's floats
  const float* red = reinterpret_cast<const float*>(ring);  // the slots
  int g = 0;  // chunks through the ring before this item's
  for (int item = cluster; item < a.items; item += clusters) {
    const int bh = item / per, t = item - bh * per, b = bh / a.heads, h = bh - b * a.heads;
    const int i0 = (t / a.tiles_n) * kGRows, j0 = (t % a.tiles_n) * TN;
    const int qboxes = min(kGWG, (a.d - i0 + 63) / 64);  // warpgroups with rows
    const bool active = wg < qboxes;
    // chunk c of the item through stage (g + c) % kGStages: wait until its
    // stage is free, then copy its q boxes and k boxes
    const auto produce = [&](int c) {
      const int n = g + c, s = n % kGStages, px = p0 + c * kGChunk;
      const uint32_t st = ring_s + s * kGStage;
      mbar_wait(empty + 8 * s, ((n / kGStages) & 1) ^ 1);
      mbar_expect_tx(full + 8 * s, (qboxes + NB) * kGBox);
      for (int w = 0; w < qboxes; ++w)
        tma_box(st + w * kGBox, &qmap, full + 8 * s, i0 + 64 * w, h, px, b);
      for (int j = 0; j < NB; ++j)
        tma_box(st + (kGWG + j) * kGBox, &kmap, full + 8 * s, j0 + 64 * j, h, px, b);
    };
    if (tid == 0)
      for (int c = 0; c < min(chunks, kGStages); ++c) produce(c);
    __syncwarp();  // warp 0 whole again before its warpgroup's wgmma
    float acc[TN / 2];
#pragma unroll
    for (int i = 0; i < TN / 2; ++i) acc[i] = 0.f;
    // every warpgroup multiplies, those whose rows lie past d on stale
    // boxes (their sums are never stored): a wgmma behind a branch, or in
    // flight across the producer's branch, is serialized by ptxas (C7518)
    for (int c = 0; c < chunks; ++c) {
      const int n = g + c, s = n % kGStages;
      if (c > 0) {  // chunk c - 1's products done: free its stage, refill it
        wgmma_wait<0>();
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * ((n - 1) % kGStages));
        if (tid == 0 && c + kGStages - 1 < chunks) produce(c + kGStages - 1);
        __syncwarp();
      }
      mbar_wait(full + 8 * s, (n / kGStages) & 1);
      const uint32_t st = ring_s + s * kGStage;
      wgmma_fence();
#pragma unroll
      for (int k16 = 0; k16 < kGChunk / 16; ++k16)
        wgmma_tt<TN>(acc, gmma_desc(st + wg * kGBox + k16 * 2048),
                     gmma_desc(st + kGWG * kGBox + k16 * 2048));
      wgmma_commit();
    }
    wgmma_wait<0>();
    __syncwarp();
    if (chunks > 0 && lane == 0) mbar_arrive(empty + 8 * ((g + chunks - 1) % kGStages));
    g += chunks;
    // the item's output: register i of lane l in warp w of a warpgroup
    // holds row 16 w + l / 4 + 8 (i / 2 % 2) and columns 8 (i / 4) +
    // 2 (l % 4) + {0, 1} of the group's 64 x TN (wgmma's D layout)
    const int rows = min(kGRows, a.d - i0), cols = min(TN, a.d - j0);
    const int r0 = 64 * wg + 16 * (warp & 3) + (lane >> 2), c0 = 2 * (lane & 3);
    float* out = a.stats + (long long)bh * a.ld + (long long)i0 * a.d + j0;
    if (a.slices == 1) {  // one block a tile: straight from the registers
      if (active) {
#pragma unroll
        for (int i = 0; i < TN / 2; i += 2) {
          const int r = r0 + 8 * ((i >> 1) & 1), col = c0 + 8 * (i >> 2);
          if (r < rows && col < cols)
            *reinterpret_cast<float2*>(out + (long long)r * a.d + col) =
                make_float2(acc[i], acc[i + 1]);
        }
      }
      continue;
    }
    // rank q owns rows [q rpr, (q + 1) rpr) of the tile; each rank stores its
    // partial of them into slot `rank` of the owner's ring (every rank is
    // done with its ring first), then the owner sums slots 0, 1, ...,
    // slices - 1 in that order and writes them
    const int rpr = (rows + a.slices - 1) / a.slices;
    cluster_sync();
    if (active) {
#pragma unroll
      for (int i = 0; i < TN / 2; i += 2) {
        const int r = r0 + 8 * ((i >> 1) & 1), col = c0 + 8 * (i >> 2);
        if (r < rows && col < cols) {
          const int owner = r / rpr;
          store_rank(ring_s + ((rank * rpr + r - owner * rpr) * rld + col) * 4, owner, acc[i],
                     acc[i + 1]);
        }
      }
    }
    cluster_sync();  // every slot of every owner is written
    const int own0 = rank * rpr, own1 = min(rows, own0 + rpr), c4 = cols / 4;
    for (int e = tid; e < (own1 - own0) * c4; e += kGThreads) {
      const int lr = e / c4, col = (e - lr * c4) * 4;
      float4 v[kGMaxSlices];
#pragma unroll
      for (int q = 0; q < kGMaxSlices; ++q)
        if (q < a.slices) v[q] = *reinterpret_cast<const float4*>(red + (q * rpr + lr) * rld + col);
      float4 sum = v[0];
#pragma unroll
      for (int q = 1; q < kGMaxSlices; ++q)
        if (q < a.slices) {
          sum.x += v[q].x;
          sum.y += v[q].y;
          sum.z += v[q].z;
          sum.w += v[q].w;
        }
      *reinterpret_cast<float4*>(out + (long long)(own0 + lr) * a.d + col) = sum;
    }
    // the ring's generic reads before the next item's copies into it
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
  }
}

// cuTensorMapEncodeTiled through the runtime's entry-point query, so the
// library needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                     &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The (d, heads, P, B) view of a (B, P, C) bf16 tensor, boxes of 64
// channels by kGChunk pixels, 128-byte swizzle, zeros outside.
bool head_map(CUtensorMap* map, const void* t, int B, int P, int C, int heads) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const int d = C / heads;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads, (cuuint64_t)P, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 2, (cuuint64_t)C * 2, (cuuint64_t)P * C * 2};
  const cuuint32_t box[4] = {64, 1, kGChunk, 1}, step[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(t), dims, strides, box,
             step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_NONE,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// head_map through a small cache keyed by the tensor's address and shape:
// the caching allocator hands the wide route's q and k the same addresses
// forward after forward, and an encode costs host time at every launch.
bool cached_head_map(CUtensorMap* map, const void* t, int B, int P, int C, int heads) {
  struct Entry {
    const void* t;
    int B, P, C, heads;
    CUtensorMap map;
  };
  static Entry cache[16];
  static int next = 0;
  static std::mutex lock;
  std::lock_guard<std::mutex> hold(lock);
  for (const Entry& e : cache)
    if (e.t == t && e.B == B && e.P == P && e.C == C && e.heads == heads) {
      *map = e.map;
      return true;
    }
  if (!head_map(map, t, B, P, C, heads)) return false;
  cache[next] = Entry{t, B, P, C, heads, *map};
  next = (next + 1) % 16;
  return true;
}

// The launch attributes of a cluster of `slices` blocks (16 is past the
// portable 8: the kernel opts in once).
template <int TN>
cudaError_t cluster_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int slices) {
  static bool opted[64] = {};
  int dev = 0;
  cudaError_t err = allow_smem_once<gram_tc_kernel<TN>>();
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess && slices > 8 && !(dev < 64 && opted[dev])) {
    err = cudaFuncSetAttribute(gram_tc_kernel<TN>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err == cudaSuccess && dev < 64) opted[dev] = true;
  }
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = slices;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->blockDim = dim3(kGThreads);
  cfg->dynamicSmemBytes = kGSmem;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return err;
}

template <int TN>
cudaError_t launch_gram(const CUtensorMap& qm, const CUtensorMap& km, const GramTcArgs& a,
                        int clusters, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cudaError_t err = cluster_config<TN>(&cfg, attr, a.slices);
  if (err != cudaSuccess) return err;
  cfg.gridDim = dim3(clusters * a.slices);
  cfg.stream = stream;
  err = cudaLaunchKernelEx(&cfg, gram_tc_kernel<TN>, qm, km, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// The bf16 Gram of the wide route into stats[b, h, :d*d], stats (B, heads,
// ld) fp32, by ops/cuda/mdta.py:gram_plan, whose launch arguments come as
// one array (ops/cuda/mdta.py:gram_launch_args; a ctypes call costs host
// time by the argument): plan = [ld, B, P, C, heads, tn, slices, span,
// clusters, smem], tiles of 192 rows by tn columns, `slices` blocks a
// cluster each taking `span` pixels, `clusters` clusters; smem is the
// plan's shared-memory bytes, checked against the kernel's. Returns the
// CUDA error code of the launch (0 on success).
extern "C" int mdta_gram_tc_launch(const void* q, const void* k, float* stats, const int* plan,
                                   void* stream) {
  const int ld = plan[0], B = plan[1], P = plan[2], C = plan[3], heads = plan[4], tn = plan[5];
  const int slices = plan[6], span = plan[7], clusters = plan[8], smem = plan[9];
  const int d = C / heads;
  if (smem != kGSmem || C % heads || d % 8 || ld < d * d || tn % 16 || tn < 16 ||
      tn > kGMaxCols || slices < 1 || slices > kGMaxSlices || span % kGChunk ||
      span < kGChunk || (long long)(slices - 1) * span >= P || (long long)slices * span < P ||
      clusters < 1)
    return cudaErrorInvalidValue;
  CUtensorMap qm, km;
  if (!cached_head_map(&qm, q, B, P, C, heads) || !cached_head_map(&km, k, B, P, C, heads))
    return cudaErrorInvalidValue;
  GramTcArgs a;
  a.stats = stats;
  a.d = d;
  a.heads = heads;
  a.P = P;
  a.tiles_m = (d + kGRows - 1) / kGRows;
  a.tiles_n = (d + tn - 1) / tn;
  a.items = B * heads * a.tiles_m * a.tiles_n;
  a.slices = slices;
  a.span = span;
  a.ld = ld;
  if (clusters > a.items) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tn) {
    case 16: return launch_gram<16>(qm, km, a, clusters, s);
    case 32: return launch_gram<32>(qm, km, a, clusters, s);
    case 48: return launch_gram<48>(qm, km, a, clusters, s);
    case 64: return launch_gram<64>(qm, km, a, clusters, s);
    case 80: return launch_gram<80>(qm, km, a, clusters, s);
    case 96: return launch_gram<96>(qm, km, a, clusters, s);
    case 112: return launch_gram<112>(qm, km, a, clusters, s);
    case 128: return launch_gram<128>(qm, km, a, clusters, s);
    case 144: return launch_gram<144>(qm, km, a, clusters, s);
    case 160: return launch_gram<160>(qm, km, a, clusters, s);
    case 176: return launch_gram<176>(qm, km, a, clusters, s);
    default: return launch_gram<192>(qm, km, a, clusters, s);
  }
}

// Clusters of `slices` Gram blocks that the current card holds at once
// (cudaOccupancyMaxActiveClusters; ops/cuda/mdta.py:GRAM_CLUSTERS), or -1
// on an error.
extern "C" int mdta_gram_tc_max_clusters(int slices) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  int n = -1;
  cudaError_t err = cluster_config<192>(&cfg, attr, slices);
  cfg.gridDim = dim3(slices);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&n, gram_tc_kernel<192>, &cfg);
  return err == cudaSuccess ? n : -1;
}
