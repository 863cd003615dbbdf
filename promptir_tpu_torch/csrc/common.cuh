// Shared device helpers for the PromptIR Hopper kernels.
//
// Every kernel here keeps its arithmetic in fp32 and reads or writes its
// activations in T, which is float or __nv_bfloat16. Two matrix routines:
//   gemm_tile  the float32 route's plain shared-memory SIMT tile (64 output
//              channels by 16 * MP pixels, a 32-deep reduction chunk, a
//              4-by-MP micro-tile per thread). fp32 on the tensor cores would
//              be TF32, which misses the float32 goldens' 2e-4 gate;
//   tc_gemm    the bf16 route's product on the tensor cores: bf16 operands in
//              shared memory, fp32 accumulators in registers
//              (mma.sync.m16n8k16 fed by ldmatrix), the weights streamed in
//              32-deep chunks through a cp.async double buffer.
// The kernels dispatch by dtype, never by fit: a float32 launch takes
// gemm_tile, a bf16 launch tc_gemm.
//
// Why mma.sync and not wgmma: one instruction form serves every product of
// the bf16 route, from the 32-row pixel tiles of gdfn_out at C = 704 to the
// d x d Gram, each warp owning its own 16-row slices, so products of 32 to
// 256 rows split over the block's 8 warps without padding to wgmma's
// 64-row warpgroup tile; and the W2 products of block_tail and tail_stats
// must sum every output in the same instruction sequence (x3 bit-exact
// between them, gdfn.cuh:gdfn_w2). The one wgmma kernel is the wide route's
// bf16 Gram (mdta_gram.cu): a d x d output of up to 192 x 192 over long
// pixel spans fills whole 64-row warpgroup tiles, its operands come by TMA,
// and it launches 384 threads (three warpgroups), not kThreads.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pk {

constexpr int kThreads = 256;  // every kernel launches 256 threads a block
constexpr int kSmSmem = 233472;      // bytes of shared memory of one H100 SM
constexpr int kBlockReserved = 1024;  // bytes the runtime keeps per resident block
constexpr int kTileN = 64;     // output channels of one gemm_tile pass
constexpr int kTileK = 32;     // reduction depth staged per step
constexpr int kLd = 65;        // padded row stride of the staging tiles

// dtype codes passed by the Python wrappers
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <class T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Round an fp32 value through T: the identity for float.
template <class T> __device__ __forceinline__ float round_t(float v) { return to_f(from_f<T>(v)); }

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

// Block-wide product tile. For the 16 * MP pixels p and kTileN channels n of
// one pass, thread (pg, ng) = (tid / 16, tid % 16) accumulates
//   acc[i][j] = sum_k A(k, pg + 16 i) * W(k, ng + 16 j),  k in [0, K).
// la(k, p) and lw(k, n) supply the operands; they are called only for k < K
// and return 0 for pixels or channels outside the caller's range. As and Ws
// are kTileK * kLd floats of shared memory each. The strided micro-tile keeps
// both the staging writes and the inner-loop reads free of bank conflicts.
template <int MP, class LoadA, class LoadW>
__device__ __forceinline__ void gemm_tile(int K, LoadA la, LoadW lw, float* As, float* Ws,
                                          float (&acc)[MP][4]) {
  constexpr int PT = 16 * MP;
  const int tid = threadIdx.x, ng = tid & 15, pg = tid >> 4;
#pragma unroll
  for (int i = 0; i < MP; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += kTileK) {
    for (int e = tid; e < kTileK * PT; e += kThreads) {
      const int k = e % kTileK, p = e / kTileK;
      As[k * kLd + p] = (k0 + k < K) ? la(k0 + k, p) : 0.f;
    }
    for (int e = tid; e < kTileK * kTileN; e += kThreads) {
      const int k = e % kTileK, n = e / kTileK;
      Ws[k * kLd + n] = (k0 + k < K) ? lw(k0 + k, n) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kTileK; ++k) {
      float a[MP], w[4];
#pragma unroll
      for (int i = 0; i < MP; ++i) a[i] = As[k * kLd + pg + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = Ws[k * kLd + ng + 16 * j];
#pragma unroll
      for (int i = 0; i < MP; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// ------------------------------------------------------- the bf16 route

using bf16 = __nv_bfloat16;

constexpr int kKB = 32;  // reduction depth of one streamed weight chunk (tc_gemm)

// Row stride, in elements, of a bf16 operand tile of k columns: k rounded up
// to 16 (the instruction's depth) plus 8, so that the stride in 16-byte units
// is odd and the eight rows an ldmatrix phase reads fall in distinct banks.
__host__ __device__ constexpr int tc_ld(int k) { return (k + 15) / 16 * 16 + 8; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// d += a b for one m16n8k16 tile, bf16 operands, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes from device to shared memory in flight; zeros when !valid (src is
// then not read, but must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }
// Wait until at most N of the groups this thread committed are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// One k16 step of a warp's (16 MT) x (8 NT) tile: acc[i][j] += A_i B_j^T.
// A: the warp's first row, row-major bf16 in shared memory (stride lda, rows
// are pixels); B: its first output channel, row-major N x K bf16 in shared
// memory (stride ldb). Both point at the step's first k.
template <int MT, int NT>
__device__ __forceinline__ void warp_mma_k16(const bf16* A, int lda, const bf16* B, int ldb,
                                             float (&acc)[MT][NT][4]) {
  const int lane = threadIdx.x & 31;
  uint32_t a[MT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i) ldsm_x4(a[i], A + (i * 16 + (lane & 15)) * lda + (lane >> 4) * 8);
#pragma unroll
  for (int j = 0; j < NT; j += 2) {
    if (j + 1 < NT) {
      uint32_t b[4];
      ldsm_x4(b, B + (j * 8 + (lane & 7) + ((lane >> 4) << 3)) * ldb + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        mma_bf16(acc[i][j], a[i], b[0], b[1]);
        mma_bf16(acc[i][j + 1], a[i], b[2], b[3]);
      }
    } else {
      uint32_t b[2];
      ldsm_x2(b, B + (j * 8 + (lane & 7)) * ldb + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int i = 0; i < MT; ++i) mma_bf16(acc[i][j], a[i], b[0], b[1]);
    }
  }
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// One k16 step of a warp's (16 MT) x (8 NT) tile of a product over a shared
// index k whose operands are both stored k-major: acc[i][j] += A_i^T B_j
// with A[k][m] (stride lda) and B[k][n] (stride ldb) bf16 in shared memory,
// e.g. the Gram q^T k of pixel-major q and k. A points at the step's first
// k and the warp's first m, B at its first k and first n; NT even.
// ldmatrix.trans turns the k-major 8 x 8 blocks into the m16n8k16
// fragments that warp_mma_k16 reads from m-major rows.
template <int MT, int NT>
__device__ __forceinline__ void warp_mma_t_k16(const bf16* A, int lda, const bf16* B, int ldb,
                                               float (&acc)[MT][NT][4]) {
  static_assert(NT % 2 == 0, "B fragments come in pairs of 8 columns");
  const int lane = threadIdx.x & 31, q = lane >> 3, r = lane & 7;
  uint32_t a[MT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
    ldsm_x4_t(a[i], A + (r + (q >> 1) * 8) * lda + i * 16 + (q & 1) * 8);
#pragma unroll
  for (int j = 0; j < NT; j += 2) {
    uint32_t b[4];
    ldsm_x4_t(b, B + (r + (q & 1) * 8) * ldb + j * 8 + (q >> 1) * 8);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      mma_bf16(acc[i][j], a[i], b[0], b[1]);
      mma_bf16(acc[i][j + 1], a[i], b[2], b[3]);
    }
  }
}

// A lane's ldmatrix offsets, in elements, into a warp's operand tiles of
// warp_mma_k16 (row-major, stride ld): the A fragments' row (lane & 15) and
// column ((lane >> 4) * 8), and the B fragment pairs' row (lane & 7) +
// ((lane >> 4) << 3) and column ((lane >> 3) & 1) * 8 (the single B
// fragment of an odd NT reads the first 16 lanes' addresses of the same
// formula with row lane & 7).
__device__ __forceinline__ int lane_a_off(int ld) {
  const int lane = threadIdx.x & 31;
  return (lane & 15) * ld + (lane >> 4) * 8;
}
__device__ __forceinline__ int lane_b_off(int ld) {
  const int lane = threadIdx.x & 31;
  return ((lane & 7) + ((lane >> 4) << 3)) * ld + ((lane >> 3) & 1) * 8;
}
__device__ __forceinline__ int lane_b1_off(int ld) {
  const int lane = threadIdx.x & 31;
  return (lane & 7) * ld + ((lane >> 3) & 1) * 8;
}

__device__ __forceinline__ void ldsm_x4_at(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2_at(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// KS k16 steps of a warp's (16 MT) x (8 NT) tile, acc += A B^T over k in
// [0, 16 KS), the same instructions as KS calls of warp_mma_k16 but from
// shared-memory byte addresses computed once: a = the warp's first A row
// plus lane_a_off, b = its first B row plus lane_b_off, b1 = plus
// lane_b1_off; lda, ldb the row strides in bytes. No branch between the
// steps, so a step's ldmatrix may issue while the last step multiplies.
template <int MT, int NT, int KS>
__device__ __forceinline__ void warp_mma_steps(uint32_t a, uint32_t lda, uint32_t b, uint32_t b1,
                                               uint32_t ldb, float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    uint32_t af[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i) ldsm_x4_at(af[i], a + i * 16 * lda + s * 32);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      if (j + 1 < NT) {
        uint32_t bf[4];
        ldsm_x4_at(bf, b + j * 8 * ldb + s * 32);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_bf16(acc[i][j], af[i], bf[0], bf[1]);
          mma_bf16(acc[i][j + 1], af[i], bf[2], bf[3]);
        }
      } else {
        uint32_t bf[2];
        ldsm_x2_at(bf, b1 + j * 8 * ldb + s * 32);
#pragma unroll
        for (int i = 0; i < MT; ++i) mma_bf16(acc[i][j], af[i], bf[0], bf[1]);
      }
    }
  }
}

template <int MT, int NT>
__device__ __forceinline__ void zero_acc(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
}

// f(row, col, v0, v1) for every pair of accumulators (columns col and col +
// 1, col even) of the warp's tile, row and col relative to the tile (the
// m16n8 accumulator layout).
template <int MT, int NT, class F>
__device__ __forceinline__ void for_each_acc(const float (&acc)[MT][NT][4], F f) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        f(i * 16 + (lane >> 2) + r * 8, j * 8 + (lane & 3) * 2, acc[i][j][2 * r],
          acc[i][j][2 * r + 1]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void store2(bf16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// The block's 8 warps as WM rows by 8 / WM columns of warp tiles.
template <int WM, int MT, int NT>
struct TcShape {
  static constexpr int WN = 8 / WM;
  static constexpr int M = WM * 16 * MT;  // rows of the block's tile
  static constexpr int NP = WN * 8 * NT;  // output channels of one pass
  static constexpr int LDB = tc_ld(kKB);  // row stride of a weight chunk
  static constexpr int WBUF = 2 * NP * LDB;  // bf16 of the double buffer
};

// Stage rows [n0, n0 + NP) x k [k0, k0 + kKB) of a row-major weight into
// dst (NP x LDB bf16) with cp.async; row(n) gives row n's first element, or
// nullptr for a zero row; k >= K is zero. K must be a multiple of 8 and the
// rows 16-byte aligned. Commits one group.
template <int NP, class Row>
__device__ __forceinline__ void tc_stage_w(bf16* dst, Row row, int n0, int k0, int K) {
  constexpr int LDB = tc_ld(kKB);
  for (int e = threadIdx.x; e < NP * (kKB / 8); e += kThreads) {
    const int r = e / (kKB / 8), k = k0 + (e % (kKB / 8)) * 8;
    const bf16* src = row(n0 + r);
    const bool ok = src != nullptr && k < K;
    cp_async16(dst + r * LDB + (e % (kKB / 8)) * 8, ok ? src + k : dst, ok);
  }
  cp_async_commit();
}

// C = A W^T on the tensor cores. A: M x K bf16 in shared memory, row-major
// with stride lda, every column below K rounded up to 16 finite (the
// caller's padding); W: N rows given by row(n) (see tc_stage_w). For each
// pass of NP output channels: the 32-deep chunks of W come through wbuf
// (WBUF bf16) with cp.async, the next chunk loading while the current one
// multiplies, the sums in fp32 registers; then epi(m, n, v) for every row m
// < M and pair of channels n, n + 1 < N of the pass (N even), and after(n0)
// once the whole block has finished the epilogue. Every output sums its k in ascending 16-deep steps
// from zero. Must be called by the whole block; ends with a barrier.
template <int WM, int MT, int NT, class Row, class Epi, class After>
__device__ __forceinline__ void tc_gemm(const bf16* A, int lda, Row row, int N, int K, bf16* wbuf,
                                        Epi epi, After after) {
  using S = TcShape<WM, MT, NT>;
  const int warp = threadIdx.x >> 5, wm = warp % WM, wn = warp / WM;
  const int nk = (K + kKB - 1) / kKB;
  const bf16* Aw = A + wm * 16 * MT * lda;
  for (int n0 = 0; n0 < N; n0 += S::NP) {
    float acc[MT][NT][4];
    zero_acc(acc);
    tc_stage_w<S::NP>(wbuf, row, n0, 0, K);
    for (int kc = 0; kc < nk; ++kc) {
      cp_async_wait_all();
      __syncthreads();  // chunk kc landed; chunk kc - 1's buffer is free
      if (kc + 1 < nk) tc_stage_w<S::NP>(wbuf + ((kc + 1) & 1) * S::NP * S::LDB, row, n0,
                                         (kc + 1) * kKB, K);
      const bf16* B = wbuf + (kc & 1) * S::NP * S::LDB + wn * 8 * NT * S::LDB;
      warp_mma_k16<MT, NT>(Aw + kc * kKB, lda, B, S::LDB, acc);
      if (kc * kKB + 16 < K) warp_mma_k16<MT, NT>(Aw + kc * kKB + 16, lda, B + 16, S::LDB, acc);
    }
    __syncthreads();  // every warp is done with wbuf
    const int m0 = wm * 16 * MT, c0 = n0 + wn * 8 * NT;
    for_each_acc(acc, [&](int r, int c, float v0, float v1) {
      if (c0 + c < N) epi(m0 + r, c0 + c, v0, v1);
    });
    __syncthreads();
    after(n0);
  }
}

// Opt a kernel in to more than 48 KB of dynamic shared memory.
template <class K>
__host__ inline cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// allow_smem for Kernel at the largest size a block may opt in to, once a
// device: later launches of any size up to it make no driver call for it.
constexpr int kMaxBlockSmem = 232448;  // bytes of shared memory one H100 block may opt in to

template <auto Kernel>
__host__ inline cudaError_t allow_smem_once() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev]) return cudaSuccess;
  err = allow_smem(Kernel, kMaxBlockSmem);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

}  // namespace pk
