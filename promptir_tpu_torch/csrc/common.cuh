// Shared device helpers for the PromptIR Hopper kernels.
//
// Every kernel here keeps its arithmetic in fp32 and reads or writes its
// activations in T, which is float or __nv_bfloat16. The one matrix routine,
// gemm_tile, is a plain shared-memory SIMT tile (64 output channels by
// 16 * MP pixels, a 32-deep reduction chunk, a 4-by-MP micro-tile per thread).
// It is the simple, correct first form; wgmma and TMA are later work.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pk {

constexpr int kThreads = 256;  // every kernel launches 256 threads a block
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

// Opt a kernel in to more than 48 KB of dynamic shared memory.
template <class K>
__host__ inline cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace pk
