// The MDTA apply step, shared by block_tail.cu (tail_a's steps 1-2) and
// ln_mdta.cu (the whole kernel):
//   av = attn v per head, rounded through T;
//   x2 = x + W_proj av, rounded through T; written out, and kept in shared
//        memory when the caller goes on from it (block_tail's LN2).
// Products are fp32 from gemm_tile (common.cuh).
#pragma once

#include "common.cuh"

// One anonymous namespace at file scope, as the including .cu files use
// (see gdfn.cuh).
namespace {
using namespace pk;

// For the np valid pixels of a tile of PT = 16 * MP consecutive pixels of
// image b, starting at flat pixel pix0. av is C x PT fp32 of shared memory;
// x2s (C x PT, only when kKeepX2) receives x2 with 0 at the pixels past np.
// Ends with a barrier.
template <class T, int MP, bool kKeepX2>
__device__ __forceinline__ void attn_apply_project(const T* v, const T* x, const float* attn,
                                                   const T* wproj, T* x2g, int b, int C,
                                                   int heads, long long pix0, int np, float* av,
                                                   float* x2s, float* As, float* Ws) {
  constexpr int PT = 16 * MP;
  const int d = C / heads;
  const int ng = threadIdx.x & 15, pg = threadIdx.x >> 4;

  // 1. av[p, h d + i] = sum_j attn[b, h, i, j] v[p, h d + j], rounded through T
  for (int hh = 0; hh < heads; ++hh) {
    const float* at = attn + (long long)(b * heads + hh) * d * d;
    for (int n0 = 0; n0 < d; n0 += kTileN) {
      float acc[MP][4];
      gemm_tile<MP>(
          d,
          [&](int k, int p) -> float {
            return p < np ? to_f(v[(pix0 + p) * C + hh * d + k]) : 0.f;
          },
          [&](int k, int n) -> float { return n0 + n < d ? at[(n0 + n) * d + k] : 0.f; }, As,
          Ws, acc);
#pragma unroll
      for (int i = 0; i < MP; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = n0 + ng + 16 * j;
          if (n < d) av[(hh * d + n) * PT + pg + 16 * i] = round_t<T>(acc[i][j]);
        }
    }
  }
  __syncthreads();

  // 2. x2 = x + W_proj av, rounded through T
  for (int n0 = 0; n0 < C; n0 += kTileN) {
    float acc[MP][4];
    gemm_tile<MP>(
        C, [&](int k, int p) -> float { return av[k * PT + p]; },
        [&](int k, int n) -> float {
          return n0 + n < C ? to_f(wproj[(long long)(n0 + n) * C + k]) : 0.f;
        },
        As, Ws, acc);
#pragma unroll
    for (int i = 0; i < MP; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = pg + 16 * i, n = n0 + ng + 16 * j;
        if (n >= C) continue;
        float val = 0.f;
        if (p < np) {
          val = round_t<T>(to_f(x[(pix0 + p) * C + n]) + acc[i][j]);
          x2g[(pix0 + p) * C + n] = from_f<T>(val);
        }
        if constexpr (kKeepX2) x2s[n * PT + p] = val;
      }
  }
  __syncthreads();
}

}  // namespace
