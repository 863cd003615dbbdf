// The MDTA apply step, block_tail.cu's tail_a steps 1-2 (and, in float32,
// the whole of ln_mdta.cu; its bf16 kernel has its own code):
//   av = attn v per head, rounded through T;
//   x2 = x + W_proj av, rounded through T; written out, and kept in shared
//        memory when the caller goes on from it (block_tail's LN2).
// The float32 route's products are gemm_tile's (attn_apply_project), the
// bf16 route's tc_gemm's on the tensor cores (attn_apply_project_tc), where
// attn arrives in bf16: the wrapper rounds the softmax output once, as the
// JAX composition does (promptir_tpu/ops/attention.py:81).
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

constexpr int kPT = 64;  // pixels of a bf16 apply (or tail_a) block

// The bf16 route: for the np valid pixels of a tile of kPT consecutive
// pixels of image b from flat pixel pix0. X and AV are kPT x tc_ld(C) bf16
// of shared memory, wbuf ProjGemm's double buffer. v is staged into X with
// cp.async (0 past np), av = attn v per head into AV, then x2 = x + W_proj
// av is written out and kept in X (0 past np). attn is (B, heads, d, d)
// bf16, d a multiple of 8. Ends with a barrier.
__device__ __forceinline__ void attn_apply_project_tc(const bf16* v, const bf16* x,
                                                      const bf16* attn, const bf16* wproj,
                                                      bf16* x2g, int b, int C, int heads,
                                                      long long pix0, int np, bf16* X, bf16* AV,
                                                      bf16* wbuf) {
  const int d = C / heads, ld = tc_ld(C), tid = threadIdx.x;
  for (int e = tid; e < kPT * (C / 8); e += kThreads) {
    const int p = e / (C / 8), q = e % (C / 8);
    const bool ok = p < np;
    cp_async16(X + p * ld + q * 8, ok ? v + (pix0 + p) * C + q * 8 : v, ok);
  }
  cp_async_commit();
  // the padding columns: a k16 step past a head's last channel reads them
  for (int e = tid; e < kPT * (ld - C); e += kThreads) {
    const int p = e / (ld - C), j = C + e % (ld - C);
    X[p * ld + j] = AV[p * ld + j] = __float2bfloat16(0.f);
  }
  cp_async_wait_all();
  __syncthreads();

  // 1. av = attn v per head: a product of K = N = d on X's head columns
  for (int hh = 0; hh < heads; ++hh) {
    const bf16* at = attn + (long long)(b * heads + hh) * d * d;
    tc_gemm<4, 1, 4>(
        X + hh * d, ld,
        [&](int n) -> const bf16* { return n < d ? at + (long long)n * d : nullptr; }, d, d, wbuf,
        [&](int m, int n, float v0, float v1) { store2(AV + m * ld + hh * d + n, v0, v1); },
        [](int) {});
  }

  // 2. x2 = x + W_proj av, rounded to bf16
  tc_gemm<2, 2, 8>(
      AV, ld, [&](int n) -> const bf16* { return n < C ? wproj + (long long)n * C : nullptr; }, C,
      C, wbuf,
      [&](int m, int n, float v0, float v1) {
        float r0 = 0.f, r1 = 0.f;
        if (m < np) {
          const long long i = (pix0 + m) * C + n;
          const float2 xv = load2(x + i);
          const __nv_bfloat162 r = __floats2bfloat162_rn(xv.x + v0, xv.y + v1);
          *reinterpret_cast<__nv_bfloat162*>(x2g + i) = r;
          r0 = __low2float(r);
          r1 = __high2float(r);
        }
        store2(X + m * ld + n, r0, r1);
      },
      [](int) {});
}

}  // namespace
