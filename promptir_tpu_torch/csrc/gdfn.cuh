// Pieces of the gated depthwise feed-forward (GDFN) shared by block_tail.cu,
// ln_gdfn.cu and tail_stats.cu:
//   ln_tile      the channel LayerNorm of a pixel tile held in shared memory;
//   project_in   the W1 product (C -> 2F) of that tile to the hidden tensor h;
//   gdfn_gate    the depthwise 3x3 taps of h at one pixel and the exact-erf
//                gate, the value gdfn_out stages for W2 (tail_stats.cu too);
//   gdfn_out     the spatial kernel from h to the output: depthwise 3x3 on a
//                1-pixel halo of h, the exact-erf gate, W2 (F -> C) and the
//                residual.
// Rounding points: LN's output, h and the gated value are rounded through T;
// products, LN statistics and taps are fp32.
#pragma once

#include "common.cuh"

// One anonymous namespace at file scope, as the including .cu files use:
// nvcc's kernel stubs cannot tell two anonymous namespaces of a file apart.
namespace {
using namespace pk;

// LN over the C channels of each of the PT pixels of src (C x PT fp32,
// channel-major), two-pass in fp32, written rounded through T to dst, which
// may be src itself (each thread rewrites only the values it read last).
// red holds kThreads + 2 * PT floats. Ends with a barrier.
template <class T, int PT>
__device__ __forceinline__ void ln_tile(const float* src, float* dst, float* red, int C,
                                        const T* lnw, const T* lnb, int bias_free, float eps) {
  constexpr int G = kThreads / PT;  // threads per pixel
  const int p = threadIdx.x % PT, g = threadIdx.x / PT;
  float s = 0.f;
  for (int c = g; c < C; c += G) s += src[c * PT + p];
  red[g * PT + p] = s;
  __syncthreads();
  if (g == 0) {
    float t = 0.f;
    for (int q = 0; q < G; ++q) t += red[q * PT + p];
    red[kThreads + p] = t / C;
  }
  __syncthreads();
  const float mean = red[kThreads + p];
  float s2 = 0.f;
  for (int c = g; c < C; c += G) {
    const float t = src[c * PT + p] - mean;
    s2 = fmaf(t, t, s2);
  }
  red[g * PT + p] = s2;
  __syncthreads();
  if (g == 0) {
    float t = 0.f;
    for (int q = 0; q < G; ++q) t += red[q * PT + p];
    red[kThreads + PT + p] = 1.f / sqrtf(t / C + eps);
  }
  __syncthreads();
  const float rstd = red[kThreads + PT + p];
  for (int c = g; c < C; c += G) {
    const float xv = src[c * PT + p];
    const float y = bias_free ? xv * rstd * to_f(lnw[c])
                              : (xv - mean) * rstd * to_f(lnw[c]) + to_f(lnb[c]);
    dst[c * PT + p] = round_t<T>(y);
  }
  __syncthreads();
}

// h[pix0 + p, n] = sum_c y[c, p] W1[n, c] (n < F2), rounded to T, for the np
// valid pixels of a tile of PT = 16 * MP; y is C x PT fp32 in shared memory.
template <class T, int MP>
__device__ __forceinline__ void project_in(const float* y, const T* w1, T* hid, long long pix0,
                                           int np, int C, int F2, float* As, float* Ws) {
  constexpr int PT = 16 * MP;
  const int ng = threadIdx.x & 15, pg = threadIdx.x >> 4;
  for (int n0 = 0; n0 < F2; n0 += kTileN) {
    float acc[MP][4];
    gemm_tile<MP>(
        C, [&](int k, int p) -> float { return y[k * PT + p]; },
        [&](int k, int n) -> float {
          return n0 + n < F2 ? to_f(w1[(long long)(n0 + n) * C + k]) : 0.f;
        },
        As, Ws, acc);
#pragma unroll
    for (int i = 0; i < MP; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = pg + 16 * i, n = n0 + ng + 16 * j;
        if (p < np && n < F2) hid[(pix0 + p) * F2 + n] = from_f<T>(acc[i][j]);
      }
  }
}

// The gated value gelu(dw(h)[k]) * dw(h)[F + k] at pixel (gy, gx), inside
// the image, with the taps' zero padding; rounded through T. ldh(yy, xx,
// half) gives h's channel half * F + k at pixel (yy, xx) and ldw(half, t)
// tap t of that channel's depthwise weight. gdfn_out_kernel (h from device
// memory) and tail_stats.cu (h staged in shared memory) take their gates
// from this one arithmetic, so that their outputs agree bit for bit.
template <class T, class LoadH, class LoadW>
__device__ __forceinline__ float gdfn_gate(LoadH ldh, LoadW ldw, int H, int W, int gy, int gx) {
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    const int yy = gy + dy - 1;
    if (yy < 0 || yy >= H) continue;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int xx = gx + dx - 1;
      if (xx < 0 || xx >= W) continue;
      const int t = dy * 3 + dx;
      s1 = fmaf(ldh(yy, xx, 0), ldw(0, t), s1);
      s2 = fmaf(ldh(yy, xx, 1), ldw(1, t), s2);
    }
  }
  return round_t<T>(gelu_erf(s1) * s2);
}

struct GdfnOutArgs {
  const void* hid;  // (B, H, W, 2F) T
  const void* wdw;  // (2F, 9) T
  const void* w2;   // (C, F) T
  const void* res;  // (B, H, W, C) T, the residual
  void* out;        // (B, H, W, C) T
  int B, H, W, C, F;
};

constexpr int kTH = 4, kTW = 16;  // gdfn_out spatial tile: 64 pixels

// One block: a kTH x kTW tile of one image; all C output channels.
// out = res + W2 (gelu(dw(h)[:F]) * dw(h)[F:]). The gated value is computed
// as it is staged for W2, so it never reaches memory; it is recomputed once
// for each 64 output channels.
template <class T>
__global__ void __launch_bounds__(kThreads) gdfn_out_kernel(GdfnOutArgs a, int tiles_w) {
  __shared__ float As[kTileK * kLd];
  __shared__ float Ws[kTileK * kLd];
  const int b = blockIdx.y, C = a.C, F = a.F, H = a.H, W = a.W;
  const int ty0 = (blockIdx.x / tiles_w) * kTH, tx0 = (blockIdx.x % tiles_w) * kTW;
  const T* hid = static_cast<const T*>(a.hid);
  const T* wdw = static_cast<const T*>(a.wdw);
  const T* w2 = static_cast<const T*>(a.w2);
  const T* res = static_cast<const T*>(a.res);
  T* out = static_cast<T*>(a.out);
  const int ng = threadIdx.x & 15, pg = threadIdx.x >> 4;

  for (int n0 = 0; n0 < C; n0 += kTileN) {
    float acc[4][4];
    gemm_tile<4>(
        F,
        [&](int k, int p) -> float {
          const int gy = ty0 + p / kTW, gx = tx0 + p % kTW;
          if (gy >= H || gx >= W) return 0.f;
          return gdfn_gate<T>(
              [&](int yy, int xx, int half) -> float {
                return to_f(hid[((long long)(b * H + yy) * W + xx) * (2 * F) + half * F + k]);
              },
              [&](int half, int t) -> float { return to_f(wdw[(half * F + k) * 9 + t]); }, H, W,
              gy, gx);
        },
        [&](int k, int n) -> float {
          return n0 + n < C ? to_f(w2[(long long)(n0 + n) * F + k]) : 0.f;
        },
        As, Ws, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = pg + 16 * i, gy = ty0 + p / kTW, gx = tx0 + p % kTW;
      if (gy >= H || gx >= W) continue;
      const long long base = ((long long)(b * H + gy) * W + gx) * C;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + ng + 16 * j;
        if (n < C) out[base + n] = from_f<T>(to_f(res[base + n]) + acc[i][j]);
      }
    }
  }
}

template <class T>
cudaError_t launch_gdfn_out(const GdfnOutArgs& a, cudaStream_t stream) {
  const int tiles_w = (a.W + kTW - 1) / kTW, tiles = ((a.H + kTH - 1) / kTH) * tiles_w;
  gdfn_out_kernel<T><<<dim3(tiles, a.B), kThreads, 0, stream>>>(a, tiles_w);
  return cudaGetLastError();
}

}  // namespace
