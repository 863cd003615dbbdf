// Pieces of the gated depthwise feed-forward (GDFN) shared by block_tail.cu,
// tail_stats.cu and, in float32, ln_gdfn.cu. The float32 route:
//   ln_tile      the channel LayerNorm of a pixel tile held in shared memory;
//   project_in   the W1 product (C -> 2F) of that tile to the hidden tensor h;
//   gdfn_gate    the depthwise 3x3 taps of h at one pixel and the exact-erf
//                gate, the value gdfn_out stages for W2 (tail_stats.cu too);
//   gdfn_out     the spatial kernel from h to the output: depthwise 3x3 on a
//                1-pixel halo of h, the exact-erf gate, W2 (F -> C) and the
//                residual.
// The bf16 route (tensor cores, common.cuh:tc_gemm):
//   ln_rows        LN of the rows (pixels) of a bf16 tile, in place;
//   project_in_tc  W1 of that tile to h, in the packed layout below;
//   gdfn_w2        the W2 product of the gates of a pixel region into
//                  register accumulators: h of each chunk of 32 gate
//                  channels staged on the region's 1-pixel halo, each gate
//                  computed once (gdfn_gate) into a bf16 tile and multiplied
//                  into all C outputs. gdfn_out_tc (block_tail's second
//                  kernel) and tail_stats.cu both take
//                  their W2 product from it;
//   gdfn_out_tc    the spatial kernel around gdfn_w2: an 8 x 8 tile (4 x 8
//                  above C = 384, for the registers), the residual, out.
// Packed layout of the bf16 route (ops/cuda/packed.py makes the weights'
// copy once): F is padded to Fp, a multiple of 32, and h holds 2Fp channels
// a pixel, chunk by chunk: [h1 of gate channels 32 i .. 32 i + 31, h2 of the
// same], so one chunk's h is 128 contiguous bytes; W1's rows and the
// depthwise weights (fp32) follow that order, W2 is C x Fp; the padding is
// zero, and so are its gates.
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

// ----------------------------------------------------------- bf16 route

constexpr int kGC = kKB;           // gate channels of one W2 chunk
constexpr int kLdh = 2 * kGC + 8;  // staged h: one chunk's 64 channels a pixel + 8

// LN over the C channels of each of `rows` rows of X (bf16, stride ld), one
// warp a row, two-pass in fp32, rounded to bf16 in place. Ends with a barrier.
__device__ __forceinline__ void ln_rows(bf16* X, int ld, int rows, int C, const bf16* lnw,
                                        const bf16* lnb, int bias_free, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += kThreads / 32) {
    bf16* x = X + r * ld;
    float sum = 0.f;
    for (int c = lane; c < C; c += 32) sum += to_f(x[c]);
    const float mean = warp_sum(sum) / C;
    float q = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float u = to_f(x[c]) - mean;
      q = fmaf(u, u, q);
    }
    const float rstd = 1.f / sqrtf(warp_sum(q) / C + eps);
    for (int c = lane; c < C; c += 32) {
      const float xv = to_f(x[c]);
      const float y = bias_free ? xv * rstd * to_f(lnw[c])
                                : (xv - mean) * rstd * to_f(lnw[c]) + to_f(lnb[c]);
      x[c] = __float2bfloat16(y);
    }
  }
  __syncthreads();
}

using ProjGemm = TcShape<2, 2, 8>;  // the pointwise products: 64 pixels, 256 channels a pass

// h[pix0 + m, :] = W1p y[m, :] for the np valid rows of Y (64 x C bf16,
// stride ld), in the packed order (2Fp channels, W1p (2Fp, C)).
__device__ __forceinline__ void project_in_tc(const bf16* Y, int ld, const bf16* w1p, bf16* hid,
                                              long long pix0, int np, int C, int F2p,
                                              bf16* wbuf) {
  tc_gemm<2, 2, 8>(
      Y, ld, [&](int n) -> const bf16* { return n < F2p ? w1p + (long long)n * C : nullptr; },
      F2p, C, wbuf,
      [&](int m, int n, float v0, float v1) {
        if (m < np) store2(hid + (pix0 + m) * F2p + n, v0, v1);
      },
      [](int) {});
}

// gdfn_w2's shared memory for a region of rh x rw pixels and NP outputs,
// in the order it is carved; every piece a multiple of 16 bytes.
struct W2Smem {
  bf16* hs;    // (rh + 2)(rw + 2) x kLdh: h of the chunk on the halo
  float* wcs;  // 64 x 9: the chunk's depthwise weights
  bf16* G;     // rh rw x tc_ld(kGC): the chunk's gates
  bf16* wbuf;  // 2 x NP x tc_ld(kKB): two chunks of W2
  __host__ __device__ static int bytes(int rh, int rw, int NP) {
    return (rh + 2) * (rw + 2) * kLdh * 2 + 64 * 9 * 4 + rh * rw * tc_ld(kGC) * 2 +
           2 * NP * tc_ld(kKB) * 2;
  }
  __device__ W2Smem(char* p, int rh, int rw, int NP) {
    hs = reinterpret_cast<bf16*>(p);
    wcs = reinterpret_cast<float*>(p + (rh + 2) * (rw + 2) * kLdh * 2);
    G = reinterpret_cast<bf16*>(reinterpret_cast<char*>(wcs) + 64 * 9 * 4);
    wbuf = G + rh * rw * tc_ld(kGC);
  }
};

// The W2 product of GDFN at the rh x rw pixels of image b from (ry0, rx0):
// acc = W2 gate(h) for the region's pixels (rows, in raster order; rh rw ==
// the block tile's M) and all outputs (columns up to NP >= C). Per chunk of
// kGC gate channels: h of the chunk on the region's 1-pixel halo (0 outside
// the image), its depthwise weights and W2's chunk arrive with cp.async, W2
// double-buffered, the next chunk's copies in flight while this chunk
// multiplies; each gate is computed once (gdfn_gate; 0 outside the image)
// into the bf16 tile G; then two k16 steps. So every output sums its
// products from zero in one order: ascending k, 16 at a time, whatever the
// region, the warp layout or the kernel. Ends with a barrier.
template <int WM, int MT, int NT>
__device__ __forceinline__ void gdfn_w2(const bf16* hid, const float* wdwp, const bf16* w2p,
                                        int b, int H, int W, int C, int Fp, int ry0, int rx0,
                                        int rh, int rw, const W2Smem& s,
                                        float (&acc)[MT][NT][4]) {
  using S = TcShape<WM, MT, NT>;
  constexpr int LDG = tc_ld(kGC);
  const int tid = threadIdx.x, warp = tid >> 5, wm = warp % WM, wn = warp / WM;
  const int sw = rw + 2, sp = (rh + 2) * sw, np = rh * rw, F2p = 2 * Fp, nk = Fp / kGC;
  const auto stage = [&](int kc) {
    for (int e = tid; e < sp * 8; e += kThreads) {
      const int q = e >> 3, part = e & 7;
      const int gy = ry0 - 1 + q / sw, gx = rx0 - 1 + q % sw;
      const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W;
      const bf16* src =
          ok ? hid + ((long long)(b * H + gy) * W + gx) * F2p + kc * 2 * kGC + part * 8 : hid;
      cp_async16(s.hs + q * kLdh + part * 8, src, ok);
    }
    for (int e = tid; e < 64 * 9 / 4; e += kThreads)
      cp_async16(s.wcs + e * 4, wdwp + (long long)kc * 64 * 9 + e * 4, true);
    tc_stage_w<S::NP>(
        s.wbuf + (kc & 1) * S::NP * S::LDB,
        [&](int n) -> const bf16* { return n < C ? w2p + (long long)n * Fp : nullptr; }, 0,
        kc * kGC, Fp);  // commits the chunk's group
  };
  zero_acc(acc);
  stage(0);
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait_all();
    __syncthreads();  // chunk kc landed; G and W2's other buffer are free
    // lane j: gate channel j; each warp walks row segments of the region
    // (rows split in halves below 8 rows) with both halves' 3 x 3 windows
    // of h and their taps in registers
    {
      const int j = tid & 31, nseg = rh < 8 ? 2 : 1, seg_w = (rw + nseg - 1) / nseg;
      float wt[2][9];
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int t = 0; t < 9; ++t) wt[half][t] = s.wcs[(half * kGC + j) * 9 + t];
      for (int u = warp; u < rh * nseg; u += kThreads / 32) {
        const int py = u / nseg, px0 = (u % nseg) * seg_w, px1 = min(rw, px0 + seg_w);
        const int gy = ry0 + py;
        const bf16* hrow = s.hs + (py * sw) * kLdh + j;  // stage rows py .. py + 2
        float win[2][3][3];
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int dy = 0; dy < 3; ++dy) {
            win[half][dy][1] = to_f(hrow[(dy * sw + px0) * kLdh + half * kGC]);
            win[half][dy][2] = to_f(hrow[(dy * sw + px0 + 1) * kLdh + half * kGC]);
          }
        for (int px = px0; px < px1; ++px) {
#pragma unroll
          for (int half = 0; half < 2; ++half)
#pragma unroll
            for (int dy = 0; dy < 3; ++dy) {
              win[half][dy][0] = win[half][dy][1];
              win[half][dy][1] = win[half][dy][2];
              win[half][dy][2] = to_f(hrow[(dy * sw + px + 2) * kLdh + half * kGC]);
            }
          const int gx = rx0 + px;
          float g = 0.f;
          if (gy >= 0 && gy < H && gx >= 0 && gx < W)
            g = gdfn_gate<bf16>(
                [&](int yy, int xx, int half) -> float {
                  return win[half][yy - gy + 1][xx - gx + 1];
                },
                [&](int half, int t) -> float { return wt[half][t]; }, H, W, gy, gx);
          s.G[(py * rw + px) * LDG + j] = __float2bfloat16(g);
        }
      }
    }
    __syncthreads();  // the gates are in G; the staged h is free
    if (kc + 1 < nk) stage(kc + 1);
    const bf16* A = s.G + wm * 16 * MT * LDG;
    const bf16* B = s.wbuf + (kc & 1) * S::NP * S::LDB + wn * 8 * NT * S::LDB;
    warp_mma_k16<MT, NT>(A, LDG, B, S::LDB, acc);
    warp_mma_k16<MT, NT>(A + 16, LDG, B + 16, S::LDB, acc);
  }
  __syncthreads();
}

struct GdfnOutTcArgs {
  const bf16* hid;    // (B, H, W, 2Fp), packed
  const float* wdwp;  // (2Fp, 9), packed
  const bf16* w2p;    // (C, Fp)
  const bf16* res;    // (B, H, W, C), the residual
  bf16* out;          // (B, H, W, C)
  int B, H, W, C, Fp;
};

// One block: a TH x TW tile of one image, all C outputs: out = res + W2
// gate(h), rounded to bf16. WM x (8 / WM) warps of 16 x 8 NT accumulators.
template <int WM, int NT, int TH, int TW>
__global__ void __launch_bounds__(kThreads) gdfn_out_tc_kernel(GdfnOutTcArgs a, int tiles_w) {
  using S = TcShape<WM, 1, NT>;
  static_assert(S::M == TH * TW, "the tile fills the warps' rows");
  extern __shared__ float4 smem4[];
  const W2Smem s(reinterpret_cast<char*>(smem4), TH, TW, S::NP);
  const int b = blockIdx.y, ty0 = (blockIdx.x / tiles_w) * TH, tx0 = (blockIdx.x % tiles_w) * TW;
  float acc[1][NT][4];
  gdfn_w2<WM, 1, NT>(a.hid, a.wdwp, a.w2p, b, a.H, a.W, a.C, a.Fp, ty0, tx0, TH, TW, s, acc);
  const int warp = threadIdx.x >> 5, m0 = (warp % WM) * 16, c0 = (warp / WM) * 8 * NT;
  for_each_acc(acc, [&](int r, int c, float v0, float v1) {
    const int m = m0 + r, n = c0 + c, gy = ty0 + m / TW, gx = tx0 + m % TW;
    if (n >= a.C || gy >= a.H || gx >= a.W) return;
    const long long i = ((long long)(b * a.H + gy) * a.W + gx) * a.C + n;
    const float2 rv = load2(a.res + i);
    store2(a.out + i, rv.x + v0, rv.y + v1);
  });
}

template <int WM, int NT, int TH, int TW>
cudaError_t launch_gdfn_out_tc_at(const GdfnOutTcArgs& a, cudaStream_t stream) {
  const size_t smem = W2Smem::bytes(TH, TW, TcShape<WM, 1, NT>::NP);
  cudaError_t err = allow_smem(gdfn_out_tc_kernel<WM, NT, TH, TW>, smem);
  if (err != cudaSuccess) return err;
  const int tiles_w = (a.W + TW - 1) / TW, tiles = ((a.H + TH - 1) / TH) * tiles_w;
  gdfn_out_tc_kernel<WM, NT, TH, TW><<<dim3(tiles, a.B), kThreads, smem, stream>>>(a, tiles_w);
  return cudaGetLastError();
}

// The accumulators cover C in 8 x 8 tiles up to C = 384 (16 NT outputs a
// warp column pair, 96 registers at most), in 4 x 8 tiles above (32 NT).
// The instantiated NT are those the promptir and X-Restormer widths need
// (48, 96, 160, 192, 320, 384; 704); another width takes the next larger.
inline cudaError_t launch_gdfn_out_tc(const GdfnOutTcArgs& a, cudaStream_t stream) {
  const int n16 = (a.C + 15) / 16, n32 = (a.C + 31) / 32;
  if (n16 <= 3) return launch_gdfn_out_tc_at<4, 3, 8, 8>(a, stream);
  if (n16 <= 6) return launch_gdfn_out_tc_at<4, 6, 8, 8>(a, stream);
  if (n16 <= 10) return launch_gdfn_out_tc_at<4, 10, 8, 8>(a, stream);
  if (n16 <= 12) return launch_gdfn_out_tc_at<4, 12, 8, 8>(a, stream);
  if (n16 <= 20) return launch_gdfn_out_tc_at<4, 20, 8, 8>(a, stream);
  if (n16 <= 24) return launch_gdfn_out_tc_at<4, 24, 8, 8>(a, stream);
  if (n32 <= 22) return launch_gdfn_out_tc_at<2, 22, 4, 8>(a, stream);
  if (n32 <= 24) return launch_gdfn_out_tc_at<2, 24, 4, 8>(a, stream);
  return cudaErrorInvalidValue;
}

}  // namespace
