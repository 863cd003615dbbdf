// The MDTA statistics pass on one spatial tile, shared by mdta_stats.cu's
// float32 route (x read from device memory) and tail_stats.cu (x held in
// shared memory); mdta_stats.cu's bf16 route has its own (stats_tc_kernel)
// and takes only ln1_value from here:
//   halo_ln_stats  LN1's mean and rstd of every pixel of the tile and its
//                  1-pixel halo, one warp a pixel, two-pass in fp32;
//   ln1_value      LN1's output at one pixel and channel, rounded through T;
//   stats_head     for one head: its 3d qkv rows at every halo pixel, the
//                  depthwise 3x3 taps on the interior, v written out, and
//                  the tile's partial Gram q^T k and squared norms of q and
//                  k added to the head's slot; or, given qo and ko (the
//                  wide route), q and k written out beside v and only the
//                  norms added;
//   slot_sum_kernel  slots summed in slot order (both kernels' last step).
// halo_ln_stats reads x as ldx(hp, pix, c): halo pixel hp, its flat pixel
// index pix, channel c (called only for pixels inside the image).
// stats_head reads LN1's output as ldy(hp, c), 0 outside the image:
// mdta_stats.cu computes it from x as the product stages it, tail_stats.cu
// once per tile. Rounding points: LN1's output is rounded through T; qkv,
// the taps, q, k and the sums stay fp32; v is rounded through T.
// stats_head_tc is tail_stats' bf16 route: the qkv product and the Gram on
// the tensor cores (common.cuh:tc_gemm, warp_mma_k16), LN1's output staged
// once a tile as a bf16 operand; q and k are rounded to bf16 for the Gram
// while their squared norms sum the unrounded fp32 values, the rounding of
// the Pallas kernel (promptir_tpu/ops/pallas/mdta.py:113-124).
#pragma once

#include "common.cuh"

// One anonymous namespace at file scope, as the including .cu files use
// (see gdfn.cuh).
namespace {
using namespace pk;

constexpr int kMP = 4;  // 64 halo pixels per product pass

// The shared-memory pieces of one stats tile (see the carving in the kernels).
struct StatsSmem {
  float* qk;    // pi x 2d: q then k of the interior pixels, fp32
  float* pre;   // ph x kTileN: one qkv chunk of the halo pixels before the taps
  float* As;    // gemm_tile's staging tiles
  float* Ws;
  float* mean;  // ph: LN1 statistics of the halo pixels
  float* rstd;
  int* pix;     // ph: flat pixel index, or -1 outside the image
};

// The th x tw tile at (ty0, tx0) of image b and its 1-pixel halo:
// (th + 2) x (tw + 2) pixels, hp = row * (tw + 2) + col.
struct StatsTile {
  int b, ty0, tx0, th, tw, H, W, C;
};

template <class LoadX>
__device__ __forceinline__ void halo_ln_stats(LoadX ldx, const StatsTile& t, float eps,
                                              const StatsSmem& s) {
  const int hw = t.tw + 2, ph = (t.th + 2) * hw, C = t.C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int hp = warp; hp < ph; hp += kThreads / 32) {
    const int gy = t.ty0 - 1 + hp / hw, gx = t.tx0 - 1 + hp % hw;
    const bool in = gy >= 0 && gy < t.H && gx >= 0 && gx < t.W;
    const int pix = in ? (t.b * t.H + gy) * t.W + gx : -1;
    float mean = 0.f, rstd = 0.f;
    if (in) {
      float sum = 0.f;
      for (int c = lane; c < C; c += 32) sum += ldx(hp, pix, c);
      mean = warp_sum(sum) / C;
      float q = 0.f;
      for (int c = lane; c < C; c += 32) {
        const float u = ldx(hp, pix, c) - mean;
        q = fmaf(u, u, q);
      }
      rstd = 1.f / sqrtf(warp_sum(q) / C + eps);
    }
    if (lane == 0) {
      s.mean[hp] = mean;
      s.rstd[hp] = rstd;
      s.pix[hp] = pix;
    }
  }
}

template <class T>
__device__ __forceinline__ float ln1_value(float xv, float mean, float rstd, const T* lnw,
                                           const T* lnb, int c, int bias_free) {
  const float y = bias_free ? xv * rstd * to_f(lnw[c])
                            : (xv - mean) * rstd * to_f(lnw[c]) + to_f(lnb[c]);
  return round_t<T>(y);
}

// Head h of the tile: v of its d channels written to v (B, H, W, C), and the
// tile's Gram and norms written (first) or added to `out` (d*d + 2d fp32).
// Each value of `out` is read and written by one thread only. Needs what
// ldy reads behind a barrier; ends with a barrier.
template <class T, class LoadY>
__device__ __forceinline__ void stats_head(LoadY ldy, const T* wqkv, const T* wdw, T* v,
                                           float* out, bool first, int h, int heads,
                                           const StatsTile& t, const StatsSmem& s,
                                           T* qo = nullptr, T* ko = nullptr) {
  const int C = t.C, d = C / heads, th = t.th, tw = t.tw;
  const int hw = tw + 2, ph = (th + 2) * hw, pi = th * tw, ld = 2 * d, n3 = 3 * d;
  const int ng = threadIdx.x & 15, pg = threadIdx.x >> 4;
  for (int n0 = 0; n0 < n3; n0 += kTileN) {
    // qkv rows n0 .. n0+63 of this head (q: 0..d-1, k: d..2d-1, v: 2d..3d-1)
    // for every halo pixel; out-of-image pixels give y = 0, hence qkv = 0,
    // which is the depthwise conv's zero padding.
    for (int p0 = 0; p0 < ph; p0 += 16 * kMP) {
      float acc[kMP][4];
      gemm_tile<kMP>(
          C,
          [&](int k, int p) -> float {
            const int hp = p0 + p;
            return hp < ph ? ldy(hp, k) : 0.f;
          },
          [&](int k, int n) -> float {
            const int nn = n0 + n;
            if (nn >= n3) return 0.f;
            const int row = (nn / d) * C + h * d + nn % d;
            return to_f(wqkv[(long long)row * C + k]);
          },
          s.As, s.Ws, acc);
#pragma unroll
      for (int i = 0; i < kMP; ++i) {
        const int hp = p0 + pg + 16 * i;
        if (hp < ph) {
#pragma unroll
          for (int j = 0; j < 4; ++j) s.pre[hp * kTileN + ng + 16 * j] = acc[i][j];
        }
      }
    }
    __syncthreads();
    // depthwise 3x3 on the interior pixels; v goes out, q and k stay here
    for (int e = threadIdx.x; e < pi * kTileN; e += kThreads) {
      const int n = e % kTileN, p = e / kTileN, nn = n0 + n;
      if (nn >= n3) continue;
      const int sec = nn / d, ch = nn % d, row = sec * C + h * d + ch;
      const int iy = p / tw, ix = p % tw;
      float acc = 0.f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
          acc = fmaf(s.pre[((iy + dy) * hw + ix + dx) * kTileN + n],
                     to_f(wdw[row * 9 + dy * 3 + dx]), acc);
      const int gy = t.ty0 + iy, gx = t.tx0 + ix;
      const bool valid = gy < t.H && gx < t.W;
      const long long o = ((long long)(t.b * t.H + gy) * t.W + gx) * C + h * d + ch;
      if (sec == 2) {
        if (valid) v[o] = from_f<T>(acc);
      } else {
        s.qk[p * ld + sec * d + ch] = valid ? acc : 0.f;
        if (qo != nullptr && valid) (sec ? ko : qo)[o] = from_f<T>(acc);
      }
    }
    __syncthreads();
  }

  // partial Gram (4x4 register tiles) and squared norms of this tile; with
  // q and k written out (qo, ko) the Gram is left to the Gram kernel and the
  // norms go to out[0, 2d)
  const int d4 = qo != nullptr ? 0 : d / 4;
  float* nrm = qo != nullptr ? out : out + d * d;
  for (int e = threadIdx.x; e < d4 * d4; e += kThreads) {
    const int ib = e / d4, jb = e % d4;
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = first ? 0.f : out[(ib * 4 + r) * d + jb * 4 + c];
    for (int p = 0; p < pi; ++p) {
      const float4 q = *reinterpret_cast<const float4*>(s.qk + p * ld + ib * 4);
      const float4 k = *reinterpret_cast<const float4*>(s.qk + p * ld + d + jb * 4);
      const float qa[4] = {q.x, q.y, q.z, q.w}, ka[4] = {k.x, k.y, k.z, k.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(qa[r], ka[c], acc[r][c]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) out[(ib * 4 + r) * d + jb * 4 + c] = acc[r][c];
  }
  for (int c = threadIdx.x; c < ld; c += kThreads) {
    float sum = first ? 0.f : nrm[c];
    for (int p = 0; p < pi; ++p) {
      const float u = s.qk[p * ld + c];
      sum = fmaf(u, u, sum);
    }
    nrm[c] = sum;
  }
  __syncthreads();  // qk and pre are rewritten by the next head or tile
}

// ----------------------------------------------------------- bf16 route

constexpr int kPreLd = 72;  // pre's row stride: 4 rows of float2 stores, distinct banks

// The bf16 stats pass's shared memory beside its operand Y, in the order it
// is carved (ops/cuda/mdta.py:stats_tc_bytes mirrors it).
struct StatsTcSmem {
  float* pre;   // ph x kPreLd: one 64-channel qkv chunk of the halo pixels, fp32
  bf16* qT;     // rows(d) x tc_ld(pi): q of the interior pixels, channel-major
  bf16* kT;     // rows(d) x tc_ld(pi): k
  bf16* wbuf;   // the qkv product's weight double buffer
  float* red;   // kThreads: partial squared norms
  float* mean;  // ph each: LN1 statistics and flat pixel indices of the halo
  float* rstd;
  int* pix;
  __host__ __device__ static int rows(int d) { return (d + 31) / 32 * 32; }
  __host__ __device__ static int bytes(int ph, int pi, int d) {
    return ph * kPreLd * 4 + 2 * rows(d) * tc_ld(pi) * 2 + TcShape<4, 1, 4>::WBUF * 2 +
           kThreads * 4 + (3 * ph + 3) / 4 * 16;
  }
  __device__ StatsTcSmem(char* p, int ph, int pi, int d) {
    pre = reinterpret_cast<float*>(p);
    qT = reinterpret_cast<bf16*>(pre + ph * kPreLd);
    kT = qT + rows(d) * tc_ld(pi);
    wbuf = kT + rows(d) * tc_ld(pi);
    red = reinterpret_cast<float*>(wbuf + TcShape<4, 1, 4>::WBUF);
    mean = red + kThreads;
    rstd = mean + ph;
    pix = reinterpret_cast<int*>(rstd + ph);
  }
  // halo_ln_stats's view
  __device__ StatsSmem ln() const {
    StatsSmem s{};
    s.mean = mean;
    s.rstd = rstd;
    s.pix = pix;
    return s;
  }
};

// Zero n bytes of shared memory from p (16-byte aligned, n a multiple of 16).
__device__ __forceinline__ void zero_smem(void* p, int n) {
  for (int e = threadIdx.x; e < n / 16; e += kThreads)
    reinterpret_cast<uint4*>(p)[e] = make_uint4(0u, 0u, 0u, 0u);
}

// Head h of the tile in the bf16 route, as stats_head: Y holds LN1's output
// on the halo pixels (WM x 16 MT rows, stride ldy, 0 outside the image and
// in the padding rows; columns up to C rounded to 16 finite). qT and kT must
// hold zeros outside rows d and columns pi. Per pass of 64 qkv rows: the
// product on the tensor cores into pre, then the taps on the interior
// pixels, each thread one channel (its taps in registers) and every fourth
// row (a 3 x 3 window of pre in registers): v written out, q and k to qT
// and kT rounded to bf16, their unrounded fp32 squares summed per channel
// (four partials added in order). Then the Gram of the rounded q and k on
// the tensor cores, 16 x 32 tiles a warp. Ends with a barrier.
template <int WM, int MT, int NT>
__device__ __forceinline__ void stats_head_tc(const bf16* Y, int ldy, const bf16* wqkv,
                                              const bf16* wdw, bf16* v, float* out, bool first,
                                              int h, int heads, const StatsTile& t,
                                              const StatsTcSmem& s) {
  static_assert(TcShape<WM, MT, NT>::NP == 64, "pre holds 64 qkv rows a pass");
  const int C = t.C, d = C / heads, th = t.th, tw = t.tw, tid = threadIdx.x;
  const int hw = tw + 2, ph = (th + 2) * hw, pi = th * tw, n3 = 3 * d, ldq = tc_ld(pi);
  tc_gemm<WM, MT, NT>(
      Y, ldy,
      [&](int nn) -> const bf16* {
        return nn < n3 ? wqkv + (long long)((nn / d) * C + h * d + nn % d) * C : nullptr;
      },
      n3, C, s.wbuf,
      [&](int m, int n, float v0, float v1) {
        if (m < ph) *reinterpret_cast<float2*>(s.pre + m * kPreLd + (n & 63)) = make_float2(v0, v1);
      },
      [&](int n0) {
        const int n = tid & 63, nn = n0 + n;
        float nrm = 0.f;
        if (nn < n3) {
          const int sec = nn / d, ch = nn % d, row = sec * C + h * d + ch;
          float wt[9];
#pragma unroll
          for (int t9 = 0; t9 < 9; ++t9) wt[t9] = to_f(wdw[row * 9 + t9]);
          bf16* qk = (sec ? s.kT : s.qT) + ch * ldq;
          for (int iy = tid >> 6; iy < th; iy += kThreads / 64) {
            const float* pr = s.pre + iy * hw * kPreLd + n;
            float win[3][3];
#pragma unroll
            for (int dy = 0; dy < 3; ++dy) {
              win[dy][1] = pr[dy * hw * kPreLd];
              win[dy][2] = pr[(dy * hw + 1) * kPreLd];
            }
            const int gy = t.ty0 + iy;
            for (int ix = 0; ix < tw; ++ix) {
#pragma unroll
              for (int dy = 0; dy < 3; ++dy) {
                win[dy][0] = win[dy][1];
                win[dy][1] = win[dy][2];
                win[dy][2] = pr[(dy * hw + ix + 2) * kPreLd];
              }
              float acc = 0.f;
#pragma unroll
              for (int dy = 0; dy < 3; ++dy)
#pragma unroll
                for (int dx = 0; dx < 3; ++dx) acc = fmaf(win[dy][dx], wt[dy * 3 + dx], acc);
              const int gx = t.tx0 + ix;
              const bool valid = gy < t.H && gx < t.W;
              if (sec == 2) {
                if (valid)
                  v[((long long)(t.b * t.H + gy) * t.W + gx) * C + h * d + ch] =
                      __float2bfloat16(acc);
              } else {
                const float u = valid ? acc : 0.f;
                qk[iy * tw + ix] = __float2bfloat16(u);
                nrm = fmaf(u, u, nrm);
              }
            }
          }
        }
        s.red[tid] = nrm;
        __syncthreads();
        if (tid < 64 && n0 + tid < 2 * d) {
          const float sum = s.red[tid] + s.red[64 + tid] + s.red[128 + tid] + s.red[192 + tid];
          float* o = out + d * d + n0 + tid;
          *o = first ? sum : *o + sum;
        }
      });
  __syncthreads();  // qT and kT are complete

  // the tile's partial Gram q^T k: K = the interior pixels, zero-padded to 16
  const int ti = (d + 15) / 16, tj = (d + 31) / 32, kp = (pi + 15) / 16 * 16;
  for (int tt = tid >> 5; tt < ti * tj; tt += kThreads / 32) {
    const int i0 = (tt / tj) * 16, j0 = (tt % tj) * 32;
    float acc[1][4][4];
    zero_acc(acc);
    for (int k = 0; k < kp; k += 16)
      warp_mma_k16<1, 4>(s.qT + i0 * ldq + k, ldq, s.kT + j0 * ldq + k, ldq, acc);
    for_each_acc(acc, [&](int r, int c, float v0, float v1) {
      const int i = i0 + r, j = j0 + c;
      if (i >= d || j >= d) return;
      float* o = out + i * d + j;
      o[0] = first ? v0 : o[0] + v0;
      o[1] = first ? v1 : o[1] + v1;
    });
  }
  __syncthreads();  // pre, qT and kT are rewritten by the next head or tile
}

// Sum the slots in slot order: row y of part (nslots x n) into
// out[y * ld_out + off, + n).
__global__ void __launch_bounds__(kThreads) slot_sum_kernel(const float* part, float* out,
                                                            int nslots, int n, int ld_out,
                                                            int off) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= n) return;
  const float* src = part + (long long)blockIdx.y * nslots * n + e;
  float sum = 0.f;
#pragma unroll 8
  for (int t = 0; t < nslots; ++t) sum += src[(long long)t * n];
  out[(long long)blockIdx.y * ld_out + off + e] = sum;
}

inline cudaError_t launch_slot_sum(const float* part, float* out, int rows, int nslots, int n,
                                   int ld_out, int off, cudaStream_t stream) {
  slot_sum_kernel<<<dim3((n + kThreads - 1) / kThreads, rows), kThreads, 0, stream>>>(
      part, out, nslots, n, ld_out, off);
  return cudaGetLastError();
}

// tail_stats' slots (B*heads, nslots, d*d + 2d) -> stats (B*heads, d*d + 2d).
inline cudaError_t launch_stats_reduce(const float* part, float* stats, int B, int heads,
                                       int C, int nslots, cudaStream_t stream) {
  const int d = C / heads, n = d * d + 2 * d;
  return launch_slot_sum(part, stats, B * heads, nslots, n, n, 0, stream);
}

}  // namespace
