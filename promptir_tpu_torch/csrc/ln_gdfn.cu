// LN + GDFN: out = x + W2 (gelu(h1) * h2) with [h1, h2] = dw3x3(W1 LN(x)),
// the spatial feed-forward of every X-Restormer block.
//
// Replaces promptir_tpu/ops/pallas/gdfn.py:536 fused_ln_gdfn (body _kernel,
// ln_gdfn_stripe). The TPU kernel never writes the hidden tensor h: a row
// stripe recomputes LN and W1 on a 2-row halo, masks the rows outside the
// image (border_mask: LN of x's zero padding is the bias, not zero) and
// keeps h in VMEM.
//
// Bound on the H100. The products cost 3FC MACs a pixel (about 8 C^2)
// against 2C stored values (x read, out written). In bf16 at 989 TFLOP/s
// and 3.35 TB/s the minimal traffic is the bound at C = 48 and the
// operations at C >= 96 (chip_smoke.py prints which for every shape). The
// bound counts neither the SIMT depthwise taps and exact-erf gates (F a
// pixel, ~78 instructions each in the SASS) nor W1 again on a tile's halo
// (128 product rows for 64 pixels at 8 x 8), and mma.sync reaches ~150-250
// TFLOP/s here: those lead (PERF.md).
//
// The bf16 route (ln_gdfn_tc_kernel) is one pass with h kept on the chip,
// as the TPU kernel is built. A block owns a TH x TW tile of one image and
// all C outputs: x on the tile's 1-pixel halo comes in by cp.async (16-byte
// pieces), LN is taken once a pixel in place (two-pass fp32, rounded to
// bf16, ln_rows_vec); then per chunk of 32 gate channels
//   W1's 64 rows of the chunk (h1 and h2, the packed order of gdfn.cuh) on
//     the tensor cores over the halo pixels, in pieces of 16 KS columns (KS
//     by width, so that the served widths take whole pieces) streamed
//     through a cp.async ring of NS stages that runs on across chunks, each
//     piece's k16 steps without a branch between them
//     (common.cuh:warp_mma_steps);
//   h rounded to bf16 into shared memory, 0 at halo pixels outside the
//     image (the taps' zero padding; LN of a zero pixel is the bias);
//   the taps and the exact-erf gate (gdfn.cuh:gdfn_gate's arithmetic) into
//     a bf16 gate tile, lane j of each warp on gate channel j along a row;
//   W2's chunk (C x 32, arriving with the chunk's last W1 piece) into
//     register accumulators for all C outputs;
// and at the end the residual and one bf16 store. h never reaches device
// memory (the split form wrote 2Fp values a pixel and read them back on an
// 8 x 8 tile's halo: ~1.4 ms of traffic a promptxrestormerir forward). The
// plan (ops/cuda/gdfn.py:ln_gdfn_plan) picks the tile and, at the deep
// shapes whose tiles do not fill the card, a split of the gate chunks over
// S blocks a tile: each writes its fp32 partial sums, and split_sum_kernel
// adds them to x in slot order (no atomics: two launches give the same
// bits). The float32 route keeps the two SIMT kernels of its first form:
// ln_gdfn_a (x tile -> LN -> W1, writes h) and gdfn.cuh:gdfn_out (taps,
// gate, W2, residual), whose fp32 goldens hold at 2e-4.
//
// Dropped TPU workarounds: the W+2 / 128-lane padding, the per-half hidden
// padding, the hybrid-MXU tap split, the rational erf and the w % 8 gates.
#include "gdfn.cuh"

namespace {
using namespace pk;

struct LnGdfnArgs {
  const void* x;    // (B, H, W, C) T
  const void* lnw;  // (C) T
  const void* lnb;  // (C) T, unused when bias_free
  const void* w1;   // (2F, C) T (out, in)
  void* hid;        // (B, H, W, 2F) T
  int B, H, W, C, F, bias_free;
  float eps;
};

constexpr int kMP = 4;  // 64 pixels a block

// One block: PT = 16 * kMP consecutive pixels of one image. Shared memory, in
// order: the x tile (C x PT fp32, normalised in place), the two product
// staging tiles, the LN reduction (kThreads + 2 PT floats); the byte count is
// ops/cuda/gdfn.py:ln_gdfn_smem.
template <class T>
__global__ void __launch_bounds__(kThreads) ln_gdfn_a_kernel(LnGdfnArgs a) {
  constexpr int PT = 16 * kMP;
  extern __shared__ float4 smem4[];
  const int C = a.C, HW = a.H * a.W, b = blockIdx.y;
  const long long pix0 = (long long)b * HW + (long long)blockIdx.x * PT;
  const int np = min(PT, HW - (int)blockIdx.x * PT);
  const T* x = static_cast<const T*>(a.x);

  float* buf = reinterpret_cast<float*>(smem4);  // C x PT: x, then LN(x)
  float* As = buf + C * PT;
  float* Ws = As + kTileK * kLd;
  float* red = Ws + kTileK * kLd;

  // pixel-fastest order: conflict-free shared stores; pixels past the
  // image's end are 0 (their LN is finite and their h is never written)
  for (int e = threadIdx.x; e < C * PT; e += kThreads) {
    const int p = e % PT, c = e / PT;
    buf[c * PT + p] = p < np ? to_f(x[(pix0 + p) * C + c]) : 0.f;
  }
  __syncthreads();
  ln_tile<T, PT>(buf, buf, red, C, static_cast<const T*>(a.lnw),
                 static_cast<const T*>(a.lnb), a.bias_free, a.eps);
  project_in<T, kMP>(buf, static_cast<const T*>(a.w1), static_cast<T*>(a.hid), pix0, np, C,
                     2 * a.F, As, Ws);
}

template <class T>
int launch(const LnGdfnArgs& a, const void* wdw, const void* w2, void* out, size_t smem,
           cudaStream_t stream) {
  constexpr int PT = 16 * kMP;
  cudaError_t err = allow_smem(ln_gdfn_a_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const int HW = a.H * a.W;
  ln_gdfn_a_kernel<T><<<dim3((HW + PT - 1) / PT, a.B), kThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  GdfnOutArgs g;  // the residual is x
  g.hid = a.hid; g.wdw = wdw; g.w2 = w2; g.res = a.x; g.out = out;
  g.B = a.B; g.H = a.H; g.W = a.W; g.C = a.C; g.F = a.F;
  return launch_gdfn_out<T>(g, stream);
}

// ----------------------------------------------- the bf16 route, one pass

constexpr int kHC = 2 * kGC;       // h channels of one gate chunk (h1, h2)
constexpr int kLdG = tc_ld(kGC);   // row stride of the gate tile and of W2's chunk

// LN over the C channels of each of `rows` rows of X (bf16, stride ld, C a
// multiple of 8), in place: two-pass fp32 statistics, the output rounded to
// bf16. TPR threads a row (a power of two, enough that each holds at most
// kLnVec vectors of 8 channels in registers), thread t of a row on its
// vectors t, t + TPR, ...; every row's values are read once from shared
// memory and written once, 16 bytes a thread at a time. (gdfn.cuh:ln_rows
// takes one warp a row and reads each value three times; on the halo of a
// tile it led the block at small C.) Ends with a barrier.
constexpr int kLnVec = 4;

__device__ __forceinline__ void ln_rows_vec(bf16* X, int ld, int rows, int C, const bf16* lnw,
                                            const bf16* lnb, int bias_free, float eps) {
  const int nv = C / 8;
  int tpr = 1;
  while (tpr * kLnVec < nv && tpr < 32) tpr <<= 1;
  const int t = threadIdx.x % tpr, rpp = kThreads / tpr;
  for (int r0 = 0; r0 < rows; r0 += rpp) {  // every thread takes part in the shuffles
    const int r = r0 + (int)threadIdx.x / tpr;
    const bool ok = r < rows;
    bf16* x = X + (ok ? r : 0) * ld;
    float v[kLnVec][8];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kLnVec; ++i) {
      const int q = t + i * tpr;
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (ok && q < nv) u = *reinterpret_cast<const uint4*>(x + q * 8);
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(h2[j]);
        v[i][2 * j] = f.x;
        v[i][2 * j + 1] = f.y;
        sum += f.x + f.y;
      }
    }
    for (int o = tpr / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float mean = sum / C;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < kLnVec; ++i)
      if (t + i * tpr < nv)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float u = v[i][j] - mean;
          sq = fmaf(u, u, sq);
        }
    for (int o = tpr / 2; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
    const float rstd = 1.f / sqrtf(sq / C + eps);
#pragma unroll
    for (int i = 0; i < kLnVec; ++i) {
      const int q = t + i * tpr;
      if (!ok || q >= nv) continue;
      const uint4 wu = *reinterpret_cast<const uint4*>(lnw + q * 8);
      const uint4 bu = bias_free ? make_uint4(0u, 0u, 0u, 0u)
                                 : *reinterpret_cast<const uint4*>(lnb + q * 8);
      const __nv_bfloat162* w2 = reinterpret_cast<const __nv_bfloat162*>(&wu);
      const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&bu);
      uint4 o;
      __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 wf = __bfloat1622float2(w2[j]), bf = __bfloat1622float2(b2[j]);
        const float y0 = bias_free ? v[i][2 * j] * rstd * wf.x
                                   : (v[i][2 * j] - mean) * rstd * wf.x + bf.x;
        const float y1 = bias_free ? v[i][2 * j + 1] * rstd * wf.y
                                   : (v[i][2 * j + 1] - mean) * rstd * wf.y + bf.y;
        o2[j] = __floats2bfloat162_rn(y0, y1);
      }
      *reinterpret_cast<uint4*>(x + q * 8) = o;
    }
  }
  __syncthreads();
}

// The warp layouts of a TH x TW tile. W1: the halo's PH pixels (rows,
// padded to MH) by the chunk's 64 h channels, WM1 x WN1 warps of MT1 x NT1
// m16n8 tiles. W2: the tile's NPX pixels by the outputs, WM2 x WN2 warps of
// MT2 x NT2 tiles (NT2 by C, a template argument of the kernel).
template <int TH, int TW>
struct FusedTile {
  static constexpr int SW = TW + 2, PH = (TH + 2) * SW, NPX = TH * TW;
  static constexpr int M1T = (PH + 15) / 16;
  static constexpr int WM1 = M1T >= 4 ? 4 : 1;
  static constexpr int MT1 = (M1T + WM1 - 1) / WM1;
  static constexpr int MH = WM1 * MT1 * 16;
  static constexpr int WN1 = 8 / WM1, NT1 = 8 / WN1;
  static constexpr int M2T = NPX / 16;
  static constexpr int MT2 = M2T >= 4 ? 4 : M2T;
  static constexpr int WM2 = M2T / MT2, WN2 = 8 / WM2;
  static_assert(NPX % 16 == 0 && (TH == 4 || TH == 8) && MH > PH,
                "the tile's rows and warps; a padding row past the halo");
};

// Shared memory of one block, in the order it is carved (every piece a
// multiple of 16 bytes): Xn, x then LN(x) on the halo (MH x tc_ld(C) bf16);
// the W1 ring (NS pieces of 64 x tc_ld(16 KS) bf16); W2's chunk buffers
// (NB x NP x kLdG bf16); the depthwise weights' (NB x 64 x 9 fp32); h of
// the chunk on the halo (PH x kLdh bf16); the gates (NPX x kLdG bf16).
template <int TH, int TW, int NT2, int KS, int NS, int NB>
struct FusedSmem {
  using T = FusedTile<TH, TW>;
  static constexpr int NP = T::WN2 * 8 * NT2, LDP = tc_ld(16 * KS);
  __host__ __device__ static int bytes(int C) {
    return T::MH * tc_ld(C) * 2 + NS * kHC * LDP * 2 + NB * NP * kLdG * 2 + NB * kHC * 9 * 4 +
           T::PH * kLdh * 2 + T::NPX * kLdG * 2;
  }
  bf16 *xn, *ring, *w2, *hs, *g;
  float* wd;
  __device__ FusedSmem(char* p, int C) {
    xn = reinterpret_cast<bf16*>(p);
    ring = xn + T::MH * tc_ld(C);
    w2 = ring + NS * kHC * LDP;
    wd = reinterpret_cast<float*>(w2 + NB * NP * kLdG);
    hs = reinterpret_cast<bf16*>(wd + NB * kHC * 9);
    g = hs + T::PH * kLdh;
  }
};

struct FusedArgs {
  const bf16* x;      // (B, H, W, C)
  const bf16* lnw;    // (C)
  const bf16* lnb;    // (C), unused when bias_free
  const bf16* w1p;    // (2Fp, C), packed
  const float* wdwp;  // (2Fp, 9), packed
  const bf16* w2p;    // (C, Fp)
  bf16* out;          // (B, H, W, C)
  float* part;        // (S, B, H, W, C) fp32 partial sums when S > 1
  int B, H, W, C, Fp, bias_free, nsplit, tiles_w;
  float eps;
};

// One block: tile blockIdx.x of image blockIdx.y, gate chunks [kc0, kc1) of
// split blockIdx.z. W1's rows of a chunk come in P = ceil(C / KP) pieces
// of KP = 16 KS columns (every piece full: past C the weights are zero and
// the product reads the next row of Xn, finite, or a padding row), numbered
// p = 0, 1, ... over the block's chunks; piece p goes to ring slot p % NS,
// and with the last piece of a chunk come that chunk's W2 columns and
// depthwise weights (buffer chunk % NB). One cp.async group a piece: at
// piece p the block waits for its group, then issues piece p + NS - 1 into
// the slot that piece p - 1 freed. A W2 buffer is free when issued because
// NS <= NB P (checked by the launcher).
template <int TH, int TW, int NT2, int KS, int NS, int NB, int MINB>
__global__ void __launch_bounds__(kThreads, MINB) ln_gdfn_tc_kernel(FusedArgs a) {
  using T = FusedTile<TH, TW>;
  using S = FusedSmem<TH, TW, NT2, KS, NS, NB>;
  constexpr int NP = S::NP, KP = 16 * KS, LDP = S::LDP;
  extern __shared__ float4 smem4[];
  const int C = a.C, H = a.H, W = a.W, b = blockIdx.y, ldx = tc_ld(C);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ty0 = (blockIdx.x / a.tiles_w) * TH, tx0 = (blockIdx.x % a.tiles_w) * TW;
  const int nk = a.Fp / kGC;
  const int kc0 = blockIdx.z * nk / a.nsplit, kc1 = (blockIdx.z + 1) * nk / a.nsplit;
  const int P = (C + KP - 1) / KP, npieces = (kc1 - kc0) * P;
  const S s(reinterpret_cast<char*>(smem4), C);

  // the next piece to issue: its number, chunk and piece within the chunk
  int ip = 0, ikc = kc0, ikp = 0;
  const auto issue = [&]() {
    if (ip < npieces) {
      bf16* dst = s.ring + (ip % NS) * kHC * LDP;
      for (int e = tid; e < kHC * KS * 2; e += kThreads) {
        const int r = e / (KS * 2), q = e % (KS * 2), k = ikp * KP + q * 8;
        const bool ok = k < C;
        cp_async16(dst + r * LDP + q * 8,
                   ok ? a.w1p + (long long)(ikc * kHC + r) * C + k : a.w1p, ok);
      }
      if (ikp == P - 1) {
        const int nb = (ikc - kc0) % NB;
        bf16* w2d = s.w2 + nb * NP * kLdG;
        for (int e = tid; e < NP * (kGC / 8); e += kThreads) {
          const int r = e >> 2;
          const bool ok = r < C;
          cp_async16(w2d + r * kLdG + (e & 3) * 8,
                     ok ? a.w2p + (long long)r * a.Fp + ikc * kGC + (e & 3) * 8 : a.w2p, ok);
        }
        for (int e = tid; e < kHC * 9 / 4; e += kThreads)
          cp_async16(s.wd + nb * kHC * 9 + e * 4, a.wdwp + (long long)ikc * kHC * 9 + e * 4,
                     true);
      }
      ++ip;
      if (++ikp == P) ikp = 0, ++ikc;
    }
    cp_async_commit();
  };

  // x on the halo, 0 outside the image; the padding rows and columns 0
  for (int e = tid; e < T::PH * (C / 8); e += kThreads) {
    const int q = e / (C / 8), part = e % (C / 8);
    const int gy = ty0 - 1 + q / T::SW, gx = tx0 - 1 + q % T::SW;
    const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W;
    cp_async16(s.xn + q * ldx + part * 8,
               ok ? a.x + ((long long)(b * H + gy) * W + gx) * C + part * 8 : a.x, ok);
  }
  cp_async_commit();
  for (int p = 0; p < NS - 1; ++p) issue();
  for (int e = tid; e < T::PH * (ldx - C); e += kThreads)
    s.xn[(e / (ldx - C)) * ldx + C + e % (ldx - C)] = __float2bfloat16(0.f);
  for (int e = tid; e < (T::MH - T::PH) * ldx; e += kThreads)
    s.xn[T::PH * ldx + e] = __float2bfloat16(0.f);
  cp_async_wait<NS - 1>();  // x landed; the ring's first pieces may still fly
  __syncthreads();
  ln_rows_vec(s.xn, ldx, T::PH, C, a.lnw, a.lnb, a.bias_free, a.eps);

  const int wm1 = warp % T::WM1, wn1 = warp / T::WM1;
  const int wm2 = warp % T::WM2, wn2 = warp / T::WM2;
  // the lanes' ldmatrix addresses (bytes): W1's A (Xn) and B (ring slot 0),
  // W2's A (G) and B (W2 buffer 0)
  const uint32_t a1 = smem_u32(s.xn + wm1 * 16 * T::MT1 * ldx + lane_a_off(ldx));
  const uint32_t r0 = smem_u32(s.ring) + 2 * (wn1 * 8 * T::NT1 * LDP);
  const uint32_t b1 = r0 + 2 * lane_b_off(LDP), b1s = r0 + 2 * lane_b1_off(LDP);
  const uint32_t a2 = smem_u32(s.g + wm2 * 16 * T::MT2 * kLdG + lane_a_off(kLdG));
  const uint32_t w0 = smem_u32(s.w2) + 2 * (wn2 * 8 * NT2 * kLdG);
  const uint32_t b2 = w0 + 2 * lane_b_off(kLdG), b2s = w0 + 2 * lane_b1_off(kLdG);
  float acc1[T::MT1][T::NT1][4];
  float acc2[T::MT2][NT2][4];
  zero_acc(acc2);
  int p = 0;
  for (int kc = kc0; kc < kc1; ++kc) {
    zero_acc(acc1);
    for (int kp = 0; kp < P; ++kp, ++p) {
      cp_async_wait<NS - 2>();
      __syncthreads();  // piece p landed; piece p - 1's slot is free
      issue();
      const uint32_t slot = (p % NS) * (kHC * LDP * 2);
      warp_mma_steps<T::MT1, T::NT1, KS>(a1 + kp * KP * 2, ldx * 2, b1 + slot, b1s + slot,
                                         LDP * 2, acc1);
    }

    // the chunk's h on the halo, rounded to bf16; 0 outside the image
    {
      const int m0 = wm1 * 16 * T::MT1, n0 = wn1 * 8 * T::NT1;
      for_each_acc(acc1, [&](int r, int c, float v0, float v1) {
        const int q = m0 + r;
        if (q >= T::PH) return;
        const int gy = ty0 - 1 + q / T::SW, gx = tx0 - 1 + q % T::SW;
        const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
        store2(s.hs + q * kLdh + n0 + c, in ? v0 : 0.f, in ? v1 : 0.f);
      });
    }
    __syncthreads();  // h is on the halo
    const int nb = (kc - kc0) % NB;
    // the gates: lane j on gate channel j; warp u on row u / NSEG, segment
    // u % NSEG, its 3 x 3 windows of both halves of h in registers. Taps
    // outside the image read h's zeros: fmaf(0, w, s) is s, so the sums are
    // gdfn_gate's. A pixel outside the image gets a finite gate that only
    // its own (unstored) output row reads.
    {
      constexpr int NSEG = 8 / TH, SEGW = TW / NSEG;
      const int py = warp / NSEG, px0 = (warp % NSEG) * SEGW;
      const float* wd = s.wd + nb * kHC * 9;
      float wt[2][9];
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int t = 0; t < 9; ++t) wt[half][t] = wd[(half * kGC + lane) * 9 + t];
      const bf16* hrow = s.hs + (py * T::SW) * kLdh + lane;
      float win[2][3][3];
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          win[half][dy][1] = to_f(hrow[(dy * T::SW + px0) * kLdh + half * kGC]);
          win[half][dy][2] = to_f(hrow[(dy * T::SW + px0 + 1) * kLdh + half * kGC]);
        }
#pragma unroll
      for (int i = 0; i < SEGW; ++i) {
        const int px = px0 + i;
        float sum[2];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float acc = 0.f;
#pragma unroll
          for (int dy = 0; dy < 3; ++dy) {
            win[half][dy][0] = win[half][dy][1];
            win[half][dy][1] = win[half][dy][2];
            win[half][dy][2] = to_f(hrow[(dy * T::SW + px + 2) * kLdh + half * kGC]);
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) acc = fmaf(win[half][dy][dx], wt[half][dy * 3 + dx], acc);
          }
          sum[half] = acc;
        }
        s.g[(py * TW + px) * kLdG + lane] = __float2bfloat16(gelu_erf(sum[0]) * sum[1]);
      }
    }
    __syncthreads();  // the gates are in G
    const uint32_t wb = nb * (NP * kLdG * 2);
    warp_mma_steps<T::MT2, NT2, 2>(a2, kLdG * 2, b2 + wb, b2s + wb, kLdG * 2, acc2);
  }
  cp_async_wait_all();  // no copy may outlive the block

  const int m0 = wm2 * 16 * T::MT2, c0 = wn2 * 8 * NT2;
  float* part = a.part + (long long)blockIdx.z * a.B * H * W * C;
  for_each_acc(acc2, [&](int r, int c, float v0, float v1) {
    const int m = m0 + r, n = c0 + c, gy = ty0 + m / TW, gx = tx0 + m % TW;
    if (n >= C || gy >= H || gx >= W) return;
    const long long i = ((long long)(b * H + gy) * W + gx) * C + n;
    if (a.nsplit == 1) {
      const float2 xv = load2(a.x + i);
      store2(a.out + i, xv.x + v0, xv.y + v1);
    } else {
      *reinterpret_cast<float2*>(part + i) = make_float2(v0, v1);
    }
  });
}

// out = x + (part[0] + part[1] + ... + part[S - 1]), 8 channels a thread,
// the slots summed in order, rounded once to bf16.
__global__ void __launch_bounds__(kThreads) split_sum_kernel(const bf16* x, const float* part,
                                                             bf16* out, long long n8,
                                                             int nsplit) {
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < n8;
       i += (long long)gridDim.x * kThreads) {
    float acc[8];
    for (int k = 0; k < nsplit; ++k) {
      const float4* p = reinterpret_cast<const float4*>(part + (k * n8 + i) * 8);
      const float4 u = p[0], v = p[1];
      const float t[8] = {u.x, u.y, u.z, u.w, v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = k ? acc[j] + t[j] : t[j];
    }
    const uint4 xv = reinterpret_cast<const uint4*>(x)[i];
    const __nv_bfloat162* xh = reinterpret_cast<const __nv_bfloat162*>(&xv);
    uint4 o;
    __nv_bfloat162* oh = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(xh[j]);
      oh[j] = __floats2bfloat162_rn(f.x + acc[2 * j], f.y + acc[2 * j + 1]);
    }
    reinterpret_cast<uint4*>(out)[i] = o;
  }
}

// The W1 ring's stages and W2's buffers of an instantiation: 2 stages while
// a chunk may be one piece (16 KS >= C), W2 single-buffered at the 4 x 8
// tile (C > 640, for shared memory); two blocks an SM at the 8 x 8 tile
// where the accumulators need at most 64 registers.
template <int TH, int TW, int NT2, int KS>
struct FusedConfig {
  using T = FusedTile<TH, TW>;
  static constexpr int NP = T::WN2 * 8 * NT2;
  static constexpr int NS = NP <= 64 ? 2 : 4;
  static constexpr int NB = TH == 4 ? 1 : 2;
  static constexpr int MINB = TH == 8 && T::MT1 * T::NT1 * 4 + T::MT2 * NT2 * 4 <= 64 ? 2 : 1;
  using Smem = FusedSmem<TH, TW, NT2, KS, NS, NB>;
};

// KS of the instantiation at NT2 = nt and width C (see launch_fused).
inline int fused_ks(int nt, int C) { return nt <= 2 ? 3 : (nt == 3 && C % 64) ? 5 : 4; }

template <int TH, int TW, int NT2, int KS>
int launch_fused_at(const FusedArgs& a, long long smem, cudaStream_t stream) {
  using F = FusedConfig<TH, TW, NT2, KS>;
  const int P = (a.C + 16 * KS - 1) / (16 * KS), nk = a.Fp / kGC;
  if (smem != F::Smem::bytes(a.C) || F::NS > F::NB * P || a.nsplit < 1 || a.nsplit > nk ||
      a.C > F::NP)
    return cudaErrorInvalidValue;
  constexpr auto kernel = ln_gdfn_tc_kernel<TH, TW, NT2, KS, F::NS, F::NB, F::MINB>;
  cudaError_t err = allow_smem_once<kernel>();
  if (err != cudaSuccess) return err;
  const int tiles = ((a.H + TH - 1) / TH) * a.tiles_w;
  kernel<<<dim3(tiles, a.B, a.nsplit), kThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.nsplit == 1) return err;
  const long long n8 = (long long)a.B * a.H * a.W * a.C / 8;
  const long long want = (n8 + kThreads - 1) / kThreads;
  const int blocks = want < 4096 ? (int)want : 4096;
  split_sum_kernel<<<blocks, kThreads, 0, stream>>>(a.x, a.part, a.out, n8, a.nsplit);
  return cudaGetLastError();
}

// The instantiations (th, tw, NT2, KS): the 8 x 8 tile up to C = 384 with
// NT2 = ceil(C / 64) output tiles a warp, the 4 x 8 tile from 641 to 768;
// KS, the k16 steps of a W1 piece, such that the widths served and trained
// (48, 96, 160, 192, 320, 384, 704) take whole pieces of the fewest
// barriers: 3 up to C = 128 (48 and 96), 5 at 129-192 unless C is a
// multiple of 64 (160), 4 else (192 and above). Another tile or width:
// cudaErrorInvalidValue.
#define PK_FUSED(TH, TW, NT, KS) \
  if (th == TH && tw == TW && nt == NT && ks == KS) \
    return launch_fused_at<TH, TW, NT, KS>(a, smem, stream);

int launch_fused(const FusedArgs& a, int th, int tw, long long smem, cudaStream_t stream) {
  const int nt = (a.C + 63) / 64, ks = fused_ks(nt, a.C);
  PK_FUSED(8, 8, 1, 3) PK_FUSED(8, 8, 2, 3) PK_FUSED(8, 8, 3, 5) PK_FUSED(8, 8, 3, 4)
  PK_FUSED(8, 8, 4, 4) PK_FUSED(8, 8, 5, 4) PK_FUSED(8, 8, 6, 4) PK_FUSED(4, 8, 11, 4)
  PK_FUSED(4, 8, 12, 4)
  return cudaErrorInvalidValue;
}
#undef PK_FUSED

}  // namespace

// Returns the CUDA error code of the launches (0 on success). float32: `smem`
// is ln_gdfn_a's shared-memory bytes (the wrapper checks the fit), `hid`
// (B, H, W, 2F) its hidden tensor. bf16: w1, wdw and w2 are the packed
// copies, (th, tw) the tile and nsplit the gate-chunk split of the plan
// (ops/cuda/gdfn.py:ln_gdfn_plan), `smem` its shared-memory bytes, which
// must be what the kernel carves (else cudaErrorInvalidValue, as for a tile
// or width without an instantiation), and `hid` the (S, B, H, W, C) fp32
// partial sums when nsplit > 1.
extern "C" int ln_gdfn_launch(int dtype, const void* x, const void* lnw, const void* lnb,
                              const void* w1, const void* wdw, const void* w2, void* hid,
                              void* out, int B, int H, int W, int C, int F, int bias_free,
                              float eps, int th, int tw, int nsplit, long long smem,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    if (th < 1 || tw < 1) return cudaErrorInvalidValue;
    FusedArgs a;
    a.x = static_cast<const bf16*>(x); a.lnw = static_cast<const bf16*>(lnw);
    a.lnb = static_cast<const bf16*>(lnb); a.w1p = static_cast<const bf16*>(w1);
    a.wdwp = static_cast<const float*>(wdw); a.w2p = static_cast<const bf16*>(w2);
    a.out = static_cast<bf16*>(out); a.part = static_cast<float*>(hid);
    a.B = B; a.H = H; a.W = W; a.C = C; a.Fp = (F + kGC - 1) / kGC * kGC;
    a.bias_free = bias_free; a.nsplit = nsplit; a.tiles_w = (W + tw - 1) / tw; a.eps = eps;
    return launch_fused(a, th, tw, smem, s);
  }
  if (dtype == kF32) {
    LnGdfnArgs a;
    a.x = x; a.lnw = lnw; a.lnb = lnb; a.w1 = w1; a.hid = hid;
    a.B = B; a.H = H; a.W = W; a.C = C; a.F = F; a.bias_free = bias_free; a.eps = eps;
    return launch<float>(a, wdw, w2, out, (size_t)smem, s);
  }
  return cudaErrorInvalidValue;
}
