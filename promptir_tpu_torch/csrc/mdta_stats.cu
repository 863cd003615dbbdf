// MDTA statistics pass: LN1 -> 1x1 qkv (C -> 3C) -> depthwise 3x3, writing v
// and the whole-image Gram S = q^T k and squared norms of q and k per head.
//
// Replaces promptir_tpu/ops/pallas/mdta.py:317 mdta_stats (body _kernel_a,
// stats_stripe). There the grid ran in order over row stripes of all heads
// and carried the Gram in VMEM from one step to the next. Here a block takes
// all heads of a spatial tile, as the stripe did: x comes into shared memory
// once, 16 bytes a cp.async copy, LN1 is computed once a pixel from it and
// its output Y replaces x in place, and the block then walks the heads, each
// through the qkv product of its 3d rows of W_qkv, the taps and its share of
// the statistics. Hopper blocks run in no order, so each block is
// persistent: block `slot` of image b walks the tiles slot, slot + nslots,
// ... (about one block an SM over all images, ops/cuda/mdta.py:stats_plan),
// keeps its running sums in shared memory across them and writes one slot
// at the end; slot_sum_kernel then sums the slots in slot order. No atomics:
// two launches give the same bits.
//
// Two routes, chosen by ops/cuda/mdta.py:stats_route from (C, heads):
//   narrow (every head's d x d sums and norms fit the block: d = 48 up to
//     C = 384, d = 96 at C = 96, d = 40 at C = 160): the block also takes
//     the Gram of each tile and head from q and k in shared memory (rounded
//     to bf16 on the tensor cores, fp32 on SIMT) into its running sums;
//   wide (d = 80 at C = 320, d = 176 at C = 704 and every one-head width
//     from 160): the pass writes q and k of every pixel to device memory, in
//     the dtype that enters the Gram (bf16, or fp32), and sums only the
//     norms; the Gram stage then takes q^T k over all pixels of each head:
//     in bf16 mdta_gram.cu's gram_tc_kernel (wgmma, TMA, the slices summed
//     inside its one launch), in float32 gram_kernel here over a few pixel
//     slices, each slice's output tile held in registers across its pixels,
//     and slot_sum_kernel sums the slices. This
//     departs from the Pallas kernel, where q and k never reach memory: at B4
//     (32, 32, 704, 1) they are 11.5 MB in bf16, written and read once,
//     where a per-tile partial Gram of d^2 fp32 through device memory moved
//     764 MB, and the tile no longer has to hold the Gram's operands.
//
// The bf16 route (stats_tc_kernel, templated on the tile): LN1 with one to
// four threads a pixel; the qkv product on the tensor cores (mma.sync
// m16n8k16 from ldmatrix) in passes of 64 qkv rows (128 for the small
// tiles), W_qkv resident in shared memory up to C = 96, else streamed in
// 64-deep chunks through a ring of 3-4 cp.async stages that runs on across
// passes and heads, one barrier a chunk (32-deep chunks of 64 rows spent
// ~1400 cycles each at C = 384 and 704, PERF.md); each pass's fp32 output
// goes to `pre`, whose taps (two channels a thread, a 3 x 3 window of
// float2 in registers, the tile's row unrolled) write v, round q and k to
// bf16 for the Gram and sum their unrounded squares; the Gram of the
// rounded q and k (pixel-major, read through ldmatrix.trans) on the tensor
// cores. The float32 route
// (stats_kernel): the SIMT tile (common.cuh:gemm_tile) through
// mdta_stats.cuh:stats_head, LN1's statistics once a tile and pixel, q and k
// fp32.
//
// Bound on the H100. Per pixel the function does about 6C^2 + 2Cd
// operations against 2C stored values (x read, v written); in bf16 at 989
// TFLOP/s and 3.35 TB/s the traffic bounds C <= 160 and the operations C >=
// 192 (chip_smoke.py prints which for every shape). A tile recomputes the
// product and taps on its 1-pixel halo ((th + 2)(tw + 2) / (th tw): 1.31x at
// 14 x 14, 1.52x at 14 x 6, 1.78x at 6 x 6, 2x at 4 x 6) and, above C =
// 96, reads its heads' weights from L2 once a tile. With one block an SM
// (117-217 KB each at the served shapes) and its phases separated by
// barriers, the kernel is latency-bound, not near either bound (PERF.md).
//
// Dropped TPU workarounds: the W+2 / 128-lane padding, the packed-qk lanes,
// the w % 8 gates. Rounding points as the Pallas kernel and the plain version
// (ops/cuda/mdta.py:mdta_stats_plain): LN1's output rounded to x's dtype, qkv
// and the taps fp32, v rounded to x's dtype; in bf16 q and k enter the Gram
// rounded to bf16 while their norms sum the fp32 values, in fp32 both stay
// fp32.
#include "mdta_stats.cuh"

namespace {
using namespace pk;

constexpr int kKC = 64;            // k depth of one streamed weight chunk (bf16 route)
constexpr int kLdw = tc_ld(kKC);   // row stride of a weight chunk

// The bf16 route's product passes: np qkv rows a pass (64 for the 256- and
// 128-row products, 128 for the 64- and 48-row ones, so that a weight chunk
// meets enough pixels), their chunks in a ring of `ring` stages, and the
// taps' row groups (two channels a thread).
__host__ __device__ constexpr int pass_rows(int M) { return M <= 64 ? 128 : 64; }
// Up to C = 96, at the 256- and 128-row tiles, all of W_qkv (at most 60 KB)
// stays in shared memory for the block's life instead of streaming through
// the ring: the product then takes no barrier inside a pass.
__host__ __device__ constexpr bool resident(int C, int M) { return C <= 96 && M >= 128; }
__host__ __device__ constexpr int ring_stages(int np) { return np == 64 ? 4 : 3; }
__host__ __device__ constexpr int tap_groups(int np) { return 2 * kThreads / np; }

struct StatsArgs {
  const void* x;     // (B, H, W, C) T
  const void* lnw;   // (C) T
  const void* lnb;   // (C) T, unused when bias_free
  const void* wqkv;  // (3C, C) T, torch's conv weight (out, in)
  const void* wdw;   // (3C, 9) T
  void* v;           // (B, H, W, C) T
  void* q;           // (B, H, W, C) T, the wide route (else null)
  void* k;
  float* part;       // (B, heads, nslots, sld): sld = d*d + 2d (narrow), 2d (wide)
  int B, H, W, C, heads, th, tw, tiles_w, tiles, nslots, bias_free, wide;
  float eps;
};

// Shared memory of stats_tc_kernel, piece by piece in the order it is carved
// (ops/cuda/mdta.py:stats_tc_smem mirrors it; every piece a multiple of 16
// bytes):
//   X     M x ldc bf16: x of the tile and its halo, then LN1's output in place
//         (M = the product's rows: 48, or ph rounded up to 64);
//   ring  `ring` chunks of np x kKC weights (bf16), or with `resident`
//         all of W_qkv, 3C + np rows of ldc bf16, head after head (each
//         head's q, k, v rows together) and np zero rows;
//   pre   ph x (np + 8) fp32: one pass's np qkv rows at every halo pixel;
//   Qs,Ks kp x ldqk bf16 each (narrow only): q and k of the interior pixels,
//         pixel-major, pixels rounded up to 16 and channels to tc_ld(d);
//   sums  heads x sld fp32: the block's running Gram and norms;
//   red   tap_groups x np fp32: the taps' partial norms.
struct TcCarve {
  int M, np, ldc, ph, pi, kp, ldqk, sld, x, ring, pre, qk, sums, red;
  bool res;
  __host__ __device__ TcCarve(int C, int th, int tw, int heads, int wide) {
    const int d = C / heads;
    ph = (th + 2) * (tw + 2);
    pi = th * tw;
    M = ph <= 48 ? 48 : (ph + 63) / 64 * 64;
    np = pass_rows(M);
    ldc = tc_ld(C);
    kp = (pi + 15) / 16 * 16;
    ldqk = tc_ld(d);
    sld = wide ? 2 * d : d * d + 2 * d;
    res = resident(C, M);
    x = M * ldc * 2;
    ring = res ? (3 * C + np) * ldc * 2 : ring_stages(np) * np * kLdw * 2;
    pre = ph * (np + 8) * 4;
    qk = wide ? 0 : 2 * kp * ldqk * 2;
    sums = heads * sld * 4;
    red = tap_groups(np) * np * 4;
  }
  __host__ __device__ int bytes() const { return x + ring + pre + qk + sums + red; }
};

// The float32 route: one block a slot of image blockIdx.y, all heads, its
// tiles' Grams and norms summed into its slot of `part` in device memory
// (stats_head: the slot's first tile writes, the rest add). Shared memory as
// in mdta_stats.cuh:StatsSmem: qk (pi x 2d), pre (ph x kTileN), the staging
// tiles, mean, rstd, pix (ops/cuda/mdta.py:stats_f32_smem).
template <class T>
__global__ void __launch_bounds__(kThreads) stats_kernel(StatsArgs a) {
  extern __shared__ float4 smem4[];
  const int slot = blockIdx.x, b = blockIdx.y;
  const int C = a.C, heads = a.heads, d = C / heads, th = a.th, tw = a.tw;
  const int ph = (th + 2) * (tw + 2), pi = th * tw;
  const int sld = a.wide ? 2 * d : d * d + 2 * d;
  const T* x = static_cast<const T*>(a.x);

  StatsSmem s;
  s.qk = reinterpret_cast<float*>(smem4);  // pi x 2d
  s.pre = s.qk + pi * 2 * d;               // ph x kTileN
  s.As = s.pre + ph * kTileN;
  s.Ws = s.As + kTileK * kLd;
  s.mean = s.Ws + kTileK * kLd;            // ph
  s.rstd = s.mean + ph;                    // ph
  s.pix = reinterpret_cast<int*>(s.rstd + ph);  // ph
  const T* lnw = static_cast<const T*>(a.lnw);
  const T* lnb = static_cast<const T*>(a.lnb);
  const auto ldx = [&](int, int pix, int c) -> float { return to_f(x[(long long)pix * C + c]); };
  // LN1 applied as the product stages x
  const auto ldy = [&](int hp, int c) -> float {
    const int pix = s.pix[hp];
    if (pix < 0) return 0.f;
    return ln1_value(ldx(hp, pix, c), s.mean[hp], s.rstd[hp], lnw, lnb, c, a.bias_free);
  };
  T* qo = static_cast<T*>(a.q);
  T* ko = static_cast<T*>(a.k);

  for (int tile = slot; tile < a.tiles; tile += a.nslots) {
    const StatsTile t{b, (tile / a.tiles_w) * th, (tile % a.tiles_w) * tw, th, tw, a.H, a.W, C};
    halo_ln_stats(ldx, t, a.eps, s);
    __syncthreads();
    for (int h = 0; h < heads; ++h) {
      float* out = a.part + ((long long)(b * heads + h) * a.nslots + slot) * sld;
      stats_head<T>(ldy, static_cast<const T*>(a.wqkv), static_cast<const T*>(a.wdw),
                    static_cast<T*>(a.v), out, tile == slot, h, heads, t, s, qo, ko);
    }
  }
}

__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 v = __bfloat1622float2(p[e]);
    f[2 * e] = v.x;
    f[2 * e + 1] = v.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  uint4 u;
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) p[e] = __floats2bfloat162_rn(f[2 * e], f[2 * e + 1]);
  return u;
}

// The warps of the qkv product of M rows by pass_rows(M) qkv rows.
template <int M> struct ProductShape;
template <> struct ProductShape<256> { static constexpr int WM = 4, MT = 4, NT = 4; };
template <> struct ProductShape<128> { static constexpr int WM = 4, MT = 2, NT = 4; };
template <> struct ProductShape<64> { static constexpr int WM = 2, MT = 2, NT = 4; };
template <> struct ProductShape<48> { static constexpr int WM = 1, MT = 3, NT = 2; };

// The bf16 route: one block a slot of image blockIdx.y, all heads (see the
// note above and TcCarve), on a TH x TW tile (compile-time, so that the
// taps' pixel loop unrolls); RES: W_qkv resident (TcCarve::res).
template <int TH, int TW, bool RES>
__global__ void __launch_bounds__(kThreads) stats_tc_kernel(StatsArgs a) {
  constexpr int HW = TW + 2, PH = (TH + 2) * HW;
  constexpr int MR = PH <= 48 ? 48 : (PH + 63) / 64 * 64;
  constexpr int WM = ProductShape<MR>::WM, MT = ProductShape<MR>::MT, NT = ProductShape<MR>::NT;
  using S = TcShape<WM, MT, NT>;
  constexpr int NP = S::NP, R = ring_stages(NP), TG = tap_groups(NP), PL = NP + 8;
  constexpr int STAGE = NP * kLdw, CP = NP * kKC / 8 / kThreads;  // 16-byte copies a thread
  static_assert(S::M == MR && NP == pass_rows(MR), "a pass is pass_rows(M) qkv rows");
  extern __shared__ float4 smem4[];
  const int slot = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int C = a.C, heads = a.heads, d = C / heads;
  constexpr int th = TH, tw = TW, hw = HW, ph = PH;
  const TcCarve m(C, th, tw, heads, a.wide);
  const int ldc = m.ldc, sld = m.sld, nrm_off = a.wide ? 0 : d * d;
  char* p = reinterpret_cast<char*>(smem4);
  bf16* X = reinterpret_cast<bf16*>(p);
  bf16* ring = reinterpret_cast<bf16*>(p += m.x);
  float* pre = reinterpret_cast<float*>(p += m.ring);
  bf16* Qs = reinterpret_cast<bf16*>(p += m.pre);
  bf16* Ks = Qs + m.kp * m.ldqk;
  float* sums = reinterpret_cast<float*>(p += m.qk);
  float* red = reinterpret_cast<float*>(p += m.sums);

  const bf16* x = static_cast<const bf16*>(a.x);
  const bf16* lnw = static_cast<const bf16*>(a.lnw);
  const bf16* lnb = static_cast<const bf16*>(a.lnb);
  const bf16* wqkv = static_cast<const bf16*>(a.wqkv);
  const bf16* wdw = static_cast<const bf16*>(a.wdw);
  bf16* v = static_cast<bf16*>(a.v);
  bf16* qo = static_cast<bf16*>(a.q);
  bf16* ko = static_cast<bf16*>(a.k);
  const int n3 = 3 * d, npass = (n3 + NP - 1) / NP, nk = (C + kKC - 1) / kKC, c8 = C / 8;
  const int warp = tid >> 5, wm = warp % WM, wn = warp / WM;
  const bf16* Aw = X + wm * 16 * MT * ldc;

  // X's padding rows and columns, Qs's and Ks's padding and the sums start
  // at zero; the tiles rewrite only the rest
  zero_smem(X, m.x);
  zero_smem(Qs, m.qk);
  zero_smem(sums, m.sums);
  if constexpr (RES) zero_smem(ring, m.ring);
  __syncthreads();
  if constexpr (RES) {
    // all of W_qkv once, head after head: row h * 3d + nn is the head's qkv
    // row nn (q: nn < d, k: nn < 2d, v)
    for (int e = tid; e < 3 * C * c8; e += kThreads) {
      const int r = e / c8, cc = (e - r * c8) * 8, hh = r / n3, nn = r - hh * n3;
      cp_async16(ring + r * ldc + cc, wqkv + (long long)((nn / d) * C + hh * d + nn % d) * C + cc,
                 true);
    }
    cp_async_commit();
  }

  // The weight stream of a tile: for each head and pass, its np rows of
  // W_qkv in chunks of kKC columns, in the order the product takes them.
  // A thread copies rows (tid / 8) + 32 j, 16 bytes at column (tid % 8) * 8
  // of the chunk; `src` holds those rows' starts for the pass being issued
  // (null past 3d); past the tile's last chunk it commits empty groups, so
  // that every step waits on the same count.
  int ih = 0, ipass = 0, ikc = 0;
  const bf16* src[CP];
  const auto rows_of = [&]() {
#pragma unroll
    for (int j = 0; j < CP; ++j) {
      const int nn = ipass * NP + (tid >> 3) + 32 * j;
      src[j] = nn < n3 ? wqkv + (long long)((nn / d) * C + ih * d + nn % d) * C : nullptr;
    }
  };
  const auto issue = [&](int stage) {
    if (ih < heads) {
      const int k = ikc * kKC + (tid & 7) * 8;
#pragma unroll
      for (int j = 0; j < CP; ++j) {
        const bool ok = src[j] != nullptr && k < C;
        cp_async16(ring + stage * STAGE + ((tid >> 3) + 32 * j) * kLdw + (tid & 7) * 8,
                   ok ? src[j] + k : wqkv, ok);
      }
      if (++ikc == nk) {
        ikc = 0;
        if (++ipass == npass) {
          ipass = 0;
          ++ih;
        }
        if (ih < heads) rows_of();
      }
    }
    cp_async_commit();
  };

  for (int tile = slot; tile < a.tiles; tile += a.nslots) {
    const int ty0 = (tile / a.tiles_w) * th, tx0 = (tile % a.tiles_w) * tw;
    // 1. x of the tile and its halo, 16 bytes a copy (zeros outside the
    //    image), and the first weight chunks behind it
    for (int e = tid; e < ph * c8; e += kThreads) {
      const int hp = e / c8, cc = (e - hp * c8) * 8;
      const int gy = ty0 - 1 + hp / hw, gx = tx0 - 1 + hp % hw;
      const bool in = gy >= 0 && gy < a.H && gx >= 0 && gx < a.W;
      cp_async16(X + hp * ldc + cc, in ? x + ((long long)(b * a.H + gy) * a.W + gx) * C + cc : x,
                 in);
    }
    cp_async_commit();
    if constexpr (RES) {
      cp_async_wait<0>();
    } else {
      ih = ipass = ikc = 0;
      rows_of();
      for (int i = 0; i < R - 1; ++i) issue(i);
      cp_async_wait<R - 1>();
    }
    __syncthreads();

    // 2. LN1 in place, two-pass fp32 statistics, TPP threads a pixel (each
    //    every TPP-th 8 channels, their sums combined by shuffles); pixels
    //    outside the image stay zero (their qkv is the taps' zero padding)
    constexpr int TPP = MR >= 256 ? 1 : MR >= 128 ? 2 : 4;
    if (tid < ph * TPP) {
      const int hp = tid / TPP, part = tid % TPP;
      const int gy = ty0 - 1 + hp / hw, gx = tx0 - 1 + hp % hw;
      const bool in = gy >= 0 && gy < a.H && gx >= 0 && gx < a.W;
      uint4* row = reinterpret_cast<uint4*>(X + hp * ldc);
      float f[8], sum = 0.f;
      for (int j = part; in && j < c8; j += TPP) {
        unpack8(row[j], f);
#pragma unroll
        for (int e = 0; e < 8; ++e) sum += f[e];
      }
#pragma unroll
      for (int o = 1; o < TPP; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float mean = sum / C;
      float sq = 0.f;
      for (int j = part; in && j < c8; j += TPP) {
        unpack8(row[j], f);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float u = f[e] - mean;
          sq = fmaf(u, u, sq);
        }
      }
#pragma unroll
      for (int o = 1; o < TPP; o <<= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
      const float rstd = 1.f / sqrtf(sq / C + a.eps);
      for (int j = part; in && j < c8; j += TPP) {
        unpack8(row[j], f);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          f[e] = ln1_value(f[e], mean, rstd, lnw, lnb, j * 8 + e, a.bias_free);
        row[j] = pack8(f);
      }
    }
    __syncthreads();

    // 3. each head: its qkv rows in passes of NP, each pass's taps, then
    //    (narrow) its Gram
    int step = 0;
    for (int h = 0; h < heads; ++h) {
      for (int pass = 0; pass < npass; ++pass) {
        // this thread's two tap channels of the pass (rows n0 + n, n0 + n +
        // 1 of the head's 3d) and their taps, loaded before the product
        const int n0 = pass * NP, g = tid / (NP / 2), n = 2 * (tid % (NP / 2)), nn = n0 + n;
        const int sec = nn / d, ch = nn - sec * d, row = sec * C + h * d + ch;
        float2 wt[9];
#pragma unroll
        for (int t9 = 0; t9 < 9; ++t9)
          wt[t9] = nn < n3 ? make_float2(to_f(wdw[row * 9 + t9]), to_f(wdw[(row + 1) * 9 + t9]))
                           : make_float2(0.f, 0.f);
        float acc[MT][NT][4];
        zero_acc(acc);
        if constexpr (RES) {
          const bf16* B = ring + (h * n3 + pass * NP + wn * 8 * NT) * ldc;
          for (int k = 0; k < C; k += 16) warp_mma_k16<MT, NT>(Aw + k, ldc, B + k, ldc, acc);
        } else {
          for (int kc = 0; kc < nk; ++kc, ++step) {
            cp_async_wait<R - 2>();
            __syncthreads();  // chunk `step` landed for all; the previous stage is free
            issue((step + R - 1) % R);
            const bf16* B = ring + (step % R) * STAGE + wn * 8 * NT * kLdw;
#pragma unroll
            for (int s16 = 0; s16 < kKC; s16 += 16)
              if (kc * kKC + s16 < C)
                warp_mma_k16<MT, NT>(Aw + kc * kKC + s16, ldc, B + s16, kLdw, acc);
          }
        }
        const int m0 = wm * 16 * MT, c0 = wn * 8 * NT;
        for_each_acc(acc, [&](int r, int c, float v0, float v1) {
          if (m0 + r < ph)
            *reinterpret_cast<float2*>(pre + (m0 + r) * PL + c0 + c) = make_float2(v0, v1);
        });
        __syncthreads();  // pre is complete

        // the taps of rows n0 .. n0 + NP - 1: two channels a thread, every
        // TG-th tile row, a 3 x 3 window of pre in registers
        float nrm0 = 0.f, nrm1 = 0.f;
        if (nn < n3) {
          bf16* qk = sec ? Ks : Qs;
          bf16* qkg = sec ? ko : qo;
          for (int iy = g; iy < th; iy += TG) {
            const float* pr = pre + iy * hw * PL + n;
            float2 win[3][3];
#pragma unroll
            for (int dy = 0; dy < 3; ++dy) {
              win[dy][1] = *reinterpret_cast<const float2*>(pr + dy * hw * PL);
              win[dy][2] = *reinterpret_cast<const float2*>(pr + (dy * hw + 1) * PL);
            }
            const int gy = ty0 + iy;
#pragma unroll
            for (int ix = 0; ix < tw; ++ix) {
#pragma unroll
              for (int dy = 0; dy < 3; ++dy) {
                win[dy][0] = win[dy][1];
                win[dy][1] = win[dy][2];
                win[dy][2] = *reinterpret_cast<const float2*>(pr + (dy * hw + ix + 2) * PL);
              }
              float a0 = 0.f, a1 = 0.f;
#pragma unroll
              for (int dy = 0; dy < 3; ++dy)
#pragma unroll
                for (int dx = 0; dx < 3; ++dx) {
                  a0 = fmaf(win[dy][dx].x, wt[dy * 3 + dx].x, a0);
                  a1 = fmaf(win[dy][dx].y, wt[dy * 3 + dx].y, a1);
                }
              const int gx = tx0 + ix;
              const bool valid = gy < a.H && gx < a.W;
              const long long o = ((long long)(b * a.H + gy) * a.W + gx) * C + h * d + ch;
              if (sec == 2) {
                if (valid) store2(v + o, a0, a1);
              } else {
                const float u0 = valid ? a0 : 0.f, u1 = valid ? a1 : 0.f;
                if (a.wide) {
                  if (valid) store2(qkg + o, u0, u1);
                } else {
                  store2(qk + (iy * tw + ix) * m.ldqk + ch, u0, u1);
                }
                nrm0 = fmaf(u0, u0, nrm0);
                nrm1 = fmaf(u1, u1, nrm1);
              }
            }
          }
        }
        *reinterpret_cast<float2*>(red + g * NP + n) = make_float2(nrm0, nrm1);
        __syncthreads();  // red, and this pass's q and k, are complete
        if (tid < NP && n0 + tid < 2 * d) {
          float s = 0.f;
#pragma unroll
          for (int gg = 0; gg < TG; ++gg) s += red[gg * NP + tid];
          sums[h * sld + nrm_off + n0 + tid] += s;
        }
      }
      if (!a.wide) {
        // the tile's Gram of head h on the tensor cores, a warp task 16 rows
        // by 48 columns (d = 40, 48 and 96 rounded up to 48), added to the
        // running sums (each sum by one thread)
        const int ti = (d + 15) / 16, tj = (d + 47) / 48;
        for (int tt = warp; tt < ti * tj; tt += kThreads / 32) {
          const int i0 = (tt / tj) * 16, j0 = (tt % tj) * 48;
          float acc[1][6][4];
          zero_acc(acc);
          for (int k = 0; k < m.kp; k += 16)
            warp_mma_t_k16<1, 6>(Qs + k * m.ldqk + i0, m.ldqk, Ks + k * m.ldqk + j0, m.ldqk, acc);
          for_each_acc(acc, [&](int r, int c, float v0, float v1) {
            const int i = i0 + r, j = j0 + c;
            if (i >= d || j >= d) return;
            float* o = sums + h * sld + i * d + j;
            o[0] += v0;
            o[1] += v1;
          });
        }
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < heads * sld; e += kThreads) {
    const int h = e / sld, r = e - h * sld;
    a.part[((long long)(b * heads + h) * a.nslots + slot) * sld + r] = sums[e];
  }
}

// ---------------------------------------------------------------- the Gram

// The wide route's float32 Gram: part[b, h, slice] = q_h^T k_h over the
// slice's pixels, q and k pixel-major (B, P, C). One block a 64 x 64 output
// tile of one slice of one (image, head); grid (tiles^2, slices, B * heads).
// The bf16 Gram is mdta_gram.cu's gram_tc_kernel (one launch, no slices
// through device memory).
struct GramArgs {
  const void* q;
  const void* k;
  float* part;  // (B, heads, slices, d*d)
  int P, C, heads, tiles, slices, span;
};

constexpr int kGT = 64;          // output tile
constexpr int kGK = 64;          // pixels a slice comes in multiples of

// float32 on SIMT: the same tiles through gemm_tile, the pixels its k.
__global__ void __launch_bounds__(kThreads) gram_kernel(GramArgs a) {
  __shared__ float As[kTileK * kLd], Ws[kTileK * kLd];
  const int d = a.C / a.heads, bh = blockIdx.z, b = bh / a.heads, h = bh % a.heads;
  const int i0 = (blockIdx.x / a.tiles) * kGT, j0 = (blockIdx.x % a.tiles) * kGT;
  const int p0 = blockIdx.y * a.span, p1 = min(a.P, p0 + a.span);
  const float* q = static_cast<const float*>(a.q) + ((long long)b * a.P + p0) * a.C + h * d;
  const float* k = static_cast<const float*>(a.k) + ((long long)b * a.P + p0) * a.C + h * d;
  float acc[4][4];
  gemm_tile<4>(
      max(p1 - p0, 0),
      [&](int kk, int p) -> float { return i0 + p < d ? q[(long long)kk * a.C + i0 + p] : 0.f; },
      [&](int kk, int n) -> float { return j0 + n < d ? k[(long long)kk * a.C + j0 + n] : 0.f; },
      As, Ws, acc);
  float* out = a.part + ((long long)bh * a.slices + blockIdx.y) * d * d;
  const int ng = threadIdx.x & 15, pg = threadIdx.x >> 4;
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int i = i0 + pg + 16 * ii, j = j0 + ng + 16 * jj;
      if (i < d && j < d) out[i * d + j] = acc[ii][jj];
    }
}

template <class K>
int launch_stats(K kernel, const StatsArgs& a, size_t smem, cudaStream_t stream) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.nslots, a.B), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Bytes of dynamic shared memory that the stats pass carves for a th x tw
// tile (ops/cuda/mdta.py:stats_smem computes the same; the wrapper checks).
extern "C" long long mdta_stats_smem(int dtype, int th, int tw, int C, int heads, int wide) {
  if (dtype == kBF16) return TcCarve(C, th, tw, heads, wide).bytes();
  const int d = C / heads, ph = (th + 2) * (tw + 2), pi = th * tw;
  return (long long)(pi * 2 * d + ph * kTileN + 2 * kTileK * kLd + 2 * ph) * 4 + ph * 4;
}

// The stats pass and the sum of its slots into `stats` (B, heads, d*d + 2d):
// the whole row (narrow), or the norms at d*d (wide; mdta_gram_launch fills
// the Gram). Returns the CUDA error code of the launches (0 on success).
extern "C" int mdta_stats_launch(int dtype, const void* x, const void* lnw, const void* lnb,
                                 const void* wqkv, const void* wdw, void* v, void* q, void* k,
                                 float* part, float* stats, int B, int H, int W, int C, int heads,
                                 int th, int tw, int nslots, int bias_free, int wide, float eps,
                                 long long smem, void* stream) {
  StatsArgs a;
  a.x = x; a.lnw = lnw; a.lnb = lnb; a.wqkv = wqkv; a.wdw = wdw; a.v = v; a.part = part;
  a.q = wide ? q : nullptr;
  a.k = wide ? k : nullptr;
  a.B = B; a.H = H; a.W = W; a.C = C; a.heads = heads; a.th = th; a.tw = tw;
  a.tiles_w = (W + tw - 1) / tw;
  a.tiles = ((H + th - 1) / th) * a.tiles_w;
  a.nslots = nslots; a.bias_free = bias_free; a.wide = wide; a.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t sm = static_cast<size_t>(smem);
  const int d = C / heads;
  int err = cudaErrorInvalidValue;
  if (dtype == kF32) err = launch_stats(stats_kernel<float>, a, sm, s);
  // the tiles of ops/cuda/mdta.py:STATS_TILES, whose halos fill products of
  // 256, 128, 64 and 48 rows; W_qkv resident up to C = 96 at the first two
  else if (dtype == kBF16 && th == 14 && tw == 14)
    err = C <= 96 ? launch_stats(stats_tc_kernel<14, 14, true>, a, sm, s)
                  : launch_stats(stats_tc_kernel<14, 14, false>, a, sm, s);
  else if (dtype == kBF16 && th == 14 && tw == 6)
    err = C <= 96 ? launch_stats(stats_tc_kernel<14, 6, true>, a, sm, s)
                  : launch_stats(stats_tc_kernel<14, 6, false>, a, sm, s);
  else if (dtype == kBF16 && th == 6 && tw == 6)
    err = launch_stats(stats_tc_kernel<6, 6, false>, a, sm, s);
  else if (dtype == kBF16 && th == 4 && tw == 6)
    err = launch_stats(stats_tc_kernel<4, 6, false>, a, sm, s);
  if (err != cudaSuccess) return err;
  const int n = wide ? 2 * d : d * d + 2 * d;
  return launch_slot_sum(part, stats, B * heads, nslots, n, d * d + 2 * d, wide ? d * d : 0, s);
}

// The wide route's float32 Gram q^T k of each head over `slices` pixel
// slices into part (B, heads, slices, d*d), then their sum into
// stats[..., :d*d]. (bf16: mdta_gram.cu:mdta_gram_tc_launch.)
extern "C" int mdta_gram_launch(int dtype, const void* q, const void* k, float* part,
                                float* stats, int B, int P, int C, int heads, int slices,
                                void* stream) {
  if (dtype != kF32) return cudaErrorInvalidValue;
  GramArgs a;
  const int d = C / heads;
  a.q = q; a.k = k; a.part = part; a.P = P; a.C = C; a.heads = heads; a.slices = slices;
  a.tiles = (d + kGT - 1) / kGT;
  a.span = ((P + slices - 1) / slices + kGK - 1) / kGK * kGK;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  gram_kernel<<<dim3(a.tiles * a.tiles, slices, B * heads), kThreads, 0, s>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_slot_sum(part, stats, B * heads, slices, d * d, d * d + 2 * d, 0, s);
}
