// Block n's tail and block n+1's stats pass, with block n's output x3 kept
// in shared memory for the stats instead of being read back from device
// memory:
//   x3 = block_tail(v, x, attn) of block n;
//   v2, Gram, norms = mdta_stats(x3) of block n+1.
//
// Replaces promptir_tpu/ops/pallas/megablock.py:165 fused_tail_stats_padded
// (body _merged_kernel). The TPU kernel ran row stripes in order and let the
// stats lag one stripe behind the tail, holding the previous stripe in a
// rolling VMEM scratch, with one extra program per image for the last
// stripe. Hopper blocks run in no order, so nothing can lag: each block owns
// a spatial tile and recomputes x3 on a 1-pixel ring around it, which its
// neighbours compute too. Three launches:
//   tail_a (block_tail.cuh, unchanged): x2 and the hidden h of block n;
//   tail_stats_kernel, one block a slot of an image, walking the tiles
//     slot, slot + nslots, ...; per tile:
//     1. the W2 product at every ring pixel, in chunks of 32 gate channels:
//        h of the chunk is staged on a 2-pixel ring in shared memory, each
//        gate computed once (gdfn.cuh:gdfn_gate) and multiplied into all C
//        outputs, whose fp32 sums stay in shared memory between chunks;
//     2. x3 = x2 + that product, rounded through T; the interior written
//        out, the ring kept;
//     3. block n+1's stats pass from shared memory (mdta_stats.cuh): LN1
//        once per tile, in place of x3, then for each head its qkv rows,
//        the taps, v2 written out and the partial Gram and norms added to
//        the head's slot;
//   slot_sum_kernel (mdta_stats.cuh): the slots summed in slot order
//   (deterministic).
// Every x3 output sums its products in gdfn_out's order (gemm_tile's: k
// ascending, the last chunk padded with zeros), so x3 equals block_tail's
// output bit for bit, and v2 mdta_stats's on it; the Gram sums the same
// products in another order.
//
// Bound on the H100: the two functions' operations (about 15 C^2 MACs a
// pixel) against v and x read and x3 and v2 written, one read of x3 fewer
// than the two kernels apart. In bf16 the operations are the bound from
// C = 96 (chip_smoke.py:megablock_bound prints it per forward). Both routes
// still write and read back h (and x2) as block_tail does, and the ring
// costs (th + 2)(tw + 2) / (th tw) of the W2 and qkv products.
// The float32 route (tail_stats_kernel, described above): SIMT FMAs, W2's
// sums in shared memory between gate chunks, fp32 x3; the largest tile of
// 8 x 8 / 6 x 6 / 4 x 6 whose shared memory (MergedSmem) lets two blocks
// share an SM, as a SIMT block is latency-bound alone.
// The bf16 route (tail_stats_tc_kernel, below): every product on the tensor
// cores; W2's sums in registers over all gate chunks (gdfn.cuh:gdfn_w2, the
// routine of block_tail's gdfn_out_tc, so x3 stays bit-exact), x3 in bf16;
// tiles of 14 x 14 / 6 x 14 / 6 x 6 whose ring fills the product's 256 /
// 128 / 64 rows (ring cost 1.31x / 1.52x / 1.78x), one block an SM (96
// accumulator registers a thread); the stats pass on the tensor cores too
// (mdta_stats.cuh:stats_head_tc). Per serving forward it is about as fast
// as block_tail + mdta_stats apart (PERF.md): what the ring recomputes now
// costs what the saved read of x3 gives back.
//
// Dropped TPU workarounds: the stripe lag and its rolling scratch, the extra
// program per image, the clamped index maps, the W+2 / 128-lane padding.
#include "block_tail.cuh"
#include "mdta_stats.cuh"

namespace {
using namespace pk;

struct TailStatsArgs {
  TailArgs tail;      // block n: tail_a's arguments (x2 and hid are written)
  const void* ln1w;   // (C) T, block n+1
  const void* ln1b;   // (C) T, unused when bias_free
  const void* wqkv;   // (3C, C) T
  const void* wdwa;   // (3C, 9) T
  void* x3;           // (B, H, W, C) T
  void* v2;           // (B, H, W, C) T
  float* part;        // (B, heads2, nslots, d*d + 2d)
  int heads2, th, tw, tiles_w, tiles, nslots;
};

constexpr int kKC = kTileK;  // gate channels of one chunk of the W2 product

// Floats of the merged block's shared memory, in the order tail_stats_kernel
// carves them (ops/cuda/megablock.py:tail_stats_smem mirrors this):
//   x3    ph x C   x3 on the tile and its ring, then LN1's output in place;
//   mean, rstd, pix  ph each (pix as int32), rounded up to a multiple of 4;
//   then one scratch area, used first by the W2 product:
//     hc  64 x ldh   h of the chunk's 32 gate channels and their 32 partners
//                    on the tile and a 2-pixel ring (ldh = rp, made odd);
//     wc  64 x 9     their depthwise weights;
//     G   kKC x ph   the chunk's gated values at the ring pixels;
//     Ws  kKC x kLd  one chunk of W2;
//   and then by the stats pass: qk (pi x 2d), pre (ph x kTileN), As, Ws.
struct MergedSmem {
  int ph, pi, rp, ldh, head, p1, p2;
  __host__ __device__ MergedSmem(int th, int tw, int C, int d) {
    ph = (th + 2) * (tw + 2);
    pi = th * tw;
    rp = (th + 4) * (tw + 4);
    ldh = rp | 1;
    head = (ph * C + 3 * ph + 3) / 4 * 4;
    p1 = 64 * ldh + 64 * 9 + kKC * ph + kKC * kLd;
    p2 = pi * 2 * d + ph * kTileN + 2 * kTileK * kLd;
  }
  __host__ __device__ int floats() const { return head + (p1 > p2 ? p1 : p2); }
};

// One block: slot blockIdx.x of image blockIdx.y, all heads of block n+1.
template <class T>
__global__ void __launch_bounds__(kThreads) tail_stats_kernel(TailStatsArgs a) {
  extern __shared__ float4 smem4[];
  const TailArgs& ta = a.tail;
  const int slot = blockIdx.x, b = blockIdx.y;
  const int C = ta.C, F = ta.F, H = ta.H, W = ta.W, heads = a.heads2, d = C / heads;
  const int th = a.th, tw = a.tw, hw = tw + 2, rw = tw + 4;
  const MergedSmem m(th, tw, C, d);
  const int ph = m.ph, pi = m.pi, ldh = m.ldh;
  const T* hid = static_cast<const T*>(ta.hid);
  const T* wdw = static_cast<const T*>(ta.wdw);
  const T* w2 = static_cast<const T*>(ta.w2);
  const T* x2 = static_cast<const T*>(ta.x2);
  const T* ln1w = static_cast<const T*>(a.ln1w);
  const T* ln1b = static_cast<const T*>(a.ln1b);
  T* x3 = static_cast<T*>(a.x3);

  float* x3a = reinterpret_cast<float*>(smem4);  // ph x C
  StatsSmem s;
  s.mean = x3a + ph * C;
  s.rstd = s.mean + ph;
  s.pix = reinterpret_cast<int*>(s.rstd + ph);
  float* scratch = x3a + m.head;
  float* hc = scratch;      // phase 1
  float* wc = hc + 64 * ldh;
  float* G = wc + 64 * 9;
  float* Ws1 = G + kKC * ph;
  s.qk = scratch;           // phase 2
  s.pre = s.qk + pi * 2 * d;
  s.As = s.pre + ph * kTileN;
  s.Ws = s.As + kTileK * kLd;
  const int tid = threadIdx.x, ng = tid & 15, pg = tid >> 4;

  for (int tile = slot; tile < a.tiles; tile += a.nslots) {
    const int ty0 = (tile / a.tiles_w) * th, tx0 = (tile % a.tiles_w) * tw;

    // 1. the W2 product W2 gate(h) at every ring pixel, accumulated in x3a
    //    one chunk of kKC gate channels at a time: each gate is computed once
    //    per tile, from h staged in shared memory. Every output sums its
    //    products in gemm_tile's order (k ascending, the last chunk padded
    //    with zeros), so x3 equals gdfn_out's bit for bit.
    for (int k0 = 0; k0 < F; k0 += kKC) {
      for (int e = tid; e < m.rp * 64; e += kThreads) {
        const int j = e & 63, q = e >> 6;  // 32 channels of each half, per pixel
        const int gy = ty0 - 2 + q / rw, gx = tx0 - 2 + q % rw, k = k0 + (j & 31);
        const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W && k < F;
        hc[j * ldh + q] =
            ok ? to_f(hid[((long long)(b * H + gy) * W + gx) * (2 * F) + (j >> 5) * F + k]) : 0.f;
      }
      for (int e = tid; e < 64 * 9; e += kThreads) {
        const int j = e / 9, k = k0 + (j & 31);
        wc[e] = k < F ? to_f(wdw[((j >> 5) * F + k) * 9 + e % 9]) : 0.f;
      }
      __syncthreads();
      for (int e = tid; e < kKC * ph; e += kThreads) {
        const int kk = e / ph, hp = e % ph, ry = hp / hw, rx = hp % hw;
        const int gy = ty0 - 1 + ry, gx = tx0 - 1 + rx;
        float g = 0.f;
        if (k0 + kk < F && gy >= 0 && gy < H && gx >= 0 && gx < W)
          g = gdfn_gate<T>(
              [&](int yy, int xx, int half) -> float {
                return hc[(half * 32 + kk) * ldh + (yy - ty0 + 2) * rw + xx - tx0 + 2];
              },
              [&](int half, int t) -> float { return wc[(half * 32 + kk) * 9 + t]; }, H, W, gy,
              gx);
        G[kk * ph + hp] = g;
      }
      for (int n0 = 0; n0 < C; n0 += kTileN) {
        for (int e = tid; e < kKC * kTileN; e += kThreads) {
          const int k = e % kKC, n = e / kKC;
          Ws1[k * kLd + n] =
              (n0 + n < C && k0 + k < F) ? to_f(w2[(long long)(n0 + n) * F + k0 + k]) : 0.f;
        }
        __syncthreads();
        for (int p0 = 0; p0 < ph; p0 += 16 * kMP) {
          float acc[kMP][4];
#pragma unroll
          for (int i = 0; i < kMP; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int hp = p0 + pg + 16 * i, n = n0 + ng + 16 * j;
              acc[i][j] = (k0 == 0 || hp >= ph || n >= C) ? 0.f : x3a[hp * C + n];
            }
#pragma unroll 4
          for (int k = 0; k < kKC; ++k) {
            float av[kMP], wv[4];
#pragma unroll
            for (int i = 0; i < kMP; ++i) av[i] = G[k * ph + min(p0 + pg + 16 * i, ph - 1)];
#pragma unroll
            for (int j = 0; j < 4; ++j) wv[j] = Ws1[k * kLd + ng + 16 * j];
#pragma unroll
            for (int i = 0; i < kMP; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
          }
#pragma unroll
          for (int i = 0; i < kMP; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int hp = p0 + pg + 16 * i, n = n0 + ng + 16 * j;
              if (hp < ph && n < C) x3a[hp * C + n] = acc[i][j];
            }
        }
        __syncthreads();
      }
    }

    // 2. x3 = x2 + that product, rounded through T (0 outside the image);
    //    only the tile's interior is written out
    for (int e = tid; e < ph * C; e += kThreads) {
      const int hp = e / C, n = e % C, ry = hp / hw, rx = hp % hw;
      const int gy = ty0 - 1 + ry, gx = tx0 - 1 + rx;
      float val = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        const long long i = ((long long)(b * H + gy) * W + gx) * C + n;
        val = round_t<T>(to_f(x2[i]) + x3a[e]);
        if (ry >= 1 && ry <= th && rx >= 1 && rx <= tw) x3[i] = from_f<T>(val);
      }
      x3a[e] = val;
    }
    __syncthreads();

    // 3. block n+1's stats pass on the tile: LN1 once per tile, in place,
    //    then each head's qkv rows, taps, v2 and partial Gram
    const StatsTile t{b, ty0, tx0, th, tw, H, W, C};
    halo_ln_stats([&](int hp, int, int c) -> float { return x3a[hp * C + c]; }, t, ta.eps, s);
    __syncthreads();
    for (int e = tid; e < ph * C; e += kThreads) {
      const int hp = e / C;
      x3a[e] = s.pix[hp] < 0 ? 0.f
                             : ln1_value(x3a[e], s.mean[hp], s.rstd[hp], ln1w, ln1b, e % C,
                                         ta.bias_free);
    }
    __syncthreads();
    for (int h = 0; h < heads; ++h) {
      float* out = a.part + ((long long)(b * heads + h) * a.nslots + slot) * (d * d + 2 * d);
      // the slot's first tile writes, the rest add
      stats_head<T>([&](int hp, int c) -> float { return x3a[hp * C + c]; },
                    static_cast<const T*>(a.wqkv), static_cast<const T*>(a.wdwa),
                    static_cast<T*>(a.v2), out, tile == slot, h, heads, t, s);
    }
  }
}

// ----------------------------------------------------------- bf16 route

// Shared-memory bytes of the bf16 merged block, in the order
// tail_stats_tc_kernel carves them (ops/cuda/megablock.py mirrors this):
//   X3   ph x tc_ld(C) bf16: x3 on the tile and its ring, then LN1's output
//        in place (the stats pass's operand);
//   then one scratch area, used first by gdfn_w2 (W2Smem on the ring and its
//   halo, np = the accumulators' columns) and then by the stats pass
//   (StatsTcSmem).
__host__ __device__ inline int merged_tc_bytes(int th, int tw, int C, int d, int np) {
  const int ph = (th + 2) * (tw + 2), w2 = W2Smem::bytes(th + 2, tw + 2, np);
  const int st = StatsTcSmem::bytes(ph, th * tw, d);
  return ph * tc_ld(C) * 2 + (w2 > st ? w2 : st);
}

// One block: slot blockIdx.x of image blockIdx.y, all heads of block n+1,
// on th x tw tiles whose ring, (th + 2)(tw + 2) pixels, fills the W2
// product's rows (WM x 16 MT); the accumulators hold all C outputs of the
// ring in registers across every gate chunk (8 / WM x 8 NT >= C columns).
// Per tile: 1. gdfn_w2 on the ring (the routine gdfn_out_tc runs on its
// tile, so x3 equals block_tail's bit for bit); 2. x3 = x2 + that product,
// rounded to bf16, into X3 (0 outside the image), the interior written out;
// 3. LN1 on X3 in place, then stats_head_tc for each head.
template <int WM, int MT, int NT, int TH, int TW>
__global__ void __launch_bounds__(kThreads) tail_stats_tc_kernel(TailStatsArgs a) {
  using S = TcShape<WM, MT, NT>;
  constexpr int RW = TW + 2, PH = (TH + 2) * RW;
  static_assert(S::M == PH, "the ring fills the product's rows");
  extern __shared__ float4 smem4[];
  const TailArgs& ta = a.tail;
  const int slot = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int C = ta.C, H = ta.H, W = ta.W, heads = a.heads2, d = C / heads, ld = tc_ld(C);
  const bf16* x2 = static_cast<const bf16*>(ta.x2);
  const bf16* ln1w = static_cast<const bf16*>(a.ln1w);
  const bf16* ln1b = static_cast<const bf16*>(a.ln1b);
  bf16* x3 = static_cast<bf16*>(a.x3);
  bf16* X3 = reinterpret_cast<bf16*>(smem4);
  char* scratch = reinterpret_cast<char*>(X3 + PH * ld);
  const W2Smem w2s(scratch, TH + 2, TW + 2, S::NP);
  const StatsTcSmem ss(scratch, PH, TH * TW, d);
  const StatsSmem ls = ss.ln();
  const int warp = tid >> 5, m0 = (warp % WM) * 16 * MT, c0 = (warp / WM) * 8 * NT;
  for (int e = tid; e < PH * (ld - C); e += kThreads)  // X3's padding stays zero
    X3[(e / (ld - C)) * ld + C + e % (ld - C)] = __float2bfloat16(0.f);

  for (int tile = slot; tile < a.tiles; tile += a.nslots) {
    const int ty0 = (tile / a.tiles_w) * TH, tx0 = (tile % a.tiles_w) * TW;

    // 1-2. x3 = x2 + W2 gate(h) on the tile and its ring
    float acc[MT][NT][4];
    gdfn_w2<WM, MT, NT>(static_cast<const bf16*>(ta.hid), static_cast<const float*>(ta.wdw),
                        static_cast<const bf16*>(ta.w2), b, H, W, C, packed_f(ta.F), ty0 - 1,
                        tx0 - 1, TH + 2, TW + 2, w2s, acc);
    for_each_acc(acc, [&](int r, int c, float v0, float v1) {
      const int hp = m0 + r, n = c0 + c;
      if (n >= C) return;
      const int ry = hp / RW, rx = hp % RW, gy = ty0 - 1 + ry, gx = tx0 - 1 + rx;
      __nv_bfloat162 val = __floats2bfloat162_rn(0.f, 0.f);
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        const long long i = ((long long)(b * H + gy) * W + gx) * C + n;
        const float2 xv = load2(x2 + i);
        val = __floats2bfloat162_rn(xv.x + v0, xv.y + v1);
        if (ry >= 1 && ry <= TH && rx >= 1 && rx <= TW)
          *reinterpret_cast<__nv_bfloat162*>(x3 + i) = val;
      }
      *reinterpret_cast<__nv_bfloat162*>(X3 + hp * ld + n) = val;
    });
    __syncthreads();

    // 3. block n+1's stats pass: LN1 once per tile, in place, then each head
    const StatsTile t{b, ty0, tx0, TH, TW, H, W, C};
    halo_ln_stats([&](int hp, int, int c) -> float { return to_f(X3[hp * ld + c]); }, t, ta.eps,
                  ls);
    zero_smem(ss.qT, 2 * StatsTcSmem::rows(d) * tc_ld(TH * TW) * 2);  // phase 1's leftovers
    __syncthreads();
    for (int hp = warp; hp < PH; hp += kThreads / 32) {  // a warp a pixel
      const bool out = ss.pix[hp] < 0;
      const float mean = ss.mean[hp], rstd = ss.rstd[hp];
      for (int c = tid & 31; c < C; c += 32)
        X3[hp * ld + c] = __float2bfloat16(
            out ? 0.f
                : ln1_value(to_f(X3[hp * ld + c]), mean, rstd, ln1w, ln1b, c, ta.bias_free));
    }
    __syncthreads();
    for (int h = 0; h < heads; ++h) {
      float* out = a.part + ((long long)(b * heads + h) * a.nslots + slot) * (d * d + 2 * d);
      // the slot's first tile writes, the rest add
      stats_head_tc<4, PH / 64, 4>(X3, ld, static_cast<const bf16*>(a.wqkv),
                                   static_cast<const bf16*>(a.wdwa), static_cast<bf16*>(a.v2),
                                   out, tile == slot, h, heads, t, ss);
    }
  }
}

template <int WM, int MT, int NT, int TH, int TW>
int launch_tc_at(const TailStatsArgs& a, float* stats, size_t smem, cudaStream_t stream) {
  if (a.th != TH || a.tw != TW) return cudaErrorInvalidValue;
  cudaError_t err = launch_tail_a_tc(a.tail, stream);
  if (err != cudaSuccess) return err;
  err = allow_smem(tail_stats_tc_kernel<WM, MT, NT, TH, TW>, smem);
  if (err != cudaSuccess) return err;
  tail_stats_tc_kernel<WM, MT, NT, TH, TW>
      <<<dim3(a.nslots, a.tail.B), kThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_stats_reduce(a.part, stats, a.tail.B, a.heads2, a.tail.C, a.nslots, stream);
}

// The bf16 tile and warp layout by width (ops/cuda/megablock.py:TC_TILES):
// the ring fills 256, 128 or 64 rows and the accumulators 96 registers a
// thread at C = 96, 192 and 384 (48 at C = 48).
int launch_tc(const TailStatsArgs& a, float* stats, size_t smem, cudaStream_t stream) {
  const int C = a.tail.C;
  if (C <= 48) return launch_tc_at<4, 4, 3, 14, 14>(a, stats, smem, stream);
  if (C <= 96) return launch_tc_at<4, 4, 6, 14, 14>(a, stats, smem, stream);
  if (C <= 192) return launch_tc_at<2, 4, 6, 6, 14>(a, stats, smem, stream);
  if (C <= 384) return launch_tc_at<1, 4, 6, 6, 6>(a, stats, smem, stream);
  return cudaErrorInvalidValue;
}

template <class T, int MP>
int launch(const TailStatsArgs& a, float* stats, size_t smem, cudaStream_t stream) {
  cudaError_t err = launch_tail_a<T, MP>(a.tail, stream);
  if (err != cudaSuccess) return err;
  err = allow_smem(tail_stats_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  tail_stats_kernel<T><<<dim3(a.nslots, a.tail.B), kThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_stats_reduce(a.part, stats, a.tail.B, a.heads2, a.tail.C, a.nslots, stream);
}

}  // namespace

// Shared-memory bytes of one merged block at a (th, tw) tile, width C and
// head width d (the Python wrapper picks the tile and checks the fit).
extern "C" long long tail_stats_smem(int dtype, int th, int tw, int C, int d) {
  if (dtype == kBF16) {
    const int n8 = C <= 48 ? 6 : C <= 96 ? 12 : C <= 192 ? 24 : 48;  // launch_tc's columns / 8
    return merged_tc_bytes(th, tw, C, d, 8 * n8);
  }
  return (long long)MergedSmem(th, tw, C, d).floats() * sizeof(float);
}

// Returns the CUDA error code of the launches (0 on success). `smem` is
// tail_stats_smem's bytes for the launch's tile (the wrapper checks the
// fit, and tail_a's). In bf16, attn is bf16, w1, wdw and w2 the packed
// copies and hid (B, H, W, 2Fp).
extern "C" int tail_stats_launch(int dtype, const void* v, const void* x, const void* attn,
                                 const void* wproj, const void* ln2w, const void* ln2b,
                                 const void* w1, const void* wdw, const void* w2,
                                 const void* ln1w, const void* ln1b, const void* wqkv,
                                 const void* wdwa, void* x2, void* hid, void* x3, void* v2,
                                 float* part, float* stats, int B, int H, int W, int C,
                                 int heads, int heads2, int F, int th, int tw, int nslots,
                                 int bias_free, float eps, long long smem, void* stream) {
  TailStatsArgs a;
  TailArgs& t = a.tail;
  t.v = v; t.x = x; t.attn = attn; t.wproj = wproj; t.lnw = ln2w; t.lnb = ln2b; t.w1 = w1;
  t.wdw = wdw; t.w2 = w2; t.x2 = x2; t.hid = hid; t.out = nullptr;
  t.B = B; t.H = H; t.W = W; t.C = C; t.heads = heads; t.F = F; t.bias_free = bias_free;
  t.eps = eps;
  a.ln1w = ln1w; a.ln1b = ln1b; a.wqkv = wqkv; a.wdwa = wdwa; a.x3 = x3; a.v2 = v2;
  a.part = part; a.heads2 = heads2; a.th = th; a.tw = tw;
  a.tiles_w = (W + tw - 1) / tw;
  a.tiles = ((H + th - 1) / th) * a.tiles_w;
  a.nslots = nslots;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = tail_mp(C) == 4;
  if (dtype == kBF16) return launch_tc(a, stats, (size_t)smem, s);
  if (dtype == kF32)
    return wide ? launch<float, 4>(a, stats, (size_t)smem, s)
                : launch<float, 2>(a, stats, (size_t)smem, s);
  return cudaErrorInvalidValue;
}
