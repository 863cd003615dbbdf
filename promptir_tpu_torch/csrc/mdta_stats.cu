// MDTA statistics pass: LN1 -> 1x1 qkv (C -> 3C) -> depthwise 3x3, writing v
// and the whole-image Gram S = q^T k and squared norms of q and k per head.
//
// Replaces promptir_tpu/ops/pallas/mdta.py:317 mdta_stats (body _kernel_a,
// stats_stripe). There the grid ran in order over row stripes and carried
// the Gram in VMEM from one step to the next. Here the blocks run in no
// order, so each block owns a slot of one (head, image): it walks the
// spatial tiles slot, slot + nslots, ... and sums their partial d x d Gram
// and norms into its slot, and a second tiny pass sums the slots in a fixed
// order: the result is deterministic. The wrapper picks nslots
// (ops/cuda/mdta.py:stats_slots): one a tile while the slots' d^2 + 2d fp32
// fit a 128 MiB budget, else about 264 blocks over all images and heads, so
// the slot buffer does not grow with the image.
//
// Bound on the H100. Per pixel the function does about 6C^2 + 2Cd
// operations (the 1x1 product and the Gram) against 2C stored values (x read,
// v written). In bf16 at 989 TFLOP/s and 3.35 TB/s that makes the minimal
// traffic the bound at C <= 160 (with d = 48 or 40) and the operations the
// bound at C >= 192; chip_smoke.py prints which for every shape. Both routes
// are far from it. The float32 route's products are SIMT FMAs from
// common.cuh:gemm_tile, bound by the SMs' fp32 issue rate; the bf16 route
// (stats_tc_kernel) stages LN1's output once a tile and puts the qkv
// product and the Gram on the tensor cores (mdta_stats.cuh:stats_head_tc),
// leaving its SIMT taps, LN and barriers as the cost (PERF.md). Only the same-head d x d blocks of the Gram are ever used
// (the softmax masks the rest), so a block needs only its head's 3d rows of
// W_qkv: LN over all C is recomputed per head, while the product's total
// work stays one pass over all 3C rows. q and k stay in shared memory and
// never reach device memory. Each block recomputes LN and qkv on a 1-pixel
// halo for the depthwise taps (overhead (th+2)(tw+2)/(th tw), 1.3x at the
// 14 x 14 tile of the d = 48 stacks, 2x at the 4 x 6 tile that one-head
// widths above 352 take). The tile shrinks with d (ops/cuda/mdta.py:
// stats_tile) so that q and k fit.
//
// Dropped TPU workarounds: the W+2 / 128-lane padding, the packed-qk lanes,
// the w % 8 gates and the bf16 rounding of q and k before the Gram (q and k
// stay fp32 here).
#include "mdta_stats.cuh"

namespace {
using namespace pk;

struct StatsArgs {
  const void* x;     // (B, H, W, C) T
  const void* lnw;   // (C) T
  const void* lnb;   // (C) T, unused when bias_free
  const void* wqkv;  // (3C, C) T, torch's conv weight (out, in)
  const void* wdw;   // (3C, 9) T
  void* v;           // (B, H, W, C) T
  float* part;       // (B, heads, nslots, d*d + 2d)
  int B, H, W, C, heads, th, tw, tiles_w, tiles, nslots, bias_free;
  float eps;
};

// One block: slot blockIdx.x of (head, image) = (blockIdx.y, blockIdx.z). It
// walks the tiles slot, slot + nslots, ... in order and sums their Grams and
// norms into its own slot of `part`.
template <class T>
__global__ void __launch_bounds__(kThreads) stats_kernel(StatsArgs a) {
  extern __shared__ float4 smem4[];
  const int slot = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int C = a.C, d = C / a.heads, th = a.th, tw = a.tw;
  const int ph = (th + 2) * (tw + 2), pi = th * tw;
  const T* x = static_cast<const T*>(a.x);

  StatsSmem s;
  s.qk = reinterpret_cast<float*>(smem4);  // pi x 2d
  s.pre = s.qk + pi * 2 * d;               // ph x kTileN
  s.As = s.pre + ph * kTileN;
  s.Ws = s.As + kTileK * kLd;
  s.mean = s.Ws + kTileK * kLd;            // ph
  s.rstd = s.mean + ph;                    // ph
  s.pix = reinterpret_cast<int*>(s.rstd + ph);  // ph
  float* out = a.part + ((long long)(b * a.heads + h) * a.nslots + slot) * (d * d + 2 * d);
  const T* lnw = static_cast<const T*>(a.lnw);
  const T* lnb = static_cast<const T*>(a.lnb);
  const auto ldx = [&](int, int pix, int c) -> float { return to_f(x[(long long)pix * C + c]); };
  // LN1 applied as the product stages x
  const auto ldy = [&](int hp, int c) -> float {
    const int pix = s.pix[hp];
    if (pix < 0) return 0.f;
    return ln1_value(ldx(hp, pix, c), s.mean[hp], s.rstd[hp], lnw, lnb, c, a.bias_free);
  };

  for (int tile = slot; tile < a.tiles; tile += a.nslots) {
    const StatsTile t{b, (tile / a.tiles_w) * th, (tile % a.tiles_w) * tw, th, tw, a.H, a.W, C};
    halo_ln_stats(ldx, t, a.eps, s);
    __syncthreads();
    // the slot's first tile writes, the rest add
    stats_head<T>(ldy, static_cast<const T*>(a.wqkv), static_cast<const T*>(a.wdw),
                  static_cast<T*>(a.v), out, tile == slot, h, a.heads, t, s);
  }
}

// The bf16 route: as stats_kernel, with LN1's output staged once a tile as
// the bf16 operand Y (the halo's ph pixels in WM x 16 MT rows of tc_ld(C),
// zero padding rows) and the products on the tensor cores (stats_head_tc).
// Shared memory: Y, then StatsTcSmem.
template <int WM, int MT, int NT>
__global__ void __launch_bounds__(kThreads) stats_tc_kernel(StatsArgs a) {
  constexpr int M = TcShape<WM, MT, NT>::M;
  extern __shared__ float4 smem4[];
  const int slot = blockIdx.x, h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int C = a.C, d = C / a.heads, th = a.th, tw = a.tw, ld = tc_ld(C);
  const int ph = (th + 2) * (tw + 2), pi = th * tw;
  const bf16* x = static_cast<const bf16*>(a.x);
  const bf16* lnw = static_cast<const bf16*>(a.lnw);
  const bf16* lnb = static_cast<const bf16*>(a.lnb);
  bf16* Y = reinterpret_cast<bf16*>(smem4);
  const StatsTcSmem s(reinterpret_cast<char*>(Y + M * ld), ph, pi, d);
  const StatsSmem ls = s.ln();
  float* out = a.part + ((long long)(b * a.heads + h) * a.nslots + slot) * (d * d + 2 * d);
  // Y's padding and qT's and kT's stay zero: the tiles rewrite the rest
  zero_smem(Y, M * ld * 2);
  zero_smem(s.qT, 2 * StatsTcSmem::rows(d) * tc_ld(pi) * 2);
  __syncthreads();
  for (int tile = slot; tile < a.tiles; tile += a.nslots) {
    const StatsTile t{b, (tile / a.tiles_w) * th, (tile % a.tiles_w) * tw, th, tw, a.H, a.W, C};
    halo_ln_stats([&](int, int pix, int c) -> float { return to_f(x[(long long)pix * C + c]); },
                  t, a.eps, ls);
    __syncthreads();
    for (int hp = tid >> 5; hp < ph; hp += kThreads / 32) {  // a warp a pixel
      const int pix = s.pix[hp];
      const float mean = s.mean[hp], rstd = s.rstd[hp];
      for (int c = tid & 31; c < C; c += 32)
        Y[hp * ld + c] = __float2bfloat16(
            pix < 0 ? 0.f
                    : ln1_value(to_f(x[(long long)pix * C + c]), mean, rstd, lnw, lnb, c,
                                a.bias_free));
    }
    __syncthreads();
    // the slot's first tile writes, the rest add
    stats_head_tc<WM, MT, NT>(Y, ld, static_cast<const bf16*>(a.wqkv),
                              static_cast<const bf16*>(a.wdw), static_cast<bf16*>(a.v), out,
                              tile == slot, h, a.heads, t, s);
  }
}

template <class K>
int launch_kernel(K kernel, const StatsArgs& a, float* stats, size_t smem, cudaStream_t stream) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.nslots, a.heads, a.B), kThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_stats_reduce(a.part, stats, a.B, a.heads, a.C, a.nslots, stream);
}

}  // namespace

// Returns the CUDA error code of the launches (0 on success). `smem` is the
// block's shared-memory bytes, computed by ops/cuda/mdta.py:stats_smem for the
// layout that stats_kernel (float32) or stats_tc_kernel (bf16) carves (the
// wrapper checks the fit).
extern "C" int mdta_stats_launch(int dtype, const void* x, const void* lnw, const void* lnb,
                                 const void* wqkv, const void* wdw, void* v, float* part,
                                 float* stats, int B, int H, int W, int C, int heads, int th,
                                 int tw, int nslots, int bias_free, float eps, long long smem,
                                 void* stream) {
  StatsArgs a;
  a.x = x; a.lnw = lnw; a.lnb = lnb; a.wqkv = wqkv; a.wdw = wdw; a.v = v; a.part = part;
  a.B = B; a.H = H; a.W = W; a.C = C; a.heads = heads; a.th = th; a.tw = tw;
  a.tiles_w = (W + tw - 1) / tw;
  a.tiles = ((H + th - 1) / th) * a.tiles_w;
  a.nslots = nslots;
  a.bias_free = bias_free; a.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t sm = static_cast<size_t>(smem);
  const int ph = (th + 2) * (tw + 2);
  if (dtype == kF32) return launch_kernel(stats_kernel<float>, a, stats, sm, s);
  // the halo's rows: 48 (the 4 x 6 tile of the widest heads), 64, 128 or 256
  if (dtype == kBF16 && ph <= 48) return launch_kernel(stats_tc_kernel<1, 3, 1>, a, stats, sm, s);
  if (dtype == kBF16 && ph <= 64) return launch_kernel(stats_tc_kernel<4, 1, 4>, a, stats, sm, s);
  if (dtype == kBF16 && ph <= 128) return launch_kernel(stats_tc_kernel<4, 2, 4>, a, stats, sm, s);
  if (dtype == kBF16 && ph <= 256) return launch_kernel(stats_tc_kernel<4, 4, 4>, a, stats, sm, s);
  return cudaErrorInvalidValue;
}
