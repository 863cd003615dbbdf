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
// bound at C >= 192; chip_smoke.py prints which for every shape. This first
// form is far from both: its products are fp32 SIMT FMAs from a plain
// shared-memory tile (common.cuh), not wgmma, so it is bound by the SMs'
// fp32 issue rate. Only the same-head d x d blocks of the Gram are ever used
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
#include "common.cuh"

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

constexpr int kMP = 4;  // 64 halo pixels per product pass

// One block: slot blockIdx.x of (head, image) = (blockIdx.y, blockIdx.z). It
// walks the tiles slot, slot + nslots, ... in order and sums their Grams and
// norms into its own slot of `part`.
template <class T>
__global__ void __launch_bounds__(kThreads) stats_kernel(StatsArgs a) {
  extern __shared__ float4 smem4[];
  const int slot = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int C = a.C, d = C / a.heads, th = a.th, tw = a.tw;
  const int hw = tw + 2, ph = (th + 2) * hw, pi = th * tw, ld = 2 * d, n3 = 3 * d;
  const T* x = static_cast<const T*>(a.x);
  const T* lnw = static_cast<const T*>(a.lnw);
  const T* lnb = static_cast<const T*>(a.lnb);
  const T* wqkv = static_cast<const T*>(a.wqkv);
  const T* wdw = static_cast<const T*>(a.wdw);
  T* v = static_cast<T*>(a.v);

  float* qk_s = reinterpret_cast<float*>(smem4);  // pi x 2d: q then k, fp32
  float* pre_s = qk_s + pi * ld;                  // ph x kTileN: qkv before the taps
  float* As = pre_s + ph * kTileN;
  float* Ws = As + kTileK * kLd;
  float* mean_s = Ws + kTileK * kLd;  // ph
  float* rstd_s = mean_s + ph;        // ph
  int* pix_s = reinterpret_cast<int*>(rstd_s + ph);  // ph: flat pixel index or -1
  float* out = a.part + ((long long)(b * a.heads + h) * a.nslots + slot) * (d * d + 2 * d);

  for (int tile = slot; tile < a.tiles; tile += a.nslots) {
    const bool first = tile == slot;  // the slot's first tile writes, the rest add
    const int ty0 = (tile / a.tiles_w) * th, tx0 = (tile % a.tiles_w) * tw;

    // LN statistics (two-pass, fp32) of every halo pixel, one warp a pixel.
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int hp = warp; hp < ph; hp += kThreads / 32) {
      const int gy = ty0 - 1 + hp / hw, gx = tx0 - 1 + hp % hw;
      const bool in = gy >= 0 && gy < a.H && gx >= 0 && gx < a.W;
      float mean = 0.f, rstd = 0.f;
      if (in) {
        const T* xp = x + ((long long)(b * a.H + gy) * a.W + gx) * C;
        float s = 0.f;
        for (int c = lane; c < C; c += 32) s += to_f(xp[c]);
        mean = warp_sum(s) / C;
        float q = 0.f;
        for (int c = lane; c < C; c += 32) {
          const float t = to_f(xp[c]) - mean;
          q = fmaf(t, t, q);
        }
        rstd = 1.f / sqrtf(warp_sum(q) / C + a.eps);
      }
      if (lane == 0) {
        mean_s[hp] = mean;
        rstd_s[hp] = rstd;
        pix_s[hp] = in ? (b * a.H + gy) * a.W + gx : -1;
      }
    }
    __syncthreads();

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
              if (hp >= ph) return 0.f;
              const int pix = pix_s[hp];
              if (pix < 0) return 0.f;
              const float xv = to_f(x[(long long)pix * C + k]);
              const float y = a.bias_free
                                  ? xv * rstd_s[hp] * to_f(lnw[k])
                                  : (xv - mean_s[hp]) * rstd_s[hp] * to_f(lnw[k]) + to_f(lnb[k]);
              return round_t<T>(y);
            },
            [&](int k, int n) -> float {
              const int nn = n0 + n;
              if (nn >= n3) return 0.f;
              const int row = (nn / d) * C + h * d + nn % d;
              return to_f(wqkv[(long long)row * C + k]);
            },
            As, Ws, acc);
#pragma unroll
        for (int i = 0; i < kMP; ++i) {
          const int hp = p0 + pg + 16 * i;
          if (hp < ph) {
#pragma unroll
            for (int j = 0; j < 4; ++j) pre_s[hp * kTileN + ng + 16 * j] = acc[i][j];
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
        float s = 0.f;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx)
            s = fmaf(pre_s[((iy + dy) * hw + ix + dx) * kTileN + n], to_f(wdw[row * 9 + dy * 3 + dx]), s);
        const int gy = ty0 + iy, gx = tx0 + ix;
        const bool valid = gy < a.H && gx < a.W;
        if (sec == 2) {
          if (valid) v[((long long)(b * a.H + gy) * a.W + gx) * C + h * d + ch] = from_f<T>(s);
        } else {
          qk_s[p * ld + sec * d + ch] = valid ? s : 0.f;
        }
      }
      __syncthreads();
    }

    // partial Gram (4x4 register tiles) and squared norms of this tile, added
    // to the slot's sums; each value of the slot is read and written by one
    // thread only
    const int d4 = d / 4;
    for (int t = threadIdx.x; t < d4 * d4; t += kThreads) {
      const int ib = t / d4, jb = t % d4;
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s) acc[r][s] = first ? 0.f : out[(ib * 4 + r) * d + jb * 4 + s];
      for (int p = 0; p < pi; ++p) {
        const float4 q = *reinterpret_cast<const float4*>(qk_s + p * ld + ib * 4);
        const float4 k = *reinterpret_cast<const float4*>(qk_s + p * ld + d + jb * 4);
        const float qa[4] = {q.x, q.y, q.z, q.w}, ka[4] = {k.x, k.y, k.z, k.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int s = 0; s < 4; ++s) acc[r][s] = fmaf(qa[r], ka[s], acc[r][s]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s) out[(ib * 4 + r) * d + jb * 4 + s] = acc[r][s];
    }
    for (int c = threadIdx.x; c < ld; c += kThreads) {
      float s = first ? 0.f : out[d * d + c];
      for (int p = 0; p < pi; ++p) {
        const float t = qk_s[p * ld + c];
        s = fmaf(t, t, s);
      }
      out[d * d + c] = s;
    }
    __syncthreads();  // qk_s is rewritten by the next tile
  }
}

// Sum the slots in slot order: (B*heads, nslots, n) -> (B*heads, n).
__global__ void __launch_bounds__(kThreads) stats_reduce_kernel(const float* part, float* stats,
                                                                int nslots, int n) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= n) return;
  const float* src = part + (long long)blockIdx.y * nslots * n + e;
  float s = 0.f;
#pragma unroll 8
  for (int t = 0; t < nslots; ++t) s += src[(long long)t * n];
  stats[(long long)blockIdx.y * n + e] = s;
}

template <class T>
int launch(const StatsArgs& a, float* stats, size_t smem, cudaStream_t stream) {
  cudaError_t err = allow_smem(stats_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  stats_kernel<T><<<dim3(a.nslots, a.heads, a.B), kThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int d = a.C / a.heads, n = d * d + 2 * d;
  stats_reduce_kernel<<<dim3((n + kThreads - 1) / kThreads, a.B * a.heads), kThreads, 0, stream>>>(
      a.part, stats, a.nslots, n);
  return cudaGetLastError();
}

}  // namespace

// Returns the CUDA error code of the launches (0 on success). `smem` is the
// block's shared-memory bytes, computed by ops/cuda/mdta.py:stats_smem for the
// layout that stats_kernel carves (the wrapper checks the fit).
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
  if (dtype == kBF16) return launch<__nv_bfloat16>(a, stats, (size_t)smem, s);
  if (dtype == kF32) return launch<float>(a, stats, (size_t)smem, s);
  return cudaErrorInvalidValue;
}
