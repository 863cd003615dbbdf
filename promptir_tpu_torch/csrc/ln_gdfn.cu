// LN + GDFN: out = x + W2 (gelu(h1) * h2) with [h1, h2] = dw3x3(W1 LN(x)),
// the spatial feed-forward of every X-Restormer block.
//
// Replaces promptir_tpu/ops/pallas/gdfn.py:536 fused_ln_gdfn (body _kernel,
// ln_gdfn_stripe). The TPU kernel kept a row stripe's hidden tensor with its
// halo rows in VMEM; on Hopper the hidden (2F up to 3744 channels) does not
// fit one block's shared memory with its halo, so this first form splits at
// h exactly as block_tail does, and reuses its pieces (gdfn.cuh):
//   ln_gdfn_a (pointwise, 16 * MP pixels a block): x tile -> LN (two-pass,
//             fp32, in place) -> W1 (C -> 2F); writes h in T;
//   gdfn_out  (a 4 x 16 tile with a 1-pixel halo of h): depthwise 3x3, the
//             exact erf gate, W2 (F -> C) and the residual x.
//
// Bound on the H100. The products cost 3FC MACs a pixel (about 8 C^2)
// against 2C stored values (x read, out written). In bf16 at 989 TFLOP/s
// and 3.35 TB/s the minimal traffic is the bound at C = 48 and the
// operations at C >= 96 (chip_smoke.py prints which for every shape). Both
// routes write h (2F values a pixel) and read it back with its halo, about
// 10 times the size of x. The float32 route's products are SIMT FMAs
// (common.cuh:gemm_tile) and its gdfn_out recomputes the gate once for each
// 64 outputs; the bf16 route (ln_gdfn_a_tc_kernel, then gdfn_out_tc) puts
// W1 and W2 on the tensor cores and computes each gate once a tile.
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
constexpr int kPT = 16 * kMP;

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

// The bf16 route: one block a kPT-pixel tile; X (kPT x tc_ld(C) bf16) takes
// x with cp.async, LN in place, then W1 on the tensor cores into the packed
// h; then ProjGemm's weight double buffer.
size_t ln_gdfn_a_tc_smem(int C) { return (size_t)kPT * tc_ld(C) * 2 + ProjGemm::WBUF * 2; }

__global__ void __launch_bounds__(kThreads) ln_gdfn_a_tc_kernel(LnGdfnArgs a) {
  extern __shared__ float4 smem4[];
  const int C = a.C, HW = a.H * a.W, ld = tc_ld(C), b = blockIdx.y, tid = threadIdx.x;
  const long long pix0 = (long long)b * HW + (long long)blockIdx.x * kPT;
  const int np = min(kPT, HW - (int)blockIdx.x * kPT);
  const bf16* x = static_cast<const bf16*>(a.x);
  bf16* X = reinterpret_cast<bf16*>(smem4);
  bf16* wbuf = X + kPT * ld;
  for (int e = tid; e < kPT * (C / 8); e += kThreads) {
    const int p = e / (C / 8), q = e % (C / 8);
    const bool ok = p < np;
    cp_async16(X + p * ld + q * 8, ok ? x + (pix0 + p) * C + q * 8 : x, ok);
  }
  cp_async_commit();
  for (int e = tid; e < kPT * (ld - C); e += kThreads)  // the padding columns
    X[(e / (ld - C)) * ld + C + e % (ld - C)] = __float2bfloat16(0.f);
  cp_async_wait_all();
  __syncthreads();
  ln_rows(X, ld, kPT, C, static_cast<const bf16*>(a.lnw), static_cast<const bf16*>(a.lnb),
          a.bias_free, a.eps);
  const int Fp = (a.F + kGC - 1) / kGC * kGC;
  project_in_tc(X, ld, static_cast<const bf16*>(a.w1), static_cast<bf16*>(a.hid), pix0, np, C,
                2 * Fp, wbuf);
}

int launch_tc(const LnGdfnArgs& a, const void* wdw, const void* w2, void* out,
              cudaStream_t stream) {
  const size_t smem = ln_gdfn_a_tc_smem(a.C);
  cudaError_t err = allow_smem(ln_gdfn_a_tc_kernel, smem);
  if (err != cudaSuccess) return err;
  const int HW = a.H * a.W;
  ln_gdfn_a_tc_kernel<<<dim3((HW + kPT - 1) / kPT, a.B), kThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  GdfnOutTcArgs g;  // the residual is x
  g.hid = static_cast<const bf16*>(a.hid); g.wdwp = static_cast<const float*>(wdw);
  g.w2p = static_cast<const bf16*>(w2); g.res = static_cast<const bf16*>(a.x);
  g.out = static_cast<bf16*>(out);
  g.B = a.B; g.H = a.H; g.W = a.W; g.C = a.C; g.Fp = (a.F + kGC - 1) / kGC * kGC;
  return launch_gdfn_out_tc(g, stream);
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

}  // namespace

// Returns the CUDA error code of the two launches (0 on success). `smem` is
// ln_gdfn_a's shared-memory bytes (the wrapper checks the fit); in bf16, w1,
// wdw and w2 are the packed copies and hid (B, H, W, 2Fp).
extern "C" int ln_gdfn_launch(int dtype, const void* x, const void* lnw, const void* lnb,
                              const void* w1, const void* wdw, const void* w2, void* hid,
                              void* out, int B, int H, int W, int C, int F, int bias_free,
                              float eps, long long smem, void* stream) {
  LnGdfnArgs a;
  a.x = x; a.lnw = lnw; a.lnb = lnb; a.w1 = w1; a.hid = hid;
  a.B = B; a.H = H; a.W = W; a.C = C; a.F = F; a.bias_free = bias_free; a.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) return launch_tc(a, wdw, w2, out, s);
  if (dtype == kF32) return launch<float>(a, wdw, w2, out, (size_t)smem, s);
  return cudaErrorInvalidValue;
}
