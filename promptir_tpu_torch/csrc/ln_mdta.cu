// MDTA apply: x2 = x + W_proj (attn v), the second pass of x + MDTA(LN(x)),
// run after the stats pass (mdta_stats.cu) and the softmax over its Gram
// (ops/cuda/mdta.py:attn_from_stats).
//
// Replaces promptir_tpu/ops/pallas/mdta.py:252 fused_ln_mdta (body
// _kernel_b). The TPU kernel takes a row stripe of v and x and the
// block-diagonal (C x C) attention padded to 128 lanes; here a block takes
// 16 * MP consecutive pixels of one image and the (heads, d, d) attention
// of that image, and runs attn_apply_project of mdta_apply.cuh, the same
// code as steps 1-2 of block_tail.cu's tail_a: attn v per head into shared
// memory (rounded through T), then W_proj and the residual. Rounding points
// as _kernel_b: attn v is rounded to T; the products are fp32.
//
// Bound on the H100. Per pixel the function reads v and x and writes x2:
// 3C stored values; it does dC + C^2 MACs (2dC + 2C^2 operations), d = C /
// heads. In bf16 at 989 TFLOP/s and 3.35 TB/s (295 operations a byte) the
// minimal traffic is the bound while (d + C) / 3 < 295, i.e. at every
// promptir shape (d + C <= 880) and the operations only for one head at
// C = 704 (d + C = 1408); chip_smoke.py prints which for every shape. Both
// routes re-read W_proj and attn from L2 for every tile of pixels; the
// float32 route's products are SIMT FMAs (common.cuh:gemm_tile), the bf16
// route's (mdta_apply_tc_kernel) on the tensor cores with attn in bf16.
//
// Dropped TPU workarounds: the 128-lane padding of C and of the attention
// matrix (the masked off-head blocks cost the MXU a C x C product where
// the heads need d x d).
#include "mdta_apply.cuh"

namespace {
using namespace pk;

struct ApplyArgs {
  const void* v;      // (B, H, W, C) T
  const void* x;      // (B, H, W, C) T
  const void* attn;   // (B, heads, d, d) T
  const void* wproj;  // (C, C) T (out, in)
  void* x2;           // (B, H, W, C) T
  int B, HW, C, heads;
};

// One block: PT = 16 * MP consecutive pixels of one image. Shared memory,
// in order: av (C x PT fp32) and the two product staging tiles; the byte
// count is ops/cuda/mdta.py:ln_mdta_smem.
template <class T, int MP>
__global__ void __launch_bounds__(kThreads) mdta_apply_kernel(ApplyArgs a) {
  constexpr int PT = 16 * MP;
  extern __shared__ float4 smem4[];
  const int b = blockIdx.y;
  const long long pix0 = (long long)b * a.HW + (long long)blockIdx.x * PT;
  const int np = min(PT, a.HW - (int)blockIdx.x * PT);
  float* av = reinterpret_cast<float*>(smem4);
  float* As = av + a.C * PT;
  float* Ws = As + kTileK * kLd;
  attn_apply_project<T, MP, false>(static_cast<const T*>(a.v), static_cast<const T*>(a.x),
                                   static_cast<const float*>(a.attn),
                                   static_cast<const T*>(a.wproj),
                                   static_cast<T*>(a.x2), b, a.C, a.heads, pix0, np, av,
                                   nullptr, As, Ws);
}

// The bf16 route: kPT pixels a block; X and AV (kPT x tc_ld(C) bf16), then
// the weight double buffer (2 x 256 x tc_ld(32) bf16).
__global__ void __launch_bounds__(kThreads) mdta_apply_tc_kernel(ApplyArgs a) {
  extern __shared__ float4 smem4[];
  const int b = blockIdx.y, ld = tc_ld(a.C);
  const long long pix0 = (long long)b * a.HW + (long long)blockIdx.x * kPT;
  const int np = min(kPT, a.HW - (int)blockIdx.x * kPT);
  bf16* X = reinterpret_cast<bf16*>(smem4);
  bf16* AV = X + kPT * ld;
  attn_apply_project_tc(static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.x),
                        static_cast<const bf16*>(a.attn), static_cast<const bf16*>(a.wproj),
                        static_cast<bf16*>(a.x2), b, a.C, a.heads, pix0, np, X, AV,
                        AV + kPT * ld);
}

int launch_tc(const ApplyArgs& a, size_t smem, cudaStream_t stream) {
  cudaError_t err = allow_smem(mdta_apply_tc_kernel, smem);
  if (err != cudaSuccess) return err;
  mdta_apply_tc_kernel<<<dim3((a.HW + kPT - 1) / kPT, a.B), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <class T, int MP>
int launch(const ApplyArgs& a, size_t smem, cudaStream_t stream) {
  constexpr int PT = 16 * MP;
  cudaError_t err = allow_smem(mdta_apply_kernel<T, MP>, smem);
  if (err != cudaSuccess) return err;
  mdta_apply_kernel<T, MP><<<dim3((a.HW + PT - 1) / PT, a.B), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Returns the CUDA error code of the launch (0 on success). `mp` is the
// pixel tile's 16-pixel groups (4 or 2; 4 in bf16) and `smem` its
// shared-memory bytes, both from ops/cuda/mdta.py (the wrapper checks the
// fit); a bf16 launch takes attn in bf16.
extern "C" int ln_mdta_launch(int dtype, const void* v, const void* x, const void* attn,
                              const void* wproj, void* x2, int B, int H, int W, int C, int heads,
                              int mp, long long smem, void* stream) {
  ApplyArgs a;
  a.v = v; a.x = x; a.attn = attn; a.wproj = wproj; a.x2 = x2;
  a.B = B; a.HW = H * W; a.C = C; a.heads = heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t sm = static_cast<size_t>(smem);
  if (dtype == kBF16) return launch_tc(a, sm, s);
  if (dtype == kF32 && mp == 4) return launch<float, 4>(a, sm, s);
  if (dtype == kF32 && mp == 2) return launch<float, 2>(a, sm, s);
  return cudaErrorInvalidValue;
}
