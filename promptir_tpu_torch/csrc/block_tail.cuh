// tail_a, the pointwise first kernel of the TransformerBlock tail, shared by
// block_tail.cu (tail_a then gdfn_out) and tail_stats.cu (tail_a then the
// merged kernel): attn apply, out-projection, residual, LN2 and W1 (C -> 2F)
// on 16 * MP consecutive pixels a block; writes x2 and the hidden h, both
// in T. Its first two steps are attn_apply_project of mdta_apply.cuh, its
// last two ln_tile and project_in of gdfn.cuh. tail_a_tc is the bf16 route:
// the same steps on 64 pixels with every product on the tensor cores
// (attn_apply_project_tc, ln_rows, project_in_tc), h in the packed layout of
// gdfn.cuh.
#pragma once

#include "gdfn.cuh"
#include "mdta_apply.cuh"

// One anonymous namespace at file scope, as the including .cu files use
// (see gdfn.cuh).
namespace {
using namespace pk;

struct TailArgs {
  const void* v;      // (B, H, W, C) T
  const void* x;      // (B, H, W, C) T
  const void* attn;   // (B, heads, d, d) T
  const void* wproj;  // (C, C) T (out, in)
  const void* lnw;    // (C) T
  const void* lnb;    // (C) T, unused when bias_free
  const void* w1;     // (2F, C) T; bf16: (2Fp, C) packed
  const void* wdw;    // (2F, 9) T; bf16: (2Fp, 9) fp32 packed
  const void* w2;     // (C, F) T; bf16: (C, Fp)
  void* x2;           // (B, H, W, C) T
  void* hid;          // (B, H, W, 2F) T; bf16: (B, H, W, 2Fp) packed
  void* out;          // (B, H, W, C) T
  int B, H, W, C, heads, F, bias_free;
  float eps;
};

template <int MP>
constexpr size_t tail_a_smem_floats(int C) {
  return (size_t)2 * C * 16 * MP + 2 * kTileK * kLd + kThreads + 2 * 16 * MP;
}

// One block: PT = 16 * MP consecutive pixels of one image.
template <class T, int MP>
__global__ void __launch_bounds__(kThreads) tail_a_kernel(TailArgs a) {
  constexpr int PT = 16 * MP;
  extern __shared__ float4 smem4[];
  const int C = a.C, HW = a.H * a.W, F2 = 2 * a.F, b = blockIdx.y;
  const long long pix0 = (long long)b * HW + (long long)blockIdx.x * PT;
  const int np = min(PT, HW - (int)blockIdx.x * PT);
  const T* v = static_cast<const T*>(a.v);
  const T* x = static_cast<const T*>(a.x);
  const T* wproj = static_cast<const T*>(a.wproj);
  const T* lnw = static_cast<const T*>(a.lnw);
  const T* lnb = static_cast<const T*>(a.lnb);
  const T* w1 = static_cast<const T*>(a.w1);
  T* x2g = static_cast<T*>(a.x2);
  T* hid = static_cast<T*>(a.hid);

  float* bufA = reinterpret_cast<float*>(smem4);  // C x PT: av, then LN2(x2)
  float* bufB = bufA + C * PT;                    // C x PT: x2
  float* As = bufB + C * PT;
  float* Ws = As + kTileK * kLd;
  float* red = Ws + kTileK * kLd;  // kThreads partials + PT means + PT rstds

  // 1-2. av = attn v, then x2 = x + W_proj av: written out and kept in bufB
  attn_apply_project<T, MP, true>(v, x, static_cast<const float*>(a.attn), wproj, x2g, b, C,
                                  a.heads, pix0, np, bufA, bufB, As, Ws);

  // 3. LN2 over the C channels of each pixel (two-pass, fp32) -> bufA
  ln_tile<T, PT>(bufB, bufA, red, C, lnw, lnb, a.bias_free, a.eps);

  // 4. h = W1 LN2(x2) (2F channels), rounded to T
  project_in<T, MP>(bufA, w1, hid, pix0, np, C, F2, As, Ws);
}

template <class T, int MP>
cudaError_t launch_tail_a(const TailArgs& a, cudaStream_t stream) {
  constexpr int PT = 16 * MP;
  const size_t smem = tail_a_smem_floats<MP>(a.C) * sizeof(float);
  cudaError_t err = allow_smem(tail_a_kernel<T, MP>, smem);
  if (err != cudaSuccess) return err;
  const int HW = a.H * a.W;
  tail_a_kernel<T, MP><<<dim3((HW + PT - 1) / PT, a.B), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// tail_a's pixel tile: 64 pixels up to C = 256, else 32 (shared memory).
int tail_mp(int C) { return C <= 256 ? 4 : 2; }

// Fp of the bf16 route's packed layout: F rounded up to a gate chunk.
__host__ __device__ inline int packed_f(int F) { return (F + kGC - 1) / kGC * kGC; }

// Shared-memory bytes of a bf16 tail_a (and apply) block: X and AV, then
// ProjGemm's weight double buffer.
__host__ __device__ inline size_t tail_a_tc_smem(int C) {
  return (size_t)2 * kPT * tc_ld(C) * 2 + ProjGemm::WBUF * 2;
}

// One block: kPT consecutive pixels of one image. X holds v, then x2, then
// LN2(x2) in place; AV holds attn v. kBlocks blocks an SM: 2 where two fit
// its shared memory (C up to 256), which caps the registers at 128 a
// thread: one block of 166 registers waits on its barriers alone
// (PERF.md, section 6).
template <int kBlocks>
__global__ void __launch_bounds__(kThreads, kBlocks) tail_a_tc_kernel(TailArgs a) {
  extern __shared__ float4 smem4[];
  const int C = a.C, HW = a.H * a.W, ld = tc_ld(C), b = blockIdx.y;
  const long long pix0 = (long long)b * HW + (long long)blockIdx.x * kPT;
  const int np = min(kPT, HW - (int)blockIdx.x * kPT);
  bf16* X = reinterpret_cast<bf16*>(smem4);
  bf16* AV = X + kPT * ld;
  bf16* wbuf = AV + kPT * ld;
  attn_apply_project_tc(static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.x),
                        static_cast<const bf16*>(a.attn), static_cast<const bf16*>(a.wproj),
                        static_cast<bf16*>(a.x2), b, C, a.heads, pix0, np, X, AV, wbuf);
  ln_rows(X, ld, kPT, C, static_cast<const bf16*>(a.lnw), static_cast<const bf16*>(a.lnb),
          a.bias_free, a.eps);
  project_in_tc(X, ld, static_cast<const bf16*>(a.w1), static_cast<bf16*>(a.hid), pix0, np, C,
                2 * packed_f(a.F), wbuf);
}

template <int kBlocks>
cudaError_t launch_tail_a_tc_at(const TailArgs& a, size_t smem, cudaStream_t stream) {
  cudaError_t err = allow_smem(tail_a_tc_kernel<kBlocks>, smem);
  if (err != cudaSuccess) return err;
  const int HW = a.H * a.W;
  tail_a_tc_kernel<kBlocks><<<dim3((HW + kPT - 1) / kPT, a.B), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

inline cudaError_t launch_tail_a_tc(const TailArgs& a, cudaStream_t stream) {
  const size_t smem = tail_a_tc_smem(a.C);
  return 2 * (smem + kBlockReserved) <= kSmSmem ? launch_tail_a_tc_at<2>(a, smem, stream)
                                                 : launch_tail_a_tc_at<1>(a, smem, stream);
}

}  // namespace
