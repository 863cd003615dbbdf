// TransformerBlock tail: x2 = x + W_proj (attn v); out = x2 + W2 (gelu(h1) * h2)
// with [h1, h2] = dw3x3(W1 LN2(x2)).
//
// Replaces promptir_tpu/ops/pallas/block.py:158 fused_block_tail (body
// _tail_kernel, sharing gdfn.py:403 ln_gdfn_stripe). This first form splits
// the tail in two kernels at the hidden tensor:
//   tail_a (pointwise): attn apply, out-projection, residual, LN2, W1 (C->2F);
//          writes x2 and the hidden h, both in T. Its first two steps are
//          attn_apply_project of mdta_apply.cuh (ln_mdta.cu's in float32);
//   tail_b (spatial tile with a 1-pixel halo of h): depthwise 3x3, the exact
//          erf gate, W2 (F->C) and the residual x2. This is gdfn_out of
//          gdfn.cuh, which ln_gdfn.cu's float32 route shares, with steps 3-4 of
//          tail_a (ln_tile, project_in).
// Against the single-pass TPU kernel the split writes h (2F values a pixel)
// and x2 (C) and reads them back, h with its halo: about 2 * (2F + C) extra
// values a pixel, some 12 times the size of x at F = 2.66 C.
//
// Bound on the H100. The three products cost Cd + C^2 + 3FC MACs a pixel
// (about 9 C^2) against 3C stored values (v and x read, out written). In
// bf16 at 989 TFLOP/s and 3.35 TB/s the minimal traffic is the bound at
// C = 48 and the operations at C >= 96 (chip_smoke.py prints which for every
// shape). tail_a keeps av, x2 and LN2(x2) of its pixels in shared memory
// between the products. The float32 route's products are SIMT FMAs from
// common.cuh:gemm_tile, and its tail_b (gdfn_out) recomputes each gate once
// for every 64 outputs. The bf16 route puts every product on the tensor
// cores (tail_a_tc: attn v, W_proj, W1 through tc_gemm on 64 pixels, two
// blocks an SM up to C = 256), and its tail_b (gdfn_out_tc) takes an 8 x 8
// tile (4 x 8 above C = 384, for the registers), computes each gate once
// from h staged in shared memory and sums W2 into registers over all gate
// chunks (gdfn.cuh:gdfn_w2, tail_stats.cu's routine too). It is still far
// from the bound (PERF.md, per shape): its SIMT depthwise taps and gates,
// the barriers of one block an SM, and h's round trip.
//
// Dropped TPU workarounds: the W+2 / 128-lane padding, the rational erf
// (erff here is exact to a few ulp), the hybrid-MXU depthwise split and the
// w % 8 gates.
#include "block_tail.cuh"

namespace {
using namespace pk;

template <class T, int MP>
int launch(const TailArgs& a, cudaStream_t stream) {
  const cudaError_t err = launch_tail_a<T, MP>(a, stream);
  if (err != cudaSuccess) return err;
  GdfnOutArgs g;  // tail_b: the residual is x2
  g.hid = a.hid; g.wdw = a.wdw; g.w2 = a.w2; g.res = a.x2; g.out = a.out;
  g.B = a.B; g.H = a.H; g.W = a.W; g.C = a.C; g.F = a.F;
  return launch_gdfn_out<T>(g, stream);
}

// The bf16 route: tail_a_tc, then gdfn_out_tc (the packed weights of
// ops/cuda/packed.py).
int launch_tc(const TailArgs& a, cudaStream_t stream) {
  const cudaError_t err = launch_tail_a_tc(a, stream);
  if (err != cudaSuccess) return err;
  GdfnOutTcArgs g;
  g.hid = static_cast<const bf16*>(a.hid); g.wdwp = static_cast<const float*>(a.wdw);
  g.w2p = static_cast<const bf16*>(a.w2); g.res = static_cast<const bf16*>(a.x2);
  g.out = static_cast<bf16*>(a.out);
  g.B = a.B; g.H = a.H; g.W = a.W; g.C = a.C; g.Fp = packed_f(a.F);
  return launch_gdfn_out_tc(g, stream);
}

}  // namespace

// Shared-memory bytes of one tail_a block (the Python wrapper checks the fit).
extern "C" long long block_tail_smem(int dtype, int C) {
  if (dtype == kBF16) return (long long)tail_a_tc_smem(C);
  return (long long)(tail_mp(C) == 4 ? tail_a_smem_floats<4>(C) : tail_a_smem_floats<2>(C)) *
         sizeof(float);
}

// Returns the CUDA error code of the two launches (0 on success). In bf16,
// w1, wdw and w2 are the packed copies, hid (B, H, W, 2Fp) and attn bf16.
extern "C" int block_tail_launch(int dtype, const void* v, const void* x, const void* attn,
                                 const void* wproj, const void* lnw, const void* lnb,
                                 const void* w1, const void* wdw, const void* w2, void* x2,
                                 void* hid, void* out, int B, int H, int W, int C, int heads,
                                 int F, int bias_free, float eps, void* stream) {
  TailArgs a;
  a.v = v; a.x = x; a.attn = attn; a.wproj = wproj; a.lnw = lnw; a.lnb = lnb; a.w1 = w1;
  a.wdw = wdw; a.w2 = w2; a.x2 = x2; a.hid = hid; a.out = out;
  a.B = B; a.H = H; a.W = W; a.C = C; a.heads = heads; a.F = F; a.bias_free = bias_free;
  a.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) return launch_tc(a, s);
  if (dtype == kF32) return tail_mp(C) == 4 ? launch<float, 4>(a, s) : launch<float, 2>(a, s);
  return cudaErrorInvalidValue;
}
